"""Cell builder: (architecture × input shape × mesh) → one step run on
``meta`` local shards, with the counts a roofline needs.  Shared by
``launch/dryrun.py`` and the tests (which run it on a fake (2, 2, 2) mesh).

There is no XLA here: the step is run once, eagerly, as DTensors whose local
shards are ``meta`` tensors, under a fake process group (every collective is
issued and returns at once, nothing is computed or allocated).  The kernel
wrappers take their plain versions on ``meta``, so the counters see the
attention and SSD products as the reference's dry-run sees its einsums.  The
fields of ``CellResult`` that XLA's compiled program filled in the reference
hold what this run can count instead (see ``CellResult``).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field, replace

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..configs import get_config, get_shape
from ..convert import tree_leaves, tree_map
from ..data.pipeline import input_axes, input_specs
from ..distributed.sharding import (axis_sizes, rules_override, shardings_for, use_mesh,
                                    watch_local_maps)
from ..models.layers import abstract
from ..models.transformer import (abstract_params, cache_axes, cache_specs, forward_hidden,
                                  param_axes, unembed_weight)
from ..optim.optimizers import make_optimizer
from ..training.train_step import make_serve_step, make_train_step, on_mesh

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: ``_c10d_functional`` op → the reference's collective name
_KINDS = {"all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced":
          "all-gather", "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
          "reduce_scatter_tensor": "reduce-scatter",
          "reduce_scatter_tensor_coalesced": "reduce-scatter",
          "all_to_all_single": "all-to-all", "broadcast": "collective-permute"}


def _batch_override_needed(shape, mesh) -> bool:
    sizes = axis_sizes(mesh)
    bsh = math.prod(sizes[a] for a in ("pod", "data") if a in sizes)
    return shape.global_batch % bsh != 0


@dataclass
class CellResult:
    """One cell's run.  Without XLA:

    * ``lower_s``: wall seconds of the one eager run; ``compile_s``: 0 (no
      compiler);
    * ``flops``: per device, every operator this rank runs counted at its
      local shapes by ``torch.utils.flop_counter``'s formulas (``Recorder``);
      ``flops_global``: the step's work counted once for the whole mesh
      (``GlobalFlops``): a DTensor operator at its global shapes, a
      ``local_map`` body's operators, forward and backward, at this rank's
      shapes times the blocks the body's work is split into.  Replicated
      work counts once in ``flops_global`` and on every rank in ``flops``,
      so ``flops`` × ranks ≥ ``flops_global``.  Attention and SSD count as
      their plain versions compute (the whole S × T score matrix, masked),
      as the reference's dense einsums do;
    * ``hlo_bytes``: 0 (no compiled program to read);
    * ``argument_bytes``: the local shards' bytes of the step's arguments;
      ``output_bytes``: of its outputs;
    * ``peak_bytes_per_device``, ``temp_bytes``: 0 — the local shards are
      ``meta`` and allocate nothing, so no memory tracker sees a byte;
    * ``collective_bytes``: bytes of each collective's result, by kind, as
      this rank issued them (``CollectiveRecorder``, the counterpart of
      ``collective_bytes_from_hlo``); ``n_collectives``: their number."""
    arch: str
    shape: str
    mesh_axes: list
    mesh_shape: list
    kind: str
    lower_s: float = 0.0
    compile_s: float = 0.0
    flops: float = 0.0
    flops_global: float = 0.0
    hlo_bytes: float = 0.0
    peak_bytes_per_device: float = 0.0
    argument_bytes: float = 0.0
    output_bytes: float = 0.0
    temp_bytes: float = 0.0
    collective_bytes: dict = field(default_factory=dict)
    collective_total: float = 0.0
    n_collectives: int = 0
    error: str = ""

    def to_json(self) -> dict:
        return dict(self.__dict__)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class CollectiveRecorder(TorchDispatchMode):
    """Counts the local operators a DTensor program runs: each
    ``_c10d_functional`` collective (its result's bytes, by kind) and the
    FLOPs of every operator ``flop_registry`` has a formula for, over the
    local shapes.  It lets DTensor dispatch first (``NotImplemented`` on a
    DTensor argument), so it sees the ops on the local shards."""

    def __init__(self):
        super().__init__()
        self.bytes = dict.fromkeys(COLLECTIVES, 0)
        self.n = 0
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if func.namespace == "_c10d_functional" and packet.__name__ in _KINDS:
            kind = _KINDS[packet.__name__]
            self.bytes[kind] += sum(_nbytes(t) for t in
                                    (out if isinstance(out, (list, tuple)) else [out]))
            self.n += 1
        elif packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        return out


def _body_nodes(args, out) -> list:
    """The autograd nodes a ``local_map`` body made: those reachable from
    its outputs' ``grad_fn`` before the nodes of its (local) inputs."""
    stop = {a.grad_fn for a in pytree.tree_leaves(args) if isinstance(a, torch.Tensor)}
    todo = [o.grad_fn for o in pytree.tree_leaves(out) if isinstance(o, torch.Tensor)]
    seen: dict = {}
    while todo:
        n = todo.pop()
        if n is None or n in stop or n in seen:
            continue
        seen[n] = None
        todo.extend(nxt for nxt, _ in n.next_functions)
    return list(seen)


class GlobalFlops(TorchDispatchMode):
    """The step's FLOPs counted once for the whole mesh.  A DTensor operator
    counts at its global shapes (this mode sits above DTensor's dispatch, so
    the local operators DTensor issues for it do not reach it).  An operator
    on plain tensors is a ``local_map`` body's (``watch`` marks each body,
    and each autograd node of its backward, with the blocks its work is
    split into: the product of the mesh dims that shard any of its inputs)
    and counts at this rank's shapes times that split; outside a body, once."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self._split = [1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += n if any(issubclass(t, DTensor) for t in types) else \
                n * self._split[-1]
        return out

    def watch(self, body, in_placements, mesh):
        """``body`` run with its split pushed, and every autograd node it
        made pushing it again while the backward runs the node."""
        k = math.prod(mesh.size(i) for i in range(mesh.ndim)
                      if any(pl[i].is_shard() for pl in in_placements))

        def push(*_):
            self._split.append(k)

        def pop(*_):
            self._split.pop()

        def watched(*args):
            push()
            try:
                out = body(*args)
            finally:
                pop()
            for node in _body_nodes(args, out):
                node.register_prehook(push)
                node.register_hook(pop)
            return out

        return watched


def meta_dtensor(t, mesh, placements) -> DTensor:
    """A DTensor of ``t``'s global shape and dtype whose local shard (this
    rank's block) is a ``meta`` tensor."""
    local, _ = compute_local_shape_and_global_offset(tuple(t.shape), mesh, placements)
    return DTensor.from_local(torch.empty(local, dtype=t.dtype, device="meta"), mesh,
                              placements, run_check=False, shape=t.shape, stride=t.stride())


def _place(tree, axes, mesh):
    sh = shardings_for(tree, axes, mesh)
    return tree_map(lambda t, pl: meta_dtensor(t, mesh, pl), tree, sh)


def build_step(arch: str, shape_name: str, mesh, variant: dict | None = None):
    """Returns (fn, args, meta) for the cell: ``fn(*args)`` runs the step on
    DTensors with ``meta`` local shards placed by ``shardings_for``.

    The config takes the port's kernel path (``use_flash``, as the port's
    trainer does): each kernel runs through its DTensor route, as its plain
    version on the ``meta`` shards.  (The dense attention's einsums on a 3-D
    mesh send DTensor's redistribution planner into a graph search of
    minutes an operator.)

    ``variant`` (perf-iteration knobs): dict with optional keys remat /
    attn_chunked / loss_chunk / state_dtype / grad_accum / optimizer and the
    config's other knobs, as the reference's; ``_cfg`` replaces the config
    whole (the tests' smoke configs)."""
    cfg = replace(get_config(arch), use_flash=True)
    shape = get_shape(shape_name)
    variant = variant or {}
    cfg_over = {k: v for k, v in variant.items()
                if k in ("remat", "attn_chunked", "loss_chunk", "state_dtype",
                         "attn_chunk", "n_layers", "scan_unroll", "use_flash",
                         "seq_sharded_acts", "sharded_embed")}
    if cfg_over:
        cfg = replace(cfg, **cfg_over)
    if "_cfg" in variant:                  # the tests' smoke configs
        cfg = variant["_cfg"]

    p_ax = param_axes(cfg)
    params = _place(abstract_params(cfg), p_ax, mesh)
    batch = _place(input_specs(cfg, shape), input_axes(cfg, shape), mesh)

    if shape.kind == "train":
        opt = make_optimizer(variant.get("optimizer", "adamw"), state_dtype=cfg.state_dtype)
        step_fn = make_train_step(cfg, opt, grad_accum=variant.get("grad_accum", 1),
                                  accum_dtype=variant.get("accum_dtype", "float32"))
        state = _place(opt.init(abstract_params(cfg)), opt.state_axes(p_ax), mesh)
        return step_fn, (params, state, batch, 0), dict(cfg=cfg, shape=shape)

    if shape.kind == "prefill":
        @torch.no_grad()
        def prefill_fn(params, inputs):
            with on_mesh(params):
                hidden, _ = forward_hidden(params, cfg, inputs)
                return hidden[:, -1:] @ unembed_weight(params, cfg)
        return prefill_fn, (params, batch["inputs"]), dict(cfg=cfg, shape=shape)

    # decode: one token against a seq_len KV cache
    cache = abstract(cache_specs(cfg, shape.global_batch, shape.seq_len))
    cache = _place(cache, cache_axes(cfg, shape.global_batch, shape.seq_len), mesh)
    return (make_serve_step(cfg), (params, cache, batch["inputs"], 0),
            dict(cfg=cfg, shape=shape))


def _local_bytes(items) -> int:
    """Bytes of the local shards of the tensors in ``items`` (tensors and
    trees of them; anything else counts nothing)."""
    leaves = [t for i in items for t in (tree_leaves(i) if isinstance(i, dict) else [i])]
    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t) for t in leaves
               if isinstance(t, torch.Tensor))


def lower_cell(arch: str, shape_name: str, mesh, variant: dict | None = None):
    """Run one cell once; returns (CellResult, comm_counts | None).  The mesh
    lives on a fake process group, so this needs no device."""
    shape = get_shape(shape_name)
    sizes = axis_sizes(mesh)
    res = CellResult(arch=arch, shape=shape_name, mesh_axes=list(sizes),
                     mesh_shape=list(sizes.values()), kind=shape.kind)
    overrides = {}
    if _batch_override_needed(shape, mesh):
        overrides = dict(batch=(), kv_seq=("pod", "data", "model"))
    try:
        with use_mesh(mesh), rules_override(**overrides):
            fn, args, _ = build_step(arch, shape_name, mesh, variant)
            res.argument_bytes = float(_local_bytes(args))
            rec, flops, comm = CollectiveRecorder(), GlobalFlops(), CommDebugMode()
            t0 = time.time()
            # GlobalFlops innermost, right above the recorder: it counts the
            # DTensor operators (global shapes) and the local_map bodies, the
            # recorder every local operator
            with comm, rec, flops, watch_local_maps(flops.watch):
                out = fn(*args)
            res.lower_s = time.time() - t0
        res.output_bytes = float(_local_bytes(out if isinstance(out, tuple) else (out,)))
        res.flops = float(rec.flops)
        res.flops_global = float(flops.flops)
        res.collective_bytes = dict(rec.bytes)
        res.collective_total = float(sum(rec.bytes.values()))
        res.n_collectives = rec.n
        return res, comm.get_comm_counts()
    except Exception as e:  # noqa: BLE001 — record it; the dry-run goes on to the next cell
        res.error = f"{type(e).__name__}: {e}"
        return res, None
