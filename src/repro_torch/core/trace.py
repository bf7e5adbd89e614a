"""A PyTorch step → ``WorkloadGraph``: the port's front-end to MONET's IR.

The reference (``repro.core.trace``) traces a jittable function to a jaxpr and
turns each equation into a node.  Here the function runs, on the tensors it
is given (CPU, ``meta`` or CUDA), under a ``TorchDispatchMode`` that records
every aten operator it dispatches, in the order they run: the forward, the
autograd backward, the recompute of selective activation checkpointing and
the optimizer.  On CUDA the step really runs while it is traced.

* **Nodes** take the reference's kinds and FLOP rules: ``gemm`` (``mm``,
  ``bmm``, ``addmm``, ``baddbmm`` and the like; ``matmul`` and ``einsum``
  reach the dispatcher as these) with ``B/M/N/K`` and ``2·B·M·N·K``;
  ``conv`` with ``B/K/C/OY/OX/FY/FX``; ``reduce`` at ``n_in``; ``reshape``
  and ``transpose`` at 0; ``elementwise`` at one FLOP an output element, 8
  for a transcendental.  An aten operator that fuses what JAX writes as
  several primitives (``_softmax``, ``silu``, ``mean``, …) costs what the
  reference's rules give its JAX decomposition (``_COMPOSITE``).  Every node
  is of kind ``fwd``, as in the reference, and ``meta["aten"]`` names the
  operator.
* **Layers are unrolled.**  The port walks the layers in a Python loop where
  the reference scans one body, so ``scan_length`` is always 1: totals agree
  with the reference's scaled scan, node counts do not.
* **Each kernel launch is one node.**  Every kernel wrapper passes through
  ``kernels.build.kernel_call``; while a trace is active the call comes here
  and is recorded as one node, never dropped and never expanded: the aten
  operators inside it (its plain version on the CPU or ``meta``, its output
  allocations on CUDA) are not recorded.  ``meta["kernel"]`` is the entry
  point's name in ``build.LAUNCHES``; the op is ``gemm`` for the flash
  kernels, ``ssd_chunk`` and ``ssd_chunk_bwd`` (dims ``B`` = batch·heads
  (·chunks), ``M``,
  ``N`` the sequence or chunk lengths, ``K`` what the FLOPs leave), ``norm``
  / ``norm_bwd`` for the rmsnorm entry points, ``opt`` for AdamW and
  ``elementwise`` for the causal conv and its backward, kinds that
  ``graph.OP_CLASS`` already holds (class ``gemm``, or ``simd``).  Its
  FLOPs are what ``torch.utils.flop_counter.FlopCounterMode`` reads from the
  plain version on ``meta`` at the same shapes, the dry-run's convention
  (0 for the norm, the conv and AdamW, which hold no matrix product).  So a step's
  graph is the same on the CPU, on ``meta`` and on the card.  On CUDA each
  such node must have launched exactly one kernel: anything else raises.
* **Tensors** are named by what they hold, not by Python identity (autograd
  and checkpointing hand back new tensor objects for saved activations): a
  storage, an offset, a shape, strides and a dtype.  Writes in place give a
  fresh name (static single assignment, as in a jaxpr); a view taken before
  a write and read after it becomes a ``reshape`` node from what the storage
  holds now.  A tensor never produced in the trace and not passed in (a
  constant the function closes over) is an ``is_input`` tensor, as the
  reference's constvars are.
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes

from ..kernels import build
from .graph import Node, TensorSpec, WorkloadGraph

_GEMM = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot", "vdot"}
_CONV = {"convolution", "_convolution", "convolution_backward"}
_TRANSPOSE = {"transpose", "t", "permute"}
#: the reference's ``_MOVE``: views, copies, casts, gathers and scatters,
#: concatenation, padding, fills and ranges; 0 FLOPs.  (Composite operators,
#: ``reshape``, ``contiguous``, ``pad``, ``narrow`` and the like, reach the
#: dispatcher as these.)
_MOVE = {
    "view", "_unsafe_view", "expand", "slice", "select", "squeeze", "unsqueeze",
    "as_strided", "alias", "detach", "lift_fresh_copy", "clone", "copy", "_copy_from",
    "_to_copy", "cat", "stack", "split", "split_with_sizes", "unbind", "flip", "roll",
    "constant_pad_nd", "repeat", "index", "_unsafe_index", "index_select", "gather",
    "embedding", "embedding_dense_backward", "scatter", "scatter_add", "scatter_reduce",
    "index_add", "index_put", "_index_put_impl", "index_copy", "index_fill",
    "masked_scatter", "zeros", "zeros_like", "ones", "ones_like", "empty", "empty_like",
    "empty_strided", "new_zeros", "new_empty", "new_empty_strided", "new_ones", "new_full",
    "full", "full_like", "fill", "zero", "arange", "scalar_tensor", "diagonal", "unfold",
    "select_backward", "slice_backward", "repeat_interleave", "diag_embed", "set",
    "resize",
}
#: the reference's ``_REDUCE``: FLOPs = elements read
_REDUCE = {"sum", "amax", "amin", "prod", "argmax", "argmin", "any", "all", "nansum",
           "count_nonzero"}
#: the reference's transcendentals, 8 FLOPs an element (``pow`` only with a
#: tensor or non-integer exponent: JAX writes ``x ** 2`` as ``integer_pow``)
_TRANSCENDENTAL = {"exp", "log", "tanh", "sigmoid", "erf", "pow"}
#: aten operators that fuse several JAX primitives: FLOPs an input element
#: (``[0]``) and an output element (``[1]``) under the reference's rules
#: applied to the JAX decomposition of the same function
_COMPOSITE = {
    # max, sub, exp, sum, div (and a row's few)
    "_softmax": (12, 0),
    "_log_softmax": (12, 0),
    # the backward halves of JAX's VJPs (the VJP less its forward)
    "_softmax_backward_data": (8, 0),
    "_log_softmax_backward_data": (4, 0),
    # sum, then div
    "mean": (1, 1),
    # x², sum, then sqrt
    "linalg_vector_norm": (2, 1),
    # max, sub, exp, sum, then log, add and a row's few
    "logsumexp": (11, 15),
    # logistic, mul
    "silu": (0, 9),
    "silu_backward": (0, 6),
    # x³, mul, add, mul, tanh, add, mul, mul
    "gelu": (0, 15),
    "gelu_backward": (0, 14),
    "sigmoid_backward": (0, 3),
    "tanh_backward": (0, 4),
    "softplus": (0, 17),
    "addcmul": (0, 2),
    "addcdiv": (0, 2),
    "lerp": (0, 3),
}

_COMPOSITE_REDUCE = {"mean", "linalg_vector_norm", "logsumexp"}

#: operators that hand back their input: ``lift_fresh`` ends ``torch.tensor``
#: on the CPU and CUDA, not on ``meta``, so recording it would make a step's
#: graph depend on the device
_IDENTITY = {torch.ops.aten.lift_fresh.default}

#: a kernel node's op: ``gemm`` (class gemm) for the attention and SSD
#: kernels, the norms', the optimizer's and ``elementwise`` (class simd) for
#: the others
KERNEL_OPS = {"flash_fwd": "gemm", "flash_dq": "gemm", "flash_dkv": "gemm",
              "ssd_chunk": "gemm", "ssd_chunk_bwd": "gemm", "rmsnorm": "norm",
              "rmsnorm_bwd": "norm_bwd", "fused_adam": "opt", "causal_conv": "elementwise",
              "causal_conv_bwd": "elementwise"}


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _to_meta(tree):
    return pytree.tree_map(
        lambda x: torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device="meta")
        if isinstance(x, torch.Tensor) else x, tree)


def _signature(tree) -> tuple:
    return tuple((tuple(x.shape), tuple(x.stride()), x.dtype) if isinstance(x, torch.Tensor)
                 else repr(x) for x in pytree.tree_leaves(tree))


def _gemm_dims(flops: int, candidates) -> dict:
    """The first ``(B, M, N)`` of ``candidates`` whose product divides
    ``flops / 2``, with ``K`` the rest: ``gemm_flops(dims) == flops``."""
    for b, m, n in (*candidates, (1, 1, 1)):
        if b * m * n and flops % (2 * b * m * n) == 0:
            return dict(B=b, M=m, N=n, K=flops // (2 * b * m * n))
    raise AssertionError("unreachable: (1, 1, 1) divides every even count")


class GraphRecorder(TorchDispatchMode):
    """Records the aten operators dispatched under it and the kernel calls
    that reach ``build.kernel_call`` while it is active, into ``self.graph``.
    Use ``recording`` (or ``trace_fn`` / ``trace_model``)."""

    def __init__(self, name: str):
        super().__init__()
        self.graph = WorkloadGraph(name)
        self._ctr = 0
        # (storage, offset, shape, stride, dtype) -> (tensor name, version)
        self._names: dict[tuple, tuple[str, int]] = {}
        # storage -> [version, name of its latest write or view, weak ref];
        # the weak ref keeps the storage's address from being reused
        self._storages: dict[int, list] = {}
        self._suspended = 0
        self._flops_cache: dict[tuple, int] = {}
        #: kernel nodes recorded, by entry point
        self.kernel_nodes: dict[str, int] = dict.fromkeys(build.ENTRY_POINTS, 0)

    # -- names ---------------------------------------------------------------

    def uid(self, p: str) -> str:
        self._ctr += 1
        return f"{p}{self._ctr}"

    @staticmethod
    def _key(t: torch.Tensor) -> tuple[int, tuple]:
        st = t.untyped_storage()
        return st._cdata, (st._cdata, t.storage_offset(), tuple(t.shape), tuple(t.stride()),
                           t.dtype)

    def _new_tensor(self, t: torch.Tensor, hint: str, **roles) -> str:
        name = self.uid(hint + "_")
        self.graph.add_tensor(TensorSpec(name, tuple(int(s) for s in t.shape), _dtype(t),
                                         **roles))
        return name

    def bind(self, t: torch.Tensor, name: str, written: bool = False) -> None:
        """``t`` holds tensor ``name`` from now on; ``written``: it was just
        written in place, so every older view of its storage is stale."""
        sid, key = self._key(t)
        st = self._storages.get(sid)
        if st is None:
            st = self._storages[sid] = [0, name, StorageWeakRef(t.untyped_storage())]
        if written:
            st[0] += 1
        st[1] = name
        self._names[key] = (name, st[0])

    def register(self, t: torch.Tensor, hint: str, **roles) -> str:
        """A tensor passed in: a fresh ``is_param`` / ``is_input`` tensor."""
        name = self._new_tensor(t, hint, **roles)
        self.bind(t, name)
        return name

    def name_of(self, t: torch.Tensor) -> str:
        sid, key = self._key(t)
        hit = self._names.get(key)
        st = self._storages.get(sid)
        if hit is not None and st is not None and hit[1] == st[0]:
            return hit[0]
        if st is None:
            return self.register(t, "const", is_input=True)
        # a view that the trace has not seen since its storage was last
        # written: a view of what the storage holds now
        name = self._new_tensor(t, "view")
        self.graph.add_node(Node(self.uid("view_of_storage."), "reshape", "fwd",
                                 dict(N=t.numel()), [st[1]], [name], 0,
                                 meta={"aten": "view_of_storage", "scan_length": 1}))
        self._names[key] = (name, st[0])
        return name

    def _outputs(self, out, written, hint: str) -> tuple[list[str], list[torch.Tensor]]:
        """Fresh names for the returned tensors and the tensors written in
        place (each once), bound after the call."""
        wrote = {id(t) for t in written}
        seen, names, tensors = set(), [], []
        for t in _tensors(out) + written:
            if id(t) in seen:
                continue
            seen.add(id(t))
            name = self._new_tensor(t, hint)
            self.bind(t, name, written=id(t) in wrote)
            names.append(name)
            tensors.append(t)
        return names, tensors

    # -- aten operators --------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._suspended or func in _IDENTITY:
            return func(*args, **kwargs)
        ins = [self.name_of(t) for t in _tensors((args, kwargs))]
        out = func(*args, **kwargs)
        written = self._written(func, args, kwargs)
        op = func.overloadpacket.__name__
        outs, out_tensors = self._outputs(out, written, op.rstrip("_"))
        if outs:
            self._emit(func, op, args, kwargs, ins, outs, out_tensors)
        return out

    @staticmethod
    def _written(func, args, kwargs) -> list[torch.Tensor]:
        out = []
        schema = func._schema
        for i, a in enumerate(schema.arguments):
            if a.alias_info is None or not a.alias_info.is_write:
                continue
            val = args[i] if i < len(args) else kwargs.get(a.name)
            out += _tensors(val)
        return out

    def _emit(self, func, op, args, kwargs, ins, outs, out_tensors) -> None:
        base = op.rstrip("_")
        if base.startswith("_foreach_"):
            base = base.removeprefix("_foreach_")
        name = f"{op}.{self._ctr}"
        meta = {"aten": str(func), "scan_length": 1}
        n_out = out_tensors[0].numel()
        first = _tensors(args[:1])
        n_in = sum(t.numel() for t in first) if first else n_out
        if base in _GEMM:
            dims = self._gemm(base, args)
            node = Node(name, "gemm", "fwd", dims, ins, outs,
                        2 * dims["B"] * dims["M"] * dims["N"] * dims["K"], meta=meta)
        elif base in _CONV:
            dims, flops = self._conv(base, args, out_tensors)
            node = Node(name, "conv", "fwd", dims, ins, outs, flops, meta=meta)
        elif base in _TRANSPOSE or base in _MOVE:
            node = Node(name, "transpose" if base in _TRANSPOSE else "reshape", "fwd",
                        dict(N=n_out), ins, outs, 0, meta=meta)
        elif base in _REDUCE or (base in ("max", "min", "norm") and len(_tensors(args)) == 1
                                 and n_out < n_in):
            node = Node(name, "reduce", "fwd", dict(N=n_in), ins, outs, n_in, meta=meta)
        elif base in _COMPOSITE:
            a, b = _COMPOSITE[base]
            kind = "reduce" if base in _COMPOSITE_REDUCE else "elementwise"
            node = Node(name, kind, "fwd", dict(N=n_in if kind == "reduce" else n_out), ins,
                        outs, a * n_in + b * n_out, meta={**meta, "prim": base})
        else:
            per = 8 if base in _TRANSCENDENTAL else 1
            if base == "pow" and not isinstance(args[1], torch.Tensor) \
                    and float(args[1]).is_integer():
                per = 1
            n = sum(t.numel() for t in out_tensors) if op.startswith("_foreach_") else n_out
            node = Node(name, "elementwise", "fwd", dict(N=n), ins, outs, per * n,
                        meta={**meta, "prim": base})
        self.graph.add_node(node)

    @staticmethod
    def _gemm(base, args) -> dict:
        if base in ("addmm", "baddbmm", "addbmm", "addmv"):
            a, b = args[1], args[2]
        else:
            a, b = args[0], args[1]
        if base in ("dot", "vdot"):
            return dict(B=1, M=1, N=1, K=a.shape[0])
        if base in ("mv", "addmv"):
            return dict(B=1, M=a.shape[0], N=1, K=a.shape[1])
        if a.dim() == 3:                # bmm, baddbmm, addbmm (a sum over B)
            return dict(B=a.shape[0], M=a.shape[1], N=b.shape[2], K=a.shape[2])
        return dict(B=1, M=a.shape[0], N=b.shape[1], K=a.shape[1])

    @staticmethod
    def _conv(base, args, out_tensors) -> tuple[dict, int]:
        """The reference's conv rule on the forward's shapes: ``C`` is the
        weight's input-feature extent and the product is divided by the
        groups.  ``convolution_backward`` counts it once for each of the
        input and weight gradients it computes."""
        if base == "convolution_backward":
            grad_out, weight = args[0], args[2]
            groups, mask = args[9], args[10]
            out = grad_out
            times = int(mask[0]) + int(mask[1])
        else:
            weight, out = args[1], out_tensors[0]
            groups = args[8] if len(args) > 8 else 1
            times = 1
        K, C = int(weight.shape[0]), int(weight.shape[1])
        filt = [int(s) for s in weight.shape[2:]]
        sp = [int(s) for s in out.shape[2:]]
        dims = dict(B=int(out.shape[0]), K=K, C=C, OY=sp[0] if sp else 1,
                    OX=sp[1] if len(sp) > 1 else 1, FY=filt[0] if filt else 1,
                    FX=filt[1] if len(filt) > 1 else 1)
        flops = 2 * math.prod(dims.values()) // max(int(groups), 1)
        return dims, flops * times

    # -- kernel calls ----------------------------------------------------------

    def kernel(self, name: str, plain, run, args: tuple, written: tuple) -> object:
        """``build.TRACE_HOOK``: run the wrapper's choice ``run`` with this
        recorder suspended and record the call as one node."""
        ins = [self.name_of(t) for t in _tensors(args)]
        tensors = _tensors(args)
        cuda = bool(tensors) and tensors[0].device.type == "cuda"
        before = build.LAUNCHES[name]
        self._suspended += 1
        try:
            out = run(*args)
        finally:
            self._suspended -= 1
        if cuda and build.LAUNCHES[name] != before + 1:
            raise RuntimeError(
                f"trace: the {name} call on CUDA launched {build.LAUNCHES[name] - before} "
                "kernels; a kernel node records exactly one launch")
        flops = self._kernel_flops(name, plain, args)
        wr = [t for i in written for t in _tensors(args[i])]
        outs, out_tensors = self._outputs(out, wr, name)
        op = KERNEL_OPS[name]
        n = sum(t.numel() for t in _tensors(args[:1]))
        if op == "gemm":
            q = tensors[0]
            if name in ("ssd_chunk", "ssd_chunk_bwd"):    # x (Bt, nc, Q, H, hp)
                cand = [(q.shape[0] * q.shape[1] * q.shape[3], q.shape[2], q.shape[2])]
            else:                         # q (B, S, H, hd), k (B, T, Kv, hd)
                cand = [(q.shape[0] * q.shape[2], q.shape[1], tensors[1].shape[1])]
            dims = _gemm_dims(flops, cand)
        else:
            dims = dict(N=n)
        self.graph.add_node(Node(f"{name}.{self.uid('')}", op, "fwd", dims, ins, outs, flops,
                                 meta={"kernel": name, "aten": None, "scan_length": 1}))
        self.kernel_nodes[name] += 1
        return out

    def _kernel_flops(self, name: str, plain, args: tuple) -> int:
        """``plain_flops``, once a signature."""
        key = (name, _signature(args))
        if key not in self._flops_cache:
            self._flops_cache[key] = plain_flops(plain, args)
        return self._flops_cache[key]


def plain_flops(plain, args: tuple) -> int:
    """What ``FlopCounterMode`` reads over ``plain(*args)`` run on ``meta``
    copies of ``args``, outside every active mode (checkpointing's
    included, whose cache it must not touch)."""
    from torch.utils.flop_counter import FlopCounterMode
    with _disable_current_modes(), torch.no_grad():
        counter = FlopCounterMode(display=False)
        with counter:
            plain(*_to_meta(args))
    return int(counter.get_total_flops())


@contextlib.contextmanager
def recording(name: str = "traced", params=None, inputs=None):
    """Record what runs inside the block into ``rec.graph`` (the recorder is
    yielded): the tensor leaves of ``params`` are ``is_param``, those of
    ``inputs`` ``is_input``.  The graph is validated on exit.  One trace at a
    time."""
    if build.TRACE_HOOK is not None:
        raise RuntimeError("a trace is already active")
    rec = GraphRecorder(name)
    for t in _tensors(params):
        rec.register(t, "param", is_param=True)
    for t in _tensors(inputs):
        rec.register(t, "in", is_input=True)
    build.TRACE_HOOK = rec.kernel
    try:
        with rec:
            yield rec
    finally:
        build.TRACE_HOOK = None
    rec.graph.validate()


def trace_fn(fn, *example_args, name: str = "traced", **kwargs) -> WorkloadGraph:
    """Run ``fn(*example_args, **kwargs)`` and return its ``WorkloadGraph``;
    every tensor of ``example_args`` is an ``is_input`` tensor."""
    with recording(name, inputs=example_args) as rec:
        fn(*example_args, **kwargs)
    return rec.graph


def trace_model(apply_fn, params, *data_args, name: str = "model") -> WorkloadGraph:
    """Run ``apply_fn(params, *data_args)``, marking each tensor leaf of the
    ``params`` tree ``is_param`` and those of ``data_args`` ``is_input``."""
    with recording(name, params=params, inputs=data_args) as rec:
        apply_fn(params, *data_args)
    return rec.graph


def flop_count(fn, *args, **kwargs) -> tuple[int, int]:
    """``(counted, hidden)``: what ``FlopCounterMode`` reads over
    ``fn(*args, **kwargs)`` (run it on ``meta`` tensors, where every kernel
    wrapper takes its plain version), and what it does not see of the kernel
    calls that selective checkpointing's recompute serves from its cache.
    Under ``dots`` the recompute takes a plain version's matrix products from
    the cache on ``meta`` and the CPU, while on the card the kernel is
    launched again; a trace counts such a call in full, so its ``gemm``- and
    ``conv``-class FLOPs should read ``counted + hidden``.  ``hidden`` is
    each kernel call's plain FLOPs, counted on its own, less what the
    counter saw inside the call."""
    from torch.utils.flop_counter import FlopCounterMode
    if build.TRACE_HOOK is not None:
        raise RuntimeError("a trace is already active")
    counter = FlopCounterMode(display=False)
    hidden = 0

    def audit(name, plain, run, call_args, written):
        nonlocal hidden
        before = counter.get_total_flops()
        out = run(*call_args)
        hidden += plain_flops(plain, call_args) - (counter.get_total_flops() - before)
        return out

    build.TRACE_HOOK = audit
    try:
        with counter:
            fn(*args, **kwargs)
    finally:
        build.TRACE_HOOK = None
    return int(counter.get_total_flops()), int(hidden)
