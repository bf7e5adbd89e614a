"""Forward-graph → full-training-iteration-graph transformation.

This is MONET's central pass (paper §III): starting from a forward
WorkloadGraph it emits

* a **decomposed backward pass** — per-gradient-component primitives
  (input-grad / weight-grad / bias-grad) instead of monolithic ``ConvGrad`` /
  ``GemmGrad`` ops, plus the explicit tensor transpositions and gradient
  accumulation buffers that arise during backpropagation;
* **optimizer update subgraphs** (SGD-momentum / ADAM) per parameter, which
  are purely element-wise and therefore fusion candidates with the
  weight-gradient producers (paper §V-A);
* explicit **activation edges** (fwd tensor → bwd consumer), the set 𝒜 over
  which activation checkpointing optimizes (paper Eq. 6).

The pass mirrors ``jax.grad`` semantics at graph granularity and is
cross-checked against jaxpr-derived FLOP counts in the tests.

The port's own copy of ``repro.core.training_transform`` (numpy and plain Python):
names, signatures and numeric code are the reference's, held bit for
bit against it by ``tests/test_torch_core.py``.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

from .graph import (GraphError, Node, TensorSpec, WorkloadGraph, conv_flops,
                    gemm_flops)

BWD_KINDS = {"bwd", "bwd_data", "bwd_weight", "bwd_bias", "loss_bwd"}

#: optimizer → (#states, [(node-suffix, flops/elem, reads_param)])
OPTIMIZERS = {
    "sgd": (0, [("p", 2, True)]),
    "sgd_momentum": (1, [("v", 3, False), ("p", 2, True)]),
    "adam": (2, [("m", 3, False), ("v", 4, False), ("p", 7, True)]),
    "adamw": (2, [("m", 3, False), ("v", 4, False), ("p", 9, True)]),
}


@dataclass
class TrainingGraph:
    """Result bundle: the full iteration graph plus bookkeeping maps."""

    graph: WorkloadGraph
    param_grads: dict = field(default_factory=dict)   # param tensor -> grad tensor
    activations: list = field(default_factory=list)   # checkpointable set 𝒜
    optimizer: str = "adam"

    def __repr__(self):
        return (f"TrainingGraph({self.graph.name!r}, nodes={len(self.graph)}, "
                f"|A|={len(self.activations)})")


class _Autodiff:
    def __init__(self, g: WorkloadGraph, grad_dtype: str = "bfloat16"):
        self.g = g
        self.grad_dtype = grad_dtype
        self.contrib: dict[str, list[str]] = defaultdict(list)
        self._uid = 0

    # -- helpers ------------------------------------------------------------

    def uid(self) -> int:
        self._uid += 1
        return self._uid

    def gt(self, tensor: str, suffix: str = "") -> str:
        """Create a gradient tensor shaped like ``tensor``."""
        spec = self.g.tensors[tensor]
        name = f"d:{tensor}{suffix}"
        self.g.add_tensor(TensorSpec(name, spec.shape, self.grad_dtype))
        return name

    def new_grad(self, tensor: str) -> str:
        name = self.gt(tensor, f"@{len(self.contrib[tensor])}")
        self.contrib[tensor].append(name)
        return name

    def alias_grad(self, tensor: str, grad: str) -> None:
        self.contrib[tensor].append(grad)

    def node(self, name, op, kind, dims, inputs, outputs, flops, source,
             meta=None):
        self.g.add_node(Node(name, op, kind, dims, list(inputs), list(outputs),
                             int(flops), source, meta or {}))

    def finalize(self, tensor: str) -> str | None:
        """Collapse all gradient contributions of ``tensor`` into one tensor,
        emitting explicit accumulation ``add`` nodes (paper: accumulation
        buffers) when a tensor fans out to several consumers."""
        cs = self.contrib.get(tensor, [])
        if not cs:
            return None
        if len(cs) == 1:
            return cs[0]
        spec = self.g.tensors[tensor]
        acc = cs[0]
        n = spec.size
        for i, c in enumerate(cs[1:]):
            out = (f"d:{tensor}" if i == len(cs) - 2
                   else f"d:{tensor}.acc{i}")
            self.g.add_tensor(TensorSpec(out, spec.shape, self.grad_dtype))
            self.node(f"accum_{tensor}.{i}", "add", "bwd", dict(N=n),
                      [acc, c], [out], n, None)
            acc = out
        return acc

    def transpose_of(self, tensor: str, kind: str) -> str:
        """Explicit transpose node (paper: gradient-specific data
        transformations include tensor transpositions)."""
        spec = self.g.tensors[tensor]
        shape = tuple(reversed(spec.shape))
        out = f"{tensor}.T{self.uid()}"
        self.g.add_tensor(TensorSpec(out, shape, spec.dtype))
        self.node(f"tr_{out}", "transpose", kind, dict(N=spec.size),
                  [tensor], [out], 0, None)
        return out


def _is_differentiable(spec: TensorSpec) -> bool:
    return not spec.is_input and not spec.dtype.startswith(("int", "uint", "bool"))


#: fingerprint-keyed training-transform memo.  The autodiff sweep is a pure
#: function of the forward graph's *content* (structure + tensor role
#: flags) and the transform kwargs, so one master TrainingGraph per key is
#: built and each call returns a deep-copy-on-return bundle (fresh graph
#: copy, fresh maps) — callers rewrite the result freely.  The signature
#: fingerprint does not cover is_param/is_state/is_input, so those are
#: digested into the key explicitly.
_TRAIN_MEMO: dict = {}
_TRAIN_MEMO_CAP = 32


def build_training_graph(fwd: WorkloadGraph, optimizer: str = "adam",
                         include_optimizer: bool = True,
                         state_dtype: str = "float32",
                         grad_dtype: str = "bfloat16") -> TrainingGraph:
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {optimizer!r}; "
                         f"choose from {sorted(OPTIMIZERS)}")
    from .engine import _SIG_GEN, _fingerprint, graph_sigs
    flags = tuple((t, s.is_param, s.is_state, s.is_input)
                  for t, s in fwd.tensors.items())
    key = (_fingerprint(fwd, graph_sigs(fwd)), _SIG_GEN, flags, optimizer,
           include_optimizer, state_dtype, grad_dtype)
    master = _TRAIN_MEMO.get(key)
    if master is not None:
        return TrainingGraph(master.graph.copy(), dict(master.param_grads),
                             list(master.activations), master.optimizer)
    out = _build_training_graph(fwd, optimizer, include_optimizer,
                                state_dtype, grad_dtype)
    if len(_TRAIN_MEMO) >= _TRAIN_MEMO_CAP:
        _TRAIN_MEMO.clear()
    _TRAIN_MEMO[key] = TrainingGraph(out.graph.copy(),
                                     dict(out.param_grads),
                                     list(out.activations), out.optimizer)
    return out


def _build_training_graph(fwd: WorkloadGraph, optimizer: str,
                          include_optimizer: bool, state_dtype: str,
                          grad_dtype: str) -> TrainingGraph:
    g = fwd.copy()
    g.name = f"{fwd.name}.train"
    ad = _Autodiff(g, grad_dtype)
    order = fwd.topo_order()

    loss_nodes = [n for n in order if fwd.nodes[n].kind == "loss"]
    if not loss_nodes:
        raise GraphError("forward graph has no loss node; "
                         "add one with GraphBuilder.loss_xent")

    # ---- backward sweep ----------------------------------------------------
    for name in reversed(order):
        nd = g.nodes[name]
        if nd.kind == "loss":
            _bwd_loss(ad, nd)
            continue
        if nd.kind != "fwd":
            # non-fwd kinds get no adjoints.  In particular kind="kv" nodes
            # (serving KV-cache plumbing — repro.core.serving) are
            # stop-gradient sinks: a cached K/V block is a constant w.r.t.
            # the current step's parameters, so training a graph that
            # sources one differentiates only the fresh compute.
            continue
        d_outs = [ad.finalize(t) for t in nd.outputs]
        if all(d is None for d in d_outs):
            continue  # node does not influence the loss
        _emit_bwd(ad, nd, d_outs)

    # ---- parameter gradients + optimizer -----------------------------------
    param_grads: dict[str, str] = {}
    for p, spec in list(g.tensors.items()):
        if not spec.is_param:
            continue
        dg = ad.finalize(p)
        if dg is None:
            continue
        param_grads[p] = dg
        if include_optimizer:
            _emit_optimizer(ad, p, dg, optimizer, state_dtype)

    g.validate()
    return TrainingGraph(g, param_grads, g.activation_edges(), optimizer)


# ---------------------------------------------------------------------------
# per-op backward rules
# ---------------------------------------------------------------------------


def _bwd_loss(ad: _Autodiff, nd: Node) -> None:
    logits = nd.inputs[0]
    d_logits = ad.new_grad(logits)
    ad.node(f"{nd.name}_bwd", "loss_bwd", "loss_bwd", dict(N=nd.dims["N"]),
            list(nd.inputs), [d_logits], 3 * nd.dims["N"], nd.name)


def _emit_bwd(ad: _Autodiff, nd: Node, d_outs: list) -> None:
    g = ad.g
    d_out = d_outs[0]
    op = nd.op

    if op in ("conv", "conv_dw"):
        x, w = nd.inputs[0], nd.inputs[1]
        d = nd.dims
        xs = g.tensors[x].shape
        if _is_differentiable(g.tensors[x]):
            dx = ad.new_grad(x)
            ddims = dict(B=d["B"], K=d["C"], C=d["K"], OY=xs[2], OX=xs[3],
                         FY=d["FY"], FX=d["FX"])
            ad.node(f"{nd.name}_bwd_data", "conv_bwd_data", "bwd_data", ddims,
                    [d_out, w], [dx], conv_flops(ddims), nd.name)
        dw = ad.new_grad(w)
        ad.node(f"{nd.name}_bwd_weight", "conv_bwd_weight", "bwd_weight",
                dict(d), [d_out, x], [dw], conv_flops(d), nd.name)
        if len(nd.inputs) > 2:  # bias
            b = nd.inputs[2]
            db = ad.new_grad(b)
            n = g.tensors[d_out].size
            ad.node(f"{nd.name}_bwd_bias", "reduce", "bwd_bias", dict(N=n),
                    [d_out], [db], n, nd.name)

    elif op == "gemm":
        x, w = nd.inputs[0], nd.inputs[1]
        d = nd.dims
        if _is_differentiable(g.tensors[x]):
            wT = ad.transpose_of(w, "bwd_data")
            dx = ad.new_grad(x)
            ddims = dict(B=d.get("B", 1), M=d["M"], N=d["K"], K=d["N"])
            ad.node(f"{nd.name}_bwd_data", "gemm_bwd_data", "bwd_data", ddims,
                    [d_out, wT], [dx], gemm_flops(ddims), nd.name)
        xT = ad.transpose_of(x, "bwd_weight")
        dw = ad.new_grad(w)
        wdims = dict(B=d.get("B", 1), M=d["K"], N=d["N"], K=d["M"])
        ad.node(f"{nd.name}_bwd_weight", "gemm_bwd_weight", "bwd_weight", wdims,
                [xT, d_out], [dw], gemm_flops(wdims), nd.name)
        if len(nd.inputs) > 2:
            b = nd.inputs[2]
            db = ad.new_grad(b)
            n = g.tensors[d_out].size
            ad.node(f"{nd.name}_bwd_bias", "reduce", "bwd_bias", dict(N=n),
                    [d_out], [db], n, nd.name)

    elif op in ("attention_qk", "attention_av"):
        a, b = nd.inputs[0], nd.inputs[1]
        d = nd.dims
        bT = ad.transpose_of(b, "bwd_data")
        da = ad.new_grad(a)
        adims = dict(B=d.get("B", 1), M=d["M"], N=d["K"], K=d["N"])
        ad.node(f"{nd.name}_bwd_a", "gemm_bwd_data", "bwd_data", adims,
                [d_out, bT], [da], gemm_flops(adims), nd.name)
        aT = ad.transpose_of(a, "bwd_data")
        db_ = ad.new_grad(b)
        bdims = dict(B=d.get("B", 1), M=d["K"], N=d["N"], K=d["M"])
        ad.node(f"{nd.name}_bwd_b", "gemm_bwd_data", "bwd_data", bdims,
                [aT, d_out], [db_], gemm_flops(bdims), nd.name)

    elif op == "relu":
        x = nd.inputs[0]
        act = nd.outputs[0]          # sign of output suffices (Gist)
        dx = ad.new_grad(x)
        n = nd.dims["N"]
        ad.node(f"{nd.name}_bwd", "relu_bwd", "bwd_data", dict(N=n),
                [d_out, act], [dx], n, nd.name, meta={"stored": "sign"})

    elif op in ("gelu", "silu"):
        x = nd.inputs[0]
        dx = ad.new_grad(x)
        n = nd.dims["N"]
        ad.node(f"{nd.name}_bwd", f"{op}_bwd", "bwd_data", dict(N=n),
                [d_out, x], [dx], 8 * n, nd.name)

    elif op == "add":
        for t in nd.inputs:
            if _is_differentiable(g.tensors[t]):
                ad.alias_grad(t, d_out)

    elif op == "mul":
        ins = nd.inputs
        n = nd.dims["N"]
        if len(ins) == 1:
            dx = ad.new_grad(ins[0])
            ad.node(f"{nd.name}_bwd", "mul", "bwd_data", dict(N=n),
                    [d_out], [dx], n, nd.name)
        else:
            a, b = ins[0], ins[1]
            da = ad.new_grad(a)
            ad.node(f"{nd.name}_bwd_a", "mul", "bwd_data", dict(N=n),
                    [d_out, b], [da], n, nd.name)
            db = ad.new_grad(b)
            ad.node(f"{nd.name}_bwd_b", "mul", "bwd_data", dict(N=n),
                    [d_out, a], [db], n, nd.name)

    elif op == "norm":
        x = nd.inputs[0]
        n = nd.dims["N"]
        dx = ad.new_grad(x)
        ins = [d_out, x] + [t for t in nd.inputs[1:]]
        ad.node(f"{nd.name}_bwd", "norm_bwd", "bwd_data", dict(N=n),
                ins, [dx], 8 * n, nd.name)
        for pt in nd.inputs[1:]:
            if g.tensors[pt].is_param:
                dp = ad.new_grad(pt)
                ad.node(f"{nd.name}_bwd_{pt.rsplit('.', 1)[-1]}", "reduce",
                        "bwd_weight", dict(N=n), [d_out, x], [dp], 2 * n,
                        nd.name)

    elif op == "softmax":
        y = nd.outputs[0]
        x = nd.inputs[0]
        n = nd.dims["N"]
        dx = ad.new_grad(x)
        ad.node(f"{nd.name}_bwd", "softmax_bwd", "bwd_data", dict(N=n),
                [d_out, y], [dx], 4 * n, nd.name)

    elif op == "pool":
        x = nd.inputs[0]
        y = nd.outputs[0]
        n = g.tensors[x].size
        dx = ad.new_grad(x)
        ins = [d_out, y] if nd.meta.get("stored") == "indices" else [d_out]
        ad.node(f"{nd.name}_bwd", "pool_bwd", "bwd_data", dict(N=n),
                ins, [dx], n, nd.name)

    elif op == "reduce":
        x = nd.inputs[0]
        n = g.tensors[x].size
        dx = ad.new_grad(x)
        ad.node(f"{nd.name}_bwd", "elementwise", "bwd_data", dict(N=n),
                [d_out], [dx], n, nd.name)

    elif op in ("transpose", "reshape"):
        x = nd.inputs[0]
        if _is_differentiable(g.tensors[x]):
            n = g.tensors[x].size
            dx = ad.new_grad(x)
            ad.node(f"{nd.name}_bwd", nd.op, "bwd_data", dict(N=n),
                    [d_out], [dx], 0, nd.name)

    elif op == "embed":
        tokens, table = nd.inputs[0], nd.inputs[1]
        n = g.tensors[nd.outputs[0]].size
        dt = ad.new_grad(table)
        ad.node(f"{nd.name}_bwd", "embed_bwd", "bwd_weight", dict(N=n),
                [d_out, tokens], [dt], n, nd.name)

    elif op == "elementwise":
        x = nd.inputs[0]
        n = nd.dims["N"]
        dx = ad.new_grad(x)
        ad.node(f"{nd.name}_bwd", "elementwise", "bwd_data", dict(N=n),
                [d_out, x], [dx], n, nd.name)

    else:
        raise GraphError(f"no backward rule for op {op!r} (node {nd.name})")


# ---------------------------------------------------------------------------
# optimizer emission (element-wise ⇒ fusable with weight-grad producers)
# ---------------------------------------------------------------------------


def _emit_optimizer(ad: _Autodiff, p: str, dg: str, optimizer: str,
                    state_dtype: str) -> None:
    g = ad.g
    spec = g.tensors[p]
    n_states, steps = OPTIMIZERS[optimizer]
    state_names = []
    for i in range(n_states):
        sfx = ["m", "v"][i] if optimizer.startswith("adam") else "v"
        st = f"{sfx}:{p}"
        g.add_tensor(TensorSpec(st, spec.shape, state_dtype, is_state=True))
        state_names.append(st)

    produced_states = []
    for suffix, fpe, reads_param in steps:
        ins = [dg]
        outs = []
        if suffix in ("m", "v") and optimizer.startswith("adam"):
            st = state_names[0 if suffix == "m" else 1]
            ins.append(st)
            new = f"{st}.next"
            g.add_tensor(TensorSpec(new, spec.shape, state_dtype, is_state=True))
            outs = [new]
            produced_states.append(new)
        elif suffix == "v":  # sgd momentum
            st = state_names[0]
            ins.append(st)
            new = f"{st}.next"
            g.add_tensor(TensorSpec(new, spec.shape, state_dtype, is_state=True))
            outs = [new]
            produced_states.append(new)
        else:  # parameter update
            if reads_param:
                ins = ([p] + produced_states) if produced_states else [p, dg]
            new = f"{p}.next"
            g.add_tensor(TensorSpec(new, spec.shape, spec.dtype))
            outs = [new]
        ad.node(f"opt_{suffix}:{p}", "opt", "opt", dict(N=spec.size),
                ins, outs, fpe * spec.size, None, meta={"param": p})
