"""Forward-graph builder DSL.

Thin layer-level helpers that append operator nodes to a
:class:`~repro.core.graph.WorkloadGraph`.  Used by the paper case-study models
(ResNet-18, small GPT-2) and by tests; real JAX models are instead ingested
through :mod:`repro.core.trace`.

The port's own copy of ``repro.core.builders`` (numpy and plain Python):
names, signatures and numeric code are the reference's, held bit for
bit against it by ``tests/test_torch_search.py``.
"""

from __future__ import annotations

import math

from .graph import Node, WorkloadGraph, conv_flops, dtype_bytes, gemm_flops


class GraphBuilder:
    def __init__(self, name: str = "model", dtype: str = "bfloat16"):
        self.g = WorkloadGraph(name)
        self.dtype = dtype
        self._n = 0

    # -- plumbing -----------------------------------------------------------

    def _uid(self, prefix: str) -> str:
        self._n += 1
        return f"{prefix}{self._n}"

    def _t(self, name: str, shape, dtype=None, **kw) -> str:
        return self.g.tensor(name, tuple(shape), dtype or self.dtype, **kw)

    def shape(self, t: str) -> tuple[int, ...]:
        return self.g.tensors[t].shape

    def input(self, name: str, shape, dtype=None) -> str:
        return self._t(name, shape, dtype, is_input=True)

    def param(self, name: str, shape, dtype=None) -> str:
        return self._t(name, shape, dtype, is_param=True)

    def _node(self, op: str, inputs, outputs, dims=None, flops=0, name=None,
              kind="fwd", meta=None) -> str:
        nm = name or self._uid(op + "_")
        self.g.add_node(Node(nm, op, kind, dims or {}, list(inputs),
                             list(outputs), int(flops), meta=meta or {}))
        return nm

    # -- convolution / linear ------------------------------------------------

    def conv(self, x: str, k: int, kernel: int = 3, stride: int = 1,
             pad: int | None = None, bias: bool = False, name: str | None = None,
             groups: int = 1) -> str:
        B, C, H, W = self.shape(x)
        pad = kernel // 2 if pad is None else pad
        OY = (H + 2 * pad - kernel) // stride + 1
        OX = (W + 2 * pad - kernel) // stride + 1
        nm = name or self._uid("conv")
        w = self.param(f"{nm}.w", (k, C // groups, kernel, kernel))
        out = self._t(f"{nm}.out", (B, k, OY, OX))
        dims = dict(B=B, K=k, C=C // groups, OY=OY, OX=OX, FY=kernel, FX=kernel)
        ins = [x, w]
        if bias:
            ins.append(self.param(f"{nm}.b", (k,)))
        self._node("conv" if groups == 1 else "conv_dw", ins, [out], dims,
                   conv_flops(dims) * (groups if groups == 1 else 1), name=nm,
                   meta=dict(stride=stride, pad=pad, groups=groups))
        return out

    def linear(self, x: str, n: int, bias: bool = True,
               name: str | None = None) -> str:
        shp = self.shape(x)
        k = shp[-1]
        b = int(math.prod(shp[:-1])) or 1
        nm = name or self._uid("fc")
        w = self.param(f"{nm}.w", (k, n))
        out = self._t(f"{nm}.out", (*shp[:-1], n))
        ins = [x, w]
        if bias:
            ins.append(self.param(f"{nm}.b", (n,)))
        dims = dict(B=1, M=b, N=n, K=k)
        self._node("gemm", ins, [out], dims, gemm_flops(dims), name=nm)
        return out

    def matmul(self, a: str, b: str, name: str | None = None,
               op: str = "gemm", transpose_b: bool = False) -> str:
        """Activation × activation batched matmul (attention scores etc.).
        a: (..., M, K)   b: (..., K, N) — or (..., N, K) with
        ``transpose_b=True`` (decode attention reads the K cache in its
        stored layout, no materialized transpose copy)."""
        sa, sb = self.shape(a), self.shape(b)
        if transpose_b:
            assert sa[-1] == sb[-1], (sa, sb)
            n = sb[-2]
        else:
            assert sa[-1] == sb[-2], (sa, sb)
            n = sb[-1]
        batch = int(math.prod(sa[:-2])) or 1
        nm = name or self._uid("mm")
        out = self._t(f"{nm}.out", (*sa[:-2], sa[-2], n))
        dims = dict(B=batch, M=sa[-2], N=n, K=sa[-1])
        self._node(op, [a, b], [out], dims, gemm_flops(dims), name=nm,
                   meta={"transpose_b": True} if transpose_b else None)
        return out

    # -- element-wise / misc --------------------------------------------------

    def _ew(self, op: str, inputs: list[str], out_shape=None, fl_per_elem=1,
            name: str | None = None, meta=None) -> str:
        shp = out_shape or self.shape(inputs[0])
        n = int(math.prod(shp)) or 1
        nm = name or self._uid(op)
        out = self._t(f"{nm}.out", shp)
        self._node(op, inputs, [out], dict(N=n), n * fl_per_elem, name=nm,
                   meta=meta)
        return out

    def relu(self, x, name=None):
        return self._ew("relu", [x], name=name, meta={"stored": "sign"})

    def gelu(self, x, name=None):
        return self._ew("gelu", [x], fl_per_elem=8, name=name)

    def silu(self, x, name=None):
        return self._ew("silu", [x], fl_per_elem=6, name=name)

    def square_relu(self, x, name=None):
        return self._ew("relu", [x], fl_per_elem=2, name=name or self._uid("sqrelu"))

    def add(self, a, b, name=None):
        return self._ew("add", [a, b], name=name)

    def mul(self, a, b, name=None):
        return self._ew("mul", [a, b], name=name)

    def scale(self, x, name=None):
        return self._ew("mul", [x], name=name)

    def norm(self, x, affine: bool = True, kind: str = "batchnorm",
             name: str | None = None) -> str:
        shp = self.shape(x)
        nm = name or self._uid(kind)
        ins = [x]
        if affine:
            c = shp[1] if kind == "batchnorm" else shp[-1]
            ins.append(self.param(f"{nm}.scale", (c,)))
            if kind != "rmsnorm":
                ins.append(self.param(f"{nm}.bias", (c,)))
        n = int(math.prod(shp))
        out = self._t(f"{nm}.out", shp)
        self._node("norm", ins, [out], dict(N=n), 4 * n, name=nm,
                   meta={"kind": kind})
        return out

    def softmax(self, x, name=None):
        return self._ew("softmax", [x], fl_per_elem=5, name=name)

    def pool(self, x, kernel=2, stride=None, kind="max", name=None):
        B, C, H, W = self.shape(x)
        stride = stride or kernel
        OY, OX = H // stride, W // stride
        nm = name or self._uid(f"{kind}pool")
        out = self._t(f"{nm}.out", (B, C, OY, OX))
        n = B * C * OY * OX
        self._node("pool", [x], [out], dict(N=n), n * kernel * kernel, name=nm,
                   meta={"kind": kind, "stored": "indices" if kind == "max" else None})
        return out

    def global_avg_pool(self, x, name=None):
        B, C, H, W = self.shape(x)
        nm = name or self._uid("gap")
        out = self._t(f"{nm}.out", (B, C))
        self._node("reduce", [x], [out], dict(N=B * C * H * W), B * C * H * W,
                   name=nm)
        return out

    def transpose(self, x, perm, name=None):
        shp = self.shape(x)
        out_shape = tuple(shp[p] for p in perm)
        nm = name or self._uid("tr")
        out = self._t(f"{nm}.out", out_shape)
        n = int(math.prod(shp))
        self._node("transpose", [x], [out], dict(N=n), 0, name=nm,
                   meta={"perm": tuple(perm)})
        return out

    def reshape(self, x, shape, name=None):
        nm = name or self._uid("rs")
        out = self._t(f"{nm}.out", shape)
        self._node("reshape", [x], [out], dict(N=int(math.prod(shape))), 0,
                   name=nm)
        return out

    def embed(self, tokens: str, vocab: int, d: int, name=None) -> str:
        shp = self.shape(tokens)
        nm = name or self._uid("embed")
        tbl = self.param(f"{nm}.table", (vocab, d))
        out = self._t(f"{nm}.out", (*shp, d))
        n = int(math.prod(shp)) * d
        self._node("embed", [tokens, tbl], [out], dict(N=n), 0, name=nm)
        return out

    def loss_xent(self, logits: str, labels: str, name="loss") -> str:
        shp = self.shape(logits)
        n = int(math.prod(shp))
        out = self._t(f"{name}.out", (1,), "float32")
        self.g.add_node(Node(name, "loss", "loss", dict(N=n), [logits, labels],
                             [out], 6 * n))
        return out

    # -- collectives (tensor-parallel serving shards) -------------------------

    def all_reduce(self, x: str, p: int, name: str | None = None) -> str:
        """Sum-reduce ``x`` across a ``p``-chip group (op-class ``comm``,
        costed on the ``ici`` resource).  Same dims convention as the
        parallel-training rewrite (``parallel._comm_node``): ``N`` payload
        elements × ``E`` bytes × ``P`` group degree.  Kind ``fwd`` so the
        reduced tensor classifies as an activation, matching the
        tensor-parallel forward idiom."""
        shp = self.shape(x)
        n = int(math.prod(shp)) or 1
        nm = name or self._uid("ar")
        out = self._t(f"{nm}.out", shp)
        self._node("all_reduce", [x], [out],
                   dict(N=n, P=int(p), E=dtype_bytes(self.dtype)), 0,
                   name=nm)
        return out

    # -- KV cache (inference serving — repro.core.serving) --------------------
    #
    # All KV ops carry kind="kv", which classifies their outputs into the
    # kv_cache memory category (memory.category_code) and keeps them out of
    # the checkpointable-activation set; training_transform treats them as
    # stop-gradient sinks.  See docs/serving.md.

    def kv_input(self, name: str, shape, paged: bool = False,
                 dtype=None) -> str:
        """Source node materializing one layer's cached K or V block.
        Resident mode (``kv_read``, op-class ``move``) reads it from on-chip
        HBM; paged mode (``kv_load``, op-class ``dma``) streams it in from
        the host KV pool over the dedicated ``dma`` resource with a
        just-in-time residency window (``memory._FETCH_OPS``)."""
        out = self._t(name, shape, dtype)
        n = int(math.prod(shape)) or 1
        self._node("kv_load" if paged else "kv_read", [], [out],
                   dict(N=n, E=dtype_bytes(dtype or self.dtype)), 0,
                   name=f"{name}.rd", kind="kv")
        return out

    def kv_append(self, cache: str, new: str, axis: int = 2,
                  name: str | None = None) -> str:
        """In-place append of the current step's K/V block to the cache
        along ``axis``.  ``N`` counts only the *written* elements (the new
        block) — the append is an in-place page write, not a cache copy —
        while the output tensor carries the full post-append bytes for the
        lifetime model."""
        sc, sn = self.shape(cache), self.shape(new)
        out_shape = tuple(d + sn[axis] if i == axis else d
                          for i, d in enumerate(sc))
        nm = name or self._uid("kvcat")
        out = self._t(f"{nm}.out", out_shape)
        n = int(math.prod(sn)) or 1
        self._node("concat", [cache, new], [out], dict(N=n), 0, name=nm,
                   kind="kv", meta={"axis": axis})
        return out

    def kv_write(self, x: str, name: str | None = None) -> str:
        """Materialize a computed K/V block into the resident cache pool
        (prefill): a ``move``-class copy whose output classifies as
        ``kv_cache`` instead of ``activations``."""
        shp = self.shape(x)
        nm = name or self._uid("kvw")
        out = self._t(nm if name else f"{nm}.out", shp)
        n = int(math.prod(shp)) or 1
        self._node("kv_write", [x], [out], dict(N=n), 0, name=f"{nm}.wr",
                   kind="kv")
        return out

    def kv_commit(self, caches, name: str = "kv_out") -> str:
        """Terminal cache-commit barrier: consumes every per-layer cache
        tensor so resident (KEEP) caches stay live to the end of the step —
        the lifetime model then charges the full KV footprint at the peak.
        Emits a 1-byte completion token."""
        out = self._t(f"{name}.tok", (1,), "int8")
        self._node("kv_commit", list(caches), [out], dict(N=1), 0, name=name,
                   kind="kv")
        return out

    def kv_store(self, cache: str, elems: int | None = None,
                 name: str | None = None) -> str:
        """Page the (updated) cache out to the host KV pool over the ``dma``
        resource.  ``elems`` bounds the transferred payload — a paged decode
        step only writes the newly appended block, not the whole cache —
        and the 1-byte marker it leaves behind is the only thing that stays
        on-chip."""
        spec = self.g.tensors[cache]
        nm = name or f"{cache}.st"
        out = self._t(f"{nm}.off", (1,), "int8")
        n = int(elems if elems is not None else spec.size) or 1
        self._node("kv_store", [cache], [out],
                   dict(N=n, E=dtype_bytes(spec.dtype)), 0, name=nm,
                   kind="kv")
        return out
