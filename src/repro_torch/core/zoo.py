"""Paper case-study workload graphs: ResNet-18 (§IV-A) and small GPT-2 (§IV-B).

These are the explicit GraphBuilder versions used by the DSE / fusion /
checkpointing studies, where named activation edges matter.  The *real* JAX
models live in :mod:`repro.models` and are ingested via jaxpr tracing.

The port's own copy of ``repro.core.zoo`` (numpy and plain Python):
names, signatures and numeric code are the reference's, held bit for
bit against it by ``tests/test_torch_search.py``.
"""

from __future__ import annotations

from .builders import GraphBuilder
from .graph import WorkloadGraph

#: arg-keyed master graphs: the zoo builders are pure functions of their
#: arguments, so each configuration is constructed (and validated, and
#: signed) once; every call returns a fresh ``.copy()`` of the master so
#: callers can rewrite/retune freely without poisoning the memo.  The copy
#: inherits the master's signature tables and adjacency, which is what
#: makes repeat construction (dozens of tests/benches build the same GPT-2)
#: a warm-path operation.
_GRAPH_MEMO: dict = {}
_GRAPH_MEMO_CAP = 64


def _memoized(key: tuple, build) -> WorkloadGraph:
    master = _GRAPH_MEMO.get(key)
    if master is None:
        if len(_GRAPH_MEMO) >= _GRAPH_MEMO_CAP:
            _GRAPH_MEMO.clear()
        master = _GRAPH_MEMO[key] = build()
    return master.copy()


def resnet18_graph(batch: int = 1, image: int = 32, num_classes: int = 10,
                   with_loss: bool = True, dtype: str = "bfloat16"
                   ) -> WorkloadGraph:
    """ResNet-18.  ``image=32`` builds the CIFAR-10 stem (3×3/1, no maxpool —
    the paper's §IV-A setting); ``image=224`` builds the ImageNet stem
    (7×7/2 + maxpool — the paper's Fig. 12 setting)."""
    return _memoized(("resnet18", batch, image, num_classes, with_loss,
                      dtype),
                     lambda: _build_resnet18(batch, image, num_classes,
                                             with_loss, dtype))


def _build_resnet18(batch: int, image: int, num_classes: int,
                    with_loss: bool, dtype: str) -> WorkloadGraph:
    b = GraphBuilder(f"resnet18_b{batch}_i{image}", dtype)
    x = b.input("image", (batch, 3, image, image))

    if image <= 64:  # CIFAR stem
        x = b.conv(x, 64, kernel=3, stride=1, name="conv1")
    else:            # ImageNet stem
        x = b.conv(x, 64, kernel=7, stride=2, pad=3, name="conv1")
    x = b.norm(x, name="bn1")
    x = b.relu(x, name="relu1")
    if image > 64:
        x = b.pool(x, kernel=3, stride=2, kind="max", name="maxpool1")

    def basic_block(x, planes, stride, tag):
        identity = x
        out = b.conv(x, planes, 3, stride, name=f"{tag}.conv1")
        out = b.norm(out, name=f"{tag}.bn1")
        out = b.relu(out, name=f"{tag}.relu1")
        out = b.conv(out, planes, 3, 1, name=f"{tag}.conv2")
        out = b.norm(out, name=f"{tag}.bn2")
        in_c = b.shape(x)[1]
        if stride != 1 or in_c != planes:
            identity = b.conv(x, planes, 1, stride, pad=0, name=f"{tag}.down")
            identity = b.norm(identity, name=f"{tag}.down_bn")
        out = b.add(out, identity, name=f"{tag}.add")
        return b.relu(out, name=f"{tag}.relu2")

    planes = [64, 128, 256, 512]
    for stage, p in enumerate(planes):
        for blk in range(2):
            stride = 2 if (stage > 0 and blk == 0) else 1
            x = basic_block(x, p, stride, f"s{stage}b{blk}")

    x = b.global_avg_pool(x, name="gap")
    logits = b.linear(x, num_classes, name="fc")
    if with_loss:
        labels = b.input("labels", (batch,), "int32")
        b.loss_xent(logits, labels)
    return b.g


def gpt2_graph(batch: int = 1, seq: int = 256, d_model: int = 768,
               n_layers: int = 12, n_heads: int = 12, vocab: int = 50257,
               with_loss: bool = True, dtype: str = "bfloat16"
               ) -> WorkloadGraph:
    """Small GPT-2: standard pre-LN transformer with causal attention."""
    return _memoized(("gpt2", batch, seq, d_model, n_layers, n_heads, vocab,
                      with_loss, dtype),
                     lambda: _build_gpt2(batch, seq, d_model, n_layers,
                                         n_heads, vocab, with_loss, dtype))


def _build_gpt2(batch: int, seq: int, d_model: int, n_layers: int,
                n_heads: int, vocab: int, with_loss: bool,
                dtype: str) -> WorkloadGraph:
    b = GraphBuilder(f"gpt2_b{batch}_s{seq}_l{n_layers}", dtype)
    dh = d_model // n_heads
    tokens = b.input("tokens", (batch, seq), "int32")

    x = b.embed(tokens, vocab, d_model, name="wte")
    pos = b.param("wpe", (seq, d_model))
    x = b.add(x, pos, name="pos_add")

    for li in range(n_layers):
        t = f"l{li}"
        h = b.norm(x, kind="layernorm", name=f"{t}.ln1")
        q = b.linear(h, d_model, name=f"{t}.q")
        k = b.linear(h, d_model, name=f"{t}.k")
        v = b.linear(h, d_model, name=f"{t}.v")
        qh = b.reshape(q, (batch, n_heads, seq, dh), name=f"{t}.qh")
        kh = b.reshape(k, (batch, n_heads, seq, dh), name=f"{t}.kh")
        vh = b.reshape(v, (batch, n_heads, seq, dh), name=f"{t}.vh")
        kt = b.transpose(kh, (0, 1, 3, 2), name=f"{t}.kT")
        scores = b.matmul(qh, kt, name=f"{t}.qk", op="attention_qk")
        probs = b.softmax(scores, name=f"{t}.softmax")
        ctx = b.matmul(probs, vh, name=f"{t}.av", op="attention_av")
        ctx = b.reshape(ctx, (batch, seq, d_model), name=f"{t}.merge")
        attn_out = b.linear(ctx, d_model, name=f"{t}.proj")
        x = b.add(x, attn_out, name=f"{t}.res1")

        h = b.norm(x, kind="layernorm", name=f"{t}.ln2")
        h = b.linear(h, 4 * d_model, name=f"{t}.fc1")
        h = b.gelu(h, name=f"{t}.gelu")
        h = b.linear(h, d_model, name=f"{t}.fc2")
        x = b.add(x, h, name=f"{t}.res2")

    x = b.norm(x, kind="layernorm", name="ln_f")
    logits = b.linear(x, vocab, bias=False, name="lm_head")
    if with_loss:
        labels = b.input("labels", (batch, seq), "int32")
        b.loss_xent(logits, labels)
    return b.g


def _tp_split(d_model: int, n_heads: int, tp: int) -> tuple[int, int]:
    """(local heads, local model width) of a ``tp``-way head-sharded
    attention block (Megatron-style: q/k/v columns and proj rows sharded,
    one fwd all-reduce per block)."""
    if tp < 1 or n_heads % tp:
        raise ValueError(f"tensor-parallel degree {tp} must divide "
                         f"n_heads={n_heads}")
    return n_heads // tp, d_model // tp


def gpt2_prefill_graph(batch: int = 1, seq: int = 256, d_model: int = 768,
                       n_layers: int = 12, n_heads: int = 12,
                       vocab: int = 50257, tp: int = 1,
                       commit_kv: bool = True, with_loss: bool = False,
                       dtype: str = "bfloat16") -> WorkloadGraph:
    """Serving prefill: the full-sequence forward pass that fills the KV
    cache.  Per layer the computed K/V blocks are materialized into
    ``kv_cache``-category tensors (``kv_write``) and held resident to the
    end of the step by a terminal ``kv_commit`` barrier — the lifetime
    model then reports the cache bytes a decode step inherits.  ``tp``
    shards heads Megatron-style across chips (the graph is the per-chip
    shard, with one fwd ``all_reduce`` per attention/MLP block).
    ``commit_kv=False`` builds the cache-free variant used as the
    RECOMPUTE-policy decode step.  See docs/serving.md."""
    return _memoized(("gpt2_prefill", batch, seq, d_model, n_layers, n_heads,
                      vocab, tp, commit_kv, with_loss, dtype),
                     lambda: _build_gpt2_serve(batch, seq, 0, d_model,
                                               n_layers, n_heads, vocab, tp,
                                               commit_kv, False, with_loss,
                                               dtype))


def gpt2_decode_graph(batch: int = 8, past: int = 256, d_model: int = 768,
                      n_layers: int = 12, n_heads: int = 12,
                      vocab: int = 50257, tp: int = 1,
                      kv_paged: bool = False,
                      dtype: str = "bfloat16") -> WorkloadGraph:
    """One continuous-batching decode step: ``batch`` concurrent sequences
    each appending one token against a ``past``-token KV cache.  Per layer
    the cache is sourced (``kv_read`` resident / ``kv_load`` host-paged),
    appended in place (``concat``), and attended over in stored layout
    (``matmul(..., transpose_b=True)`` — no cache-sized transpose copy).
    Resident mode commits the updated caches to a terminal barrier so the
    full KV footprint is live at the peak; paged mode (``kv_paged=True``,
    the serving OFFLOAD policy) pages each layer's cache in just-in-time
    and writes only the new block back out, both over the ``dma``
    resource.  See docs/serving.md."""
    return _memoized(("gpt2_decode", batch, past, d_model, n_layers, n_heads,
                      vocab, tp, kv_paged, dtype),
                     lambda: _build_gpt2_serve(batch, 1, past, d_model,
                                               n_layers, n_heads, vocab, tp,
                                               True, kv_paged, False, dtype))


def _build_gpt2_serve(batch: int, seq: int, past: int, d_model: int,
                      n_layers: int, n_heads: int, vocab: int, tp: int,
                      commit_kv: bool, kv_paged: bool, with_loss: bool,
                      dtype: str) -> WorkloadGraph:
    """Shared prefill/decode body: ``past=0`` builds prefill (cache written
    from scratch), ``past>0`` with ``seq=1`` builds one decode step (cache
    sourced and appended)."""
    hl, dl = _tp_split(d_model, n_heads, tp)
    dh = d_model // n_heads
    mode = "decode" if past else "prefill"
    tag = f"gpt2_{mode}_b{batch}_s{past or seq}_l{n_layers}"
    if tp > 1:
        tag += f"_tp{tp}"
    if kv_paged:
        tag += "_paged"
    b = GraphBuilder(tag, dtype)
    tokens = b.input("tokens", (batch, seq), "int32")

    x = b.embed(tokens, vocab, d_model, name="wte")
    pos = b.param("wpe", (seq, d_model))
    x = b.add(x, pos, name="pos_add")

    kv_out: list[str] = []
    for li in range(n_layers):
        t = f"l{li}"
        h = b.norm(x, kind="layernorm", name=f"{t}.ln1")
        q = b.linear(h, dl, name=f"{t}.q")
        k = b.linear(h, dl, name=f"{t}.k")
        v = b.linear(h, dl, name=f"{t}.v")
        qh = b.reshape(q, (batch, hl, seq, dh), name=f"{t}.qh")
        kh = b.reshape(k, (batch, hl, seq, dh), name=f"{t}.kh")
        vh = b.reshape(v, (batch, hl, seq, dh), name=f"{t}.vh")
        if past:                      # decode: source + append the cache
            kc = b.kv_input(f"{t}.k_cache", (batch, hl, past, dh),
                            paged=kv_paged)
            vc = b.kv_input(f"{t}.v_cache", (batch, hl, past, dh),
                            paged=kv_paged)
            ka = b.kv_append(kc, kh, name=f"{t}.ka")
            va = b.kv_append(vc, vh, name=f"{t}.va")
        else:                         # prefill: cache = this pass's K/V
            ka, va = kh, vh
        scores = b.matmul(qh, ka, name=f"{t}.qk", op="attention_qk",
                          transpose_b=True)
        probs = b.softmax(scores, name=f"{t}.softmax")
        ctx = b.matmul(probs, va, name=f"{t}.av", op="attention_av")
        ctx = b.reshape(ctx, (batch, seq, dl), name=f"{t}.merge")
        attn_out = b.linear(ctx, d_model, name=f"{t}.proj")
        if tp > 1:
            attn_out = b.all_reduce(attn_out, tp, name=f"{t}.proj_ar")
        x = b.add(x, attn_out, name=f"{t}.res1")

        h = b.norm(x, kind="layernorm", name=f"{t}.ln2")
        h = b.linear(h, 4 * d_model // tp, name=f"{t}.fc1")
        h = b.gelu(h, name=f"{t}.gelu")
        h = b.linear(h, d_model, name=f"{t}.fc2")
        if tp > 1:
            h = b.all_reduce(h, tp, name=f"{t}.mlp_ar")
        x = b.add(x, h, name=f"{t}.res2")

        if commit_kv:
            if past and kv_paged:     # page only the new block back out
                b.kv_store(kh, name=f"{t}.kst")
                b.kv_store(vh, name=f"{t}.vst")
            elif past:
                kv_out += [ka, va]
            else:                     # prefill: materialize into the pool
                kv_out += [b.kv_write(kh, name=f"{t}.k_cache"),
                           b.kv_write(vh, name=f"{t}.v_cache")]

    x = b.norm(x, kind="layernorm", name="ln_f")
    logits = b.linear(x, vocab, bias=False, name="lm_head")
    if kv_out:
        b.kv_commit(kv_out)
    if with_loss:
        labels = b.input("labels", (batch, seq), "int32")
        b.loss_xent(logits, labels)
    return b.g


def mlp_graph(batch: int = 8, d_in: int = 64, widths=(128, 128),
              n_classes: int = 10, with_loss: bool = True) -> WorkloadGraph:
    """Tiny MLP used by unit tests and the quickstart example."""
    return _memoized(("mlp", batch, d_in, tuple(widths), n_classes,
                      with_loss),
                     lambda: _build_mlp(batch, d_in, widths, n_classes,
                                        with_loss))


def _build_mlp(batch: int, d_in: int, widths, n_classes: int,
               with_loss: bool) -> WorkloadGraph:
    b = GraphBuilder(f"mlp_b{batch}")
    x = b.input("x", (batch, d_in))
    for i, w in enumerate(widths):
        x = b.linear(x, w, name=f"fc{i}")
        x = b.relu(x, name=f"relu{i}")
    logits = b.linear(x, n_classes, name="head")
    if with_loss:
        labels = b.input("labels", (batch,), "int32")
        b.loss_xent(logits, labels)
    return b.g
