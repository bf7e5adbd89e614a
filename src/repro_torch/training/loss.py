"""LM loss: cross-entropy with optional **chunked fused unembedding** — the
(B,S,V) logits tensor is never materialised; the final projection and the
softmax cross-entropy run per sequence chunk, and each chunk's logits are
recomputed in the backward pass instead of being kept.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..core import spans
from ..distributed.sharding import block_index, local_map, shard, take_in_block
from ..models.transformer import forward_hidden, unembed_weight

Z_LOSS = 1e-4
AUX_LOSS = 1e-2


def _xent_from_logits(logits, labels):
    """logits: (..., V); labels: (...) integer.  Returns (nll, z) with a
    stable fp32 logsumexp; no gradient flows through the max."""
    logits = logits.float()
    m = logits.max(dim=-1, keepdim=True).values.detach()
    lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]
    return lse - _label_logit(logits, labels), torch.square(lse)


def _label_logit(logits, labels):
    """``logits[..., label]``.  With the vocab dim of a DTensor sharded, each
    shard gathers from its own slice through ``local_map`` (clipped, then
    masked to zero) and the result is ``Partial`` over the vocab's mesh dims:
    DTensor's own gather over a sharded dim fails here (torch 2.13)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    nd = logits.dim()
    vdims = ([i for i, p in enumerate(logits.placements) if p.is_shard(nd - 1)]
             if isinstance(logits, DTensor) else [])
    if not vdims:
        return torch.gather(logits, -1, labels[..., None].long())[..., 0]
    mesh = logits.device_mesh
    lab_pl = tuple(Replicate() if i in vdims else p for i, p in enumerate(logits.placements))
    out_pl = tuple(Partial() if i in vdims else p for i, p in enumerate(logits.placements))

    def body(lg, lab):
        v_loc = lg.shape[-1]
        off = block_index(mesh, logits.placements, nd - 1) * v_loc
        return take_in_block(lab, off, v_loc,
                             lambda i: torch.gather(lg, -1, i[..., None])[..., 0])

    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return local_map(body, (out_pl,), (logits.placements, lab_pl), mesh)(logits, labels)


def lm_loss(params, cfg, inputs, labels, loss_chunk: int | None = None):
    """Returns (loss, metrics).  labels: (B,S) integer, -1 = masked."""
    hidden, aux = forward_hidden(params, cfg, inputs)
    w = unembed_weight(params, cfg)
    B, S, D = hidden.shape
    mask = (labels >= 0).float()
    safe_labels = labels.clamp_min(0)

    chunk = loss_chunk if loss_chunk is not None else cfg.loss_chunk
    if chunk == 0:  # auto: chunk when the logits tensor would be > 2^28 elems
        chunk = S // 8 if S * cfg.vocab > (1 << 28) and S % 8 == 0 else 0

    with spans.span("loss.head", hidden) as sp:
        if chunk and S % chunk == 0 and S > chunk:
            def chunk_nll(h, lab, msk):
                logits = shard(h @ w, "batch", "seq", "vocab")   # (B, chunk, V) transient
                nll, z = _xent_from_logits(logits, lab)
                return torch.sum(nll * msk), torch.sum(z * msk)

            nll_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
            z_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
            for c in range(S // chunk):
                sl = slice(c * chunk, (c + 1) * chunk)
                args = (hidden[:, sl], safe_labels[:, sl], mask[:, sl])
                if torch.is_grad_enabled():
                    dn, dz = checkpoint(chunk_nll, *args, use_reentrant=False,
                                        preserve_rng_state=False)
                else:
                    dn, dz = chunk_nll(*args)
                nll_sum = nll_sum + dn
                z_sum = z_sum + dz
        else:
            logits = shard(hidden @ w, "batch", "seq", "vocab")
            nll, z = _xent_from_logits(logits, safe_labels)
            nll_sum = torch.sum(nll * mask)
            z_sum = torch.sum(z * mask)
        spans.grads(sp, nll_sum, z_sum)

    denom = mask.sum().clamp_min(1.0)
    nll_mean = nll_sum / denom
    loss = nll_mean + Z_LOSS * z_sum / denom + AUX_LOSS * aux
    metrics = {"loss": loss, "nll": nll_mean, "aux_loss": aux, "tokens": denom}
    return loss, metrics
