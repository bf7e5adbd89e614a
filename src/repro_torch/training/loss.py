"""LM loss: cross-entropy with optional **chunked fused unembedding** — the
(B,S,V) logits tensor is never materialised; the final projection and the
softmax cross-entropy run per sequence chunk, and each chunk's logits are
recomputed in the backward pass instead of being kept.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..models.transformer import forward_hidden, unembed_weight

Z_LOSS = 1e-4
AUX_LOSS = 1e-2


def _xent_from_logits(logits, labels):
    """logits: (..., V); labels: (...) integer.  Returns (nll, z) with a
    stable fp32 logsumexp; no gradient flows through the max."""
    logits = logits.float()
    m = logits.max(dim=-1, keepdim=True).values.detach()
    lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]
    label_logit = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return lse - label_logit, torch.square(lse)


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

    if chunk and S % chunk == 0 and S > chunk:
        def chunk_nll(h, lab, msk):
            nll, z = _xent_from_logits(h @ w, lab)       # (B, chunk, V) transient
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
        nll, z = _xent_from_logits(hidden @ w, safe_labels)
        nll_sum = torch.sum(nll * mask)
        z_sum = torch.sum(z * mask)

    denom = mask.sum().clamp_min(1.0)
    nll_mean = nll_sum / denom
    loss = nll_mean + Z_LOSS * z_sum / denom + AUX_LOSS * aux
    metrics = {"loss": loss, "nll": nll_mean, "aux_loss": aux, "tokens": denom}
    return loss, metrics
