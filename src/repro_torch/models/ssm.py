"""Mamba-2 mixer via SSD (state-space duality, arXiv:2405.21060).

Training / prefill runs the chunked SSD algorithm: quadratic, attention-like
work *within* chunks and a linear state recurrence *across* chunks (a Python
loop over the chunks, in fp32).  Cumulative and decay terms are fp32.

With ``cfg.use_flash`` the causal convs of x and B/C and their silu are the
hand-written kernel (``kernels.ops.causal_conv_silu``), the within-chunk part
is another (``kernels.ops.ssd_chunk_heads``) and the gated norm is
``kernels.ops.rmsnorm``; without it they are the plain conv in fp32, the
reference's einsums and ``layers.rmsnorm``.  In both, the decay exponent is
masked before ``exp`` (``exp(where(i >= j, cum_i − cum_j, −inf))``): the
reference exponentiates first and masks after, which overflows for i < j once
a chunk decays by more than ~88 and makes its gradients NaN at chunk 128 and
up.  The forward values are the same.

Decode is the O(1) recurrent step (``ssd_decode_step``): an fp32 ring of the
last ``conv_width − 1`` inputs of the causal convolution and the fp32 SSM
state are the cache, both updated in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..core import spans
from ..core.remat_policy import checkpoint_name
from ..distributed.sharding import local_map, shard, unflatten
from ..kernels import ops
from ..kernels.causal_conv import conv_local
from .layers import PSpec, norm


def ssm_specs(cfg) -> dict:
    s = cfg.ssm
    d, di = cfg.d_model, cfg.d_inner
    nh = cfg.ssm_heads
    gn = 2 * s.n_groups * s.d_state
    return {
        "wz": PSpec((d, di), ("embed", "ffn")),
        "wx": PSpec((d, di), ("embed", "ffn")),
        "wbc": PSpec((d, gn), ("embed", None)),
        "wdt": PSpec((d, nh), ("embed", "ffn")),
        "conv_x": PSpec((s.conv_width, di), (None, "ffn"), "float32"),
        "conv_bc": PSpec((s.conv_width, gn), (None, None), "float32"),
        "A_log": PSpec((nh,), ("ffn",), "float32", "zeros"),
        "dt_bias": PSpec((nh,), ("ffn",), "float32", "zeros"),
        "D": PSpec((nh,), ("ffn",), "float32", "ones"),
        "norm": PSpec((di,), ("ffn",), "float32", "zeros"),
        "wo": PSpec((di, d), ("ffn", "embed")),
    }


def _causal_conv(u, w):
    """Depthwise causal conv along axis 1.  u: (B,S,C); w: (cw,C).  On a
    DTensor, a ``local_map`` body over each rank's batch rows and channels
    with the whole sequence: the conv never crosses either (and DTensor's
    own pad and slice backward in torch 2.11 returned gradients of the wrong
    length and placements)."""
    if not isinstance(u, DTensor):
        return conv_local(u, w)
    u_pl, w_pl = ops.causal_conv_placements(u)
    return local_map(conv_local, (u_pl,), (u_pl, w_pl), u.device_mesh)(u, w)


def _intra_einsum(xc, dtc, Bc, Cc, cum):
    """The reference's within-chunk einsums, exponent masked first.  Returns
    (y_intra (B,nc,Q,nh,hp) in xc's dtype, states (B,nc,nh,hp,N) fp32)."""
    Q = xc.shape[2]
    total = cum[:, :, -1]
    dtx = xc * dtc[..., None].to(xc.dtype)                        # (B,nc,Q,nh,hp)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=xc.device).tril()
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]           # (B,nc,Q,Q,nh)
    decay = torch.exp(torch.where(mask[None, None, ..., None], seg, float("-inf")))
    cb = torch.einsum("bcihn,bcjhn->bcijh", Cc, Bc).float()
    att = cb * decay
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", att.to(xc.dtype), dtx)
    sdecay = torch.exp(total[:, :, None] - cum)                   # (B,nc,Q,nh)
    states = torch.einsum("bcjhn,bcjhp->bchpn",
                          (Bc.float() * sdecay[..., None]).to(xc.dtype), dtx)
    return y_intra, states.float()


def ssd_apply(p: dict, x, cfg):
    """Full-sequence SSD.  x: (B,S,D) → (B,S,D)."""
    s = cfg.ssm
    B_, S, _ = x.shape
    di, nh, hp, N, G = (cfg.d_inner, cfg.ssm_heads, s.headdim, s.d_state,
                        s.n_groups)
    Q = min(s.chunk, S)
    if S % Q:
        raise ValueError(f"sequence length {S} is not a multiple of the chunk {Q}")
    nc = S // Q

    with spans.span("ssm.proj_in", x) as sp:
        z = x @ p["wz"]
        xin = x @ p["wx"]
        bc = x @ p["wbc"]
        spans.grads(sp, z, xin, bc)
    with spans.span("ssm.conv", xin) as sp:
        if cfg.use_flash:
            xin = ops.causal_conv_silu(xin, p["conv_x"])
            bc = ops.causal_conv_silu(bc, p["conv_bc"])
        else:
            xin = F.silu(_causal_conv(xin.float(), p["conv_x"])).to(x.dtype)
            bc = F.silu(_causal_conv(bc.float(), p["conv_bc"])).to(x.dtype)
        xin = shard(xin, "batch", "seq", "ffn")
        Bm, Cm = unflatten(bc, -1, (2 * G, N)).split(G, dim=2)    # (B,S,G,N)
        spans.grads(sp, xin, Bm, Cm)
    with spans.span("ssm.proj_in", x) as sp:       # the fourth projection, where the code makes it
        dt = F.softplus((x @ p["wdt"]).float() + p["dt_bias"])    # (B,S,nh)
        spans.grads(sp, dt)
    with spans.span("ssm.chunk", xin) as sp:
        A = -torch.exp(p["A_log"])                                # (nh,)

        xh = unflatten(xin, -1, (nh, hp))

        def ch(t):
            return t.reshape(B_, nc, Q, *t.shape[2:])

        xc, dtc = ch(xh), ch(dt)
        if cfg.use_flash:
            # the kernel takes B/C per group, x and dt in place (views, no copy)
            y_intra, st, cum = ops.ssd_chunk_heads(xc, dtc, ch(Bm), ch(Cm), A)
            states = st.transpose(-1, -2)                         # (B,nc,nh,hp,N)
            Cc = ch(Cm).repeat_interleave(nh // G, dim=3)
        else:
            rep = nh // G
            Bc, Cc = (ch(t.repeat_interleave(rep, dim=2)) for t in (Bm, Cm))
            cum = torch.cumsum(dtc * A, dim=2)                    # (B,nc,Q,nh)
            y_intra, states = _intra_einsum(xc, dtc, Bc, Cc, cum)
        spans.grads(sp, y_intra, states, cum, Cc, xh)

    with spans.span("ssm.scan", y_intra) as sp:
        total = cum[:, :, -1]                                     # (B,nc,nh)
        # inter-chunk recurrence: the state entering chunk c, in fp32
        st_c = torch.zeros((B_, nh, hp, N), dtype=torch.float32, device=x.device)
        prev = []
        for c in range(nc):
            prev.append(st_c)
            st_c = st_c * torch.exp(total[:, c])[:, :, None, None] + states[:, c]
        prev_states = torch.stack(prev, dim=1)                    # (B,nc,nh,hp,N)

        y_inter = torch.einsum("bcihn,bchpn->bcihp",
                               (Cc.float() * torch.exp(cum)[..., None]).to(xc.dtype),
                               prev_states.to(xc.dtype))
        y = (y_intra + y_inter).reshape(B_, S, nh, hp)
        y = y + xh * p["D"][..., None].to(xh.dtype)
        y = checkpoint_name(y.reshape(B_, S, di), "ssm_state")
        spans.grads(sp, y)

    with spans.span("ssm.gate", y) as sp:
        y = norm(y * F.silu(z.float()).to(y.dtype), p["norm"], cfg)
        spans.grads(sp, y)
    with spans.span("ssm.proj_out", y) as sp:
        out = shard(y @ p["wo"], "batch", "seq", "embed_act")
        spans.grads(sp, out)
    return out


def _recur_local(state, dt, xh, Bh, Ch, A, D):
    """One step of the SSM recurrence, per batch row and head: the state
    (B,nh,hp,N) updated in place; returns y (B,nh,hp) fp32."""
    decay = torch.exp(dt * A)                                     # (B,nh)
    state.copy_(state * decay[..., None, None]
                + torch.einsum("bh,bhp,bhn->bhpn", dt, xh, Bh))
    y = torch.einsum("bhn,bhpn->bhp", Ch, state)
    return y + xh * D[:, None]


def _recurrence(state, dt, xh, Bh, Ch, A, D):
    """``_recur_local``; on a DTensor state, on each rank's block of batch
    rows and heads (``local_map``: the recurrence never crosses either, and
    DTensor's planner takes minutes over these einsums on a 3-D mesh)."""
    if not isinstance(state, DTensor):
        return _recur_local(state, dt, xh, Bh, Ch, A, D)
    mesh = state.device_mesh
    st = tuple(state.placements)
    heads = tuple(Shard(0) if pl.is_shard(1) else Replicate() for pl in st)
    row = tuple(pl if pl.is_shard(0) or pl.is_shard(1) else Replicate() for pl in st)
    return local_map(_recur_local, (row,), (st, row, row, row, row, heads, heads),
                     mesh)(state, dt, xh, Bh, Ch, A, D)


def ssd_decode_step(p: dict, x, conv_cache, state, cfg):
    """One-token recurrent step.  x: (B,1,D); conv_cache: (B,cw-1,di+2GN)
    fp32 and state: (B,nh,hp,N) fp32, both written in place.  Returns
    (y, conv_cache, state)."""
    s = cfg.ssm
    B_ = x.shape[0]
    di, nh, hp, N, G = (cfg.d_inner, cfg.ssm_heads, s.headdim, s.d_state,
                        s.n_groups)
    z = x @ p["wz"]                                               # (B,1,di)
    u = torch.cat([x @ p["wx"], x @ p["wbc"]], dim=-1).float()    # (B,1,ch)
    win = torch.cat([conv_cache, u], dim=1)                       # (B,cw,ch)
    w = torch.cat([p["conv_x"], p["conv_bc"]], dim=1)             # (cw,ch)
    conv_out = F.silu(torch.einsum("bcf,cf->bf", win, w))
    conv_cache.copy_(win[:, 1:])

    xin_c, bc_c = conv_out[:, :di], conv_out[:, di:]
    Bm, Cm = unflatten(bc_c, -1, (2 * G, N)).split(G, dim=1)      # (B,G,N)
    rep = nh // G
    Bh = Bm.repeat_interleave(rep, dim=1)                         # (B,nh,N)
    Ch = Cm.repeat_interleave(rep, dim=1)
    dt = F.softplus((x[:, 0] @ p["wdt"]).float() + p["dt_bias"])  # (B,nh)
    A = -torch.exp(p["A_log"])
    xh = unflatten(xin_c, -1, (nh, hp)).float()

    y = _recurrence(state, dt, xh, Bh.float(), Ch.float(), A, p["D"])
    y = y.reshape(B_, 1, di).to(x.dtype)
    y = norm(y * F.silu(z.float()).to(y.dtype), p["norm"], cfg)
    return y @ p["wo"], conv_cache, state
