"""Mamba2 block (zamba2) — chunked SSD (state-space duality) algorithm.

Recurrence per head h (state N x P):   H_t = a_t H_{t-1} + B_t (dt_t x_t)^T
readout:                               y_t = C_t^T H_t + D x_t

The chunked algorithm splits the sequence into chunks of `ssd_chunk`:
  * intra-chunk: a masked quadratic (attention-like) term using in-chunk
    decay products exp(cum_i - cum_j);
  * inter-chunk: per-chunk boundary states carried by a loop over chunks
    (the only sequential dependency — O(S/chunk) steps).

B/C are group-shared (n_groups=1).  Decode keeps (conv tail, H state) —
O(1) in context length, which is why zamba2 runs the long_500k shape.

Simplifications vs the reference CUDA kernels of Mamba2: depthwise conv
applied to x only (not B/C), n_groups=1.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..errors import ConfigError
from .layers import normal, rms_norm


def depthwise_conv(x, w, conv_state=None):
    """x (B, S, D), w (K, D) causal depthwise conv.
    Returns (y, new_state) where state is the trailing K-1 inputs."""
    K = w.shape[0]
    if conv_state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(K))
    new_state = xp[:, -(K - 1):] if K > 1 else None
    return y, new_state


def ssd_chunked(xin, la, Bm, Cm, *, chunk: int = 128, h0=None):
    """xin (B,S,H,P) = dt*x; la (B,S,H) = log decay; Bm/Cm (B,S,N).
    Returns (y (B,S,H,P), h_last (B,H,N,P))."""
    B, S, H, P = xin.shape
    N = Bm.shape[-1]
    c = min(chunk, S)
    if S % c:
        raise ConfigError(f"ssd_chunked needs S % chunk == 0, got S={S} "
                          f"chunk={c}")
    nc = S // c
    xin_ = xin.reshape(B, nc, c, H, P).float()
    la_ = la.reshape(B, nc, c, H).float()
    Bm_ = Bm.reshape(B, nc, c, N).float()
    Cm_ = Cm.reshape(B, nc, c, N).float()
    cum = torch.cumsum(la_, dim=2)                      # (B,nc,c,H)

    # ---- intra-chunk (quadratic within chunk)
    att = torch.einsum("bgin,bgjn->bgij", Cm_, Bm_)     # (B,nc,c,c)
    # contribution of input j to output i >= j decays by prod_{t=j+1..i} a_t
    # = exp(cum_i - cum_j);  i == j contributes undecayed (exp(0)).
    dec = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=xin.device))
    dec = dec.masked_fill(~mask[None, None, :, :, None], -torch.inf)
    w = torch.exp(dec)                                  # (B,nc,c,c,H)
    y_intra = torch.einsum("bgijh,bgjhp->bgihp", att[..., None] * w, xin_)

    # ---- chunk boundary states
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)   # (B,nc,c,H)
    S_chunk = torch.einsum("bgjn,bgjhp->bghnp", Bm_,
                           decay_to_end[..., None] * xin_)

    # ---- inter-chunk loop
    chunk_decay = torch.exp(cum[:, :, -1, :])           # (B,nc,H)
    h = (torch.zeros((B, H, N, P), device=xin.device) if h0 is None
         else h0)
    h_prevs = []
    for g in range(nc):
        h_prevs.append(h)                               # state BEFORE chunk
        h = h * chunk_decay[:, g, :, None, None] + S_chunk[:, g]
    h_prevs = torch.stack(h_prevs, dim=1)               # (B,nc,H,N,P)
    y_inter = (torch.einsum("bgin,bghnp->bgihp", Cm_, h_prevs)
               * torch.exp(cum)[..., None])
    y = (y_intra + y_inter).reshape(B, S, H, P)
    return y.to(xin.dtype), h


def mamba_block(p, x, cfg, shd, state=None):
    """x (B, S, d) -> (B, S, d).  state: None (train/prefill from scratch)
    or {'conv': (B,K-1,di), 'ssd': (B,H,N,P)} for decode."""
    B, S, d = x.shape
    di, H, P = cfg.d_inner, cfg.n_ssm_heads, cfg.ssm_headdim
    z = torch.einsum("bsd,de->bse", x, p["in_z"])
    xr = torch.einsum("bsd,de->bse", x, p["in_x"])
    Bm = torch.einsum("bsd,dn->bsn", x, p["in_B"])
    Cm = torch.einsum("bsd,dn->bsn", x, p["in_C"])
    dt = torch.einsum("bsd,dh->bsh", x, p["in_dt"])
    xr = shd.constrain(xr, "batch", "seq", "dinner")
    z = shd.constrain(z, "batch", "seq", "dinner")
    conv_state = state["conv"] if state is not None else None
    xc, new_conv = depthwise_conv(xr, p["conv_w"], conv_state)
    xc = F.silu(xc)
    dt = F.softplus(dt.float() + p["dt_bias"])                    # (B,S,H)
    A = -torch.exp(p["A_log"].float())                            # (H,)
    la = dt * A                                                   # log decay
    xh = xc.reshape(B, S, H, P)
    xin = xh * dt[..., None].to(xh.dtype)
    h0 = state["ssd"] if state is not None else None
    y, h_last = ssd_chunked(xin, la, Bm, Cm, chunk=min(128, S), h0=h0)
    y = y + xh * p["D"][None, None, :, None]
    y = y.reshape(B, S, di)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"])
    new_state = {"conv": new_conv, "ssd": h_last}
    return out, new_state


def init_mamba(gen, cfg):
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    std = d ** -0.5
    dev = gen.device
    return {
        "in_z": normal(gen, (d, di), std),
        "in_x": normal(gen, (d, di), std),
        "in_B": normal(gen, (d, N), std),
        "in_C": normal(gen, (d, N), std),
        "in_dt": normal(gen, (d, H), std),
        "conv_w": normal(gen, (4, di), 0.5),
        "dt_bias": torch.log(torch.expm1(torch.full((H,), 0.01,
                                                    device=dev))),
        "A_log": torch.zeros((H,), device=dev),
        "D": torch.ones((H,), dtype=torch.bfloat16, device=dev),
        "norm": torch.ones((di,), device=dev),
        "out_proj": normal(gen, (di, d), di ** -0.5),
    }
