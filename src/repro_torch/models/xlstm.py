"""xLSTM blocks (xlstm-125m): mLSTM (matrix memory, parallelizable) and
sLSTM (scalar memory, recurrent loop).

mLSTM trains in its parallel form — the same online-softmax block machinery
as flash attention, with the additive decay bias D_ij = F_i - F_j + i_j
(F = cumulative log-sigmoid forget gates) and the mLSTM denominator
max(|l|, exp(-m)) (layers.flash_attention(decay=..., mlstm_norm=True)).
Decode uses the recurrent matrix-state update: O(1) state per token, which
is what makes the long_500k shape runnable.

sLSTM has no parallel form (its forget gate depends on the previous hidden
state), so it runs as a loop over time with exponential-gate stabilizer
state m.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import flash_attention, normal, rms_norm


# ------------------------------------------------------------------ mLSTM

def mlstm_parallel(p, x, cfg, shd):
    B, S, d = x.shape
    H = cfg.n_heads
    dh = d // H
    q = torch.einsum("bsd,de->bse", x, p["wq"]).reshape(B, S, H, dh)
    k = torch.einsum("bsd,de->bse", x, p["wk"]).reshape(B, S, H, dh)
    v = torch.einsum("bsd,de->bse", x, p["wv"]).reshape(B, S, H, dh)
    ig = torch.einsum("bsd,dh->bsh", x, p["wi"]).float()
    fg = torch.einsum("bsd,dh->bsh", x, p["wf"]).float()
    Fc = torch.cumsum(F.logsigmoid(fg), dim=1)            # (B,S,H)
    h = flash_attention(q, k, v, causal=True, decay=(Fc, ig),
                        mlstm_norm=True,
                        softmax_scale=1.0 / math.sqrt(dh))
    h = rms_norm(h.reshape(B, S, d), p["norm_h"], cfg.norm_eps)
    o = torch.sigmoid(torch.einsum("bsd,de->bse", x, p["wo_gate"]))
    return torch.einsum("bse,ed->bsd", h * o.to(h.dtype), p["w_out"])


def mlstm_decode(p, x, cfg, state):
    """x (B,1,d); state {'C': (B,H,dh,dh), 'n': (B,H,dh), 'm': (B,H)}."""
    B, _, d = x.shape
    H = cfg.n_heads
    dh = d // H
    q = torch.einsum("bsd,de->bse", x, p["wq"]).reshape(B, H, dh)
    k = torch.einsum("bsd,de->bse", x, p["wk"]).reshape(B, H, dh)
    v = torch.einsum("bsd,de->bse", x, p["wv"]).reshape(B, H, dh)
    ig = torch.einsum("bsd,dh->bh", x, p["wi"]).float()
    fg = F.logsigmoid(torch.einsum("bsd,dh->bh", x, p["wf"]).float())
    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(fg + m, ig)
    a = torch.exp(fg + m - m_new)[..., None]              # (B,H,1)
    b = torch.exp(ig - m_new)[..., None]
    kf = k.float() / math.sqrt(dh)
    C_new = C * a[..., None] + b[..., None] * (
        kf[..., :, None] * v.float()[..., None, :])
    n_new = n * a + b * kf
    qf = q.float()
    num = torch.einsum("bhd,bhde->bhe", qf, C_new)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", qf, n_new)),
                        torch.exp(-m_new)) + 1e-6
    h = (num / den[..., None]).reshape(B, 1, d).to(x.dtype)
    h = rms_norm(h, p["norm_h"], cfg.norm_eps)
    o = torch.sigmoid(torch.einsum("bsd,de->bse", x, p["wo_gate"]))
    out = torch.einsum("bse,ed->bsd", h * o.to(h.dtype), p["w_out"])
    return out, {"C": C_new, "n": n_new, "m": m_new}


def mlstm_final_state(p, x, cfg):
    """Exact recurrent state after a parallel-form prefill of x (B,S,d):
    C_S = sum_j exp(F_S - F_j + i_j - m*) k_j v_j^T (log-weighted sum),
    n_S likewise, m = m*.  Used for the prefill->decode handoff."""
    B, S, d = x.shape
    H = cfg.n_heads
    dh = d // H
    k = torch.einsum("bsd,de->bse", x, p["wk"]).reshape(B, S, H, dh)
    v = torch.einsum("bsd,de->bse", x, p["wv"]).reshape(B, S, H, dh)
    ig = torch.einsum("bsd,dh->bsh", x, p["wi"]).float()
    fg = torch.einsum("bsd,dh->bsh", x, p["wf"]).float()
    Fc = torch.cumsum(F.logsigmoid(fg), dim=1)
    w = Fc[:, -1:, :] - Fc + ig                           # (B,S,H)
    m = w.amax(dim=1)                                     # (B,H)
    a = torch.exp(w - m[:, None, :])                      # (B,S,H)
    kf = k.float() / math.sqrt(dh)
    C = torch.einsum("bshd,bshe->bhde", a[..., None] * kf, v.float())
    n = torch.einsum("bsh,bshd->bhd", a, kf)
    return {"C": C, "n": n, "m": m}


def init_mlstm(gen, cfg):
    """The mLSTM cell's weights.  As in the reference, ``w_out`` is drawn
    from the same key as ``wq``, so the two are equal at init."""
    d, H = cfg.d_model, cfg.n_heads
    std = d ** -0.5
    wq = normal(gen, (d, d), std)
    return {"wq": wq,
            "wk": normal(gen, (d, d), std),
            "wv": normal(gen, (d, d), std),
            "wi": normal(gen, (d, H), std),
            "wf": normal(gen, (d, H), std),
            "wo_gate": normal(gen, (d, d), std),
            "w_out": wq.clone(),
            "norm_h": torch.ones((d,), device=gen.device)}


def init_mlstm_state(cfg, B, device=None):
    H = cfg.n_heads
    dh = cfg.d_model // H
    return {"C": torch.zeros((B, H, dh, dh), device=device),
            "n": torch.zeros((B, H, dh), device=device),
            "m": torch.full((B, H), -1e30, device=device)}


# ------------------------------------------------------------------ sLSTM

_GATES = "zifo"


def _slstm_weights(p):
    """The four gates' input weights side by side, (d, 4d), and their
    recurrent weights as one float32 (H, dh, 4 dh) stack, so that a time
    step makes one recurrent product instead of four."""
    w = torch.cat([p[f"w{g}"] for g in _GATES], dim=1)
    r = torch.stack([p[f"r{g}"] for g in _GATES], dim=2).float()
    H, dh = r.shape[0], r.shape[1]
    return w, r.reshape(H, dh, 4 * dh)


def _slstm_inputs(x, w):
    """The gates' input pre-activations of x (..., d): (..., 4, d) in
    float32, each rounded to x's dtype first, as the reference's per-gate
    einsum is."""
    gx = torch.einsum("...d,de->...e", x, w).float()
    return gx.reshape(*x.shape[:-1], 4, x.shape[-1])


def _slstm_step(gx, state, r, cfg):
    """One step from the input pre-activations gx (B, 4, d) and the state
    tuple (c, n, h, m), each (B, d)."""
    c, n, h, m = state
    B, d = h.shape
    H = cfg.n_heads
    dh = d // H
    rec = torch.bmm(h.reshape(B, H, dh).transpose(0, 1).float(), r)
    pre = gx + rec.reshape(H, B, 4, dh).permute(1, 2, 0, 3).reshape(B, 4, d)
    zi = torch.tanh(pre[:, 0])
    ii = pre[:, 1]
    ff = pre[:, 2]
    oo = torch.sigmoid(pre[:, 3])
    lf = F.logsigmoid(ff)
    m_new = torch.maximum(lf + m, ii)
    i_e = torch.exp(ii - m_new)
    f_e = torch.exp(lf + m - m_new)
    c_new = f_e * c + i_e * zi
    n_new = torch.maximum(f_e * n + i_e, torch.exp(-m_new))
    h_new = oo * c_new / n_new
    return (c_new, n_new, h_new, m_new)


def _slstm_cell(p, x_t, state, cfg):
    """One step.  x_t (B, d); state tuple (c, n, h, m) each (B, d)."""
    w, r = _slstm_weights(p)
    return _slstm_step(_slstm_inputs(x_t, w), state, r, cfg)


def slstm_block(p, x, cfg, shd, state=None):
    """x (B, S, d) loop over time.  Returns (out, final_state).  The input
    projections of all S steps are one product before the loop and the
    recurrent products of a step one bmm; the products' shapes differ from
    the reference's per-step, per-gate ones, so a BLAS may sum in another
    order: the result equals the reference's within the parity tests'
    tolerances, not bit for bit."""
    B, S, d = x.shape
    if state is None:
        state = init_slstm_state(cfg, B, x.device)
    w, r = _slstm_weights(p)
    gx = _slstm_inputs(x, w)                              # (B,S,4,d)
    hs = []
    for t in range(S):
        state = _slstm_step(gx[:, t], state, r, cfg)
        hs.append(state[2])                               # emit h
    hs = torch.stack(hs, dim=1).to(x.dtype)               # (B,S,d)
    hs = rms_norm(hs, p["norm_h"], cfg.norm_eps)
    out = torch.einsum("bsd,de->bse", hs, p["w_out"])
    return out, state


def init_slstm(gen, cfg):
    d, H = cfg.d_model, cfg.n_heads
    dh = d // H
    std = d ** -0.5
    p = {}
    for g in "zifo":
        p[f"w{g}"] = normal(gen, (d, d), std)
    for g in "zifo":
        p[f"r{g}"] = normal(gen, (H, dh, dh), dh ** -0.5)
    p["w_out"] = normal(gen, (d, d), std)
    p["norm_h"] = torch.ones((d,), device=gen.device)
    return p


def init_slstm_state(cfg, B, device=None):
    d = cfg.d_model
    z = torch.zeros((B, d), device=device)
    return (z, z + 1e-6, z, z - 1e30)
