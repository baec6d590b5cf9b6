"""Transformer building blocks: RMSNorm, RoPE, GQA attention (flash-style
blocked online softmax, memory-bounded), SwiGLU/GELU MLP.

Attention uses an online-softmax block algorithm (outer loop over query
blocks, inner loop over KV blocks) so the S x S score matrix never
materializes.  The same machinery accepts an additive per-block decay bias,
which models/xlstm.py reuses for the parallel mLSTM form.  On a CUDA
tensor the plain causal case (no decay, no mLSTM denominator) runs
``torch.nn.functional.scaled_dot_product_attention`` instead, which
computes the same function; ``blocked_attention`` is the blocked form on
every device.

GQA + TP head padding: when n_heads is not a multiple of the model-axis
size (qwen2-7b: 28 heads on a 16-way axis) each KV group is padded with
zero-weight query heads (wq columns and wo rows are zero), which keeps the
math exact while making the padded head count divide the axis.  KV heads
are repeated per group before flash attention; the decode path keeps the
grouped form and never repeats the cache.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..errors import ConfigError


def rms_norm(x, w, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w).to(dt)


def rope_freqs(dh: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                         device=device) / dh))


def apply_rope(x, pos, theta: float):
    """x (..., S, H, dh); pos (..., S) integer positions."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)              # (dh/2,)
    ang = pos[..., None].float() * freqs                  # (..., S, dh/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def _blockify(x, block, axis=1):
    n = x.shape[axis]
    nb = n // block
    shape = x.shape[:axis] + (nb, block) + x.shape[axis + 1:]
    return x.reshape(shape), nb


def blocked_attention(q, k, v, *, causal: bool = True, q_block: int = 512,
                      kv_block: int = 1024, decay: tuple | None = None,
                      softmax_scale: float | None = None,
                      mlstm_norm: bool = False):
    """Online-softmax attention; q/k/v: (B, S, H, dh) (KV pre-repeated).

    decay: optional (F, i_gate) tensors (B, S, H) adding the mLSTM bias
    D_ij = F_i - F_j + i_j to the pre-softmax logits (xlstm.py);
    mlstm_norm uses the mLSTM denominator max(|l|, exp(-m)).

    Memory: O(q_block x kv_block) per (batch, head) — outer loop over
    query blocks, inner loop over KV blocks carrying (acc, m, l).
    """
    B, Sq, H, dh = q.shape
    Skv = k.shape[1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(dh)
    q_block = min(q_block, Sq)
    kv_block = min(kv_block, Skv)
    if Sq % q_block or Skv % kv_block:
        raise ConfigError(f"flash_attention needs Sq % q_block == 0 and "
                          f"Skv % kv_block == 0, got Sq={Sq} q_block={q_block}"
                          f" Skv={Skv} kv_block={kv_block}")
    dev = q.device
    qb, nq = _blockify(q, q_block)                  # (B, nq, qb, H, dh)
    kb, nk = _blockify(k, kv_block)                 # (B, nk, kb, H, dh)
    vb, _ = _blockify(v, kv_block)
    if decay is not None:
        Fd, ig = decay                              # (B, S, H)
        Fq, _ = _blockify(Fd, q_block)
        Fk, _ = _blockify(Fd, kv_block)
        igk, _ = _blockify(ig, kv_block)
    ninf = torch.tensor(-math.inf, device=dev)
    zero = torch.tensor(0.0, device=dev)

    outs = []
    for qi in range(nq):
        qc = qb[:, qi].float()                      # (B, qb, H, dh)
        m = torch.full((B, q_block, H), -math.inf, device=dev)
        l = torch.zeros((B, q_block, H), device=dev)
        acc = torch.zeros((B, q_block, H, dh), device=dev)
        for ki in range(nk):
            kc = kb[:, ki].float()
            vc = vb[:, ki].float()
            s = torch.einsum("bqhd,bphd->bqhp", qc, kc) * scale
            if decay is not None:
                d = (Fq[:, qi][:, :, None, :]       # (B,qb,1,H)
                     - Fk[:, ki][:, None, :, :]     # (B,1,kb,H)
                     + igk[:, ki][:, None, :, :])   # -> (B,qb,kb,H)
                s = s + torch.movedim(d, -1, 2)     # (B,qb,H,kb)
            if causal:
                qpos = qi * q_block + torch.arange(q_block, device=dev)
                kpos = ki * kv_block + torch.arange(kv_block, device=dev)
                mask = qpos[:, None] >= kpos[None, :]
                s = torch.where(mask[None, :, None, :], s, ninf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, zero)
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(torch.isfinite(s), p, zero)
            fin = torch.isfinite(m)
            corr = torch.exp(torch.where(fin, m - m_safe, ninf))
            corr = torch.where(fin, corr, zero)
            l = l * corr + p.sum(dim=-1)
            acc = (acc * corr[..., None]
                   + torch.einsum("bqhp,bphd->bqhd", p, vc))
            m = m_new
        if mlstm_norm:
            denom = torch.maximum(torch.abs(l), torch.exp(-torch.where(
                torch.isfinite(m), m, zero))) + 1e-6
        else:
            denom = torch.clamp(l, min=1e-30)
        outs.append(acc / denom[..., None])
    out = torch.stack(outs, dim=1).reshape(B, Sq, H, dh)
    return out.to(q.dtype)


def sdpa_attention(q, k, v, *, softmax_scale: float | None = None):
    """Causal attention by ``scaled_dot_product_attention`` on (B, S, H, dh)
    tensors: the function of ``blocked_attention(causal=True)`` without
    decay.  On meta tensors (a dry run) it is the fused flash-attention op
    that the card runs: meta would decompose scaled_dot_product_attention
    into its math form, whose S x S scores the card never materialises."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if q.is_meta:
        o = torch.ops.aten._scaled_dot_product_flash_attention(
            qt, kt, vt, 0.0, True, False, scale=softmax_scale)[0]
    else:
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                           scale=softmax_scale)
    return o.transpose(1, 2).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True, q_block: int = 512,
                    kv_block: int = 1024, decay: tuple | None = None,
                    softmax_scale: float | None = None,
                    mlstm_norm: bool = False):
    """Attention of (B, S, H, dh) tensors (KV pre-repeated): the blocked
    online softmax of ``blocked_attention``, or on CUDA, for the plain
    causal case, ``sdpa_attention`` (same function, fused).  Meta tensors
    stand for the card in a dry run and take the card's route."""
    if ((q.is_cuda or q.is_meta) and causal and decay is None and not mlstm_norm
            and q.shape[1] == k.shape[1]):
        return sdpa_attention(q, k, v, softmax_scale=softmax_scale)
    return blocked_attention(q, k, v, causal=causal, q_block=q_block,
                             kv_block=kv_block, decay=decay,
                             softmax_scale=softmax_scale,
                             mlstm_norm=mlstm_norm)


def quantize_kv(x):
    """(..., dh) -> int8 values + fp32 per-(...,) scale."""
    xf = x.float()
    scale = torch.amax(torch.abs(xf), dim=-1) / 127.0
    scale = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q, scale):
    return q.float() * scale[..., None].float()


def repeat_kv(k, groups: int):
    """(B, S, KV, dh) -> (B, S, KV*groups, dh), group-aligned."""
    B, S, KV, dh = k.shape
    k = k[:, :, :, None, :].expand(B, S, KV, groups, dh)
    return k.reshape(B, S, KV * groups, dh)


def _write_rows(cache, rows, pos):
    """``cache`` (B, T, ...) with row pos[b] of batch b replaced by
    rows[b, 0] (functional: the input cache is not changed).  A cache
    sharded over ranks takes a masked local write: each rank writes the
    rows whose position falls in its slice of T."""
    from torch.distributed.tensor import DTensor
    if isinstance(cache, DTensor):
        return _write_rows_sharded(cache, rows, pos)
    out = cache.clone()
    out[torch.arange(cache.shape[0], device=cache.device), pos] = \
        rows[:, 0].to(cache.dtype)
    return out


def _pad(x, pad):
    """``F.pad(x, pad)`` with zeros.  A ``DTensor`` whose padded dims are
    whole on every rank is padded on each rank's shard (the same result;
    torch 2.11's DTensor cannot redistribute for ``pad``)."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        padded = {x.dim() - 1 - i // 2 for i in range(len(pad)) if pad[i]}
        if not any(p.is_shard() and p.dim in padded for p in x.placements):
            return DTensor.from_local(F.pad(x.to_local(), pad),
                                      x.device_mesh, x.placements,
                                      run_check=False)
    return F.pad(x, pad)


def _write_rows_sharded(cache, rows, pos):
    """``_write_rows`` on a ``DTensor`` cache: the new rows and positions
    are brought to the cache's placements with T whole (small: one row a
    batch entry), and each rank writes into its local slice of T the rows
    that fall in it (GSPMD's masked local write)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh, pl = cache.device_mesh, cache.placements
    whole_t = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
               for p in pl]
    rows = _placed_like(rows, mesh, whole_t).to_local()
    pos = _placed_like(pos, mesh, [p if isinstance(p, Shard) and p.dim == 0
                                   else Replicate() for p in pl]).to_local()
    local = cache.to_local().clone()
    Tl = local.shape[1]
    off = 0
    for i, p in enumerate(pl):
        if isinstance(p, Shard) and p.dim == 1:
            off = off * mesh.size(i) + mesh.get_local_rank(i)
    off *= Tl
    lp = pos.long() - off
    inside = (lp >= 0) & (lp < Tl)
    b = torch.arange(local.shape[0], device=local.device)
    lp = torch.clamp(lp, 0, Tl - 1)
    keep = local[b, lp]
    new = rows[:, 0].to(local.dtype)
    mask = inside.reshape((-1,) + (1,) * (new.dim() - 1))
    local[b, lp] = torch.where(mask, new, keep)
    return DTensor.from_local(local, mesh, pl, run_check=False)


def _placed_like(x, mesh, placements):
    """``x`` as a ``DTensor`` of ``placements`` on ``mesh`` (a plain
    tensor is taken as replicated)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return x.redistribute(mesh, placements)


def check_positions(pos, T: int) -> None:
    """Decode positions must lie in [0, T): a row outside the cache is a
    caller's error, never a clamped write.  Meta tensors (a dry run) hold
    no positions to check."""
    if pos.is_meta:
        return
    from torch.distributed.tensor import DTensor
    if isinstance(pos, DTensor):
        pos = pos.full_tensor()
    lo, hi = torch.stack([pos.min(), pos.max()]).tolist()
    if lo < 0 or hi >= T:
        raise ConfigError(f"decode position {hi if hi >= T else lo} outside "
                          f"a cache of {T} rows")


def attention_block(p, x, cfg, shd, pos=None, cache=None):
    """Attention sublayer (pre-norm applied by caller).

    Train/prefill: pos None.  Decode: x (B, 1, d), pos (B,), cache
    {'k','v'}: (B, T, KV, dh), functionally updated.
    Returns (out, new_cache or None).
    """
    B, S, _ = x.shape
    KV, dh = cfg.n_kv_heads, cfg.dh
    Hp = p["wq"].shape[1] // dh                     # padded head count
    G = Hp // KV
    q = torch.einsum("bsd,dh->bsh", x, p["wq"])
    k = torch.einsum("bsd,dh->bsh", x, p["wk"])
    v = torch.einsum("bsd,dh->bsh", x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, Hp, dh)
    k = k.reshape(B, S, KV, dh)
    v = v.reshape(B, S, KV, dh)
    pvec = (torch.arange(S, device=x.device)[None, :] if pos is None
            else pos[:, None])
    q = apply_rope(q, pvec, cfg.rope_theta)
    k = apply_rope(k, pvec, cfg.rope_theta)

    if cache is not None and pos is not None:       # ---- decode
        check_positions(pos, cache["k"].shape[1])
        if "ks" in cache:
            kq, ksc = quantize_kv(k)
            vq, vsc = quantize_kv(v)
            ck = _write_rows(cache["k"], kq, pos)
            cv = _write_rows(cache["v"], vq, pos)
            cks = _write_rows(cache["ks"], ksc, pos)
            cvs = _write_rows(cache["vs"], vsc, pos)
            kf = dequantize_kv(ck, cks)
            vf = dequantize_kv(cv, cvs)
            new_cache = {"k": ck, "v": cv, "ks": cks, "vs": cvs}
        else:
            ck = _write_rows(cache["k"], k, pos)
            cv = _write_rows(cache["v"], v, pos)
            kf, vf = ck.float(), cv.float()
            new_cache = {"k": ck, "v": cv}
        kf = shd.constrain(kf, "batch", "cache_seq", None, None)
        vf = shd.constrain(vf, "batch", "cache_seq", None, None)
        o = _decode_attention(q, kf, vf, pos, shd).to(x.dtype)
    else:                                            # ---- train / prefill
        q = shd.constrain(q, "batch", "seq", "heads", None)
        kf = repeat_kv(k, G)
        vf = repeat_kv(v, G)
        kf = shd.constrain(kf, "batch", "seq", "heads", None)
        vf = shd.constrain(vf, "batch", "seq", "heads", None)
        o = _attention(q, kf, vf, shd)
        o = shd.constrain(o, "batch", "seq", "heads", None)
        if cache is not None:                        # prefill fills cache
            T = cache["k"].shape[1]
            if T < S:
                raise ConfigError(f"a prompt of {S} positions does not fit "
                                  f"a cache of {T} rows")
            pad = (0, 0, 0, 0, 0, T - S)             # rows S..T-1 zero
            if "ks" in cache:
                kq, ksc = quantize_kv(k)
                vq, vsc = quantize_kv(v)
                pad3 = pad[2:]
                new_cache = {"k": _pad(kq, pad), "v": _pad(vq, pad),
                             "ks": _pad(ksc, pad3),
                             "vs": _pad(vsc, pad3)}
            else:
                new_cache = {"k": _pad(k, pad), "v": _pad(v, pad)}
        else:
            new_cache = None
    out = torch.einsum("bsh,hd->bsd", o.reshape(B, S, Hp * dh), p["wo"])
    return out, new_cache


def _attention(q, k, v, shd):
    """Causal ``flash_attention``; on a mesh of ranks on each rank's shard
    of (batch, heads), which attention keeps apart."""
    if not shd.spmd:
        return flash_attention(q, k, v, causal=True)
    spec = shd.spec("batch", "seq", "heads", None)
    return shd.leave(flash_attention(shd.enter(q, spec), shd.enter(k, spec),
                                     shd.enter(v, spec), causal=True), spec)


def _decode_attention(q, kf, vf, pos, shd):
    """The decode step's attention: the query (all heads) scored against
    the cache rows up to ``pos``, softmax, weighted values.  On a mesh of
    ranks GSPMD's form for a cache sharded on its sequence: each rank
    scores against its rows of the cache, and the softmax's max and sum
    and the weighted values are reduced over the cache_seq axis.  q (B, 1,
    Hp, dh); kf, vf (B, T, KV, dh) float32; returns (B, 1, Hp, dh)
    float32."""
    mesh = shd.mesh if shd.spmd else None
    axis = None
    if mesh is not None:
        batch, axis = shd.rules["batch"], shd.rules["cache_seq"]
        q = shd.enter(q, (batch, None, None, None))
        kf = shd.enter(kf, (batch, axis, None, None))
        vf = shd.enter(vf, (batch, axis, None, None))
        pos = shd.enter(pos, (batch,))
    B, Tl, KV, dh = kf.shape
    G = q.shape[2] // KV
    off = mesh.index(axis) * Tl if axis else 0
    s = torch.einsum("bkgd,btkd->bkgt", q.reshape(B, KV, G, dh).float(), kf)
    s = s / math.sqrt(dh)
    mask = (off + torch.arange(Tl, device=kf.device))[None, :] \
        <= pos[:, None]                               # (B, T)
    s = s.masked_fill(~mask[:, None, None, :], -math.inf)
    m = s.amax(dim=-1)
    if axis:
        m = mesh.pmax(m, axis)
    e = torch.exp(s - m[..., None])
    denom = e.sum(dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", e, vf)
    if axis:
        denom, o = mesh.psum(denom, axis), mesh.psum(o, axis)
    o = (o / denom[..., None]).reshape(B, 1, KV * G, dh)
    return shd.leave(o, (batch, None, None, None)) if mesh is not None \
        else o


def mlp_block(p, x, cfg, shd):
    h = torch.einsum("bsd,df->bsf", x, p["w_in"])
    if cfg.act == "swiglu":
        g = torch.einsum("bsd,df->bsf", x, p["w_gate"])
        h = F.silu(g) * h
    else:
        h = F.gelu(h, approximate="tanh")            # jax.nn.gelu's default
    h = shd.constrain(h, "batch", "seq", "ff")
    return torch.einsum("bsf,fd->bsd", h, p["w_out"])


# ------------------------------------------------------------------- init

class MetaDraws:
    """Takes a generator's place when parameters are built on the meta
    device (a dry run): every draw is a meta tensor, so nothing is drawn
    and nothing is allocated."""
    device = torch.device("meta")


def normal(gen, shape, std, dtype=torch.bfloat16):
    """N(0, std^2) of ``shape`` drawn in float32 by ``gen`` on its device,
    then cast (as the reference draws in float32 and casts)."""
    x = torch.randn(shape, generator=None if isinstance(gen, MetaDraws)
                    else gen, device=gen.device, dtype=torch.float32)
    return (x * std).to(dtype)


def padded_heads(cfg, shards: int = 16) -> int:
    """Padded per-group head count * KV (see module docstring)."""
    H, KV = cfg.n_heads, cfg.n_kv_heads
    G = H // KV
    Hp = H
    if H % shards != 0 and H > shards:
        # pad per-group so total padded heads divide `shards`
        Gp = G
        while (KV * Gp) % shards != 0:
            Gp += 1
        Hp = KV * Gp
    return Hp


def init_attention(gen, cfg, shards: int = 16):
    d, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh
    Hp = padded_heads(cfg, shards)
    G, Gp = H // KV, Hp // KV
    std = d ** -0.5
    # generate (d, KV, Gp, dh) with zeros at g >= G, then flatten
    wq = normal(gen, (d, KV, Gp, dh), std, torch.float32)
    wk = normal(gen, (d, KV * dh), std)
    wv = normal(gen, (d, KV * dh), std)
    wo = normal(gen, (KV, Gp, dh, d), (H * dh) ** -0.5, torch.float32)
    if Gp != G:
        wq[:, :, G:, :] = 0.0
        wo[:, G:, :, :] = 0.0
    p = {"wq": wq.reshape(d, Hp * dh).to(torch.bfloat16),
         "wk": wk, "wv": wv,
         "wo": wo.reshape(Hp * dh, d).to(torch.bfloat16)}
    if cfg.qkv_bias:
        z = dict(device=gen.device, dtype=torch.bfloat16)
        p["bq"] = torch.zeros((Hp * dh,), **z)
        p["bk"] = torch.zeros((KV * dh,), **z)
        p["bv"] = torch.zeros((KV * dh,), **z)
    return p


def init_mlp(gen, cfg, d_ff=None):
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    p = {"w_in": normal(gen, (d, f), d ** -0.5),
         "w_out": normal(gen, (f, d), f ** -0.5)}
    if cfg.act == "swiglu":
        p["w_gate"] = normal(gen, (d, f), d ** -0.5)
    return p
