"""Mixture-of-Experts layer (olmoe, deepseek-moe): top-k router, shared +
routed experts.

Two dispatch implementations (cfg.moe_impl):

  * 'gather' (default) — a sort + gather into per-expert capacity buffers
    (zero dispatch-matmul FLOPs), expert GEMMs over the buffers, and a
    scatter-add combine.  Without a mesh every expert is local
    (``e_start=0``, ``e_local=n_experts``, no combine across devices); with
    a mesh the body runs through ``shardings.Sharding.moe_shard_map`` on
    each rank's tokens and experts, and the combine sums over 'model'.
    Capacity is counted per DP shard.  Shapes stay static (no
    data-dependent sizes), so the body also runs on the meta device in a
    dry run.

  * 'onehot' — classic capacity one-hot einsum dispatch (Mesh-TF/GShard
    style), kept as the reference/baseline; its dispatch einsums burn
    T*E*C*d MACs.

Both produce identical outputs up to capacity-drop tie-breaking; tests
compare them on small shapes.  Routing follows the reference exactly: a
stable sort of the routed slots by expert, and top-k ties broken toward
the lower expert index.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from .layers import normal


def router_probs(x, w_router):
    logits = torch.einsum("td,de->te", x.float(), w_router.float())
    return torch.softmax(logits, dim=-1), logits


def top_k(probs, k: int):
    """(values, indices) of the k largest entries of each row, ties broken
    toward the lower index (``lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def aux_losses(probs, top_idx, n_experts: int):
    """Load-balance loss (Switch) + router z-loss."""
    T, k = top_idx.shape
    me = torch.mean(probs, dim=0)                         # (E,)
    flat = top_idx.reshape(-1)
    ce = torch.zeros((n_experts,), device=probs.device).index_add(
        0, flat, torch.full(flat.shape, 1.0 / (T * k), device=probs.device))
    lb = n_experts * torch.sum(me * ce)
    z = torch.mean(torch.log(torch.sum(torch.exp(
        torch.clamp(probs, 1e-9, 1.0)), dim=-1)) ** 2)
    return lb, z


def _expert_ffn(h_in, w_in, w_gate, w_out, act: str):
    """(E, C, d) x (E, d, f) -> (E, C, d)."""
    h = torch.einsum("ecd,edf->ecf", h_in, w_in)
    if act == "swiglu":
        g = torch.einsum("ecd,edf->ecf", h_in, w_gate)
        h = F.silu(g) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.einsum("ecf,efd->ecd", h, w_out)


def moe_gather_local(x, p, cfg, *, e_start, e_local, capacity, axis_name,
                     mesh=None):
    """Local body: x (T, d) are this data shard's tokens, the same on every
    rank of ``axis_name``; this call computes experts e_start .. e_start +
    e_local - 1.  ``axis_name`` names the mesh axis whose shards sum the
    combine (None without a mesh); on a mesh of ranks (``mesh``) the sum
    is an all-reduce over it, on one card the identity.

    For each local expert slot (e, c) it computes which *sorted routed
    token* fills it (slot-inverse indexing) and gathers exactly
    e_local * C rows."""
    T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = capacity
    dev = x.device
    probs, _ = router_probs(x, p["router"])               # (T, E)
    top_p, top_i = top_k(probs, k)                        # (T, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    flat_e = top_i.reshape(-1)                            # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    st = order // k                              # token of sorted slot
    sp = top_p.reshape(-1)[order]
    counts = torch.zeros((E,), dtype=se.dtype, device=dev).index_add(
        0, se, torch.ones_like(se))                       # per expert
    starts = torch.cumsum(counts, 0) - counts             # exclusive prefix
    eids = e_start + torch.arange(e_local, device=dev)
    ar = torch.arange(C, device=dev)
    src = starts[eids][:, None] + ar[None, :]             # (e_local, C)
    valid = ar[None, :] < torch.clamp(counts[eids], max=C)[:, None]
    src = torch.clamp(src, 0, T * k - 1)
    tok = st[src]                                         # (e_local, C)
    gate = sp[src] * valid                                # (e_local, C)
    buf = x[tok] * valid[..., None].to(x.dtype)           # (e_local, C, d)
    y = _expert_ffn(buf, p["w_in"], p.get("w_gate"), p["w_out"], cfg.act)
    contrib = y * gate[..., None].to(x.dtype)
    out = torch.zeros((T, d), dtype=x.dtype, device=dev).index_add(
        0, tok.reshape(-1), contrib.reshape(-1, d))
    if axis_name and mesh is not None:
        out = mesh.psum(out, axis_name)                   # combine over EP
    lb, z = aux_losses(probs, top_i, E)
    return out, lb, z


def moe_onehot(x, p, cfg, *, capacity):
    """Reference one-hot dispatch.  x: (T, d)."""
    T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    probs, _ = router_probs(x, p["router"])
    top_p, top_i = top_k(probs, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    oh = F.one_hot(top_i, E).float()                      # (T, k, E)
    # capacity positions per expert, k-slot priority order
    pos = (torch.cumsum(oh.reshape(T * k, E), dim=0) - 1.0).reshape(T, k, E)
    keep = (pos < capacity) * oh
    pos = torch.clamp(pos, 0, capacity - 1).long()
    pos_oh = F.one_hot(pos, capacity).float()             # (T,k,E,C)
    disp = (keep[..., None] * pos_oh).sum(1)              # (T, E, C)
    comb = (keep * top_p[..., None])[..., None] * pos_oh  # (T,k,E,C)
    comb = comb.sum(1)                                    # (T, E, C)
    h_in = torch.einsum("tec,td->ecd", disp.to(x.dtype), x)
    y = _expert_ffn(h_in, p["w_in"], p.get("w_gate"), p["w_out"], cfg.act)
    out = torch.einsum("tec,ecd->td", comb.to(x.dtype), y)
    lb, z = aux_losses(probs, top_i, E)
    return out, lb, z


def moe_block(p, x, cfg, shd):
    """x (B, S, d) -> (B, S, d) plus aux losses (lb, z).

    Shared experts (deepseek) run as a dense MLP on every token; routed
    experts go through the dispatch of ``cfg.moe_impl``.
    """
    B, S, d = x.shape
    T = B * S
    cap = int(cfg.capacity_factor * T * cfg.top_k / cfg.n_experts /
              max(1, shd.dp_size))
    cap = max(cap, cfg.top_k)
    xt = x.reshape(T, d)

    if cfg.moe_impl == "gather" and shd.mesh is not None:
        out2, lb, z = shd.moe_shard_map(
            functools.partial(moe_gather_local, cfg=cfg, capacity=cap),
            xt, p)
    elif cfg.moe_impl == "gather":
        out2, lb, z = moe_gather_local(
            xt, p, cfg, e_start=0, e_local=cfg.n_experts, capacity=cap,
            axis_name=None)
    else:
        out2, lb, z = moe_onehot(xt, p, cfg, capacity=cap)
    out = out2.reshape(B, S, d)
    if cfg.n_shared_experts:
        h = torch.einsum("bsd,df->bsf", x, p["shared_w_in"])
        g = torch.einsum("bsd,df->bsf", x, p["shared_w_gate"])
        h = F.silu(g) * h
        h = shd.constrain(h, "batch", "seq", "ff")
        out = out + torch.einsum("bsf,fd->bsd", h, p["shared_w_out"])
    return out, (lb, z)


def init_moe(gen, cfg):
    d, E, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    std = d ** -0.5
    p = {"router": normal(gen, (d, E), std, torch.float32),
         "w_in": normal(gen, (E, d, f), std),
         "w_gate": normal(gen, (E, d, f), std),
         "w_out": normal(gen, (E, f, d), f ** -0.5)}
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * f
        p["shared_w_in"] = normal(gen, (d, fs), std)
        p["shared_w_gate"] = normal(gen, (d, fs), std)
        p["shared_w_out"] = normal(gen, (fs, d), fs ** -0.5)
    return p
