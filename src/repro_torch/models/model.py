"""Composable decoder model: init / train-forward / prefill / decode for
all 10 assigned architectures.

Families:
  dense | audio | vlm : uniform [attn + MLP] stack, a loop over layers
  moe                 : uniform [attn + MoE] stack, a loop over layers
  hybrid (zamba2)     : 54 Mamba2 layers + ONE shared attn+MLP block
                        (weight-tied) applied every `attn_every` layers —
                        a loop over groups, an inner loop over the group's
                        mamba layers
  ssm (xlstm)         : 12-layer loop of mLSTM/sLSTM blocks

Parameters are a tree of dicts of tensors with the reference's keys and
its STACKED layout: each per-layer leaf carries a leading L axis (xLSTM:
(G,) for the sLSTM layers and (G, period-1) for the mLSTM layers), and the
loops index the stack.  A tree of either package's params therefore maps
leaf for leaf onto the other's (``params_from_numpy`` /
``params_to_numpy``).  With ``cfg.remat`` each layer body of the training
forward runs under ``torch.utils.checkpoint`` (activations recomputed in
the backward pass; values unchanged).

On a mesh of ranks (``Sharding.spmd``) the params, batch and caches are
``DTensor``s placed by the shardings' specs (``init_params(shd=...)``,
``init_cache(shd=...)``), the entry points run inside ``shd.region()``, and
the loss is vocab-parallel (``lm_loss``): each rank holds a slice of the
vocab, and the max, the sum of exponentials and the gold logit are reduced
across the 'model' axis.

Modality frontends are stubs per the assignment: internvl2 consumes
precomputed patch embeddings through a linear connector; musicgen consumes
the EnCodec token stream directly (single-codebook stand-in).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..errors import ConfigError
from ..kernels import ops
from ..mesh import replicating
from . import moe as moe_mod
from . import ssm as ssm_mod
from . import xlstm as xlstm_mod
from .layers import (MetaDraws, attention_block, check_positions,
                     init_attention, init_mlp, mlp_block, normal, rms_norm)

_TX = ("dense", "moe", "audio", "vlm")


def xlstm_groups(cfg):
    """(n_groups, period) for the periodic sLSTM placement; (0, 0) if the
    stack is pure mLSTM.  slstm_at must be (0, p, 2p, ...)."""
    if not cfg.slstm_at:
        return 0, 0
    G = len(cfg.slstm_at)
    period = cfg.n_layers // G
    if tuple(cfg.slstm_at) != tuple(range(0, cfg.n_layers, period)):
        raise ConfigError(f"slstm_at must be periodic, got {cfg.slstm_at}")
    return G, period


def padded_vocab(cfg, shards: int = 16) -> int:
    return -(-cfg.vocab // shards) * shards


# ============================================================= tree helpers

def tree_map(fn, tree):
    """``fn`` applied to every leaf of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _at(tree, *idx):
    return tree_map(lambda a: a[idx], tree)


def _stack(trees):
    """One tree whose leaves stack the leaves of ``trees`` on a new axis 0."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack([t[i] for t in trees])
                           for i in range(len(first)))
    return torch.stack(trees)


def _run(cfg, fn, *args):
    """``fn(*args)``, under activation checkpointing while autograd records
    a training forward with ``cfg.remat``."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(_replayed, fn, *args, use_reentrant=False)
    return fn(*args)


def _replayed(fn, *args):
    """``fn(*args)``; with ``DTensor``s among the args (a mesh of ranks)
    inside ``replicating()``, which the recomputation in the backward pass
    does not inherit from the forward's region."""
    from torch.distributed.tensor import DTensor
    found = []
    tree_map(lambda a: found.append(isinstance(a, DTensor)), args)
    if any(found):
        with replicating():
            return fn(*args)
    return fn(*args)


def _vocab_mask(cfg, V, like):
    """-1e9 on the padded vocab entries, in ``like``'s dtype (the
    reference adds a weakly typed mask, which keeps the logits' dtype)."""
    return ((torch.arange(V, device=like.device) >= cfg.vocab) * (-1e9)
            ).to(like.dtype)


# ===================================================================== init

def _init_tx_layer(gen, cfg, shards):
    d = gen.device
    p = {"attn": init_attention(gen, cfg, shards),
         "ln1": torch.ones((cfg.d_model,), device=d),
         "ln2": torch.ones((cfg.d_model,), device=d)}
    if cfg.family == "moe":
        p["moe"] = moe_mod.init_moe(gen, cfg)
    else:
        p["mlp"] = init_mlp(gen, cfg)
    return p


def init_params(cfg, gen: torch.Generator, shards: int = 16, device=None,
                shd=None):
    """Random params of ``cfg`` with the reference's tree, shapes and
    dtypes, drawn by ``gen`` on its device and placed on ``device``
    (default: the engine's device, ``kernels.ops.device()``).  On the meta
    device (a dry run, the counterpart of ``jax.eval_shape``) nothing is
    drawn or allocated.  With ``shd`` on a mesh of ranks, rank 0 draws and
    every rank keeps only its shards of each leaf (``shd.param_specs``),
    the values of the one-device draw."""
    if shd is not None and shd.spmd:
        mesh = shd.mesh
        src = mesh.device_mesh.get_rank() == 0
        whole = init_params(cfg, gen, shards,
                            device=mesh.device if src else "meta")
        return mesh.place_tree(whole, shd.param_specs(whole))
    device = ops.ready_device() if device is None else torch.device(device)
    if device.type == "meta":
        gen = MetaDraws()
    V = padded_vocab(cfg, shards)
    d = cfg.d_model
    dev = gen.device
    params = {
        "embed": normal(gen, (V, d), d ** -0.5),
        "unembed": normal(gen, (d, V), d ** -0.5),
        "final_norm": torch.ones((d,), device=dev),
    }
    if cfg.family in _TX:
        params["layers"] = _stack([_init_tx_layer(gen, cfg, shards)
                                   for _ in range(cfg.n_layers)])
    elif cfg.family == "hybrid":
        params["layers"] = _stack([ssm_mod.init_mamba(gen, cfg)
                                   for _ in range(cfg.n_layers)])
        params["shared_attn"] = {
            "attn": init_attention(gen, cfg, shards),
            "mlp": init_mlp(gen, cfg),
            "ln1": torch.ones((d,), device=dev),
            "ln2": torch.ones((d,), device=dev)}
    elif cfg.family == "ssm":
        # periodic structure: G groups of [sLSTM, (period-1) x mLSTM]
        # (slstm_at must be (0, p, 2p, ...)); pure-mLSTM stack if empty.
        G, period = xlstm_groups(cfg)

        def one_m():
            return {"cell": xlstm_mod.init_mlstm(gen, cfg),
                    "ln": torch.ones((d,), device=dev)}

        if G:
            params["layers"] = {
                "slstm": _stack([{"cell": xlstm_mod.init_slstm(gen, cfg),
                                  "ln": torch.ones((d,), device=dev)}
                                 for _ in range(G)]),
                "mlstm": _stack([_stack([one_m() for _ in range(period - 1)])
                                 for _ in range(G)])}
        else:
            params["layers"] = {"mlstm": _stack([one_m() for _ in
                                                 range(cfg.n_layers)])}
    if cfg.frontend == "vision":
        params["frontend"] = {"proj": normal(gen, (d, d), d ** -0.5)}
    return tree_map(lambda a: a.to(device), params)


# ================================================================== embed

def embed_inputs(params, batch, cfg, shd):
    """Returns x (B, S, d).  VLM: [projected patches ; token embeds]."""
    tok = batch["tokens"]
    x = params["embed"][tok]
    x = shd.constrain(x, "batch", "seq", None)
    if cfg.frontend == "vision" and "patch_embeds" in batch:
        pe = torch.einsum("bpd,de->bpe", batch["patch_embeds"].to(x.dtype),
                          params["frontend"]["proj"])
        x = torch.cat([pe, x], dim=1)
        x = shd.constrain(x, "batch", "seq", None)
    return x


# ============================================================ train stacks

def _tx_layer_fwd(lp, h, cfg, shd):
    h = shd.constrain(h, "batch", "seq_res", None)
    a, _ = attention_block(lp["attn"], rms_norm(h, lp["ln1"], cfg.norm_eps),
                           cfg, shd)
    h = h + shd.constrain(a, "batch", "seq_res", None)
    hn = rms_norm(h, lp["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        ff, aux = moe_mod.moe_block(lp["moe"], hn, cfg, shd)
    else:
        ff, aux = mlp_block(lp["mlp"], hn, cfg, shd), (0.0, 0.0)
    h = h + shd.constrain(ff, "batch", "seq_res", None)
    return shd.constrain(h, "batch", "seq_res", None), aux


def _shared_block(sa, h, cfg, shd):
    """zamba2's weight-tied attention + MLP block."""
    a, _ = attention_block(sa["attn"], rms_norm(h, sa["ln1"], cfg.norm_eps),
                           cfg, shd)
    h = h + a
    return h + mlp_block(sa["mlp"], rms_norm(h, sa["ln2"], cfg.norm_eps),
                         cfg, shd)


def backbone(params, x, cfg, shd):
    """x (B,S,d) -> (final hidden, aux losses)."""
    aux = (0.0, 0.0)
    if cfg.family in _TX:
        lb = z = 0.0
        for i in range(cfg.n_layers):
            x, (alb, az) = _run(cfg, _tx_layer_fwd, _at(params["layers"], i),
                                x, cfg, shd)
            lb, z = lb + alb, z + az
        aux = (lb / cfg.n_layers, z / cfg.n_layers)
    elif cfg.family == "hybrid":
        k = cfg.attn_every

        def mamba_one(lp, hh):
            o, _ = ssm_mod.mamba_block(lp, hh, cfg, shd)
            return hh + o
        for g in range(cfg.n_layers // k):
            for j in range(k):
                x = _run(cfg, mamba_one, _at(params["layers"], g * k + j), x)
            x = _run(cfg, _shared_block, params["shared_attn"], x, cfg, shd)
    else:                                    # ssm / xlstm
        G, period = xlstm_groups(cfg)

        def m_one(lp, h):
            hn = rms_norm(h, lp["ln"], cfg.norm_eps)
            return h + xlstm_mod.mlstm_parallel(lp["cell"], hn, cfg, shd)

        def s_one(lp, h):
            hn = rms_norm(h, lp["ln"], cfg.norm_eps)
            return h + xlstm_mod.slstm_block(lp["cell"], hn, cfg, shd)[0]
        layers = params["layers"]
        if G:
            for g in range(G):
                x = _run(cfg, s_one, _at(layers["slstm"], g), x)
                for j in range(period - 1):
                    x = _run(cfg, m_one, _at(layers["mlstm"], g, j), x)
        else:
            for i in range(cfg.n_layers):
                x = _run(cfg, m_one, _at(layers["mlstm"], i), x)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux


# ==================================================================== loss

def _chunk_of(S: int, chunk: int) -> int:
    chunk = min(chunk, S)
    while S % chunk:           # largest chunk <= requested that divides S
        chunk -= 1
    return chunk


def lm_loss(params, x, labels, cfg, shd, chunk: int = 512):
    """Chunked cross-entropy: logits materialize only for `chunk` positions
    at a time (padded vocab masked with -1e9).  As in the reference, the
    gold logit is read from the logits rounded to bfloat16.  On a mesh of
    ranks the vocab-parallel form (``_lm_loss_spmd``); both run
    ``_lm_mean_local``."""
    if shd.spmd:
        return _lm_loss_spmd(params, x, labels, cfg, shd, chunk)
    return _lm_mean_local(x, labels, params["unembed"], cfg, shd, chunk)


def _lm_loss_spmd(params, x, labels, cfg, shd, chunk: int):
    """``lm_loss`` on each rank's shards, as a ``shard_map`` body: the
    rank's batch rows (the batch axes) against its slice of the vocab
    (the 'vocab' axis)."""
    batch, vocab = shd.rules["batch"], shd.rules["vocab"]
    return shd.leave(_lm_mean_local(
        shd.enter(x, (batch, None, None)), shd.enter(labels, (batch, None)),
        shd.enter(params["unembed"], (None, vocab)), cfg, shd, chunk), ())


def _lm_mean_local(x_l, lab, u_l, cfg, shd, chunk: int = 512):
    """The mean cross-entropy over the whole batch from each rank's rows
    ``x_l``, labels ``lab`` and vocab slice ``u_l``.  The row max and the
    sum of exponentials are reduced over the vocab axis, and the gold
    logit is a masked gather from the local slice (its bfloat16 rounding,
    as the reference reads it), summed over the vocab axis; the token sums
    are summed over the batch axes.  Off a mesh of ranks the slice is the
    whole vocab and nothing is reduced."""
    mesh = shd.mesh if shd.spmd else None
    vocab = shd.rules["vocab"] if mesh is not None else None
    Vl = u_l.shape[1]
    off = mesh.index(vocab) * Vl if vocab else 0
    pad_mask = ((off + torch.arange(Vl, device=x_l.device)) >= cfg.vocab) \
        * (-1e9)
    S = x_l.shape[1]
    chunk = _chunk_of(S, chunk)
    nll = cnt = 0.0
    for ci in range(S // chunk):
        xc = x_l[:, ci * chunk:(ci + 1) * chunk]
        lc = lab[:, ci * chunk:(ci + 1) * chunk]
        logits = torch.einsum("bsd,dv->bsv", xc, u_l).float() + pad_mask
        m = logits.detach().amax(dim=-1)
        if vocab:
            m = mesh.pmax(m, vocab)
        se = torch.exp(logits - m[..., None]).sum(dim=-1)
        logz = torch.log(mesh.psum(se, vocab) if vocab else se) + m
        idx = lc.long() - off
        inside = (idx >= 0) & (idx < Vl)
        gold = logits.to(torch.bfloat16).gather(
            -1, torch.clamp(idx, 0, Vl - 1)[..., None])[..., 0].float()
        gold = gold * inside
        if vocab:
            gold = mesh.psum(gold, vocab)
        valid = (lc >= 0).float()
        nll = nll + torch.sum((logz - gold) * valid)
        cnt = cnt + torch.sum(valid)
    for a in (shd.batch_axes() if mesh is not None else ()):
        nll, cnt = mesh.psum(nll, a), mesh.psum(cnt, a)
    return nll / torch.clamp(cnt, min=1.0)


def _local_sharding(shd):
    """The mesh-less ``Sharding`` each rank runs a data-parallel body
    under."""
    return type(shd)(None, shd.cfg)


def _enter_params(params, shd):
    return shd.enter_tree(params, shd.param_specs(params))


def _enter_batch(batch, shd):
    return {k: shd.enter(v, shd.spec("batch", *([None] * (v.ndim - 1))))
            for k, v in batch.items()}


def train_loss(params, batch, cfg, shd):
    with shd.region():
        if shd.data_parallel:
            return _train_loss_dp(params, batch, cfg, shd)
        return _train_loss(params, batch, cfg, shd)


def _train_loss_dp(params, batch, cfg, shd):
    """``train_loss`` where no param is sharded (``shd.data_parallel``):
    each rank runs the one-device model on its rows; the loss is the mean
    over every rank's tokens."""
    p = _enter_params(params, shd)
    b = _enter_batch(batch, shd)
    one = _local_sharding(shd)
    h, (lb, z) = backbone(p, embed_inputs(p, b, cfg, one), cfg, one)
    if cfg.frontend == "vision":
        h = h[:, -b["labels"].shape[1]:]
    loss = shd.leave(_lm_mean_local(h, b["labels"], p["unembed"], cfg, shd),
                     ())
    lb, z = (shd.leave(shd.mesh.pmean(a, shd.batch_axes()), ())
             if isinstance(a, torch.Tensor) else a for a in (lb, z))
    return loss + 0.01 * lb + 1e-3 * z, {"ce": loss, "lb": lb, "z": z}


def _train_loss(params, batch, cfg, shd):
    x = embed_inputs(params, batch, cfg, shd)
    h, (lb, z) = backbone(params, x, cfg, shd)
    h = shd.constrain(h, "batch", "seq", None)   # regather seq for loss
    if cfg.frontend == "vision":
        h = h[:, -batch["labels"].shape[1]:]    # loss on text positions
    loss = lm_loss(params, h, batch["labels"], cfg, shd)
    return loss + 0.01 * lb + 1e-3 * z, {"ce": loss, "lb": lb, "z": z}


# ================================================================= serving

def init_cache(cfg, B: int, T: int, dtype=torch.bfloat16, device=None,
               shd=None):
    """Decode cache tree on ``device`` (default: the engine's device); with
    ``shd`` on a mesh of ranks, each rank's shards of it
    (``shd.cache_specs``)."""
    if shd is not None and shd.spmd:
        whole = init_cache(cfg, B, T, dtype, device=shd.mesh.device)
        return shd.mesh.place_tree(whole, shd.cache_specs(whole))
    device = ops.ready_device() if device is None else torch.device(device)
    KV, dh, L = cfg.n_kv_heads, cfg.dh, cfg.n_layers

    def zeros(shape, dt=torch.float32):
        return torch.zeros(shape, dtype=dt, device=device)
    if cfg.family in _TX:
        if cfg.kv_quant:
            return {"k": zeros((L, B, T, KV, dh), torch.int8),
                    "v": zeros((L, B, T, KV, dh), torch.int8),
                    "ks": zeros((L, B, T, KV)),
                    "vs": zeros((L, B, T, KV))}
        return {"k": zeros((L, B, T, KV, dh), dtype),
                "v": zeros((L, B, T, KV, dh), dtype)}
    if cfg.family == "hybrid":
        ng = cfg.n_layers // cfg.attn_every
        return {"conv": zeros((L, B, 3, cfg.d_inner), dtype),
                "ssd": zeros((L, B, cfg.n_ssm_heads, cfg.ssm_state,
                              cfg.ssm_headdim)),
                "attn_k": zeros((ng, B, T, KV, dh), dtype),
                "attn_v": zeros((ng, B, T, KV, dh), dtype)}
    # ssm / xlstm: recurrent states, O(1) in T
    G, period = xlstm_groups(cfg)
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H

    def mstates(*lead):
        return {"C": zeros(lead + (B, H, dh, dh)),
                "n": zeros(lead + (B, H, dh)),
                "m": torch.full(lead + (B, H), -1e30, device=device)}
    if G:
        z = zeros((G, B, d))
        return {"slstm": (z, z + 1e-6, z, z - 1e30),
                "mlstm": mstates(G, period - 1)}
    return {"mlstm": mstates(cfg.n_layers)}


def _cache_len(cache) -> int | None:
    for key in ("k", "attn_k"):
        if key in cache:
            return cache[key].shape[2]
    return None                                      # recurrent state only


def decode_step(params, cache, batch, cfg, shd):
    """One-token decode against a T-long cache.  batch: tokens (B,1),
    pos (B,).  Returns (new_cache, logits (B, V)); the input cache is not
    changed.  A position outside [0, T) raises ConfigError."""
    with shd.region():
        if shd.data_parallel:
            new, logits = _decode_step(
                _enter_params(params, shd),
                shd.enter_tree(cache, shd.cache_specs(cache)),
                _enter_batch(batch, shd), cfg, _local_sharding(shd))
            return (shd.leave_tree(new, shd.cache_specs(new)),
                    shd.leave(logits, shd.spec("batch", None)))
        return _decode_step(params, cache, batch, cfg, shd)


def _decode_step(params, cache, batch, cfg, shd):
    tok, pos = batch["tokens"], batch["pos"]
    T = _cache_len(cache)
    if T is not None:
        check_positions(pos, T)
    x = params["embed"][tok]                         # (B,1,d)
    if cfg.family in _TX:
        keys = ("k", "v", "ks", "vs") if "ks" in cache else ("k", "v")
        new = []
        for i in range(cfg.n_layers):
            lp = _at(params["layers"], i)
            a, nc = attention_block(lp["attn"],
                                    rms_norm(x, lp["ln1"], cfg.norm_eps),
                                    cfg, shd, pos=pos,
                                    cache={c: cache[c][i] for c in keys})
            x = x + a
            hn = rms_norm(x, lp["ln2"], cfg.norm_eps)
            if cfg.family == "moe":
                ff, _ = moe_mod.moe_block(lp["moe"], hn, cfg, shd)
            else:
                ff = mlp_block(lp["mlp"], hn, cfg, shd)
            x = x + ff
            new.append(nc)
        new_cache = _stack(new)
    elif cfg.family == "hybrid":
        k = cfg.attn_every
        sa = params["shared_attn"]
        conv, ssd, ak, av = [], [], [], []
        for g in range(cfg.n_layers // k):
            for j in range(k):
                i = g * k + j
                o, ns = ssm_mod.mamba_block(
                    _at(params["layers"], i), x, cfg, shd,
                    state={"conv": cache["conv"][i], "ssd": cache["ssd"][i]})
                x = x + o
                conv.append(ns["conv"])
                ssd.append(ns["ssd"])
            a, nca = attention_block(sa["attn"],
                                     rms_norm(x, sa["ln1"], cfg.norm_eps),
                                     cfg, shd, pos=pos,
                                     cache={"k": cache["attn_k"][g],
                                            "v": cache["attn_v"][g]})
            x = x + a
            x = x + mlp_block(sa["mlp"], rms_norm(x, sa["ln2"], cfg.norm_eps),
                              cfg, shd)
            ak.append(nca["k"])
            av.append(nca["v"])
        new_cache = {"conv": torch.stack(conv), "ssd": torch.stack(ssd),
                     "attn_k": torch.stack(ak), "attn_v": torch.stack(av)}
    else:                                            # xlstm
        G, period = xlstm_groups(cfg)
        layers = params["layers"]

        def m_one(h, lp, st):
            hn = rms_norm(h, lp["ln"], cfg.norm_eps)
            o, ns = xlstm_mod.mlstm_decode(lp["cell"], hn, cfg, st)
            return h + o, ns
        if G:
            s_new, m_new = [], []
            for g in range(G):
                sp = _at(layers["slstm"], g)
                hn = rms_norm(x, sp["ln"], cfg.norm_eps)
                s2 = xlstm_mod._slstm_cell(sp["cell"], hn[:, 0],
                                           _at(cache["slstm"], g), cfg)
                h_out = rms_norm(s2[2][:, None, :].to(x.dtype),
                                 sp["cell"]["norm_h"], cfg.norm_eps)
                x = x + torch.einsum("bsd,de->bse", h_out,
                                     sp["cell"]["w_out"])
                row = []
                for j in range(period - 1):
                    x, ns = m_one(x, _at(layers["mlstm"], g, j),
                                  _at(cache["mlstm"], g, j))
                    row.append(ns)
                s_new.append(s2)
                m_new.append(_stack(row))
            new_cache = {"slstm": _stack(s_new), "mlstm": _stack(m_new)}
        else:
            m_new = []
            for i in range(cfg.n_layers):
                x, ns = m_one(x, _at(layers["mlstm"], i),
                              _at(cache["mlstm"], i))
                m_new.append(ns)
            new_cache = {"mlstm": _stack(m_new)}
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    V = params["unembed"].shape[1]
    logits = torch.einsum("bsd,dv->bsv", h, params["unembed"])[:, 0]
    return new_cache, logits + _vocab_mask(cfg, V, logits)


def prefill(params, batch, cfg, shd, cache_len: int | None = None):
    """Process a full prompt, filling a decode cache of ``cache_len`` rows
    (default: the prompt's length); returns (cache, last-position
    logits).  On a mesh of ranks the cache is placed by
    ``shd.cache_specs``, as ``decode_step`` reads it."""
    with shd.region():
        if shd.data_parallel:
            cache, logits = _prefill(
                _enter_params(params, shd), _enter_batch(batch, shd), cfg,
                _local_sharding(shd), cache_len)
            return (shd.leave_tree(cache, shd.cache_specs(cache)),
                    shd.leave(logits, shd.spec("batch", None)))
        cache, logits = _prefill(params, batch, cfg, shd, cache_len)
        if shd.spmd:
            cache = shd.constrain_tree(cache, shd.cache_specs(cache))
        return cache, logits


def _prefill(params, batch, cfg, shd, cache_len):
    tok = batch["tokens"]
    B = tok.shape[0]
    x = embed_inputs(params, batch, cfg, shd)
    S = x.shape[1]
    T = cache_len or S
    KV, dh = cfg.n_kv_heads, cfg.dh

    def empty(dtype):
        c = {"k": torch.zeros((B, T, KV, dh), dtype=dtype, device=x.device),
             "v": torch.zeros((B, T, KV, dh), dtype=dtype, device=x.device)}
        if cfg.kv_quant and cfg.family in _TX:
            c["ks"] = torch.zeros((B, T, KV), device=x.device)
            c["vs"] = torch.zeros((B, T, KV), device=x.device)
        return c

    if cfg.family in _TX:
        new = []
        for i in range(cfg.n_layers):
            lp = _at(params["layers"], i)
            hn = rms_norm(x, lp["ln1"], cfg.norm_eps)
            a, nc = attention_block(lp["attn"], hn, cfg, shd,
                                    cache=empty(x.dtype))
            x = x + a
            hn = rms_norm(x, lp["ln2"], cfg.norm_eps)
            if cfg.family == "moe":
                ff, _ = moe_mod.moe_block(lp["moe"], hn, cfg, shd)
            else:
                ff = mlp_block(lp["mlp"], hn, cfg, shd)
            x = x + ff
            new.append(nc)
        cache = _stack(new)
    elif cfg.family == "hybrid":
        k = cfg.attn_every
        sa = params["shared_attn"]
        conv, ssd, ak, av = [], [], [], []
        for g in range(cfg.n_layers // k):
            for j in range(k):
                o, ns = ssm_mod.mamba_block(_at(params["layers"], g * k + j),
                                            x, cfg, shd)
                x = x + o
                conv.append(ns["conv"])
                ssd.append(ns["ssd"])
            hn = rms_norm(x, sa["ln1"], cfg.norm_eps)
            a, nca = attention_block(sa["attn"], hn, cfg, shd,
                                     cache=empty(x.dtype))
            x = x + a
            x = x + mlp_block(sa["mlp"], rms_norm(x, sa["ln2"], cfg.norm_eps),
                              cfg, shd)
            ak.append(nca["k"])
            av.append(nca["v"])
        cache = {"conv": torch.stack(conv), "ssd": torch.stack(ssd),
                 "attn_k": torch.stack(ak), "attn_v": torch.stack(av)}
    else:                                            # xlstm
        G, period = xlstm_groups(cfg)
        layers = params["layers"]

        def m_one(h, lp):
            hn = rms_norm(h, lp["ln"], cfg.norm_eps)
            o = xlstm_mod.mlstm_parallel(lp["cell"], hn, cfg, shd)
            return h + o, xlstm_mod.mlstm_final_state(lp["cell"], hn, cfg)
        if G:
            s_new, m_new = [], []
            for g in range(G):
                sp = _at(layers["slstm"], g)
                hn = rms_norm(x, sp["ln"], cfg.norm_eps)
                o, s_st = xlstm_mod.slstm_block(sp["cell"], hn, cfg, shd)
                x = x + o
                row = []
                for j in range(period - 1):
                    x, st = m_one(x, _at(layers["mlstm"], g, j))
                    row.append(st)
                s_new.append(s_st)
                m_new.append(_stack(row))
            cache = {"slstm": _stack(s_new), "mlstm": _stack(m_new)}
        else:
            m_new = []
            for i in range(cfg.n_layers):
                x, st = m_one(x, _at(layers["mlstm"], i))
                m_new.append(st)
            cache = {"mlstm": _stack(m_new)}
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    V = params["unembed"].shape[1]
    logits = torch.einsum("bd,dv->bv", h[:, -1], params["unembed"])
    return cache, logits + _vocab_mask(cfg, V, logits)


# ========================================================= weights across

def params_from_numpy(tree, device=None):
    """A tree of numpy arrays (the reference's params, for example, taken
    leaf by leaf with ``np.asarray``) as the port's tree of tensors on
    ``device`` (default: the engine's device).  A bfloat16 leaf (numpy
    dtype name ``"bfloat16"``) crosses bit for bit through an int16
    view."""
    device = ops.ready_device() if device is None else torch.device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))
        return t.to(device)
    return tree_map(leaf, tree)


def params_to_numpy(tree):
    """The port's tree of tensors as numpy arrays on the host, bit for bit.
    A bfloat16 leaf comes back under numpy's ``"bfloat16"`` dtype, which
    exists once a numpy extension (ml_dtypes, which JAX loads) has
    registered it; without one it raises ConfigError."""
    def leaf(t):
        t = t.detach().cpu()
        if t.dtype != torch.bfloat16:
            return t.numpy()
        try:
            bf16 = np.dtype("bfloat16")
        except TypeError:
            raise ConfigError("numpy has no bfloat16 dtype in this process "
                              "(load ml_dtypes first)") from None
        return t.view(torch.int16).numpy().view(bf16)
    return tree_map(leaf, tree)


# ================================================================ nn.Module

class _Tree(nn.Module):
    """A tree of dicts of tensors registered as parameters, one submodule
    per dict, so that the names read ``layers.attn.wq``."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Tree(v))
            else:
                self.register_parameter(
                    k, nn.Parameter(v, requires_grad=v.is_floating_point()))

    def as_tree(self) -> dict:
        out = dict(self._parameters)
        out.update({k: m.as_tree() for k, m in self._modules.items()})
        return out


class Decoder(_Tree):
    """The model of one ``ArchConfig`` as an ``nn.Module``: its params tree
    (the reference's keys and stacked layout) registered as parameters
    (``embed``, ``layers.attn.wq``, ...), and the functional entry points
    as methods."""

    def __init__(self, cfg, shd, params: dict):
        super().__init__(params)
        self.cfg = cfg
        self.shd = shd

    def params(self) -> dict:
        return self.as_tree()

    def loss(self, batch):
        return train_loss(self.params(), batch, self.cfg, self.shd)

    def prefill(self, batch, cache_len: int | None = None):
        return prefill(self.params(), batch, self.cfg, self.shd, cache_len)

    def decode_step(self, cache, batch):
        return decode_step(self.params(), cache, batch, self.cfg, self.shd)
