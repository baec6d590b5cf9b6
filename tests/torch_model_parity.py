"""Shared harness of the model parity tests
(tests/test_torch_models_parity_*.py): the JAX reference and the PyTorch port on the same inputs and the same
weights, carried across as numpy arrays.

Tolerances, at float32 on both sides (params cast to float32):
  * LOGIT_TOL 1e-3 abs on logits and caches: the two packages contract in
    different orders (XLA's einsum against torch's), which moves float32
    results by ~1e-5 at these sizes; 1e-3 leaves room for the longer sums
    of the MoE and Mamba paths and stays far below a changed token.
  * LOSS_TOL 2e-3 on the loss and its metrics: the gold logit is rounded
    to bfloat16 in both packages, so a logit that differs by 1e-5 can round
    to a neighbouring bfloat16 value.
  * int8 KV caches (kv_quant) are compared dequantized, within one quantum
    (the row's scale) plus LOGIT_TOL: a float32 difference can move a value
    across .5 before rounding.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import ARCHS, smoke
from repro.models import model as M
from repro.shardings import Sharding
from repro_torch.configs import ARCHS as T_ARCHS, smoke as t_smoke
from repro_torch.models import model as TM
from repro_torch.shardings import Sharding as TSharding
from torch_threads import torch_one_thread  # noqa: F401 (re-exported)

B, S, DECODES = 2, 32, 3
LOGIT_TOL = 1e-3
LOSS_TOL = 2e-3


def flatten(tree, prefix=""):
    """(path, leaf) pairs of a tree of dicts/lists/tuples, keys sorted."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in flatten(tree[k],
                                                           f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in flatten(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def as_numpy(tree):
    """Leaves of a JAX or torch tree as float64/int numpy arrays."""
    def leaf(a):
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu()
            a = a.float() if a.dtype == torch.bfloat16 else a
            return a.numpy()
        a = np.asarray(a)
        return a.astype(np.float32) if a.dtype.name == "bfloat16" else a
    return {p: leaf(a) for p, a in flatten(tree)}


def carried(arch: str, seed: int = 0, fp32: bool = True):
    """(ref cfg, port cfg, reference params, port params): the reference's
    smoke params (shards=4), cast to float32 when ``fp32``, carried into
    the port on the CPU."""
    sc, tc = smoke(ARCHS[arch]), t_smoke(T_ARCHS[arch])
    p = M.init_params(sc, jax.random.PRNGKey(seed), shards=4)
    if fp32:
        p = jax.tree.map(lambda a: a.astype(jnp.float32), p)
    tp = TM.params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")
    return sc, tc, p, tp


def make_batch(sc, seed: int = 1) -> dict:
    """Numpy tokens (and the VLM's patch embeddings), S positions in all."""
    rng = np.random.default_rng(seed)
    st = S - sc.n_patches if sc.frontend == "vision" else S
    toks = rng.integers(0, sc.vocab, (B, st)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks}
    if sc.frontend == "vision":
        batch["patch_embeds"] = rng.standard_normal(
            (B, sc.n_patches, sc.d_model)).astype(np.float32)
    return batch


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tbatch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def max_abs(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b))) if a.size else 0.0


def assert_caches_close(ref, port, tol=LOGIT_TOL):
    r, p = as_numpy(ref), as_numpy(port)
    assert sorted(r) == sorted(p)
    for path in r:
        if r[path].dtype == np.int8:
            # compare dequantized, within one quantum (the row's scale)
            scale = path + "s"                     # k -> ks, v -> vs
            deq_r = r[path] * r[scale][..., None]
            deq_p = p[path] * p[scale][..., None]
            quantum = np.maximum(r[scale], p[scale])[..., None]
            assert p[path].dtype == np.int8, path
            assert np.all(np.abs(deq_r - deq_p) <= quantum + tol), path
        else:
            assert max_abs(r[path], p[path]) <= tol, (path, max_abs(
                r[path], p[path]))


def check_model(arch: str):
    """train_loss and its metrics, prefill logits and cache, then DECODES
    decode steps of logits and cache: the reference against the port on
    carried float32 weights."""
    sc, tc, p, tp = carried(arch)
    shd, tsd = Sharding(None, sc), TSharding(None, tc)
    batch = make_batch(sc)
    loss, met = jax.jit(lambda p, b: M.train_loss(p, b, sc, shd))(
        p, jbatch(batch))
    with torch.no_grad():
        tloss, tmet = TM.train_loss(tp, tbatch(batch), tc, tsd)
    assert abs(float(loss) - float(tloss)) <= LOSS_TOL
    for k in ("ce", "lb", "z"):
        assert abs(float(met[k]) - float(tmet[k])) <= LOSS_TOL, k

    T = S + DECODES + 1
    pb = {k: v for k, v in batch.items() if k != "labels"}
    cache, logits = jax.jit(
        lambda p, b: M.prefill(p, b, sc, shd, cache_len=T))(p, jbatch(pb))
    with torch.no_grad():
        tcache, tlogits = TM.prefill(tp, tbatch(pb), tc, tsd, cache_len=T)
    assert str(tlogits.dtype).split(".")[-1] == str(logits.dtype)
    assert max_abs(logits, tlogits) <= LOGIT_TOL
    assert_caches_close(cache, tcache)

    step = jax.jit(lambda p, c, b: M.decode_step(p, c, b, sc, shd))
    tok = np.asarray(jnp.argmax(logits, -1)[:, None].astype(jnp.int32))
    for i in range(DECODES):
        pos = np.full((B,), S + i, np.int32)
        cache, logits = step(p, cache, {"tokens": jnp.asarray(tok),
                                        "pos": jnp.asarray(pos)})
        with torch.no_grad():
            tcache, tlogits = TM.decode_step(
                tp, tcache, tbatch({"tokens": tok, "pos": pos}), tc, tsd)
        assert max_abs(logits, tlogits) <= LOGIT_TOL, i
        assert_caches_close(cache, tcache)
        tok = np.asarray(jnp.argmax(logits, -1)[:, None].astype(jnp.int32))
