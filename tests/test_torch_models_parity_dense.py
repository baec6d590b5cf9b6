"""The port's transformer families (dense, audio, vlm) against the JAX
reference at float32 on carried weights: the layers, every such smoke arch
end to end (loss, prefill, three decode steps), tinyllama's gradients and
one native-bfloat16 tinyllama run.  Tolerances: tests/torch_model_parity.py
and each test below."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as L
from repro.models import model as M
from repro.shardings import Sharding
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.shardings import Sharding as TSharding
from torch_model_parity import (B, S, carried, check_model, flatten, jbatch,
                                make_batch, max_abs, tbatch)
from torch_model_parity import torch_one_thread  # noqa: F401 (autouse)

ARCHS = ["tinyllama-1.1b", "internlm2-1.8b", "qwen2-7b", "qwen1.5-110b",
         "musicgen-large", "internvl2-2b"]
LAYER_TOL = 1e-5        # one op or one block loop at float32


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_rms_norm_and_rope():
    rng = np.random.default_rng(0)
    x, w = _rand(rng, 2, 8, 4, 16), _rand(rng, 16)
    assert max_abs(L.rms_norm(jnp.asarray(x), jnp.asarray(w)),
                   TL.rms_norm(torch.from_numpy(x), torch.from_numpy(w))
                   ) <= LAYER_TOL
    pos = rng.integers(0, 4096, (2, 8)).astype(np.int32)
    assert max_abs(L.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4),
                   TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                 1e4)) <= 1e-4     # angles up to 4096 rad


@pytest.mark.parametrize("mode", ["plain", "decay", "decay_mlstm_norm"])
def test_flash_attention_blocks(mode):
    """nq = 4 query blocks, nk = 2 KV blocks."""
    rng = np.random.default_rng(1)
    q, k, v = (_rand(rng, 2, 64, 3, 16) for _ in range(3))
    kw = dict(causal=True, q_block=16, kv_block=32)
    if mode != "plain":
        f = np.cumsum(np.log(1 / (1 + np.exp(-_rand(rng, 2, 64, 3)))), 1)
        ig = _rand(rng, 2, 64, 3)
        kw["decay"] = (f.astype(np.float32), ig)
        kw["softmax_scale"] = 0.25
        kw["mlstm_norm"] = mode == "decay_mlstm_norm"
    jkw = dict(kw, decay=tuple(map(jnp.asarray, kw["decay"]))) \
        if "decay" in kw else kw
    tkw = dict(kw, decay=tuple(map(torch.from_numpy, kw["decay"]))) \
        if "decay" in kw else kw
    ref = L.flash_attention(*map(jnp.asarray, (q, k, v)), **jkw)
    got = TL.flash_attention(*map(torch.from_numpy, (q, k, v)), **tkw)
    assert max_abs(ref, got) <= LAYER_TOL
    assert max_abs(TL.blocked_attention(*map(torch.from_numpy, (q, k, v)),
                                        **tkw), got) == 0.0


def test_flash_attention_block_shapes_are_typed_errors():
    from repro_torch.errors import ConfigError
    x = torch.zeros(1, 48, 1, 8)
    with pytest.raises(ConfigError):
        TL.flash_attention(x, x, x, q_block=32)     # 48 % 32 != 0


def test_quantize_kv():
    rng = np.random.default_rng(2)
    x = _rand(rng, 2, 16, 4, 32) * 3
    x[0, 0, 0] = 0.0                                  # the 1e-8 scale floor
    qr, sr = L.quantize_kv(jnp.asarray(x))
    qp, sp = TL.quantize_kv(torch.from_numpy(x))
    assert qp.dtype == torch.int8 and sp.dtype == torch.float32
    assert max_abs(sr, sp) <= 1e-7 and float(sp[0, 0, 0]) == np.float32(1e-8)
    assert max_abs(qr, qp) <= 1                       # one quantum
    assert max_abs(L.dequantize_kv(qr, sr), TL.dequantize_kv(qp, sp)) <= \
        float(sp.max()) + 1e-6


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "musicgen-large"])
def test_mlp_block(arch):
    """swiglu (tinyllama) and tanh-approximated gelu (musicgen)."""
    sc, tc, p, tp = carried(arch)
    x = _rand(np.random.default_rng(3), B, 8, sc.d_model)
    lp = jax.tree.map(lambda a: a[0], p["layers"]["mlp"])
    tlp = {k: v[0] for k, v in tp["layers"]["mlp"].items()}
    assert max_abs(L.mlp_block(lp, jnp.asarray(x), sc, Sharding(None, sc)),
                   TL.mlp_block(tlp, torch.from_numpy(x), tc,
                                TSharding(None, tc))) <= LAYER_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_model_matches_the_reference(arch):
    check_model(arch)


def test_tinyllama_gradients_match_jax_grad():
    """jax.grad against autograd of train_loss, leaf by leaf; tolerance
    1e-3 x the leaf's largest |grad| (the bf16-rounded gold logit moves a
    loss term by a bf16 step, which the gradient does not see, so the
    gradients agree to float32 contraction order)."""
    sc, tc, p, tp = carried("tinyllama-1.1b")
    batch = make_batch(sc)
    g = jax.jit(jax.grad(lambda p, b: M.train_loss(
        p, b, sc, Sharding(None, sc))[0]))(p, jbatch(batch))
    tp = {k: v for k, v in tp.items()}
    leaves = [t for _, t in flatten(tp)]
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = TM.train_loss(tp, tbatch(batch), tc, TSharding(None, tc))
    loss.backward()
    ref = dict(flatten(g))
    got = {path: t.grad for path, t in flatten(tp)}
    assert sorted(ref) == sorted(got)
    for path in ref:
        r = np.asarray(ref[path])
        scale = float(np.max(np.abs(r)))
        assert scale > 0, path
        assert max_abs(r, got[path]) <= 1e-3 * scale, path


def test_tinyllama_native_bfloat16():
    """The reference's bf16 params as it inits them, both packages
    computing in bf16: logits within 3e-2 x max|logit| (a few bf16 steps
    of the largest logit), the loss within 3e-2."""
    sc, tc, p, tp = carried("tinyllama-1.1b", fp32=False)
    assert tp["embed"].dtype == torch.bfloat16
    shd, tsd = Sharding(None, sc), TSharding(None, tc)
    batch = make_batch(sc)
    loss, _ = M.train_loss(p, jbatch(batch), sc, shd)
    with torch.no_grad():
        tloss, _ = TM.train_loss(tp, tbatch(batch), tc, tsd)
    assert abs(float(loss) - float(tloss)) <= 3e-2
    pb = {"tokens": batch["tokens"]}
    cache, logits = M.prefill(p, jbatch(pb), sc, shd, cache_len=S + 2)
    with torch.no_grad():
        tcache, tlogits = TM.prefill(tp, tbatch(pb), tc, tsd, cache_len=S + 2)
    assert tlogits.dtype == torch.bfloat16 and logits.dtype == jnp.bfloat16
    bound = 3e-2 * float(jnp.max(jnp.abs(logits.astype(jnp.float32))))
    assert max_abs(logits.astype(jnp.float32), tlogits.float()) <= bound
    tok = np.asarray(jnp.argmax(logits, -1)[:, None].astype(jnp.int32))
    pos = np.full((B,), S, np.int32)
    _, logits = M.decode_step(p, cache, {"tokens": jnp.asarray(tok),
                                         "pos": jnp.asarray(pos)}, sc, shd)
    with torch.no_grad():
        _, tlogits = TM.decode_step(tp, tcache, tbatch(
            {"tokens": tok, "pos": pos}), tc, tsd)
    assert max_abs(logits.astype(jnp.float32), tlogits.float()) <= bound
    assert math.isfinite(float(tloss))
