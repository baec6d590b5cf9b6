"""The port of tests/test_archs.py, torch only: every assigned
architecture, at its reduced same-family config, runs one training forward
and backward and one decode step on the CPU with shape and finiteness
checks; plus the port's own checks of the params tree, the nn.Module, remat
and the device."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, smoke
from repro_torch.errors import ConfigError
from repro_torch.kernels import ops
from repro_torch.models import model as M
from repro_torch.shardings import Sharding
from torch_model_parity import torch_one_thread  # noqa: F401 (autouse)

B, S = 2, 64


@pytest.fixture(autouse=True)
def _cpu():
    prev = ops.device()
    ops.set_device("cpu")
    try:
        yield
    finally:
        ops.set_device(prev)


def _batch(sc, gen):
    toks = torch.randint(0, sc.vocab, (B, S), generator=gen,
                         dtype=torch.int32)
    batch = {"tokens": toks, "labels": toks}
    if sc.frontend == "vision":
        batch["tokens"] = toks[:, :S - sc.n_patches]
        batch["labels"] = batch["tokens"]
        batch["patch_embeds"] = torch.ones((B, sc.n_patches, sc.d_model),
                                           dtype=torch.bfloat16)
    return batch


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_arch_smoke(arch):
    sc = smoke(ARCHS[arch])
    shd = Sharding(None, sc)
    gen = torch.Generator().manual_seed(0)
    params = M.init_params(sc, gen, shards=4)
    batch = _batch(sc, gen)

    flat = []
    M.tree_map(flat.append, params)
    for t in flat:
        t.requires_grad_(t.is_floating_point())
    loss, metrics = M.train_loss(params, batch, sc, shd)
    assert np.isfinite(loss.item())
    assert 0 < loss.item() < 2 * np.log(sc.vocab)
    loss.backward()
    gn = sum(float(torch.sum(t.grad.float() ** 2)) for t in flat
             if t.grad is not None)
    assert np.isfinite(gn) and gn > 0

    with torch.no_grad():
        cache = M.init_cache(sc, B, S)
        dec = {"tokens": batch["tokens"][:, :1],
               "pos": torch.zeros((B,), dtype=torch.int32)}
        nc, logits = M.decode_step(params, cache, dec, sc, shd)
    V = M.padded_vocab(sc, 4)
    assert logits.shape == (B, V)
    assert torch.isfinite(logits.float()).all()
    # padded vocab entries must never win sampling
    assert int(torch.argmax(logits.float(), -1).max()) < sc.vocab


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "zamba2-2.7b",
                                  "xlstm-125m"])
def test_prefill_decode_consistency(arch):
    """Greedy continuation after prefill is finite and in-vocab.  For the
    attention and Mamba stacks the decode logits at position S also equal
    prefill's over S + 1 tokens.  xLSTM is exempt, as in the reference: its
    parallel form (prefill) exponentiates q.k inside the softmax-style
    block, its recurrent form (decode) does not, so the two differ (1.6 in
    the reference's logits at this size; ROADMAP, faults section)."""
    sc = smoke(ARCHS[arch])
    shd = Sharding(None, sc)
    gen = torch.Generator().manual_seed(1)
    params = M.tree_map(lambda t: t.float(),
                        M.init_params(sc, gen, shards=4))
    toks = torch.randint(0, sc.vocab, (B, S + 1), generator=gen,
                         dtype=torch.int32)
    with torch.no_grad():
        cache, logits = M.prefill(params, {"tokens": toks[:, :S]}, sc, shd,
                                  cache_len=S + 1)
        assert torch.isfinite(logits).all()
        _, step = M.decode_step(params, cache, {
            "tokens": toks[:, S:], "pos": torch.full((B,), S,
                                                     dtype=torch.int32)},
            sc, shd)
        _, full = M.prefill(params, {"tokens": toks}, sc, shd)
    assert torch.isfinite(step).all()
    assert int(torch.argmax(step, -1).max()) < sc.vocab
    if arch != "xlstm-125m":
        assert float((step - full).abs().max()) <= 1e-4


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_init_params_tree_equals_the_reference(arch):
    """Keys, shapes and dtypes of every leaf, against jax.eval_shape of the
    reference's init_params (no compile, no allocation)."""
    from repro.configs import ARCHS as R_ARCHS, smoke as r_smoke
    from repro.models import model as RM

    rsc = r_smoke(R_ARCHS[arch])
    ref = jax.eval_shape(lambda k: RM.init_params(rsc, k, shards=4),
                         jax.random.PRNGKey(0))
    got = M.init_params(smoke(ARCHS[arch]), torch.Generator().manual_seed(0),
                        shards=4)

    def flat(tree, pre=""):
        if isinstance(tree, dict):
            return {p: v for k in tree for p, v in flat(tree[k],
                                                        f"{pre}/{k}").items()}
        return {pre: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}
    assert flat(got) == flat(ref)


def test_decoder_registers_the_tree_as_parameters():
    sc = smoke(ARCHS["tinyllama-1.1b"])
    params = M.init_params(sc, torch.Generator().manual_seed(2), shards=4)
    dec = M.Decoder(sc, Sharding(None, sc), params)
    names = dict(dec.named_parameters())
    assert "layers.attn.wq" in names and "embed" in names
    assert names["layers.attn.wq"].shape == params["layers"]["attn"]["wq"].shape
    toks = torch.randint(0, sc.vocab, (B, 16), generator=torch.Generator())
    batch = {"tokens": toks, "labels": toks}
    loss, _ = dec.loss(batch)
    want, _ = M.train_loss(params, batch, sc, Sharding(None, sc))
    assert loss.item() == want.item()
    loss.backward()
    assert dec.layers.attn.wq.grad is not None
    with torch.no_grad():
        cache, logits = dec.prefill({"tokens": toks}, cache_len=17)
        _, step = dec.decode_step(cache, {"tokens": toks[:, :1],
                                          "pos": torch.full((B,), 16)})
    assert step.shape == logits.shape


def test_remat_leaves_loss_and_gradients_unchanged():
    sc = smoke(ARCHS["deepseek-moe-16b"])
    params = M.tree_map(lambda t: t.float(), M.init_params(
        sc, torch.Generator().manual_seed(3), shards=4))
    toks = torch.randint(0, sc.vocab, (B, 16), generator=torch.Generator())
    batch = {"tokens": toks, "labels": toks}
    out = []
    for remat in (True, False):
        cfg = dataclasses.replace(sc, remat=remat)
        p = M.tree_map(lambda t: t.clone().requires_grad_(), params)
        loss, _ = M.train_loss(p, batch, cfg, Sharding(None, cfg))
        loss.backward()
        flat = []
        M.tree_map(lambda t: flat.append(t.grad), p)
        out.append((float(loss), flat))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_cuda_default_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ops.set_device("cuda")
    sc = smoke(ARCHS["tinyllama-1.1b"])
    with pytest.raises(ConfigError):
        M.init_params(sc, torch.Generator().manual_seed(0))
    with pytest.raises(ConfigError):
        M.init_cache(sc, 1, 8)
    with pytest.raises(ConfigError):
        M.params_from_numpy({"w": np.zeros(2, np.float32)})


def test_params_round_trip_through_numpy():
    import ml_dtypes  # noqa: F401  (registers numpy's bfloat16)
    sc = smoke(ARCHS["xlstm-125m"])
    params = M.init_params(sc, torch.Generator().manual_seed(4), shards=4)
    back = M.params_from_numpy(M.params_to_numpy(params), device="cpu")
    flat_a, flat_b = [], []
    M.tree_map(flat_a.append, params)
    M.tree_map(flat_b.append, back)
    assert all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(flat_a, flat_b))


def test_model_phase_rehearsal_on_the_cpu():
    """Phase 8 of chip_smoke.py on the CPU at smoke widths and small
    shapes: every check of the phase holds."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    tl = smoke(ARCHS["tinyllama-1.1b"])

    def cut(cfg):
        return smoke(cfg) if cfg.family == "ssm" else \
            chip_smoke.depth_cut(smoke(cfg))
    out = chip_smoke.model_path(
        torch.device("cpu"), make_cfg=cut, serve_cfg=tl,
        wide=dict(B=2, S=16, decodes=3), serve=dict(B=2, S=16, gen=4),
        train=dict(B=1, S=64), attn_shapes=((2, 64, 4, 32),))
    assert set(out["smoke"]) == set(ARCHS)
    assert all(r["err_f32"] <= chip_smoke.SMOKE_F32_TOL
               for r in out["smoke"].values())
    assert set(out["full_width"]) == set(ARCHS)
    assert out["serve"]["decode_tok_s"] > 0
    assert out["train"]["grad_norm"] > 0
    assert set(out["examples"]) == set(chip_smoke.EXAMPLES)
    assert all(r["lines"] >= 4 for r in out["examples"].values())
