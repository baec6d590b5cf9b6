"""The port's training loop (repro_torch.train) against the JAX package's
(repro.train) on the CPU, on the same inputs made with numpy: the LR
schedule, SyntheticLM's batches, apply_adamw on seeded params and grads,
and one make_train_step on the reference's train state carried across by
``state_from_numpy`` (microbatch 1 and 4; a dense and an MoE arch).

Tolerances:
  * schedule: float32, relative 1e-6, and 1e-6 x the peak lr absolute
    (both evaluate the same float32 expression; cos may differ in its
    last bit, which 1 + cos magnifies where the cosine ends near -1).
  * SyntheticLM: byte-identical (the same numpy generator).
  * apply_adamw: master, mu and nu within ADAM_ULPS float32 ulps of the
    reference's value (XLA may contract a multiply and an add into one
    rounding where torch rounds twice, and the global norm sums in another
    order), plus ADAM_ULPS ulps of the leaf's largest value for entries
    near 0; bfloat16 params and moments within one bfloat16 ulp of the
    value (a float32 master an ulp apart can round to the neighbouring
    bfloat16).
  * make_train_step, on float32 state (params cast to float32): loss and
    its metrics within LOSS_TOL (tests/torch_model_parity.py); gnorm and
    lr relative 1e-5; master: every entry within 2.05 x lr of the
    reference's (the whole of one Adam step: at step 1 an entry moves by
    lr x g/|g|, so an entry whose gradient is at rounding level may step
    the other way) and at most 1e-3 of the entries more than 1e-3 x lr
    away (a wrong decay, bias correction or clip moves nearly all of
    them; measured: at most 1.2e-4 of them, and 0.074 x lr at most).
    On the reference's bfloat16 state, where bfloat16 activations turn ~1%
    of the step-1 directions, only the loss (LOSS_TOL), gnorm (relative
    1e-3) and lr, and params == master cast to bfloat16 in both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, smoke
from repro.shardings import Sharding
from repro.train import (AdamWConfig as RAdamWConfig, init_train_state as
                         r_init_train_state, make_train_step as
                         r_make_train_step, schedule as r_schedule)
from repro.train.adamw import apply_adamw as r_apply_adamw
from repro.train.adamw import init_opt_state as r_init_opt_state
from repro.train.data import SyntheticLM as RSyntheticLM
from repro.train.step import make_eval_step as r_make_eval_step
from repro_torch.ckpt.store import _leaf_paths
from repro_torch.configs import ARCHS as T_ARCHS, smoke as t_smoke
from repro_torch.kernels import ops
from repro_torch.shardings import Sharding as TSharding
from repro_torch.train import (AdamWConfig, SyntheticLM, apply_adamw,
                               init_opt_state, make_train_step, schedule,
                               shard_batch)
from repro_torch.train.step import make_eval_step, state_from_numpy
from torch_model_parity import LOSS_TOL, as_numpy
from torch_threads import torch_one_thread  # noqa: F401 (autouse)

ADAM_ULPS = 8
F32_ULP = 2.0 ** -23
BF16_ULP = 2.0 ** -7


@pytest.fixture(autouse=True)
def _cpu():
    prev = ops.device()
    ops.set_device("cpu")
    try:
        yield
    finally:
        ops.set_device(prev)


def np_tree(tree):
    """A JAX tree as numpy arrays (bfloat16 kept as numpy's bfloat16)."""
    return jax.tree.map(np.asarray, tree)


def close_ulps(got, want, ulp: float, n: int = 1) -> None:
    """|got - want| <= n ulps of want, plus n ulps of the leaf's largest
    |want| (for entries near 0)."""
    want = np.asarray(want, np.float64)
    top = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               rtol=n * ulp, atol=n * ulp * top)


# ------------------------------------------------------------- schedule

@pytest.mark.parametrize("kw", [
    {}, {"lr": 1.0, "warmup_steps": 10, "total_steps": 100},
    {"lr": 3e-3, "warmup_steps": 0, "total_steps": 60, "min_lr_frac": 0.0}])
def test_schedule_matches_the_reference(kw):
    steps = np.arange(0, 121, dtype=np.int32)
    want = np.asarray([float(r_schedule(RAdamWConfig(**kw), jnp.asarray(s)))
                       for s in steps], np.float32)
    got = schedule(AdamWConfig(**kw), torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * AdamWConfig(**kw).lr)


# ------------------------------------------------------------ SyntheticLM

@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "internvl2-2b"])
def test_synthetic_batches_are_byte_identical(arch):
    sc = smoke(ARCHS[arch])
    kw = dict(frontend=sc.frontend, n_patches=sc.n_patches,
              d_model=sc.d_model)
    ref = RSyntheticLM(sc.vocab, 48, 4, seed=7, **kw)
    port = SyntheticLM(sc.vocab, 48, 4, seed=7, **kw)
    for step in (0, 1, 17, 2 ** 31 + 5):
        want, got = ref.batch_at(step), port.batch_at(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert got[k].shape == want[k].shape
            assert got[k].tobytes() == want[k].tobytes()
    if sc.frontend == "vision":
        assert port.batch_at(0)["patch_embeds"].shape == (4, 16, 128)


def test_shard_batch_keeps_the_bytes():
    b = SyntheticLM(512, 16, 2).batch_at(3)
    got = shard_batch(b)
    for k, v in b.items():
        assert got[k].device.type == "cpu"
        assert got[k].numpy().tobytes() == np.ascontiguousarray(v).tobytes()


# ------------------------------------------------------------- apply_adamw

def seeded_params(rng):
    bf16 = np.dtype("bfloat16")
    return {"w": (rng.standard_normal((8, 16)) * 0.02).astype(bf16),
            "b": np.ones(16, np.float32),
            "layers": {"k": (rng.standard_normal((2, 8, 4)) * 0.02)
                       .astype(bf16),
                       "ln": (1 + rng.standard_normal((2, 8)) * 0.02)
                       .astype(np.float32)}}


def seeded_grads(rng, params, scale):
    return jax.tree.map(lambda p: (rng.standard_normal(p.shape) * scale)
                        .astype(p.dtype), params)


@pytest.mark.parametrize("moments", ["f32", "bf16"])
@pytest.mark.parametrize("scale", [1e-3, 10.0])     # clip off / clip on
def test_apply_adamw_matches_the_reference(moments, scale):
    rng = np.random.default_rng(11)
    params = seeded_params(rng)
    opt = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    r_p = jax.tree.map(jnp.asarray, params)
    r_s = r_init_opt_state(r_p, moments)
    t_p = state_from_numpy(params, device="cpu")
    t_s = init_opt_state(t_p, moments)
    for _ in range(3):
        g = seeded_grads(rng, params, scale)
        r_p, r_s, r_m = r_apply_adamw(RAdamWConfig(**opt), r_p, r_s,
                                      jax.tree.map(jnp.asarray, g))
        t_p, t_s, t_m = apply_adamw(AdamWConfig(**opt), t_p, t_s,
                                    state_from_numpy(g, device="cpu"))
    np.testing.assert_allclose(float(t_m["lr"]), float(r_m["lr"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(t_m["gnorm"]), float(r_m["gnorm"]),
                               rtol=ADAM_ULPS * F32_ULP)
    assert int(t_s["step"]) == int(r_s["step"]) == 3
    want, got = as_numpy(r_s), as_numpy(t_s)
    for path in want:
        if path == "/step":
            continue
        if moments == "bf16" and path.split("/")[1] in ("mu", "nu"):
            close_ulps(got[path], want[path], BF16_ULP)
        else:
            close_ulps(got[path], want[path], F32_ULP, ADAM_ULPS)
    want, got = as_numpy(r_p), as_numpy(t_p)
    for path in want:
        if params_dtype(params, path) == "bfloat16":
            close_ulps(got[path], want[path], BF16_ULP)
        else:
            close_ulps(got[path], want[path], F32_ULP, ADAM_ULPS)


def params_dtype(params, path: str) -> str:
    node = params
    for k in path.strip("/").split("/"):
        node = node[k]
    return node.dtype.name


def test_apply_adamw_is_pure():
    rng = np.random.default_rng(3)
    params = state_from_numpy(seeded_params(rng), device="cpu")
    state = init_opt_state(params)
    grads = state_from_numpy(seeded_grads(rng, seeded_params(rng), 1.0),
                             device="cpu")
    before = [x.clone() for _, x in _leaf_paths((params, state, grads))]
    new_p, new_s, _ = apply_adamw(AdamWConfig(lr=1e-2, warmup_steps=1),
                                  params, state, grads)
    after = [x for _, x in _leaf_paths((params, state, grads))]
    assert len(after) == len(before) == 21
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    # the new params never alias the new master weights
    assert new_p["b"].data_ptr() != new_s["master"]["b"].data_ptr()
    assert torch.equal(new_p["b"], new_s["master"]["b"])


# --------------------------------------------------------- make_train_step

CASES = {"tinyllama-mb1": ("tinyllama-1.1b", 1, True),
         "tinyllama-mb4": ("tinyllama-1.1b", 4, True),
         "olmoe-mb1": ("olmoe-1b-7b", 1, True),
         "olmoe-mb4": ("olmoe-1b-7b", 4, True),
         "tinyllama-bf16": ("tinyllama-1.1b", 1, False)}
OPT = dict(lr=1e-3, warmup_steps=1)


@pytest.fixture(scope="module")
def reference():
    """One reference train step per case, each compiled once for the
    module: (numpy state before, numpy batch, state after, metrics)."""
    cache = {}

    def run(case):
        if case not in cache:
            arch, mb, fp32 = CASES[case]
            sc = smoke(ARCHS[arch])
            st = r_init_train_state(sc, jax.random.PRNGKey(0), shards=4)
            if fp32:
                st = {"params": jax.tree.map(
                    lambda a: a.astype(jnp.float32), st["params"]),
                    "opt": st["opt"]}
            b = RSyntheticLM(sc.vocab, 32, 8).batch_at(0)
            fn = jax.jit(r_make_train_step(sc, Sharding(None, sc),
                                           RAdamWConfig(**OPT),
                                           microbatch=mb))
            s1, m1 = fn(st, {k: jnp.asarray(v) for k, v in b.items()})
            cache[case] = (np_tree(st), b, np_tree(s1),
                           {k: float(v) for k, v in m1.items()})
        return cache[case]
    return run


def port_step(case, st, b):
    arch, mb, _ = CASES[case]
    tc = t_smoke(T_ARCHS[arch])
    fn = make_train_step(tc, TSharding(None, tc), AdamWConfig(**OPT),
                         microbatch=mb)
    return fn(state_from_numpy(st, device="cpu"), shard_batch(b))


@pytest.mark.parametrize("case", [c for c in CASES if CASES[c][2]])
def test_train_step_matches_the_reference(reference, case):
    st, b, want_state, want = reference(case)
    got_state, got = port_step(case, st, b)
    assert sorted(got) == sorted(want)
    for k in ("loss", "ce", "lb", "z"):
        assert abs(float(got[k]) - want[k]) <= LOSS_TOL, (k, got[k], want[k])
    np.testing.assert_allclose(float(got["gnorm"]), want["gnorm"], rtol=1e-5)
    np.testing.assert_allclose(float(got["lr"]), want["lr"], rtol=1e-5)
    lr = want["lr"]
    r, p = as_numpy(want_state), as_numpy(got_state)
    assert sorted(r) == sorted(p)
    assert int(p["/opt/step"]) == int(r["/opt/step"]) == 1
    for path in r:
        if not path.startswith("/opt/master") and \
                not path.startswith("/params"):
            continue
        d = np.abs(p[path].astype(np.float64) - r[path])
        assert d.max() <= 2.05 * lr, (path, d.max() / lr)
        assert np.mean(d > 1e-3 * lr) <= 1e-3, (path, np.mean(d > 1e-3 * lr))


def test_train_step_on_the_bfloat16_state(reference):
    st, b, want_state, want = reference("tinyllama-bf16")
    got_state, got = port_step("tinyllama-bf16", st, b)
    assert abs(float(got["loss"]) - want["loss"]) <= LOSS_TOL
    np.testing.assert_allclose(float(got["gnorm"]), want["gnorm"], rtol=1e-3)
    np.testing.assert_allclose(float(got["lr"]), want["lr"], rtol=1e-5)
    want_leaves = jax.tree_util.tree_flatten_with_path(want_state)[0]
    got_leaves = _leaf_paths(got_state)
    assert len(got_leaves) == len(want_leaves)
    for (name, t), (_, a) in zip(got_leaves, want_leaves):
        assert str(t.dtype).replace("torch.", "") == np.asarray(a).dtype.name
        assert tuple(t.shape) == np.asarray(a).shape, name
    for tree in (got_state, state_from_numpy(want_state, device="cpu")):
        params = dict(_leaf_paths(tree["params"]))
        for name, m in _leaf_paths(tree["opt"]["master"]):
            assert torch.equal(params[name], m.to(params[name].dtype)), name


def test_eval_step_matches_the_reference(reference):
    st, b, _, _ = reference("tinyllama-mb1")
    sc, tc = smoke(ARCHS["tinyllama-1.1b"]), t_smoke(T_ARCHS["tinyllama-1.1b"])
    want = r_make_eval_step(sc, Sharding(None, sc))(
        jax.tree.map(jnp.asarray, st["params"]),
        {k: jnp.asarray(v) for k, v in b.items()})
    got = make_eval_step(tc, TSharding(None, tc))(
        state_from_numpy(st, device="cpu")["params"], shard_batch(b))
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= LOSS_TOL, k


def test_state_from_numpy_carries_the_whole_state_bit_for_bit(reference):
    st, _, _, _ = reference("tinyllama-bf16")
    t = state_from_numpy(st, device="cpu")
    want = jax.tree_util.tree_flatten_with_path(st)[0]
    got = _leaf_paths(t)
    assert [n for n, _ in got] == [
        "/".join(str(getattr(k, "key", k)) for k in path)
        for path, _ in want]
    for (_, x), (_, a) in zip(got, want):
        a = np.asarray(a)
        raw = x.reshape(-1).view(torch.uint8).numpy().tobytes()
        assert raw == np.ascontiguousarray(a).tobytes()
    assert t["opt"]["step"].dtype == torch.int32
    assert t["opt"]["master"]["embed"].dtype == torch.float32
    assert t["params"]["embed"].dtype == torch.bfloat16
