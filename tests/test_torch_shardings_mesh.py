"""The port's meshes and the mesh paths of its shardings against the JAX
reference.

  * Spec parity, exact, for all ten archs: on stand-ins for the 16x16 and
    2x16x16 production meshes (``repro.shardings.Sharding`` reads only
    ``axis_names`` and ``shape``, so a ``SimpleNamespace`` serves the
    reference and no device is needed) and on ``make_mesh_for(1)``: the
    rules, tp, dp_size, batch_uses_model and padded_vocab, then
    param_specs (the reference's on ``jax.eval_shape`` params, the port's
    on meta params), state_specs, batch_specs and cache_specs.
  * ``make_mesh_for(n)``'s shape for n in 1..64 (the reference's real call
    only at n = 1; above it ``jax.make_mesh`` is replaced by a recorder).
  * On the CPU, every smoke arch's prefill and decode on the reference's
    ``make_mesh_for(1)`` against the port's one-device mesh, within
    tests/torch_model_parity.py's tolerances (the MoE archs go through
    both packages' ``moe_shard_map``), and bit for bit against the port's
    mesh-less path; one train step of an MoE smoke arch on the mesh, with
    ``shard_batch`` and ``restore(mesh=..., specs=...)``.
"""
import types
from functools import partial

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from repro import configs as R
from repro.launch import mesh as RMesh
from repro.models import model as RM
from repro.shardings import Sharding as RSharding
from repro_torch import configs as C
from repro_torch.ckpt import CheckpointStore
from repro_torch.ckpt.store import _leaf_paths
from repro_torch.errors import ConfigError
from repro_torch.kernels import ops
from repro_torch.launch import mesh as TMesh
from repro_torch.models import model as M
from repro_torch.runtime import TrainController
from repro_torch.shardings import Sharding
from repro_torch.train import (AdamWConfig, SyntheticLM, init_train_state,
                               make_train_step, shard_batch)
from torch_model_parity import (B, LOGIT_TOL, S, assert_caches_close,
                                carried, jbatch, make_batch, max_abs, tbatch)
from torch_threads import torch_one_thread  # noqa: F401 (autouse)

ARCH_NAMES = sorted(C.ARCHS)
STANDINS = {"16x16": ((16, 16), ("data", "model")),
            "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
META = torch.device("meta")


@pytest.fixture(autouse=True)
def _cpu():
    prev = ops.device()
    ops.set_device("cpu")
    try:
        yield
    finally:
        ops.set_device(prev)


def meshes(name: str):
    """(reference mesh, port mesh) of one of the three meshes."""
    if name == "1x1":
        return RMesh.make_mesh_for(1), TMesh.make_mesh_for(1, device="cpu")
    sizes, axes = STANDINS[name]
    ref = types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, sizes)))
    return ref, TMesh.make_production_mesh(multi_pod=name == "2x16x16")


def spec_tuples(tree):
    """The reference's PartitionSpecs as the port's tuples."""
    if isinstance(tree, PartitionSpec):
        return tuple(tree)
    if isinstance(tree, dict):
        return {k: spec_tuples(v) for k, v in tree.items()}
    return type(tree)(spec_tuples(v) for v in tree)


def leaf_shapes(tree):
    if isinstance(tree, dict):
        return {k: leaf_shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(leaf_shapes(v) for v in tree)
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


def batches(name):
    return [None] + sorted({C.SHAPES[s].global_batch
                            for s in C.shapes_for(C.ARCHS[name])})


# ------------------------------------------------------------------ meshes

@pytest.mark.parametrize("name", ["16x16", "2x16x16", "1x1"])
def test_mesh_axes_and_sizes_equal_the_reference(name):
    ref, mesh = meshes(name)
    assert mesh.axis_names == tuple(ref.axis_names)
    assert dict(mesh.shape) == dict(ref.shape)
    assert mesh.size == int(np.prod(list(ref.shape.values())))
    if name == "1x1":
        assert mesh.devices == (torch.device("cpu"),)
    else:
        assert mesh.devices is None


def test_make_mesh_for_shapes_equal_the_reference(monkeypatch):
    """(data, model) for 1..64 devices and model axes 16, 8, 4: the
    reference's arithmetic, recorded through a stand-in jax.make_mesh."""
    seen = []
    monkeypatch.setattr(RMesh.jax, "make_mesh",
                        lambda shape, axes, **kw: seen.append(
                            (tuple(shape), tuple(axes))) or seen[-1])
    for axis in (16, 8, 4):
        for n in range(1, 65):
            want = RMesh.make_mesh_for(n, axis)
            assert (TMesh.mesh_shape_for(n, axis), ("data", "model")) == want
    assert len(seen) == 3 * 64
    monkeypatch.undo()
    real = RMesh.make_mesh_for(1)
    assert dict(real.shape) == dict(TMesh.make_mesh_for(1, device="cpu")
                                    .shape)
    with pytest.raises(ConfigError):
        TMesh.make_mesh_for(2, device="cpu")
    with pytest.raises(ConfigError):
        TMesh.mesh_shape_for(0)


def test_device_for_places_only_whole_tensors():
    one = TMesh.make_mesh_for(1, device="cpu")
    assert one.device_for(("data", "model", None)) == torch.device("cpu")
    assert one.device_for({"a": (("data", "model"),), "b": None}) == \
        torch.device("cpu")
    wide = TMesh.make_production_mesh()
    for spec in (("data",), (None, "model"), {"x": (("pod", "data"),)}):
        with pytest.raises(ConfigError):
            wide.device_for(spec)
    with pytest.raises(ConfigError):
        one.device_for(("pod",))                 # not an axis of the mesh
    with pytest.raises(ConfigError):
        wide.device_for(())                      # binds no device


# --------------------------------------------------------------- spec parity

@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16", "1x1"])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_rules_equal_the_reference(name, mesh_name):
    ref_mesh, mesh = meshes(mesh_name)
    for gb in batches(name):
        ref = RSharding(ref_mesh, R.ARCHS[name], gb)
        shd = Sharding(mesh, C.ARCHS[name], gb)
        assert shd.rules == ref.rules, gb
        assert (shd.tp, shd.dp_size, shd.dp_axes, shd.batch_uses_model,
                shd.padded_vocab) == \
            (ref.tp, ref.dp_size, ref.dp_axes, ref.batch_uses_model,
             ref.padded_vocab), gb
        assert shd.spec("batch", "seq", "heads", None) == \
            tuple(ref.spec("batch", "seq", "heads", None))


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_param_and_state_specs_equal_the_reference(name):
    """At full size: the reference's specs of jax.eval_shape params and
    the port's of meta params (whose shapes and dtypes equal the
    reference's, padded for each mesh's model axis)."""
    rcfg, cfg = R.ARCHS[name], C.ARCHS[name]
    by_tp = {}
    for mesh_name in ("16x16", "2x16x16", "1x1"):
        ref_mesh, mesh = meshes(mesh_name)
        ref, shd = RSharding(ref_mesh, rcfg), Sharding(mesh, cfg)
        if shd.tp not in by_tp:
            rp = jax.eval_shape(partial(RM.init_params, rcfg, shards=shd.tp),
                                jax.random.PRNGKey(0))
            tp = M.init_params(cfg, torch.Generator(), shards=shd.tp,
                               device=META)
            assert leaf_shapes(tp) == jax.tree.map(
                lambda a: (tuple(a.shape), str(a.dtype)), rp)
            by_tp[shd.tp] = rp, tp
        rp, tp = by_tp[shd.tp]
        want = spec_tuples(ref.param_specs(rp))
        assert shd.param_specs(tp) == want, mesh_name
        assert shd.state_specs({"params": tp}) == \
            spec_tuples(ref.state_specs({"params": rp})), mesh_name


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_batch_and_cache_specs_equal_the_reference(name):
    """Every live shape's inputs, and the decode cache at decode_32k's
    batch and length (long_500k's for the sub-quadratic archs)."""
    rcfg, cfg = R.ARCHS[name], C.ARCHS[name]
    shapes = C.shapes_for(cfg)
    dec = C.SHAPES["decode_32k"]
    rcache = jax.eval_shape(lambda: RM.init_cache(rcfg, dec.global_batch,
                                                  dec.seq_len))
    cache = M.init_cache(cfg, dec.global_batch, dec.seq_len, device=META)
    for mesh_name in ("16x16", "2x16x16", "1x1"):
        ref_mesh, mesh = meshes(mesh_name)
        for sh in shapes:
            gb = C.SHAPES[sh].global_batch
            ref, shd = RSharding(ref_mesh, rcfg, gb), Sharding(mesh, cfg, gb)
            assert shd.batch_specs(C.input_specs(cfg, C.SHAPES[sh])) == \
                spec_tuples(ref.batch_specs(R.input_specs(rcfg,
                                                          R.SHAPES[sh])))
        ref = RSharding(ref_mesh, rcfg, dec.global_batch)
        shd = Sharding(mesh, cfg, dec.global_batch)
        assert shd.cache_specs(cache) == spec_tuples(ref.cache_specs(rcache))


# ------------------------------------------------------ the mesh on the CPU

@pytest.mark.parametrize("name", ARCH_NAMES)
def test_prefill_and_decode_on_the_one_device_mesh(name):
    """Prefill and one decode step: the reference on make_mesh_for(1)
    against the port's one-device mesh (LOGIT_TOL, carried float32
    weights), and the port's mesh path bit for bit against its mesh-less
    path."""
    sc, tc, p, tp = carried(name)
    ref = RSharding(RMesh.make_mesh_for(1), sc)
    shd = Sharding(TMesh.make_mesh_for(1, device="cpu"), tc)
    flat = Sharding(None, tc)
    pb = {k: v for k, v in make_batch(sc).items() if k != "labels"}
    T = S + 2

    def ref_calls(p, b, tok):
        cache, logits = RM.prefill(p, b, sc, ref, cache_len=T)
        step = {"tokens": tok, "pos": jax.numpy.full((B,), S, "int32")}
        return (cache, logits), RM.decode_step(p, cache, step, sc, ref)

    # the decode's token is the port's greedy one, so one compiled call
    # serves both of the reference's steps
    with torch.no_grad():
        tcache, tlogits = M.prefill(tp, tbatch(pb), tc, shd, cache_len=T)
        fcache, flogits = M.prefill(tp, tbatch(pb), tc, flat, cache_len=T)
    tok = tlogits.argmax(-1)[:, None].int().numpy()
    (cache, logits), (dcache, dlogits) = jax.jit(ref_calls)(
        p, jbatch(pb), jax.numpy.asarray(tok))
    assert max_abs(logits, tlogits) <= LOGIT_TOL
    assert_caches_close(cache, tcache)
    assert torch.equal(tlogits, flogits)
    step = {"tokens": tok, "pos": np.full((B,), S, np.int32)}
    with torch.no_grad():
        tcache, tlogits = M.decode_step(tp, tcache, tbatch(step), tc, shd)
        _, flogits = M.decode_step(tp, fcache, tbatch(step), tc, flat)
    assert max_abs(dlogits, tlogits) <= LOGIT_TOL
    assert_caches_close(dcache, tcache)
    assert torch.equal(tlogits, flogits)


def test_moe_train_step_on_the_one_device_mesh():
    """olmoe's smoke config: shard_batch onto the mesh, a train step on
    the mesh's Sharding equal bit for bit to the mesh-less step, the
    state checkpointed and restored (and remeshed) onto the mesh with its
    state specs; the 16x16 mesh's specs raise ConfigError."""
    cfg = C.smoke(C.ARCHS["olmoe-1b-7b"])
    mesh = TMesh.make_mesh_for(1, device="cpu")
    shd = Sharding(mesh, cfg, 4)
    state = init_train_state(cfg, torch.Generator().manual_seed(0),
                             shards=shd.tp, device="cpu")
    batch = shard_batch(SyntheticLM(cfg.vocab, 32, 4).batch_at(0), mesh, shd)
    opt = AdamWConfig(warmup_steps=1)
    got, gm = make_train_step(cfg, shd, opt)(state, batch)
    want, wm = make_train_step(cfg, Sharding(None, cfg), opt)(state, batch)
    for k in wm:
        assert torch.equal(gm[k], wm[k]), k
    assert all(torch.equal(a, b) for a, b in zip(_leaves(got),
                                                 _leaves(want)))
    ck = CheckpointStore()
    ck.save(got, "run", step=1)
    specs = shd.state_specs(got)
    back = ck.restore(got, "run", mesh=mesh, specs=specs)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(back),
                                                 _leaves(got)))
    ctl = TrainController(make_train_step(cfg, shd, opt), got,
                          SyntheticLM(cfg.vocab, 32, 4), ck)
    assert all(torch.equal(a, b) for a, b in zip(
        _leaves(ctl.remesh(mesh, specs)), _leaves(got)))
    wide = TMesh.make_production_mesh()
    with pytest.raises(ConfigError):
        ck.restore(got, "run", mesh=wide,
                   specs=Sharding(wide, cfg, 256).state_specs(got))
    with pytest.raises(ConfigError):
        ctl.remesh(wide, Sharding(wide, cfg, 256).state_specs(got))


def _leaves(tree) -> list:
    """The leaves in JAX's flattening order (dict keys sorted), as the
    checkpoint store rebuilds them."""
    return [leaf for _, leaf in _leaf_paths(tree)]
