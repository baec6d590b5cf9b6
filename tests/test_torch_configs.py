"""The port's configs and one-device shardings against the JAX
reference: every field of the ten assigned architectures and of their
smoke configs, parameter counts, live shapes and input specs; the ports
of test_archs.py::test_params_count_sanity and
test_system.py::test_smoke_all_archs_shapes_defined; Sharding(None, cfg)."""
import dataclasses

import jax
import pytest
import torch
from jax.sharding import PartitionSpec

from repro import configs as R
from repro.models import model as RM
from repro.shardings import Sharding as RSharding
from repro_torch import configs as C
from repro_torch.errors import ConfigError
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.shardings import Sharding, make_sharding


def test_the_ten_archs_equal_the_reference():
    assert sorted(C.ARCHS) == sorted(R.ARCHS)
    for name in R.ARCHS:
        assert dataclasses.asdict(C.ARCHS[name]) == \
            dataclasses.asdict(R.ARCHS[name]), name
        assert dataclasses.asdict(C.smoke(C.ARCHS[name])) == \
            dataclasses.asdict(R.smoke(R.ARCHS[name])), name
        assert C.get_arch(name) is C.ARCHS[name]
    for mod in ("deepseek_moe_16b", "internlm2_1_8b", "internvl2_2b",
                "musicgen_large", "olmoe_1b_7b", "qwen1_5_110b", "qwen2_7b",
                "tinyllama_1_1b", "xlstm_125m", "zamba2_2_7b"):
        assert getattr(C, mod).__doc__ == getattr(R, mod).__doc__, mod
    with pytest.raises(KeyError):
        C.get_arch("gpt-5")


def test_derived_sizes_and_shapes_equal_the_reference():
    cells = 0
    for name in R.ARCHS:
        for cfg, ref in ((C.ARCHS[name], R.ARCHS[name]),
                         (C.smoke(C.ARCHS[name]), R.smoke(R.ARCHS[name]))):
            for attr in ("dh", "d_inner", "n_ssm_heads"):
                assert getattr(cfg, attr) == getattr(ref, attr)
            assert cfg.params_count() == ref.params_count()
            assert cfg.active_params_count() == ref.active_params_count()
        assert C.shapes_for(C.ARCHS[name]) == R.shapes_for(R.ARCHS[name])
        for sh in C.shapes_for(C.ARCHS[name]):
            got = C.input_specs(C.ARCHS[name], C.SHAPES[sh])
            want = R.input_specs(R.ARCHS[name], R.SHAPES[sh])
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].shape == tuple(want[k].shape)
                assert str(got[k].dtype).split(".")[-1] == \
                    str(want[k].dtype), (name, sh, k)
            cells += 1
    assert cells == 32
    assert C.SHAPES == {k: C.ShapeConfig(**dataclasses.asdict(v))
                        for k, v in R.SHAPES.items()}


def test_params_count_sanity():
    """Config-derived parameter counts near published sizes."""
    approx = {"tinyllama-1.1b": 1.1e9, "qwen2-7b": 7.6e9,
              "qwen1.5-110b": 111e9, "olmoe-1b-7b": 6.9e9,
              "internlm2-1.8b": 1.9e9, "musicgen-large": 3.3e9,
              "deepseek-moe-16b": 16.4e9, "zamba2-2.7b": 2.7e9,
              "internvl2-2b": 1.9e9, "xlstm-125m": 125e6}
    for name, want in approx.items():
        got = C.ARCHS[name].params_count()
        assert 0.55 * want < got < 1.6 * want, (name, got, want)


def test_smoke_all_archs_shapes_defined():
    total = 0
    for _name, cfg in C.ARCHS.items():
        for sh in C.shapes_for(cfg):
            specs = C.input_specs(cfg, C.SHAPES[sh])
            assert all(isinstance(s, C.TensorSpec) and s.ndim == len(s.shape)
                       for s in specs.values())
            assert all(s.dtype in (torch.int32, torch.bfloat16)
                       for s in specs.values())
            total += 1
    assert total == 32   # 10x3 + 2 long_500k (8 skips documented)


def test_one_device_sharding():
    cfg = C.smoke(C.ARCHS["qwen2-7b"])
    shd = make_sharding(None, cfg, 8)
    ref = RSharding(None, R.smoke(R.ARCHS["qwen2-7b"]), 8)
    assert (shd.mesh, shd.tp, shd.dp_size, shd.rules, shd.dp_axes) == \
        (ref.mesh, ref.tp, ref.dp_size, ref.rules, ref.dp_axes)
    assert shd.padded_vocab == ref.padded_vocab
    x = torch.ones(2, 3)
    assert shd.constrain(x, "batch", "seq") is x
    assert shd.spec("batch", None, "heads") == \
        tuple(ref.spec("batch", None, "heads"))


def test_a_mesh_is_not_ported_yet():
    """A mesh builds its rules now; running the expert-parallel MoE over
    an axis of size > 1 is the multi-card port and raises ConfigError."""
    cfg = C.smoke(C.ARCHS["olmoe-1b-7b"])
    shd = Sharding(make_production_mesh(), cfg)
    assert (shd.tp, shd.dp_size) == (16, 16)
    with pytest.raises(ConfigError, match="multi-card port"):
        shd.moe_shard_map(None, None, {})


def test_param_specs_raise_key_error_without_a_mesh_as_the_reference():
    """The reference's Sharding._leaf_spec reads rules["fsdp"], which a
    mesh-less Sharding lacks (src/repro/shardings.py:111), so param_specs
    and state_specs raise KeyError on one device; the port keeps that."""
    rcfg, cfg = R.smoke(R.ARCHS["tinyllama-1.1b"]), \
        C.smoke(C.ARCHS["tinyllama-1.1b"])
    rparams = jax.eval_shape(lambda k: RM.init_params(rcfg, k, shards=4),
                             jax.random.PRNGKey(0))
    with pytest.raises(KeyError):
        RSharding(None, rcfg).param_specs(rparams)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), shards=4,
                           device="cpu")
    with pytest.raises(KeyError):
        Sharding(None, cfg).param_specs(params)
    with pytest.raises(KeyError):
        Sharding(None, cfg).state_specs({"params": params})


def _spec_tuples(tree):
    if isinstance(tree, PartitionSpec):
        return tuple(tree)
    if isinstance(tree, dict):
        return {k: _spec_tuples(v) for k, v in tree.items()}
    return type(tree)(_spec_tuples(v) for v in tree)


@pytest.mark.parametrize("name", sorted(C.ARCHS))
def test_cache_and_batch_specs_equal_the_reference(name):
    rcfg, cfg = R.smoke(R.ARCHS[name]), C.smoke(C.ARCHS[name])
    rcache = jax.eval_shape(lambda: RM.init_cache(rcfg, 2, 16))
    cache = M.init_cache(cfg, 2, 16, device="cpu")
    assert Sharding(None, cfg).cache_specs(cache) == \
        _spec_tuples(RSharding(None, rcfg).cache_specs(rcache))
    specs = C.input_specs(cfg, C.SHAPES["train_4k"])
    rspecs = R.input_specs(rcfg, R.SHAPES["train_4k"])
    assert Sharding(None, cfg).batch_specs(specs) == \
        _spec_tuples(RSharding(None, rcfg).batch_specs(rspecs))
