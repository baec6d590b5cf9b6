"""The port's MoE layer and MoE archs (olmoe, deepseek-moe with its shared
experts and int8 KV cache) against the JAX reference at float32 on carried
weights.  Routing (top-k order, the stable sort of the routed slots,
capacity drops) must be identical; values within the tolerances of
tests/torch_model_parity.py (the combine's scatter-add sums in another
order than ``.at[].add``)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.models import moe as MO
from repro_torch.models import moe as TMO
from torch_model_parity import carried, check_model, max_abs
from torch_model_parity import torch_one_thread  # noqa: F401 (autouse)

LAYER_TOL = 1e-5


def test_top_k_breaks_ties_toward_the_lower_index():
    probs = np.array([[0.2, 0.3, 0.3, 0.2],
                      [0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.1, 0.4]], np.float32)
    rv, ri = lax.top_k(jnp.asarray(probs), 3)
    tv, ti = TMO.top_k(torch.from_numpy(probs), 3)
    assert np.array_equal(np.asarray(ri), ti.numpy())
    assert np.array_equal(np.asarray(rv), tv.numpy())


@pytest.mark.parametrize("impl", ["gather", "onehot"])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-moe-16b"])
def test_moe_dispatch_with_capacity_drops(arch, impl):
    """64 tokens, 8 experts, top-2, capacity 6: 128 routed slots into 48,
    so most experts drop tokens; the outputs, losses and routing agree."""
    sc, tc, p, tp = carried(arch)
    sc = dataclasses.replace(sc, moe_impl=impl)
    tc = dataclasses.replace(tc, moe_impl=impl)
    x = np.random.default_rng(4).standard_normal((64, sc.d_model)
                                                 ).astype(np.float32)
    lp = {k: v[0] for k, v in p["layers"]["moe"].items()}
    tlp = {k: v[0] for k, v in tp["layers"]["moe"].items()}
    if impl == "gather":
        ref = MO.moe_gather_local(jnp.asarray(x), lp, sc, e_start=0,
                                  e_local=sc.n_experts, capacity=6,
                                  axis_name=None)
        got = TMO.moe_gather_local(torch.from_numpy(x), tlp, tc, e_start=0,
                                   e_local=tc.n_experts, capacity=6,
                                   axis_name=None)
    else:
        ref = MO.moe_onehot(jnp.asarray(x), lp, sc, capacity=6)
        got = TMO.moe_onehot(torch.from_numpy(x), tlp, tc, capacity=6)
    for r, g in zip(ref, got):
        assert max_abs(r, g) <= LAYER_TOL
    # routing: the same experts in the same order, the same sorted slots
    probs, _ = MO.router_probs(jnp.asarray(x), lp["router"])
    tprobs, _ = TMO.router_probs(torch.from_numpy(x), tlp["router"])
    _, ri = lax.top_k(probs, sc.top_k)
    _, ti = TMO.top_k(tprobs, tc.top_k)
    assert np.array_equal(np.asarray(ri), ti.numpy())
    order = jnp.argsort(ri.reshape(-1))
    assert np.array_equal(np.asarray(order),
                          torch.argsort(ti.reshape(-1), stable=True).numpy())
    counts = np.bincount(np.asarray(ri).reshape(-1), minlength=8)
    assert counts.max() > 6                           # tokens were dropped


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-moe-16b"])
def test_moe_block(arch):
    sc, tc, p, tp = carried(arch)
    from repro.shardings import Sharding
    from repro_torch.shardings import Sharding as TSharding
    x = np.random.default_rng(5).standard_normal((2, 16, sc.d_model)
                                                 ).astype(np.float32)
    lp = {k: v[0] for k, v in p["layers"]["moe"].items()}
    tlp = {k: v[0] for k, v in tp["layers"]["moe"].items()}
    out, (lb, z) = MO.moe_block(lp, jnp.asarray(x), sc, Sharding(None, sc))
    tout, (tlb, tz) = TMO.moe_block(tlp, torch.from_numpy(x), tc,
                                    TSharding(None, tc))
    assert max_abs(out, tout) <= LAYER_TOL
    assert abs(float(lb) - float(tlb)) <= LAYER_TOL
    assert abs(float(z) - float(tz)) <= LAYER_TOL


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-moe-16b"])
def test_model_matches_the_reference(arch):
    check_model(arch)
