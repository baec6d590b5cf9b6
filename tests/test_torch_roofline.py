"""The port's roofline (repro_torch.roofline) against the reference's
(repro.roofline, which imports no JAX).

  * ``roofline_terms`` on one cell record: each term times its package's
    constant is the same count (FLOPs, bytes, collective bytes), and
    ``model_flops_per_device`` and ``useful_ratio`` are equal.
  * ``analyze_ops``'s dot FLOPs against ``analyze_hlo`` of the same smoke
    prefill compiled by XLA on the CPU: exact on a plain matmul chain and
    on a dense and an MoE arch.  xLSTM's differs by exactly its
    mLSTM layers' second k, v, i and f projections: the port's prefill
    computes them in ``mlstm_parallel`` and again in
    ``mlstm_final_state``, where XLA's common-subexpression elimination
    computes them once.
  * The census's own rules: views cost nothing, an in-place update counts
    the update, the meta census (memoized) equals a CPU run's, and fused
    attention counts as torch's flop counter counts it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro import roofline as RR
from repro.models import model as RM
from repro.shardings import Sharding as RSharding
from repro_torch import roofline as TR
from repro_torch.configs import ARCHS, ShapeConfig, smoke
from repro_torch.launch import dryrun
from repro_torch.models import layers
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.shardings import Sharding
from torch_model_parity import carried, jbatch, make_batch, tbatch
from torch_threads import torch_one_thread  # noqa: F401 (autouse)

CELL = {"arch": "a", "shape": "s", "mesh": "16x16", "variant": "base",
        "n_chips": 256, "kind": "train", "params_total": 7_000_000_000,
        "params_active": 1_300_000_000, "tokens_per_step": 1_048_576,
        "memory": {"peak_per_device_gb": 3.0},
        "cost": {"flops_per_device": 1.0e14, "bytes_per_device": 4.0e11},
        "collectives": {"total_bytes": 2.5e9},
        "loop_aware": {"flops_per_device": 3.2e14,
                       "hbm_bytes_per_device": 7.5e11,
                       "collective_bytes_per_device": 1.25e10}}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("loop_aware", [True, False])
def test_roofline_terms_count_what_the_reference_counts(kind, loop_aware):
    cell = dict(CELL, kind=kind)
    if not loop_aware:
        cell["loop_aware"] = {}
    got, want = TR.roofline_terms(cell), RR.roofline_terms(cell)
    for term, tc, rc in (("compute_s", TR.PEAK_FLOPS, RR.PEAK_FLOPS),
                         ("memory_s", TR.HBM_BW, RR.HBM_BW),
                         ("collective_s", TR.LINK_BW, RR.ICI_BW)):
        assert got[term] * tc == pytest.approx(want[term] * rc, rel=1e-12)
    assert got["model_flops_per_device"] == want["model_flops_per_device"]
    assert got["useful_ratio"] == want["useful_ratio"]
    assert set(got) == set(want)


def test_uncounted_collectives_add_no_term():
    """A production mesh's record has collectives null (this process
    cannot run it): no collective term, the rest as counted."""
    cell = dict(CELL, collectives=None,
                loop_aware=dict(CELL["loop_aware"],
                                collective_bytes_per_device=None))
    got = TR.roofline_terms(cell)
    assert got["collective_s"] == 0
    assert got["compute_s"] == CELL["loop_aware"]["flops_per_device"] / \
        TR.PEAK_FLOPS


def test_h100_constants():
    assert (TR.PEAK_FLOPS, TR.HBM_BW, TR.LINK_BW) == (989e12, 3.35e12, 900e9)


# ------------------------------------------------- census against the HLO

def test_a_matmul_chain_counts_exactly_as_the_hlo():
    rng = np.random.default_rng(0)
    x, w1, w2 = (rng.standard_normal(s).astype(np.float32)
                 for s in ((8, 64), (64, 96), (96, 32)))

    def jf(x, w1, w2):
        return jnp.tanh(x @ w1) @ w2

    hlo = jax.jit(jf).lower(x, w1, w2).compile().as_text()
    want = RR.analyze_hlo(hlo)["flops_per_device"]
    got = TR.analyze_ops(lambda a, b, c: torch.tanh(a @ b) @ c,
                         *(torch.from_numpy(a) for a in (x, w1, w2)))
    assert got["flops_per_device"] == want == 2 * 8 * 64 * 96 + \
        2 * 8 * 96 * 32
    assert got["collective_bytes_per_device"] == 0


def _mlstm_dup_flops(cfg, B, S) -> int:
    """The dot FLOPs of the k, v, i and f projections of every mLSTM layer
    over B x S tokens, which the port's prefill computes twice."""
    d, H = cfg.d_model, cfg.n_heads
    n_m = cfg.n_layers - len(cfg.slstm_at)
    return n_m * 2 * B * S * d * (2 * d + 2 * H)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmoe-1b-7b",
                                  "xlstm-125m"])
def test_prefill_dot_flops_against_the_hlo(arch):
    sc, tc, p, tp = carried(arch)
    pb = {k: v for k, v in make_batch(sc).items() if k != "labels"}
    hlo = jax.jit(lambda p, b: RM.prefill(p, b, sc, RSharding(None, sc))
                  ).lower(p, jbatch(pb)).compile().as_text()
    want = RR.analyze_hlo(hlo)["flops_per_device"]
    with torch.no_grad():
        got = TR.analyze_ops(M.prefill, tp, tbatch(pb), tc,
                             Sharding(None, tc))["flops_per_device"]
    gap = _mlstm_dup_flops(tc, *pb["tokens"].shape) \
        if tc.family == "ssm" else 0
    assert got - gap == want, (got, want, gap)


# ------------------------------------------------------ the census's rules

def test_views_cost_nothing_and_updates_count_the_update():
    x = torch.zeros(64, 64)
    v = TR.analyze_ops(lambda: x.view(16, 256).t()[:10].unsqueeze(0))
    assert (v["hbm_bytes_per_device"], v["ops"]) == (0, 0)
    c = TR.analyze_ops(lambda: x.view(16, 256).t().reshape(-1))
    assert c["hbm_bytes_per_device"] == 2 * x.numel() * 4   # a copy
    rows = torch.ones(4, 64)
    u = TR.analyze_ops(lambda: x.index_put_((torch.arange(4),), rows))
    idx = 4 * 8                                    # the int64 index tensor
    assert u["hbm_bytes_per_device"] == 2 * rows.numel() * 4 + 2 * idx
    a = TR.analyze_ops(lambda: x + 1)
    assert a["hbm_bytes_per_device"] == 2 * x.numel() * 4
    assert a["peak_live_bytes"] == x.numel() * 4


def test_fused_attention_counts_as_the_flop_counter():
    q = torch.zeros(2, 4, 128, 32, device="meta", dtype=torch.bfloat16)
    fn = (lambda: layers.sdpa_attention(q.transpose(1, 2), q.transpose(1, 2),
                                        q.transpose(1, 2)))
    got = TR.analyze_ops(fn)
    with FlopCounterMode(display=False) as fc:
        fn()
    assert got["flops_per_device"] == fc.get_total_flops() == \
        4 * 2 * 4 * 128 * 128 * 32
    assert list(got["flops_by_op"]) == ["_scaled_dot_product_flash_attention"]


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_the_meta_census_equals_a_cpu_run(kind):
    """xLSTM (its attention takes the blocked route on both devices, and
    its decode reads no positions): the memoized meta census gives the
    CPU run's totals, op for op."""
    cfg = smoke(ARCHS["xlstm-125m"])
    shape = ShapeConfig("s", 32, 4, kind)
    meta = dryrun.census_cell(cfg, shape, 1, device="meta").totals
    cpu = dryrun.census_cell(cfg, shape, 1, device="cpu").totals
    assert meta == cpu
    assert meta["flops_per_device"] > 0 and meta["ops"] > 100


def test_the_meta_census_of_an_moe_layer_equals_a_cpu_run():
    cfg = smoke(ARCHS["olmoe-1b-7b"])
    totals = []
    for dev in ("meta", "cpu"):
        p = M.init_params(cfg, torch.Generator().manual_seed(0), shards=1,
                          device=dev)
        lp = M.tree_map(lambda a: a[0], p["layers"]["moe"])
        x = torch.zeros(4, 32, cfg.d_model, dtype=torch.bfloat16, device=dev)
        totals.append(TR.analyze_ops(moe.moe_block, lp, x, cfg,
                                     Sharding(None, cfg)))
    assert totals[0] == totals[1]
    assert totals[0]["flops_by_op"]["bmm"] > 0
