"""CPU rehearsals of chip_smoke.py's phase 5 (the checkpoint path, whose
controller now runs the real train step on the whole train state) and
phase 9 (the training path) at smoke widths and small shapes: every check
of each phase holds.  On the CPU the wrappers run their plain versions,
so the launch counters read 0."""
import pathlib
import sys

import pytest
import torch

from repro_torch.configs import ARCHS, smoke
from repro_torch.kernels import ops
from repro_torch.models import model as M
from torch_threads import torch_one_thread  # noqa: F401 (autouse)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu():
    prev = ops.device()
    ops.set_device("cpu")
    try:
        yield
    finally:
        ops.set_device(prev)


def narrow(table):
    """The phase-5 table at 1/16 of each width (the layer axis kept)."""
    return tuple((name, tuple(d if d == "L" else max(1, d // 16)
                              for d in shape), dtype)
                 for name, shape, dtype in table)


def test_checkpoint_phase_rehearsal_on_the_cpu():
    tl = smoke(ARCHS["tinyllama-1.1b"])
    out = chip_smoke.checkpoint_path(
        torch.device("cpu"), n_layers=2, table=narrow(
            chip_smoke.TINYLLAMA_PARAMS), hot_bytes=64 << 10,
        segment_bytes=4 << 10, ctl_cfg=tl, ctl_batch=(4, 32))
    ctl = out["controller"]
    assert ctl["restarts"] == 1 and ctl["steps"] == chip_smoke.CTL_STEPS
    assert ctl["saves"] == 3                  # steps 0, 2 and 4
    assert len(ctl["losses"]) == 5            # step 2 ran twice
    assert ctl["losses"][2] == ctl["losses"][3]
    assert ctl["state_bytes"] > 3 * 4 * tl.params_count()
    assert set(out["controller_launches"]) == set(chip_smoke.SOURCES)
    # every leaf of the last checkpoint (params, master, mu, nu and step)
    # rebuilt by the plain versions
    vs = ctl["vs_plain"]
    assert vs["leaves"] == 4 * len(chip_smoke.tree_leaves(
        M.init_params(tl, torch.Generator().manual_seed(0), shards=4,
                      device="cpu"))) + 1
    assert vs["max_abs_err"] == {"boundary_bitmap": 0, "fphash_many": 0}


def test_training_phase_rehearsal_on_the_cpu():
    tl = smoke(ARCHS["tinyllama-1.1b"])
    out = chip_smoke.training_path(
        torch.device("cpu"), cfg=tl, full=dict(B=1, S=64),
        mb=dict(B=4, S=32), entry=dict(launcher_steps=12, example_steps=15))
    full = out["full"]
    assert full["layers"] == tl.n_layers and full["peak_bytes"] is None
    assert len(full["losses"]) == chip_smoke.TRAIN_STEPS + \
        chip_smoke.TRAIN_DET_STEPS
    assert full["adamw_bound_by"] == "bytes"
    # read g, mu, nu and master, write mu, nu, master and the param: 28 B
    # a bfloat16 param, 32 B a float32 one
    params = M.init_params(tl, torch.Generator().manual_seed(0), shards=4,
                           device="cpu")
    want = []
    M.tree_map(lambda p: want.append(
        p.numel() * (28 if p.dtype == torch.bfloat16 else 32)), params)
    assert full["adamw_bytes"] == sum(want)
    assert full["grads_vary_det"] == []
    gap = out["microbatch"]
    assert gap["max_abs_diff"] <= chip_smoke.MB_TOL
    assert gap["gnorm_rel"] <= chip_smoke.MB_GNORM_REL
    assert gap["dir_off"] <= chip_smoke.MB_DIR_OFF
    entry = out["entry_points"]
    assert entry["launcher"]["restarts"] == 0
    assert entry["example"]["restarts"] == 2
    assert entry["launcher"]["last_line"].startswith("tinyllama-1.1b: 12 steps")
    for run in ("launcher", "example"):
        assert entry[run]["vs_plain"]["max_abs_err"] == {"boundary_bitmap": 0}
    assert set(out["train_launches"]) == set(chip_smoke.SOURCES)


def _microbatch_runs(cfg, batch_fn):
    """microbatch 1 on a smoke batch and microbatch 4 on ``batch_fn`` of
    it, from one state, as phase 9 (b) runs them."""
    from repro_torch.shardings import Sharding
    from repro_torch.train import (AdamWConfig, SyntheticLM,
                                   init_train_state, make_train_step,
                                   shard_batch)

    shd = Sharding(None, cfg)
    state = init_train_state(cfg, torch.Generator().manual_seed(7),
                             shards=4, device="cpu")
    batch = shard_batch(SyntheticLM(cfg.vocab, 32, 4, seed=8).batch_at(0))
    runs = {mb: make_train_step(cfg, shd, AdamWConfig(), microbatch=mb)(
        state, b) for mb, b in ((1, batch), (4, batch_fn(batch)))}
    return state, runs


def test_microbatch_check_fails_on_a_wrong_accumulation():
    """Phase 9 (b)'s limits catch what the reference's params check at a
    step-0 lr cannot: a slice accumulated twice in place of another
    (directions turned) and a missing / microbatch (gnorm 4x)."""
    tl = smoke(ARCHS["tinyllama-1.1b"])
    state, runs = _microbatch_runs(tl, lambda b: b)
    chip_smoke.check_microbatch(chip_smoke.microbatch_gap(state, runs))

    def twice(b):
        return {k: torch.cat([x[:1], x[:1], x[2:]]) for k, x in b.items()}

    state, bad = _microbatch_runs(tl, twice)
    gap = chip_smoke.microbatch_gap(state, bad)
    assert gap["max_abs_diff"] <= chip_smoke.MB_TOL   # the old check passes
    with pytest.raises(SystemExit):
        chip_smoke.check_microbatch(gap)
    s4, m4 = runs[4]
    gap = chip_smoke.microbatch_gap(
        state, {1: runs[1], 4: (s4, dict(m4, gnorm=4 * m4["gnorm"]))})
    with pytest.raises(SystemExit):
        chip_smoke.check_microbatch(gap)


@pytest.mark.parametrize("fphash", [False, True])
def test_saved_vs_plain_fails_on_other_bytes(fphash):
    """The plain-version check of a saved state passes on the bytes the
    checkpoint holds (sha256 or fphash cids) and fails on others."""
    from repro_torch.ckpt import CheckpointStore
    from repro_torch.core import hashing

    gen = torch.Generator().manual_seed(0)
    state = {"params": {"w": torch.randn(64, 256, generator=gen)},
             "opt": {"step": torch.tensor(3, dtype=torch.int32)}}
    other = {**state, "params": {"w": state["params"]["w"] + 1}}
    cpu = torch.device("cpu")
    if fphash:
        hashing.use_fphash()
    try:
        cs = CheckpointStore()
        cs.save(state, "run", step=0)
        out = chip_smoke.saved_vs_plain(cs, "run", state, cpu, fphash)
        assert out["leaves"] == 2 and out["bytes"] == 64 * 256 * 4 + 4
        assert set(out["max_abs_err"]) == (
            {"boundary_bitmap", "fphash_many"} if fphash
            else {"boundary_bitmap"})
        with pytest.raises(SystemExit):
            chip_smoke.saved_vs_plain(cs, "run", other, cpu, fphash)
    finally:
        hashing.use_sha256()
