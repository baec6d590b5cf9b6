"""The port's training loop end to end on the CPU: the reference's
``tests/test_train_runtime.py::{test_loss_decreases,
test_microbatch_equivalence, test_schedule}`` and
``tests/test_system.py::test_end_to_end_training_with_storage`` on
repro_torch (the same configs, batches, steps and bounds), failure
recovery bit for bit on the real train step and its whole state, the
prefetcher, the launcher's command line, the example, and restore's
placement arguments on a train state."""
import os
import re
import runpy
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.apps import ForkBaseLedger
from repro_torch.ckpt import CheckpointStore
from repro_torch.ckpt.store import _leaf_paths
from repro_torch.configs import ARCHS, smoke
from repro_torch.core import ChunkParams, ForkBase
from repro_torch.errors import ConfigError
from repro_torch.kernels import ops
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_mesh_for, make_production_mesh
from repro_torch.runtime import run_resilient
from repro_torch.shardings import Sharding
from repro_torch.train import (AdamWConfig, SyntheticLM, init_train_state,
                               make_train_step, schedule, shard_batch)
from torch_threads import torch_one_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _cpu():
    prev = ops.device()
    ops.set_device("cpu")
    try:
        yield
    finally:
        ops.set_device(prev)


def fresh(cfg, seed: int = 0):
    return init_train_state(cfg, torch.Generator().manual_seed(seed),
                            shards=4, device="cpu")


def assert_trees_equal(a, b):
    la, lb = _leaf_paths(a), _leaf_paths(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (n, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), n


@pytest.fixture(scope="module")
def setup():
    sc = smoke(ARCHS["tinyllama-1.1b"])
    shd = Sharding(None, sc)
    ds = SyntheticLM(sc.vocab, 64, 8)
    step = make_train_step(sc, shd, AdamWConfig(lr=3e-3, warmup_steps=5,
                                                total_steps=100))
    return sc, shd, ds, step


# ---------------------------------------- tests/test_train_runtime.py

def test_loss_decreases(setup):
    sc, shd, ds, step = setup
    state = fresh(sc)
    losses = []
    for i in range(30):
        state, m = step(state, shard_batch(ds.batch_at(i)))
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses


def test_microbatch_equivalence():
    """Gradient accumulation over microbatches ~ single large batch."""
    sc = smoke(ARCHS["internlm2-1.8b"])
    shd = Sharding(None, sc)
    state = fresh(sc)
    b = shard_batch(SyntheticLM(sc.vocab, 32, 8).batch_at(0))
    s1, _ = make_train_step(sc, shd, AdamWConfig())(state, b)
    s2, _ = make_train_step(sc, shd, AdamWConfig(), microbatch=4)(state, b)
    for (n, a), (_, c) in zip(_leaf_paths(s1["params"]),
                              _leaf_paths(s2["params"])):
        np.testing.assert_allclose(a.float().numpy(), c.float().numpy(),
                                   atol=3e-2, err_msg=n)


def test_schedule():
    opt = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_frac=0.1)
    assert float(schedule(opt, torch.tensor(0))) < 0.2
    assert float(schedule(opt, torch.tensor(10))) > 0.9
    assert abs(float(schedule(opt, torch.tensor(100))) - 0.1) < 1e-5


def test_failure_recovery_bitexact_on_the_whole_train_state(setup):
    """The reference's test_failure_recovery_bitexact on the real step: the
    restored state carries master, mu, nu and step, so the replay equals
    the run without failure leaf for leaf."""
    sc, shd, ds, step = setup
    state = fresh(sc)
    a = run_resilient(step, state, ds, n_steps=8, ckpt_every=3)
    b = run_resilient(step, state, ds, n_steps=8, fail_at=(5,),
                      ckpt_every=3)
    assert b.restarts == 1
    assert_trees_equal(a.state, b.state)
    assert int(b.state["opt"]["step"]) == 8
    manifest = b.ckpt.db.get("ckpt", "run").map()
    names = {k.decode() for k, _ in manifest.items()}
    assert {"opt/master/embed", "opt/mu/embed", "opt/nu/embed",
            "opt/step", "params/embed"} <= names


def test_controller_steps_under_deterministic_algorithms(setup):
    """The controller owns the bit-exact restart: every step of ``run``,
    replays included, runs with torch's deterministic algorithms on (and
    CUBLAS_WORKSPACE_CONFIG set), and the caller's setting comes back
    after the run."""
    sc, shd, ds, step = setup
    seen = []

    def watched(state, batch):
        seen.append(torch.are_deterministic_algorithms_enabled())
        return step(state, batch)

    assert not torch.are_deterministic_algorithms_enabled()
    ctl = run_resilient(watched, fresh(sc), ds, n_steps=4, fail_at=(3,),
                        ckpt_every=2)
    assert ctl.restarts == 1 and seen == [True] * 5
    assert not torch.are_deterministic_algorithms_enabled()
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] in (":4096:8", ":16:8")


# ---------------------------------------------- tests/test_system.py

def test_end_to_end_training_with_storage():
    """Train a reduced model through failures, checkpointing into the same
    ForkBase instance that serves a blockchain app — shared storage,
    shared dedup pool."""
    db = ForkBase(params=ChunkParams(q=12))
    ledger = ForkBaseLedger(db)
    sc = smoke(ARCHS["internlm2-1.8b"])
    shd = Sharding(None, sc)
    state = fresh(sc)
    ds = SyntheticLM(sc.vocab, 64, 4)
    step = make_train_step(sc, shd, AdamWConfig(warmup_steps=2))
    ctl = run_resilient(step, state, ds, n_steps=6, fail_at=(4,),
                        ckpt_every=2, db=db)
    assert ctl.step == 6 and ctl.restarts == 1
    # blockchain records the training lineage (model provenance on-chain)
    for s, _meta in ctl.ckpt.history("run"):
        ledger.write("provenance", "ckpt", s.hex().encode())
    ledger.commit()
    hist = ledger.state_scan("provenance", "ckpt")
    assert len(hist) == 1
    assert ledger.verify_block(0)


# ------------------------------------------------------ state and data

@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-moe-16b"])
def test_init_train_state_dtypes(arch):
    """fp32 master and step int32; moments in the config's opt_moments
    (bf16 for deepseek-moe-16b)."""
    sc = smoke(ARCHS[arch])
    st = fresh(sc)
    mdt = torch.bfloat16 if sc.opt_moments == "bf16" else torch.float32
    params = dict(_leaf_paths(st["params"]))
    for part in ("mu", "nu", "master"):
        leaves = _leaf_paths(st["opt"][part])
        assert [n for n, _ in leaves] == list(params)
        for n, x in leaves:
            assert x.shape == params[n].shape
            assert x.dtype == (torch.float32 if part == "master" else mdt)
            if part == "master":
                assert torch.equal(x, params[n].float())
                assert x.data_ptr() != params[n].data_ptr()
            else:
                assert not x.any()
    assert st["opt"]["step"].dtype == torch.int32
    assert int(st["opt"]["step"]) == 0


def test_prefetch_yields_batch_at_in_order_and_close_stops_the_worker():
    ds = SyntheticLM(512, 16, 2, seed=4, frontend="vision", n_patches=4,
                     d_model=8)
    before = threading.active_count()
    it = ds.prefetch(5, depth=2)
    for want in (5, 6, 7):
        step, batch = next(it)
        assert step == want
        ref = ds.batch_at(want)
        assert sorted(batch) == sorted(ref)
        for k, v in ref.items():
            assert batch[k].device.type == "cpu"
            assert batch[k].numpy().tobytes() == \
                np.ascontiguousarray(v).tobytes()
    it.close()
    assert not it._thread.is_alive()
    assert threading.active_count() == before


def test_prefetch_hands_a_worker_error_to_the_consumer():
    class Broken(SyntheticLM):
        def batch_at(self, step):
            if step == 1:
                raise ValueError("bad step")
            return super().batch_at(step)
    it = Broken(512, 8, 1).prefetch(0)
    try:
        assert next(it)[0] == 0
        with pytest.raises(ValueError, match="bad step"):
            next(it)
    finally:
        it.close()


def test_shard_batch_raises_for_a_mesh():
    """Over a mesh, shard_batch takes a launch.mesh.Mesh and its Sharding;
    a batch axis of size > 1 (the 16x16 mesh) is the multi-card port."""
    batch = SyntheticLM(512, 8, 16).batch_at(0)
    with pytest.raises(ConfigError):
        shard_batch(batch, mesh=object())
    cfg = smoke(ARCHS["tinyllama-1.1b"])
    wide = make_production_mesh()
    with pytest.raises(ConfigError):
        shard_batch(batch, wide, Sharding(wide, cfg, 16))
    one = make_mesh_for(1, device="cpu")
    got = shard_batch(batch, one, Sharding(one, cfg, 16))
    for k, v in batch.items():
        assert got[k].device.type == "cpu" and np.array_equal(
            got[k].numpy(), v)


def test_the_cuda_device_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA path is chip_smoke.py's")
    ops.set_device("cuda")
    with pytest.raises(ConfigError):
        SyntheticLM(512, 8, 1).prefetch(0)
    with pytest.raises(ConfigError):
        launch_train.main(["--steps", "1"])


# -------------------------------------------- restore(specs) placement

def test_restore_specs_on_a_train_state(setup):
    """As in the reference: specs are ignored without a mesh; on one
    device (a torch.device) specs may only replicate; a spec naming a
    mesh axis raises ConfigError."""
    sc, shd, _, _ = setup
    state = fresh(sc)
    ck = CheckpointStore()
    ck.save(state, "run", step=0)
    named = {"params": {"embed": ("data", None)}}
    assert_trees_equal(ck.restore(state, "run", specs=named), state)
    cpu = torch.device("cpu")
    for specs in (None, {}, {"params": None, "opt": ()},
                  {"params": {"embed": (None, None)}, "opt": ((), None)}):
        assert_trees_equal(ck.restore(state, "run", mesh=cpu, specs=specs),
                           state)
    for specs in (named, {"opt": {"mu": (("pod", "data"), None)}},
                  ("model",)):
        with pytest.raises(ConfigError):
            ck.restore(state, "run", mesh=cpu, specs=specs)
    with pytest.raises(ConfigError):
        ck.restore(state, "run", mesh=cpu, specs={"params": 3})


# ---------------------------------------------- launcher and example

LINE = re.compile(r"^(\S+): (\d+) steps, loss ([\d.]+) -> ([\d.]+); "
                  r"ckpt dedup ([\d.]+)x$")


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmoe-1b-7b",
                                  "internvl2-2b"])
def test_train_command_line_on_the_cpu(arch, capsys):
    """The reference's flags plus --device; on the CPU the smoke config."""
    ctl = launch_train.main(["--arch", arch, "--device", "cpu", "--steps",
                             "4", "--batch", "2", "--seq", "32",
                             "--ckpt-every", "2", "--branch", "b"])
    out = capsys.readouterr().out.strip().splitlines()
    m = LINE.match(out[-1])
    assert m, out
    assert m.group(1) == arch and m.group(2) == "4"
    assert ctl.step == 4 and ctl.restarts == 0
    assert [h[1]["step"] for h in ctl.ckpt.history("b")] == [4, 2, 0]


def test_train_example_on_the_cpu(capsys):
    mod = runpy.run_path(str(ROOT / "examples" / "torch" /
                             "train_with_forkbase_ckpt.py"),
                         run_name="example")
    ctl = mod["main"](["--steps", "40", "--batch", "4", "--seq", "64",
                       "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("arch=tinyllama-1.1b (reduced: 2L d=128)")
    assert "failures injected at" in out[1]
    assert re.search(r"restarts=2$", out[2]), out[2]
    assert out[3] == ("forked 'lr-sweep' from step 20 (zero-copy: "
                      "POS-Tree chunks shared)")
    assert out[-1].endswith("from step-0 commit: True")
    assert ctl.restarts == 2 and ctl.step == 40
    losses = [loss for _, loss in ctl.metrics_log]
    assert np.mean(losses[-10:]) < losses[0]
