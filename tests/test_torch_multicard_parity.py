"""The port on a (data, model) = (2, 2) mesh of four gloo ranks on the CPU
against the JAX reference on a 2x2 CPU mesh (four host devices), for the
smoke configs of tinyllama-1.1b, olmoe-1b-7b, olmoe-1b-7b with FSDP (its
expert weights all-gathered over 'data' inside the MoE body), qwen2-7b
with FSDP (so its sequence-parallel residual, ``seq_res``) and xlstm-125m
(batch over ('data', 'model')).

The train state is the port's float32 init (seed 0), carried to both
packages as numpy; the batch is SyntheticLM's step 0 (B=4, S=32).  The
reference runs in a subprocess (tests/torch_mesh_reference.py: JAX fixes
its device count at start), at the same time as the port's four ranks
(tests/torch_mesh_ranks.py, through ``run_ranks``, gloo, one thread and a
60 s collective timeout a rank).

Tolerances (tests/torch_model_parity.py):
  * loss and its metrics within LOSS_TOL; gnorm and lr relative 1e-5;
  * the new master weights: every entry within 2.05 x lr of the
    reference's and at most 1e-3 of the entries more than 1e-3 x lr away
    (tests/test_torch_train_parity.py's bound for one step at float32);
  * prefill and decode logits within LOGIT_TOL;
  * the checkpoint: the uid of the mesh save equals the one-device save's
    and the reference's, and each rank's restored shard equals, bit for
    bit, the shard that the reference's restore puts on that device.

olmoe's capacity is counted per DP shard on a mesh: the reference's mesh
loss differs from its one-device loss, and so must the port's, by the
same amount within LOSS_TOL.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.ckpt.store import _leaf_paths
from repro_torch.kernels import ops
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import model as M
from repro_torch.train import SyntheticLM, init_train_state
from torch_mesh_ranks import config, parity
from torch_model_parity import LOGIT_TOL, LOSS_TOL
from torch_threads import torch_one_thread  # noqa: F401 (autouse)

HERE = Path(__file__).resolve().parent
CASES = {"tinyllama-1.1b": ("tinyllama-1.1b", False),
         "olmoe-1b-7b": ("olmoe-1b-7b", False),
         "olmoe-1b-7b-fsdp": ("olmoe-1b-7b", True),
         "qwen2-7b-fsdp": ("qwen2-7b", True),
         "xlstm-125m": ("xlstm-125m", False)}   # case -> (arch, fsdp)
B, S, LR = 4, 32, 1e-3
GROUP_TIMEOUT_S = 60.0
REF_TIMEOUT_S = 600.0


def _inputs(d: Path) -> None:
    prev = ops.device()
    ops.set_device("cpu")
    try:
        for case, (arch, fsdp) in CASES.items():
            cfg = config(arch, fsdp)
            st = init_train_state(cfg, torch.Generator().manual_seed(0),
                                  shards=4, device="cpu")
            st = M.tree_map(lambda a: a.float() if a.is_floating_point()
                            else a, st)
            out = {f"state/{n}": t.numpy() for n, t in _leaf_paths(st)}
            out.update({f"batch/{k}": v for k, v in
                        SyntheticLM(cfg.vocab, S, B).batch_at(0).items()})
            out["cfg/arch"] = np.asarray(arch)
            out["cfg/fsdp"] = np.asarray(fsdp)
            out["cfg/lr"] = np.asarray(LR)
            np.savez(d / f"in_{case}.npz", **out)
    finally:
        ops.set_device(prev)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    _inputs(d)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(HERE.parent / "src"), os.environ.get(
                       "PYTHONPATH", "")]))
    ref = subprocess.Popen(
        [sys.executable, str(HERE / "torch_mesh_reference.py"), str(d),
         *CASES], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        port = run_ranks(parity, 4, (str(d), list(CASES)), backend="gloo",
                         device="cpu", threads=1, timeout_s=GROUP_TIMEOUT_S,
                         workdir=str(d))
        log, _ = ref.communicate(timeout=REF_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait(timeout=10)
    assert ref.returncode == 0, log.decode()[-4000:]
    want = {c: dict(np.load(d / f"out_{c}.npz")) for c in CASES}
    return want, port


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_the_reference_mesh(runs, case):
    want, port = runs
    ref, got = want[case], port[0][case]
    for k in ("ce", "lb", "z", "loss"):
        assert abs(float(got[f"loss/{k}"]) - float(ref[f"loss/{k}"])) \
            <= LOSS_TOL, k
    for k in ("gnorm", "lr"):
        g, r = float(got[f"loss/{k}"]), float(ref[f"loss/{k}"])
        assert abs(g - r) <= 1e-5 * abs(r), (k, g, r)
    masters = [k for k in ref if k.startswith("new/opt/master/")]
    assert masters and sorted(masters) == sorted(
        k for k in got if k.startswith("new/opt/master/"))
    far = total = 0
    for k in masters:
        diff = np.abs(got[k].astype(np.float64) - ref[k])
        assert diff.max() <= 2.05 * LR, (k, diff.max())
        far += int(np.sum(diff > 1e-3 * LR))
        total += diff.size
    assert far <= 1e-3 * total, (far, total)
    for k in ref:
        if k.startswith("new/params/"):
            assert np.array_equal(got[k], got["new/opt/master/" +
                                              k[len("new/params/"):]]), k


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_the_reference_mesh(runs, case):
    want, port = runs
    ref, got = want[case], port[0][case]
    for k in ("prefill", "decode0", "decode1"):
        assert got[k].shape == ref[k].shape, k
        assert np.max(np.abs(got[k] - ref[k])) <= LOGIT_TOL, k


@pytest.mark.parametrize("case", list(CASES))
def test_checkpoint_from_the_mesh_matches_the_reference(runs, case):
    """The mesh save's uid is the one-device save's and the reference's
    (the same bytes); restore(mesh=, specs=) puts on each rank the shard
    that the reference puts on the device of the same mesh position."""
    want, port = runs
    ref = want[case]
    assert np.array_equal(port[0][case]["uid"], ref["uid"])
    assert np.array_equal(port[0][case]["one_uid"], ref["uid"])
    names = [k[len("restore/"):] for k in ref if k.startswith("restore/")]
    assert names
    for rank in range(4):
        got = port[rank][case]
        assert np.array_equal(got["uid"], ref["uid"])
        for n in names:
            idx = ref[f"restore_index/{n}"][rank]
            shard = ref[f"restore/{n}"][tuple(slice(a, b) for a, b in idx)]
            assert got[f"local/{n}"].dtype == shard.dtype, n
            assert np.array_equal(got[f"local/{n}"], shard), (rank, n)


def test_moe_capacity_is_counted_per_dp_shard(runs):
    """On the mesh the reference's olmoe loss differs from its one-device
    loss (capacity per DP shard drops other tokens); the port's differs by
    the same amount, and its one-device loss is the reference's."""
    want, port = runs
    ref, got = want["olmoe-1b-7b"], port[0]["olmoe-1b-7b"]
    gap_ref = float(ref["loss/ce"]) - float(ref["one/ce"])
    gap_got = float(got["loss/ce"]) - float(got["one/ce"])
    assert abs(gap_ref) > 10 * LOSS_TOL
    assert abs(gap_got - gap_ref) <= 2 * LOSS_TOL
    assert abs(float(got["one/ce"]) - float(ref["one/ce"])) <= LOSS_TOL
