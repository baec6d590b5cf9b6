"""Execution on a mesh of ranks (a process per device, gloo on the CPU):
placement, ``constrain``, ``shard_batch``, checkpoints saved from a mesh
and restored onto another, the microbatched step, and the errors kept.

Two runs of ``run_ranks`` carry most tests (module fixtures): four ranks on
the (data, model) = (2, 2) mesh (tests/torch_mesh_ranks.py::mesh_checks)
and then two ranks that restart from the durable store the four wrote,
onto (1, 2) and, by ``TrainController.remesh``, onto (2, 1)
(``remesh_checks``).  Every collective has a 60 s timeout.

Expected shards are computed here from the whole tensor: a dim over mesh
axes (a1, a2, ...) is cut into prod(sizes) equal blocks, and the rank at
coordinates (c1, c2, ...) holds block c1 * size2 * ... + c2 * ... (major to
minor, as a PartitionSpec lays out a tuple entry).
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.ckpt.store import _leaf_paths
from repro_torch.errors import ConfigError, InvariantViolation
from repro_torch.kernels import ops
from repro_torch.launch import mesh as TMesh
from repro_torch.launch.mesh import run_ranks
from repro_torch.shardings import Sharding
from repro_torch.train import AdamWConfig, make_train_step
from torch_mesh_ranks import (BAD_SPECS, SPECS, config, failing,
                              mesh_checks, remesh_checks)
from torch_model_parity import LOSS_TOL
from torch_threads import torch_one_thread  # noqa: F401 (autouse)

TIMEOUT_S = 60.0
SHAPE22 = {"data": 2, "model": 2}


@pytest.fixture(autouse=True)
def _cpu():
    prev = ops.device()
    ops.set_device("cpu")
    try:
        yield
    finally:
        ops.set_device(prev)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("multicard")


@pytest.fixture(scope="module")
def four(ckpt_dir):
    return run_ranks(mesh_checks, 4, (str(ckpt_dir),), backend="gloo",
                     device="cpu", threads=1, timeout_s=TIMEOUT_S)


@pytest.fixture(scope="module")
def two(four, ckpt_dir):
    return run_ranks(remesh_checks, 2, (str(ckpt_dir),), backend="gloo",
                     device="cpu", threads=1, timeout_s=TIMEOUT_S)


def expected_shard(full: np.ndarray, spec, shape: dict, coords: dict):
    """The block of ``full`` that the rank at ``coords`` holds under
    ``spec`` on a mesh of ``shape`` (axes of size 1 hold it whole)."""
    idx = []
    for dim in range(full.ndim):
        entry = spec[dim] if dim < len(spec) else None
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        axes = [a for a in axes if shape[a] > 1]
        n = math.prod(shape[a] for a in axes)
        block = 0
        for a in axes:
            block = block * shape[a] + coords[a]
        w = full.shape[dim] // n
        idx.append(slice(block * w, (block + 1) * w))
    return full[tuple(idx)]


def coords_of(rank: int, shape: dict) -> dict:
    out, rest = {}, rank
    for a in reversed(list(shape)):
        out[a] = rest % shape[a]
        rest //= shape[a]
    return out


def spec_at(specs, name: str):
    node = specs
    for part in name.split("/"):
        node = node[part] if isinstance(node, dict) else node
    return node


# ---------------------------------------------------------------- the mesh

def test_mesh_of_ranks_binds_a_device_mesh(four):
    """make_mesh_for(4, 2) over four ranks: the reference's (2, 2) shape,
    the ranks laid out row-major as jax.make_mesh lays out devices, each
    rank on the CPU, its coordinates its position; mesh_shape_for as the
    reference's arithmetic."""
    for r, got in enumerate(four):
        assert got["rank"] == r
        assert got["shape"] == SHAPE22
        assert got["names"] == ("data", "model")
        assert got["ranks"] == [[0, 1], [2, 3]]
        assert got["device"] == "cpu"
        assert got["index"] == coords_of(r, SHAPE22)
        for (n, a), want in got["shapes_for"].items():
            assert want == TMesh.mesh_shape_for(n, a)
    assert four[0]["shapes_for"][(4, 16)] == (1, 4)
    assert four[0]["shapes_for"][(4, 2)] == (2, 2)
    assert four[0]["shapes_for"][(4, 1)] == (4, 1)


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_place_shards_as_the_spec_says(four, spec):
    x = np.arange(4 * 8 * 4, dtype=np.float32).reshape(4, 8, 4)
    for r, got in enumerate(four):
        placements, loc, whole_ok = got[f"place/{spec}"]
        assert whole_ok
        assert np.array_equal(loc, expected_shard(x, spec, SHAPE22,
                                                  coords_of(r, SHAPE22)))
        for axis, p in zip(SHAPE22, placements):
            dims = [d for d, e in enumerate(spec)
                    if axis in ((e,) if isinstance(e, str) else e or ())]
            assert p == (f"S({dims[0]})" if dims else "R"), (axis, p)


@pytest.mark.parametrize("name", sorted(BAD_SPECS))
def test_place_rejects_invalid_specs(four, name):
    """Uneven shards (as device_put), axes the mesh lacks, a tuple out of
    the mesh's order, an axis used twice, more entries than dims."""
    assert all(got[f"bad/{name}"] == "ConfigError" for got in four)


def test_placements_on_meshes_without_ranks():
    """A one-device mesh places whole (axes of size 1 replicate); the
    production mesh binds no device."""
    one = TMesh.make_mesh_for(1, device="cpu")
    assert not one.spmd
    assert [str(p) for p in one.placements(("data", "model"))] == ["R", "R"]
    x = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(one.place(x, ("data", None)), x)
    prod = TMesh.make_production_mesh()
    assert [str(p) for p in prod.placements((("data", "model"),))] == \
        ["S(0)", "S(0)"]
    with pytest.raises(ConfigError):
        prod.placements((("data", "model"),), shape=(8,))
    with pytest.raises(ConfigError):
        prod.place(x, (None, None))
    with pytest.raises(ConfigError):
        one.placements(("pod",))


@pytest.mark.parametrize("names", [("batch", "seq", None),
                                   ("batch", "seq_res", None),
                                   (None, "heads", None),
                                   ("batch", None, "vocab"),
                                   (None, None, None)], ids=str)
def test_constrain_round_trips(four, names):
    """constrain moves a batch-sharded tensor to each spec's placements
    and back, values unchanged (tinyllama's smoke rules: heads and vocab
    over 'model', no seq_res without FSDP)."""
    rules = Sharding(_AxesOnly(SHAPE22), config("tinyllama-1.1b"), 4).rules
    for got in four:
        pl, same, back, same_back = got[f"constrain/{names}"]
        assert same and same_back
        assert back == ["S(0)", "R"]
        want = ["R", "R"]
        for d, n in enumerate(names):
            axis = rules.get(n) if n else None
            for i, a in enumerate(SHAPE22):
                if axis == a or (isinstance(axis, tuple) and a in axis):
                    want[i] = f"S({d})"
        assert pl == want, (names, pl)
    assert all(got["constrain/plain"] == "InvariantViolation"
               for got in four)


def test_constrain_is_the_identity_off_a_mesh_of_ranks():
    cfg = config("tinyllama-1.1b")
    x = torch.ones(4, 8, 4)
    for shd in (Sharding(None, cfg), Sharding(TMesh.make_mesh_for(
            1, device="cpu"), cfg, 4)):
        assert shd.constrain(x, "batch", "seq", None) is x
        assert not shd.spmd


def test_shard_batch_places_each_ranks_rows(four):
    from repro_torch.train import SyntheticLM
    cfg = config("tinyllama-1.1b")
    data = SyntheticLM(cfg.vocab, 32, 4).batch_at(0)
    for r, got in enumerate(four):
        d = coords_of(r, SHAPE22)["data"]
        for k, v in data.items():
            pl, loc = got["batch"][k]
            assert pl == ["S(0)", "R"]
            assert np.array_equal(loc, v[2 * d:2 * d + 2])


# ------------------------------------------------------------- checkpoints

def test_save_from_the_mesh_has_the_one_device_uid(four):
    uid = four[0]["uid"]
    assert all(got["uid"] == uid for got in four)
    assert four[0]["one_uid"] == uid


def test_placed_state_holds_its_shards(four):
    """init_train_state(shd=...) on the mesh: each rank's shard of every
    leaf is the block of the one-device draw its specs say."""
    from repro_torch.train import init_train_state
    cfg = config("tinyllama-1.1b")
    want = {n: t.numpy() for n, t in _leaf_paths(init_train_state(
        cfg, torch.Generator().manual_seed(0), shards=4, device="cpu")
        ) if t.dtype != torch.bfloat16}
    assert want
    for r, got in enumerate(four):
        for n, full in got["full"].items():
            spec = spec_at(got["specs"], n)
            loc, _ = got["local"][n]
            assert np.array_equal(loc, expected_shard(
                full, spec, SHAPE22, coords_of(r, SHAPE22))), n
            if n in want:
                assert np.array_equal(full, want[n]), n


MIB = 1 << 20
LEAF_BYTES = MIB // 4          # torch_mesh_ranks.LEAF_SHAPE, float32
STATE_BYTES = 16 * LEAF_BYTES
SLACK = MIB // 2               # the process's own churn in resident memory


def test_mesh_save_and_restore_go_leaf_by_leaf(four):
    """A 4 MiB state of 256 KiB leaves on (2, 2): the save from the mesh
    has the one-device uid and the restore gives back every shard; during
    the save no rank but 0 (whose store takes the whole state) holds more
    than about one leaf besides its shards, and during the restore no rank
    holds more than its shards and a few leaves (never the whole
    state)."""
    got = [r["leafwise"] for r in four]
    assert all(g["uid"] == got[0]["one_uid"] for g in got)
    assert all(g["equal"] for g in got)
    for r, g in enumerate(got):
        assert g["shard_bytes"] < STATE_BYTES / 2, r
        if r:
            assert g["save"] <= LEAF_BYTES + SLACK, (r, g["save"])
        bound = g["shard_bytes"] + 4 * LEAF_BYTES + SLACK
        assert bound < STATE_BYTES
        assert g["restore"] <= bound, (r, g["restore"])


@pytest.mark.parametrize("which", ["r12", "r21"])
def test_restore_and_remesh_onto_two_ranks(four, two, which):
    """The (2, 2) save restored by two ranks onto (1, 2), then remeshed by
    the controller onto (2, 1): each rank's shards, bit for bit, are the
    blocks of the saved values that the new specs name."""
    shape = two[0]["shapes"][0 if which == "r12" else 1]
    assert shape == ({"data": 1, "model": 2} if which == "r12"
                     else {"data": 2, "model": 1})
    cfg = config("tinyllama-1.1b")
    for r, got in enumerate(two):
        for n, full in four[0]["full"].items():
            loc, pl = got[which][n]
            spec = spec_at(four[0]["specs"], n)
            spec = Sharding(_AxesOnly(shape), cfg, 4).state_specs(
                {"params": _tree_of(four[0]["full"], "params/"),
                 "opt": _tree_of(four[0]["full"], "opt/")})
            spec = spec_at(spec, n)
            assert loc.dtype == full.dtype, n
            assert np.array_equal(loc, expected_shard(
                full, spec, shape, coords_of(r, shape))), (which, n)
        assert got["missing"] == "CheckpointMissing"


class _AxesOnly:
    """A stand-in mesh for the rules (``Sharding`` reads the axis names and
    sizes only)."""

    def __init__(self, shape: dict):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


def _tree_of(flat: dict, prefix: str) -> dict:
    out: dict = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        node = out
        parts = k[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(np.array(v)) \
            if v.dtype != object else v
    return out


# ---------------------------------------------------------------- training

def test_microbatches_slice_each_ranks_rows(four):
    """microbatch=2 on the mesh takes local row i of every data shard:
    rows (0, 2) then (1, 3) of the global batch, so it equals the
    one-device microbatched step on the rows in that order (float32
    gradients)."""
    from repro_torch.models import model as M
    from repro_torch.train import SyntheticLM
    from repro_torch.train.step import state_from_numpy
    cfg = config("tinyllama-1.1b")
    start = four[0]["full"]
    st = state_from_numpy({"params": _tree_of(start, "params/"),
                           "opt": _tree_of(start, "opt/")}, device="cpu")
    st = M.tree_map(lambda a: a.float() if a.is_floating_point() else a, st)
    data = SyntheticLM(cfg.vocab, 32, 4).batch_at(0)
    batch = {k: torch.from_numpy(v[[0, 2, 1, 3]]) for k, v in data.items()}
    opt = AdamWConfig(lr=1e-3, warmup_steps=1)
    new, m = make_train_step(cfg, Sharding(None, cfg), opt, microbatch=2,
                             grad_dtype=torch.float32)(st, batch)
    assert abs(four[0]["mb/loss"] - float(m["loss"])) <= LOSS_TOL
    for n, t in _leaf_paths(new["opt"]["master"]):
        diff = np.abs(four[0]["mb/master"][n] - t.numpy())
        assert diff.max() <= 2.05 * 1e-3, n


# ------------------------------------------------ torch's private names

def test_all_gather_route_replaces_the_cuda_kernel(two):
    """A CPU mesh leaves torch's functional all-gather alone; after
    ``route_all_gather`` the dispatcher's CUDA entry for it is the
    route's, and that entry gathers every rank's rows in rank order (a
    registration that gathered nothing would fail here; on CUDA meshes
    phase 11 of chip_smoke.py checks that ``make_mesh_for`` installs
    it)."""
    for got in two:
        r = got["routed"]
        assert not r["before"] and r["after"]
        assert np.array_equal(r["gathered"], [[0.0] * 3, [1.0] * 3])


@pytest.mark.parametrize("owner, name", [
    ("dispatcher", "_allow_implicit_replication"),
    ("c10d", "_resolve_process_group")])
def test_missing_private_torch_names_raise(monkeypatch, owner, name):
    """The private torch names a mesh of ranks relies on are present in
    this torch; without either, ``check_torch_names`` (run when a mesh of
    ranks is bound and by ``route_all_gather``) raises ConfigError."""
    from torch.distributed import distributed_c10d
    from torch.distributed.tensor import DTensor

    from repro_torch.mesh import check_torch_names
    check_torch_names()
    obj = DTensor._op_dispatcher if owner == "dispatcher" \
        else distributed_c10d
    if not isinstance(obj, type(distributed_c10d)) and name not in vars(obj):
        obj = type(obj)        # a property of the class in newer torch
    monkeypatch.delattr(obj, name)
    with pytest.raises(ConfigError, match=name):
        check_torch_names()


# ------------------------------------------------------- errors kept

def test_a_failing_rank_fails_the_run():
    """A rank that raises while the others wait in a collective: the run
    raises InvariantViolation with that rank's error, and every rank
    process has ended."""
    with pytest.raises(InvariantViolation, match="this rank fails"):
        run_ranks(failing, 2, (1,), backend="gloo", device="cpu",
                  threads=1, timeout_s=TIMEOUT_S)


def test_config_errors_kept():
    """NCCL with more ranks than cards, a mesh of ranks without a process
    group, an unknown backend, a rank outside the world."""
    with pytest.raises(ConfigError):
        TMesh.init_distributed("nccl", rank=0, world_size=2,
                               device="cuda", init_method="file:///none")
    with pytest.raises(ConfigError):
        TMesh.init_distributed("mpi", rank=0, world_size=1, device="cpu")
    with pytest.raises(ConfigError):
        TMesh.init_distributed("gloo", rank=2, world_size=2, device="cpu")
    with pytest.raises(ConfigError):
        TMesh.make_mesh_for(2, device="cpu")
