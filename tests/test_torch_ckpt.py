"""Checkpoints and the training controller of the port (repro_torch.ckpt,
repro_torch.runtime), on the CPU: the ckpt and controller tests of the JAX
package's ``tests/test_train_runtime.py`` (failure recovery, multiple
failures, fork and lineage, racing pods, placement-agnostic restore), on a
tiny torch model — a token embedding and a two-layer MLP trained by a
deterministic SGD step — because the reference's fixture builds a JAX
train step.  ``CheckpointStore.verify`` walks a lineage proof.

Also here: the pytree flattening that names the leaves, the dtype table
(0-d, empty, bool and bfloat16 leaves) and the placement arguments of
``restore``.
"""
from collections import OrderedDict

import numpy as np
import pytest
import torch

from repro_torch.ckpt import CheckpointStore, restore_tree, save_tree
from repro_torch.ckpt.store import _leaf_paths, manifest_refs
from repro_torch.core import ForkBase
from repro_torch.errors import CheckpointMissing, ConfigError, TensorMissing
from repro_torch.kernels import ops
from repro_torch.runtime import TrainController, run_resilient

VOCAB, DIM, HIDDEN, SEQ, BATCH = 64, 16, 32, 8, 32


@pytest.fixture(autouse=True)
def _cpu_device():
    ops.set_device("cpu")
    yield
    ops.set_device("cuda")


class TinyLM:
    """Correlated synthetic tokens, deterministic in (seed, step), like
    the reference's ``SyntheticLM``."""

    def __init__(self, seed: int = 0):
        self.seed = seed

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed << 32) ^ step)
        base = rng.integers(0, VOCAB, size=(BATCH, SEQ + 1), dtype=np.int32)
        rep = rng.random((BATCH, SEQ + 1)) < 0.5
        tokens = np.where(rep, np.roll(base, 1, axis=1), base)
        return {"tokens": tokens[:, :-1].astype(np.int64),
                "labels": tokens[:, 1:].astype(np.int64)}


def init_state(seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    params = {
        "embed": torch.randn(VOCAB, DIM, generator=g) * 0.3,
        "mlp": {"w1": torch.randn(DIM, HIDDEN, generator=g) * 0.3,
                "w2": torch.randn(HIDDEN, VOCAB, generator=g) * 0.3},
    }
    return {"params": params,
            "ema": params["embed"].to(torch.bfloat16),
            "opt": {"step": torch.tensor(0, dtype=torch.int32)}}


def train_step(state, batch, lr: float = 4.0):
    """One SGD step of next-token cross-entropy; deterministic on the
    CPU, so a replay after a restore is bit-identical."""
    p = {"embed": state["params"]["embed"].clone().requires_grad_(),
         "w1": state["params"]["mlp"]["w1"].clone().requires_grad_(),
         "w2": state["params"]["mlp"]["w2"].clone().requires_grad_()}
    h = torch.relu(p["embed"][batch["tokens"]] @ p["w1"])
    logits = h @ p["w2"]
    loss = torch.nn.functional.cross_entropy(
        logits.reshape(-1, VOCAB), batch["labels"].reshape(-1))
    loss.backward()
    with torch.no_grad():
        new = {k: v - lr * v.grad for k, v in p.items()}
        ema = (0.9 * state["ema"].float() + 0.1 * new["embed"]).to(
            torch.bfloat16)
    params = {"embed": new["embed"].detach(),
              "mlp": {"w1": new["w1"].detach(), "w2": new["w2"].detach()}}
    return ({"params": params, "ema": ema,
             "opt": {"step": state["opt"]["step"] + 1}},
            {"loss": loss.detach()})


def leaves(tree) -> list[torch.Tensor]:
    return [leaf for _, leaf in _leaf_paths(tree)]


def assert_trees_equal(a, b):
    la, lb = _leaf_paths(a), _leaf_paths(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (name, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert torch.equal(x, y), name


@pytest.fixture(scope="module")
def setup():
    return init_state(), TinyLM()


# ------------------------------------------- test_train_runtime.py copies

def test_loss_decreases_on_the_tiny_model(setup):
    state, ds = setup
    losses = []
    for i in range(30):
        batch = {k: torch.as_tensor(v) for k, v in ds.batch_at(i).items()}
        state, m = train_step(state, batch)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses


def test_failure_recovery_bitexact(setup):
    state, ds = setup
    a = run_resilient(train_step, state, ds, n_steps=8, ckpt_every=3)
    b = run_resilient(train_step, state, ds, n_steps=8, fail_at=(5,),
                      ckpt_every=3)
    assert b.restarts == 1
    for x, y in zip(leaves(a.state["params"]), leaves(b.state["params"])):
        assert torch.equal(x, y)


def test_multiple_failures(setup):
    state, ds = setup
    ctl = run_resilient(train_step, state, ds, n_steps=10,
                        fail_at=(3, 6, 6), ckpt_every=2)
    assert ctl.step == 10 and ctl.restarts >= 2


def test_ckpt_fork_and_lineage(setup):
    state, ds = setup
    ck = CheckpointStore()
    ck.save(state, "main", step=0)
    state2, _ = train_step(state, {k: torch.as_tensor(v)
                                   for k, v in ds.batch_at(0).items()})
    u1 = ck.save(state2, "main", step=1)
    ck.fork("main", "sweep")
    r = ck.restore(state, "sweep")
    for x, y in zip(leaves(r["params"]), leaves(state2["params"])):
        assert torch.equal(x, y)
    hist = ck.history("main")
    assert [h[1]["step"] for h in hist] == [1, 0]
    assert ck.verify(u1, hist[-1][0])


def test_foc_racing_pods(setup):
    state, ds = setup
    ck = CheckpointStore()
    ck.save(state, "run", step=4)
    base = ck.db.get("ckpt", "run").uid
    sA, _ = train_step(state, {k: torch.as_tensor(v)
                               for k, v in ds.batch_at(4).items()})
    uA = ck.save_on_base(sA, base, step=5)
    uB = ck.save_on_base(state, base, step=4)
    heads = ck.racing_heads()
    assert uA in heads and uB in heads
    winner = ck.resolve_race(uA, uB)
    assert winner in ck.racing_heads()


def test_elastic_restore_roundtrip(setup):
    """The checkpoint is placement-agnostic: restore onto an explicit
    device.  Specs are ignored without a mesh, as in the reference; on a
    device they may only replicate, and a spec naming a mesh axis raises
    ConfigError."""
    state, _ = setup
    ck = CheckpointStore()
    ck.save(state, "run", step=0)
    assert_trees_equal(ck.restore(state, "run"), state)
    assert_trees_equal(
        ck.restore(state, "run", mesh=torch.device("cpu")), state)
    assert_trees_equal(
        ck.restore(state, "run", mesh=torch.device("cpu"), specs={}), state)
    assert_trees_equal(
        ck.restore(state, "run", specs={"params": ("data", "model")}), state)
    with pytest.raises(ConfigError):
        ck.restore(state, "run", mesh=torch.device("cpu"),
                   specs={"params": (None, "model")})


# ------------------------------------------------------ controller verbs

def test_remesh_and_fork_experiment(setup):
    state, ds = setup
    ck = CheckpointStore()
    ctl = TrainController(train_step, state, ds, ck, ckpt_every=2)
    ctl.run(4)
    before = ctl.state
    assert_trees_equal(ctl.remesh(torch.device("cpu"), None), before)
    assert_trees_equal(ctl.remesh(torch.device("cpu"), {"params": None}),
                       before)
    with pytest.raises(ConfigError):
        ctl.remesh(torch.device("cpu"), {"params": ("data",)})
    ctl.fork_experiment("from2", from_step=2)
    assert ck.step_of(ck.db.get("ckpt", "from2").uid) == 2
    ctl.fork_experiment("head")
    assert ck.db.get("ckpt", "head").uid == ck.db.get("ckpt", "run").uid
    with pytest.raises(CheckpointMissing):
        ctl.fork_experiment("nope", from_step=3)


def test_controller_batches_land_on_the_engine_device(setup):
    state, ds = setup
    seen = []

    def step_fn(s, batch):
        seen.append({v.device.type for v in batch.values()})
        return train_step(s, batch)

    run_resilient(step_fn, state, ds, n_steps=2, ckpt_every=5)
    assert seen == [{"cpu"}, {"cpu"}]


# ------------------------------------------------- names, dtypes, restore

def test_leaf_names_follow_jax_flattening():
    tree = {"b": [torch.zeros(1), (torch.zeros(2), None)],
            "a": {"z": torch.zeros(3), "y": torch.zeros(4)},
            "c": OrderedDict([("q", torch.zeros(5)), ("p", torch.zeros(6))]),
            "n": None}
    assert [n for n, _ in _leaf_paths(tree)] == [
        "a/y", "a/z", "b/0", "b/1/0", "c/q", "c/p"]


@pytest.mark.parametrize("leaf", [
    torch.tensor(7, dtype=torch.int32),
    torch.zeros((0, 3), dtype=torch.float32),
    torch.tensor([True, False, True]),
    torch.arange(12, dtype=torch.float32).reshape(3, 4).to(torch.bfloat16),
    torch.arange(6, dtype=torch.float64).reshape(2, 3).t(),
    torch.arange(5, dtype=torch.int64) - 2,
    torch.arange(4, dtype=torch.uint8),
    torch.arange(4, dtype=torch.float16),
], ids=["int32-0d", "empty", "bool", "bf16", "f64-strided", "int64",
        "uint8", "f16"])
def test_leaf_dtypes_shapes_roundtrip(leaf):
    db = ForkBase()
    uid = save_tree({"x": leaf, "y": [leaf]}, db, step=3)
    out = restore_tree({"x": None, "y": [torch.empty(0)]}, db)
    assert out["x"] is None                     # None: an empty subtree
    got = out["y"][0]
    assert got.dtype == leaf.dtype and got.shape == leaf.shape
    assert torch.equal(got, leaf)
    assert CheckpointStore(db).step_of(uid) == 3


def test_restore_names_the_missing_tensor(setup):
    state, _ = setup
    ck = CheckpointStore()
    ck.save({"params": state["params"]}, "run", step=0)
    with pytest.raises(TensorMissing):
        ck.restore(state, "run")
    with pytest.raises(CheckpointMissing):
        ck.restore(state, "nobranch")


def test_manifest_refs_surface_tensor_roots(setup):
    state, _ = setup
    ck = CheckpointStore()
    uid = ck.save(state, "run", step=0)
    assert manifest_refs in ck.db.gc_hooks
    CheckpointStore(ck.db)                       # registers once
    assert ck.db.gc_hooks.count(manifest_refs) == 1
    manifest = ck.db.get("ckpt", uid=uid).map()
    raw = ck.db.store.get(manifest.tree.root_cid)
    refs = manifest_refs(raw)
    assert len(refs) == len(leaves(state))
    assert all(ck.db.store.has_many(refs))
    assert manifest_refs(ck.db.store.get(uid)) == []    # a meta chunk
