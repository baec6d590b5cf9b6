"""Audit fuzz of the port (repro_torch.proof.Auditor and AuditDaemon)
against randomly corrupted replicas and cluster nodes, on the CPU.

Each episode builds a small deployment, lets the daemon reach a clean
steady state where it has one, injects a random corruption (bit flip,
truncation, chunk loss, head-meta tamper — on a random replica/node),
and requires the auditor to report a finding naming the offending
replica or node (and the daemon to quarantine it, within a bounded
number of ticks).  Sound reporting is checked throughout: a clean
deployment must never produce findings.

The JAX package's ``tests/test_audit_fuzz.py``.  The deep, env-scaled
variants read ``AUDIT_FUZZ_EPISODES``."""
from __future__ import annotations

import os

import numpy as np
import pytest

from repro_torch.core import Cluster, FBlob, FMap, ForkBase
from repro_torch.core.chunk import encode_chunk
from repro_torch.core.chunker import ChunkParams
from repro_torch.kernels import ops
from repro_torch.storage import MemoryBackend, ReplicatedBackend

PARAMS = ChunkParams(q=8)


@pytest.fixture(autouse=True)
def _cpu_device():
    ops.set_device("cpu")
    yield
    ops.set_device("cuda")


def _flip(raw: bytes, rng) -> bytes:
    i = int(rng.integers(0, len(raw)))
    return raw[:i] + bytes([raw[i] ^ (1 << int(rng.integers(0, 8)))]) \
        + raw[i + 1:]


# ------------------------------------------------------------- replicas

def _replica_episode(rng) -> None:
    rb = ReplicatedBackend([MemoryBackend() for _ in range(3)], k=2)
    db = ForkBase(rb, PARAMS)
    for i in range(int(rng.integers(1, 4))):
        db.put(b"k%d" % i, FBlob(rng.bytes(int(rng.integers(500, 8000)))))
    rb.put(encode_chunk(3, rng.bytes(int(rng.integers(64, 512)))))
    assert rb.audit(sample=10_000).ok            # clean: no findings
    # corrupt ONE ring copy of one random cid on one random replica
    cid = sorted(rb.iter_cids())[int(rng.integers(0, len(rb)))]
    holders = [si for si, s in enumerate(rb.stores) if s.has(cid)]
    victim = holders[int(rng.integers(0, len(holders)))]
    mode = int(rng.integers(0, 3))
    store = rb.stores[victim]
    if mode == 0:                                # bit flip
        store._data[cid] = _flip(store._data[cid], rng)
        want_kind = "corrupt"
    elif mode == 1:                              # truncation
        store._data[cid] = store._data[cid][:max(1, len(store._data[cid])
                                                 // 2)]
        want_kind = "corrupt"
    else:                                        # silent loss
        del store._data[cid]
        want_kind = "missing"
    rep = rb.audit(sample=10_000)
    assert not rep.ok
    assert any(f.kind == want_kind and f.node == f"replica{victim}"
               and f.cid == cid for f in rep.findings), rep


def _run_replica_fuzz(episodes: int, seed: int) -> None:
    rng = np.random.default_rng(seed)
    for _ in range(episodes):
        _replica_episode(rng)


def test_replica_audit_fuzz_fast(rng):
    _run_replica_fuzz(episodes=5, seed=10)


@pytest.mark.slow
def test_replica_audit_fuzz_deep():
    _run_replica_fuzz(
        episodes=int(os.environ.get("AUDIT_FUZZ_EPISODES", "50")),
        seed=11)


# -------------------------------------------------------- cluster daemon

def _daemon_episode(rng) -> None:
    cl = Cluster(int(rng.integers(2, 5)), params=PARAMS)
    keys = [b"key%d" % i for i in range(int(rng.integers(3, 9)))]
    for k in keys:
        cl.put(k, FMap({b"e%02d" % j: rng.bytes(12)
                        for j in range(int(rng.integers(5, 40)))}))
    daemon = cl.audit_daemon(sample=10_000, secret=b"s", max_interval=8)
    for _ in range(int(rng.integers(3, 12))):    # clean warm-up ticks
        assert cl.audit_tick(budget=2).ok
    assert not daemon.quarantined
    # corrupt a random head meta chunk (always covered by the engine
    # audit) on its home node
    k = keys[int(rng.integers(0, len(keys)))]
    ni = cl._home_index(k)
    uid = cl.nodes[ni].servlet.branches.head(k, "master")
    if int(rng.integers(0, 2)):
        cl.nodes[ni].store._data[uid] = _flip(cl.nodes[ni].store._data[uid],
                                              rng)
    else:
        del cl.nodes[ni].store._data[uid]
    # detection within one full backoff cycle of ticks
    for _ in range(daemon.max_interval + len(cl.nodes) + 2):
        rep = cl.audit_tick(budget=2)
        if not rep.ok:
            break
    assert f"node{ni}" in daemon.quarantined, (ni, daemon.quarantined)
    assert any(f.node == f"node{ni}" for f in daemon.findings)


def _run_daemon_fuzz(episodes: int, seed: int) -> None:
    rng = np.random.default_rng(seed)
    for _ in range(episodes):
        _daemon_episode(rng)


def test_daemon_audit_fuzz_fast(rng):
    _run_daemon_fuzz(episodes=3, seed=20)


@pytest.mark.slow
def test_daemon_audit_fuzz_deep():
    _run_daemon_fuzz(
        episodes=int(os.environ.get("AUDIT_FUZZ_EPISODES", "50")),
        seed=21)
