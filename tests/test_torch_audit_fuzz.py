"""Audit fuzz of the port (repro_torch.proof.Auditor) against randomly
corrupted replicas, on the CPU.

Each episode builds a small replicated store, injects a random
corruption (bit flip, truncation, chunk loss — on a random replica), and
requires the auditor to report a finding naming the offending replica
and cid.  Sound reporting is checked throughout: a clean deployment must
never produce findings.

The JAX package's ``tests/test_audit_fuzz.py`` less its audit-daemon
half, which builds a ``Cluster`` and comes with the cluster slice of the
port.  The deep, env-scaled variant reads ``AUDIT_FUZZ_EPISODES``."""
from __future__ import annotations

import os

import numpy as np
import pytest

from repro_torch.core import FBlob, ForkBase
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
