"""Runtime lock witness of the port (repro_torch.core.locking): rank
inversions, cycles and hold accounting — the JAX package's
``tests/test_lock_witness.py``, its end-to-end cluster test included.
The port's tables must stay
the reference's (the static analyzer reads the reference's)."""
import threading

import pytest

from repro.core import locking as ref_locking
from repro_torch.core import locking
from repro_torch.core.locking import (LOCK_ATTRS, LOCK_ORDER, LockWitness,
                                      WitnessLock, make_lock)
from repro_torch.errors import ConfigError, InvariantViolation


# ------------------------------------------------------------- the tables

def test_lock_order_table_is_consistent():
    # every attribute resolves to a declared rank; servlet is outermost
    for attr, rank_name in LOCK_ATTRS.items():
        assert rank_name in LOCK_ORDER, attr
    assert LOCK_ORDER["servlet"] < LOCK_ORDER["collector"]
    assert LOCK_ORDER["collector"] < LOCK_ORDER["index"]
    assert LOCK_ORDER["index"] == LOCK_ORDER["store"]   # incomparable pair
    assert LOCK_ORDER["fence"] > LOCK_ORDER["store"]
    assert LOCK_ORDER == ref_locking.LOCK_ORDER
    assert LOCK_ATTRS == ref_locking.LOCK_ATTRS


def test_make_lock_plain_when_witness_off():
    if locking.witness_enabled():
        pytest.skip("suite runs under REPRO_LOCK_WITNESS=1")
    lk = make_lock("servlet")
    assert not isinstance(lk, WitnessLock)
    with lk:            # still a working RLock
        with lk:
            pass


def test_make_lock_witnessed_when_enabled():
    locking.enable_witness()
    try:
        lk = make_lock("store", label="n0")
        assert isinstance(lk, WitnessLock)
        assert lk.display == "store[n0]"
    finally:
        locking.disable_witness()


def test_unranked_name_rejected():
    with pytest.raises(ConfigError):
        WitnessLock("bogus")
    with pytest.raises(ConfigError):
        make_lock("bogus")


# ------------------------------------------------------------- detection

def test_single_thread_rank_inversion_detected():
    w = LockWitness()
    servlet = WitnessLock("servlet", label="n0", witness=w)
    coll = WitnessLock("collector", label="gc", witness=w)
    with coll:
        with servlet:            # servlet(10) under collector(20): inverted
            pass
    assert len(w.violations) == 1
    v = w.violations[0]
    assert v.kind == "rank-inversion"
    assert v.acquiring == "servlet[n0]"
    assert "collector[gc]" in v.held
    with pytest.raises(InvariantViolation):
        w.assert_clean()


def test_ascending_nesting_is_clean():
    w = LockWitness()
    servlet = WitnessLock("servlet", witness=w)
    coll = WitnessLock("collector", witness=w)
    store = WitnessLock("store", witness=w)
    with servlet:
        with coll:
            with store:
                pass
    w.assert_clean()
    assert w.violations == []


def test_two_thread_inversion_detected():
    # t1 takes a then b; t2 takes b then a.  Threads run SEQUENTIALLY —
    # the witness flags the *order* (a latent deadlock) without needing
    # the unlucky interleaving that would actually wedge.
    w = LockWitness()
    a = WitnessLock("index", label="a", witness=w)
    b = WitnessLock("store", label="b", witness=w)

    def t1():
        with a:
            with b:
                pass

    def t2():
        with b:
            with a:
                pass

    th = threading.Thread(target=t1, name="t1")
    th.start(); th.join()
    assert w.violations == []        # first order just seeds the graph
    th = threading.Thread(target=t2, name="t2")
    th.start(); th.join()
    kinds = [v.kind for v in w.violations]
    assert "cycle" in kinds
    v = next(v for v in w.violations if v.kind == "cycle")
    assert v.thread == "t2"
    assert v.acquiring == "index[a]"
    with pytest.raises(InvariantViolation) as ei:
        w.assert_clean()
    assert "cycle" in str(ei.value)


def test_gc_acquisition_pattern_is_clean():
    # mimic incremental_gc: all servlet locks ascending, collector inside;
    # then a mutator thread takes one servlet lock, then the collector.
    w = LockWitness()
    servlets = [WitnessLock("servlet", label=f"n{i}", witness=w)
                for i in range(3)]
    coll = WitnessLock("collector", label="gc", witness=w)

    def begin():
        from contextlib import ExitStack
        with ExitStack() as stack:
            for lk in servlets:
                stack.enter_context(lk)
            with coll:
                pass

    def mutate():
        with servlets[1]:
            with coll:
                pass

    for fn in (begin, mutate):
        th = threading.Thread(target=fn)
        th.start(); th.join()
    w.assert_clean()


def test_gc_pattern_reverted_order_is_flagged():
    # the pre-fix shape — collector (begin()) before the servlet locks —
    # is exactly a rank inversion the witness refuses
    w = LockWitness()
    servlet = WitnessLock("servlet", label="n0", witness=w)
    coll = WitnessLock("collector", label="gc", witness=w)
    with coll:
        with servlet:
            pass
    assert any(v.kind == "rank-inversion" for v in w.violations)


def test_descending_servlet_nesting_is_flagged():
    # same-rank locks escape the rank check; the cycle detector catches
    # the AB/BA pair across two threads
    w = LockWitness()
    n0 = WitnessLock("servlet", label="n0", witness=w)
    n1 = WitnessLock("servlet", label="n1", witness=w)

    def ascending():
        with n0:
            with n1:
                pass

    def descending():
        with n1:
            with n0:
                pass

    for fn in (ascending, descending):
        th = threading.Thread(target=fn)
        th.start(); th.join()
    assert any(v.kind == "cycle" for v in w.violations)


# ------------------------------------------------------------ accounting

def test_reentrant_acquire_reports_once():
    w = LockWitness()
    lk = WitnessLock("servlet", label="n0", witness=w)
    with lk:
        with lk:                 # re-entry: depth-counted, not re-reported
            pass
    st = w.holds["servlet[n0]"]
    assert st.acquisitions == 1
    assert st.held_total_s >= 0.0
    assert st.held_max_s <= st.held_total_s + 1e-9


def test_report_shape():
    w = LockWitness()
    lk = WitnessLock("fence", label="f", witness=w)
    with lk:
        pass
    rep = w.report()
    assert rep["violations"] == []
    assert rep["locks"]["fence[f]"]["acquisitions"] == 1
    assert rep["locks"]["fence[f]"]["held_max_s"] >= 0.0


def test_reset_clears_graph_and_stats():
    w = LockWitness()
    a = WitnessLock("index", witness=w)
    b = WitnessLock("store", witness=w)
    with a:
        with b:
            pass
    w.reset()
    assert w.holds == {} and w.violations == []
    # opposite order after reset: no stale edge -> no cycle
    with b:
        with a:
            pass
    assert w.violations == []


# ----------------------------------------------------- end-to-end wiring

def test_witnessed_engine_incremental_gc(rng):
    """The port's engine under the witness: a full incremental GC epoch
    with a put landing mid-mark (the barrier takes the collector lock
    parked on the store, the fence lock nests inside) acquires ranked
    locks only in documented order."""
    from repro_torch.core import FBlob, ForkBase
    from repro_torch.gc import GCPhase
    from repro_torch.kernels import ops
    ops.set_device("cpu")
    locking.enable_witness()
    locking.WITNESS.reset()
    try:
        db = ForkBase()
        db.put("k", FBlob(rng.bytes(20_000)), "tmp")
        db.remove("k", "tmp")
        col = db.incremental_gc()
        col.step(budget=4)
        db.put("k2", FBlob(rng.bytes(20_000)))     # barrier under the lock
        while col.step(budget=64) is not GCPhase.DONE:
            pass
        assert col.report.swept_chunks > 0 and col.report.barriered > 0
        locking.WITNESS.assert_clean()
        ranks = {name.split("[")[0].split("#")[0]
                 for name in locking.WITNESS.report()["locks"]}
        assert {"collector", "fence"} <= ranks   # the wiring is live
    finally:
        locking.disable_witness()
        locking.WITNESS.reset()
        ops.set_device("cuda")


def test_witnessed_cluster_round_trip(rng):
    """Real cluster under the witness: puts, reads, and a full
    incremental GC epoch acquire ranked locks only in documented
    order."""
    from repro_torch.kernels import ops
    ops.set_device("cpu")
    locking.enable_witness()
    locking.WITNESS.reset()
    try:
        from repro_torch.core.cluster import Cluster
        cl = Cluster(n_nodes=3)
        for i in range(4):
            cl.put(f"k{i}".encode(), rng.integers(0, 256, 4096,
                                                  dtype="u1").tobytes())
        from repro_torch.gc.incremental import GCPhase
        col = cl.incremental_gc()
        while col.step(budget=64) is not GCPhase.DONE:
            pass
        for i in range(4):
            assert cl.get(f"k{i}".encode()) is not None
        locking.WITNESS.assert_clean()
        rep = locking.WITNESS.report()
        ranks = {name.split("[")[0].split("#")[0]
                 for name in rep["locks"]}
        assert "servlet" in ranks            # the wiring is actually live
    finally:
        locking.disable_witness()
        locking.WITNESS.reset()
        ops.set_device("cuda")
