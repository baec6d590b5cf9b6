"""The kernel wrappers' launch counts are exact across threads: every bump
and read of kernels.counter.LAUNCHES takes its lock, so no update is
lost when threads interleave (an unlocked ``+=`` on a shared int can lose
some)."""
import sys
import threading

from repro_torch.kernels import ops
from repro_torch.kernels.counter import LAUNCHES, LaunchCounter

THREADS, BUMPS = 8, 10_000


def test_eight_threads_count_exactly():
    counter = LaunchCounter(("a", "b"))
    start = threading.Barrier(THREADS)

    def work():
        start.wait()
        for _ in range(BUMPS):
            counter.bump("a")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=work) for _ in range(THREADS)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(old)
    assert counter.snapshot() == {"a": THREADS * BUMPS, "b": 0}
    counter.reset()
    assert counter.snapshot() == {"a": 0, "b": 0}


def test_ops_reads_and_zeroes_the_wrappers_counts():
    ops.reset_launches()
    assert ops.launches() == {"boundary_bitmap": 0, "fphash_many": 0,
                              "fphash": 0}
    LAUNCHES.bump("fphash")
    LAUNCHES.bump("fphash")
    assert ops.launches()["fphash"] == 2
    ops.reset_launches()
    assert ops.launches()["fphash"] == 0
