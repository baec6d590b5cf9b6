"""The traffic generators repeat by seed and keep the sources' shapes."""
import numpy as np

from bench.harness import gen


def test_records_repeat_by_seed_and_keep_their_shape():
    a, sa = gen.make_records(500, 7)
    b, sb = gen.make_records(500, 7)
    c, _ = gen.make_records(500, 8)
    assert np.array_equal(a, b) and np.array_equal(sa, sb)
    assert not np.array_equal(a[:1000], c[:1000])
    lengths = np.diff(sa)
    assert lengths.min() >= 120 and lengths.max() <= 240
    assert bytes(a[sa[42]:sa[42] + 12]) == b"pk0000000042"


def test_edits_keep_keys_and_lengths():
    data, starts = gen.make_records(400, 1)
    rng = np.random.default_rng(3)
    for pattern, runs in (("scattered", 10), ("contiguous", 1)):
        idx = gen.pick_records(400, 10, pattern, rng)
        edits = gen.rewrite_records(data, starts, idx, rng)
        assert len(edits) <= runs
        assert sum(n for _, n, _ in edits) == int(
            sum(starts[i + 1] - starts[i] for i in idx))
        for lo, n, new in edits:
            assert len(new) == n
            for i in idx:
                if lo <= starts[i] < lo + n:
                    k = int(starts[i]) - lo
                    assert new[k:k + 12] == data[starts[i]:
                                                 starts[i] + 12].tobytes()


def test_zipfian_keys_repeat_by_seed_and_are_skewed():
    a = gen.zipf_keys(100_000, 50_000, np.random.default_rng(11))
    b = gen.zipf_keys(100_000, 50_000, np.random.default_rng(11))
    assert np.array_equal(a, b)
    assert a.min() >= 0 and a.max() < 100_000
    counts = np.sort(np.bincount(a, minlength=100_000))[::-1]
    # theta 0.99 over 10^10 ranks: the hottest keys take a few percent
    assert counts[0] > 0.01 * len(a)
    assert counts[:100].sum() > 0.1 * len(a)
    u = gen.uniform_keys(100_000, 50_000, np.random.default_rng(11))
    assert np.bincount(u).max() < 0.001 * len(u)
