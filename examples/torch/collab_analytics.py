"""Collaborative analytics: two analysts fork a relational dataset, apply
independent transformations, merge, and run aggregations on row vs column
layouts (paper §5.3).

Run:  python examples/torch/collab_analytics.py [--device cuda|cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "src"))
import numpy as np

from repro_torch.apps import ColumnTable, OrpheusLite, RowTable
from repro_torch.core import ForkBase


def _device_from_argv() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the engine's device (default: CUDA)")
    from repro_torch.kernels import ops
    ops.set_device(ap.parse_args().device)


def main():
    rng = np.random.default_rng(3)
    db = ForkBase()
    n = 20_000
    recs = [[f"cust{i:08d}".encode(),
             str(int(rng.integers(18, 90))).encode(),       # age
             str(int(rng.integers(0, 100_000))).encode(),   # spend
             rng.bytes(int(rng.integers(80, 160)))]          # payload
            for i in range(n)]

    rt = RowTable(db, "purchases")
    t0 = time.perf_counter()
    v0 = rt.load({r[0]: r for r in recs})
    print(f"import {n} records: {time.perf_counter() - t0:.2f}s, "
          f"{db.store.stats.physical_bytes / 1e6:.1f}MB")

    # analyst A: data cleaning on a fork
    rt.fork("cleaning")
    rta = RowTable(db, "purchases", "cleaning")
    fixes = {recs[i][0]: [recs[i][0], b"30", recs[i][2], recs[i][3]]
             for i in range(0, n, 500)}
    t0 = time.perf_counter()
    va = rta.update(fixes)
    print(f"analyst A: {len(fixes)} fixes committed in "
          f"{(time.perf_counter() - t0) * 1e3:.1f}ms (copy-on-write)")

    # analyst B: behavioural analysis on master, untouched by A
    assert rt.get(recs[0][0])[1] != b"30"
    t0 = time.perf_counter()
    total_spend = rt.aggregate(2)
    print(f"analyst B: total spend {total_spend} in "
          f"{(time.perf_counter() - t0) * 1e3:.0f}ms (row layout)")

    # merge A's cleaning into master
    db.merge("purchases", "master", "cleaning")
    assert rt.get(recs[0][0])[1] == b"30"
    print("merged cleaning branch into master")

    # column layout: aggregation touches one column's chunks only
    ct = ColumnTable(db, "purchases_col", ["pk", "age", "spend", "payload"])
    ct.load(recs)
    t0 = time.perf_counter()
    s_col = ct.aggregate("spend")
    t_col = time.perf_counter() - t0
    ol = OrpheusLite()
    vo = ol.load(recs)
    t0 = time.perf_counter()
    s_or = ol.aggregate(vo, 2)
    t_or = time.perf_counter() - t0
    assert s_col == s_or == total_spend
    print(f"aggregate: column layout {t_col * 1e3:.0f}ms vs "
          f"orpheus-style {t_or * 1e3:.0f}ms ({t_or / t_col:.1f}x)")

    a, r, c = rt.diff(db.get("purchases", "master").uid, v0)
    print(f"version diff vs v0: {len(c)} changed rows "
          f"(found via POS-Tree cid-skip)")


if __name__ == "__main__":
    _device_from_argv()
    main()
