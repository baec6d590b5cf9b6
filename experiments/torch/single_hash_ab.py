"""The paths that hash one value a launch (kernel #3), under two source
trees of the repo, on one GPU, in the order A, B, B, A (each run a fresh
process).

    python3 experiments/torch/single_hash_ab.py [--records N] <tree A> <tree B>

A tree is a directory that holds ``chip_smoke.py`` and ``src/repro_torch``
(the repo's root, or an unpacked ``git archive`` of another commit).  Each
run imports that tree's ``chip_smoke`` and drives, on a dataset of
``--records`` records (phase 4's default, 1,000,000):

  * one single hash (``ops.content_hash``) of a 63-byte and of a 4,097-byte
    value, the median host wall time of SINGLE_REPS calls each;
  * phase 4, ``durable_path``: the durable verifying engine's put, sync,
    reopen and get, and ``check_ms``;
  * phase 6 (b), ``attest_churn`` at its default sizes: delta and full
    attestations and ``node_hash_ms``;
  * phase 7 (d), ``cluster_durable``: the durable verifying cluster.

Prints one JSON line a run, then the card's name and power limit.
"""
import argparse
import json
import os
import subprocess
import sys
import time

SINGLE_REPS = 2000


def run_one(tree: str, records: int) -> dict:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core import hashing
    from repro_torch.kernels import build, ops

    dev = torch.device("cuda")
    ops.set_device(dev)
    build.build_all()
    out = {"module": cs.__file__}
    rng = np.random.default_rng(7)
    for name, n in (("meta", 63), ("leaf", 4097)):
        v = rng.bytes(n)
        ops.content_hash(v)
        times = []
        for _ in range(SINGLE_REPS):
            t = time.perf_counter()
            ops.content_hash(v)
            times.append(time.perf_counter() - t)
        out[f"single_{name}_ms"] = float(np.median(times)) * 1e3
    ds = cs.make_dataset(records, 0)
    want = cs.memory_uids(ds)
    t = time.perf_counter()
    dp = cs.durable_path(ds, want)
    out["durable"] = {
        "phase_s": time.perf_counter() - t,
        "put_MB_s": dp["bytes"] / 1e6 / dp["put_s"],
        "put_v2_s": dp["put_v2_s"],
        "get_MB_s": (3 * dp["bytes"] + len(ds["tail"])) / 1e6 / dp["get_s"],
        "check_ms": dp["check_ms"], "put_launches": dp["put_launches"],
        "get_launches": dp["get_launches"]}
    hashing.use_fphash()              # as phases 6 and 7 run these parts
    try:
        ch = cs.attest_churn(cs.CHURN_HEADS, cs.CHURN_UPDATES,
                             cs.CHURN_ROUNDS, seed=1)
        t = time.perf_counter()
        cd = cs.cluster_durable(ds, want[0])
        cd["part_s"] = time.perf_counter() - t
    finally:
        hashing.use_sha256()
    out["churn"] = {k: ch[k] for k in (
        "first_attest_ms", "delta_attest_ms", "full_attest_ms",
        "node_hash_ms", "delta_fphash_per_attest", "full_fphash_per_attest")}
    mb = cd["bytes"] / 1e6
    out["cluster_durable"] = {
        "part_s": cd["part_s"], "put_MB_s": mb / cd["put_s"],
        "get_MB_s": mb / cd["get_s"], "audit_ms": cd["audit_ms"],
        "full_audit_s": cd["full_audit_s"], "launches": cd["launches"]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--records", type=int, default=1_000_000)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("tree", nargs="+")
    args = ap.parse_args()
    if args.child:
        print(json.dumps(run_one(args.tree[0], args.records)))
        return 0
    if len(args.tree) != 2:
        ap.error("give two trees, A and B")
    a, b = (os.path.abspath(s) for s in args.tree)
    for label, tree in (("A", a), ("B", b), ("B", b), ("A", a)):
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             "--records", str(args.records), tree],
            capture_output=True, text=True, cwd=tree)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        print(json.dumps({"run": label, "tree": tree, "records": args.records,
                          **json.loads(res.stdout.splitlines()[-1])}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
