"""Wiki engine demo: versioned pages, chunk-dedup storage, client chunk
caching, and a two-author fork/merge flow.

Run:  python examples/torch/wiki_demo.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "src"))
import numpy as np

from repro_torch.apps import ForkBaseWiki, RedisWiki
from repro_torch.core import ForkBase


def _device_from_argv() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the engine's device (default: CUDA)")
    from repro_torch.kernels import ops
    ops.set_device(ap.parse_args().device)


def main():
    rng = np.random.default_rng(11)
    wiki, redis = ForkBaseWiki(ForkBase()), RedisWiki()
    text = rng.bytes(15 * 1024)
    wiki.create("JAX", text)
    redis.create("JAX", text)
    cur = text
    for i in range(25):
        pos = int(rng.integers(0, len(cur) - 300))
        ins = rng.bytes(120)
        cur = cur[:pos] + ins + cur[pos:]
        wiki.edit("JAX", lambda b, q=pos, s=ins: b.insert(q, s))
        redis.edit("JAX", cur)
    assert wiki.load("JAX") == redis.load("JAX")
    print(f"26 versions | forkbase {wiki.storage_bytes() / 1024:.0f} KB "
          f"vs redis {redis.storage_bytes() / 1024:.0f} KB "
          f"({redis.storage_bytes() / wiki.storage_bytes():.1f}x)")

    cache: set = set()
    for back in (0, 1, 2, 3):
        _, fetched, cached = wiki.read_version("JAX", back, cache)
        print(f"  read version -{back}: {fetched} chunks fetched, "
              f"{cached} from client cache")

    # fork/merge editing (the 'advanced collaboration' the paper targets)
    db = wiki.db
    db.fork("JAX", "master", "draft")
    d = db.get("JAX", "draft").blob()
    d.append(b"\n== Draft section ==")
    db.put("JAX", d, "draft")
    m = db.get("JAX", "master").blob()
    m.insert(0, b"== Header ==\n")
    db.put("JAX", m, "master")
    db.merge("JAX", "master", "draft")
    merged = db.get("JAX", "master").blob().read()
    assert merged.startswith(b"== Header ==") and \
        merged.endswith(b"== Draft section ==")
    print("fork + concurrent edits merged cleanly (3-way, POS-Tree diff)")
    ops = db.diff(db.get("JAX", "master").uid,
                  db.track("JAX", "master")[1].uid)
    print(f"diff vs previous version: {len(ops)} changed leaf runs")


if __name__ == "__main__":
    _device_from_argv()
    main()
