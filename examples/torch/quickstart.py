"""ForkBase quickstart on the PyTorch port: the paper's Fig. 4 flow + both
fork semantics.

Run:  python examples/torch/quickstart.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "src"))
from repro_torch.core import FBlob, FInt, FMap, ForkBase, aggregate_resolver


def _device_from_argv() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the engine's device (default: CUDA)")
    from repro_torch.kernels import ops
    ops.set_device(ap.parse_args().device)


def main():
    db = ForkBase()

    # --- Fig. 4: put a blob, fork, modify on the branch -----------------
    db.put("my key", FBlob(b"my value " * 400))
    db.fork("my key", "master", "new branch")
    value = db.get("my key", "new branch")
    blob = value.blob()
    blob.remove(0, 10)                  # buffered client-side
    blob.append(b" ... some more")
    db.put("my key", blob, "new branch")
    print("master :", db.get("my key").blob().read()[:20], "...")
    print("branch :", db.get("my key", "new branch").blob().read()[:20],
          "...")

    # --- versioning + tamper evidence ----------------------------------
    history = db.track("my key", "new branch")
    print(f"history: {len(history)} versions, head uid "
          f"{history[0].uid.hex()[:16]}")
    assert db.verify_lineage(history[0].uid, history[-1].uid)
    print("lineage verified: head provably derives from v0")

    # --- fork-on-conflict: concurrent writers --------------------------
    base = db.put("counter", FInt(100))
    c1 = db.get("counter", uid=base).integer()
    c1.add(5)
    u1 = db.put("counter", c1, base_uid=base)       # writer A
    c2 = db.get("counter", uid=base).integer()
    c2.add(7)
    u2 = db.put("counter", c2, base_uid=base)       # writer B (same base!)
    print("untagged heads:", [u.hex()[:8]
                              for u in db.list_untagged_branches("counter")])
    merged = db.merge("counter", u1, u2, resolver=aggregate_resolver)
    print("aggregate-merged counter:",
          db.get("counter", uid=merged).integer().value)   # 112

    # --- structured types + diff ----------------------------------------
    m = FMap({b"alice": b"42", b"bob": b"17"})
    v0 = db.put("scores", m)
    m2 = db.get("scores").map()
    m2.set(b"carol", b"99")
    m2.delete(b"bob")
    v1 = db.put("scores", m2)
    added, removed, changed = db.diff(v1, v0)
    print(f"diff: +{added} -{removed} ~{changed}")
    st = db.store.stats
    print(f"store: {st.puts} puts, {st.dedup_hits} dedup hits, "
          f"{st.dedup_ratio:.2f}x logical/physical")


if __name__ == "__main__":
    _device_from_argv()
    main()
