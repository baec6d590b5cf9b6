"""Blockchain on ForkBase: a Hyperledger-style KV contract processing
batches of transactions, then analytics (state scan / block scan) that the
original storage design needs a full chain replay for.

Run:  python examples/torch/blockchain_demo.py [--device cuda|cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "src"))
import numpy as np

from repro_torch.apps import ForkBaseLedger, KVLedger


def _device_from_argv() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the engine's device (default: CUDA)")
    from repro_torch.kernels import ops
    ops.set_device(ap.parse_args().device)


def main():
    rng = np.random.default_rng(7)
    fb, kv = ForkBaseLedger(), KVLedger("bucket", 256)
    n_blocks, batch, n_keys = 60, 25, 64
    print(f"committing {n_blocks} blocks x {batch} txs over {n_keys} keys")
    for blk in range(n_blocks):
        for j in range(batch):
            key = f"acct{int(rng.integers(0, n_keys)):03d}"
            val = f"balance={int(rng.integers(0, 10_000))}".encode()
            fb.write("bank", key, val)
            kv.write("bank", key, val)
        fb.commit()
        kv.commit()

    # state scan: full history of one account
    t0 = time.perf_counter()
    hist = fb.state_scan("bank", "acct007")
    t_fb = time.perf_counter() - t0
    t0 = time.perf_counter()
    hist_kv = kv.state_scan("bank", "acct007")     # pays the replay cost
    t_kv = time.perf_counter() - t0
    assert [v for _, v in hist] == hist_kv
    print(f"state scan acct007: {len(hist)} versions | "
          f"forkbase {t_fb * 1e3:.2f}ms vs replay {t_kv * 1e3:.2f}ms "
          f"({t_kv / t_fb:.0f}x)")

    # block scan: all balances at mid-chain
    t0 = time.perf_counter()
    snap = fb.block_scan(n_blocks // 2)
    t_fb = time.perf_counter() - t0
    print(f"block scan @h{n_blocks // 2}: {len(snap)} states in "
          f"{t_fb * 1e3:.1f}ms")

    # tamper evidence
    assert fb.verify_block(3)
    print("block 3 verified as ancestor of the chain head "
          "(hash-chain intact)")
    st = fb.db.store.stats
    print(f"storage: {st.physical_bytes / 1e6:.2f}MB physical, "
          f"{st.dedup_ratio:.2f}x dedup")


if __name__ == "__main__":
    _device_from_argv()
    main()
