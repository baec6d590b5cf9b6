#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of ForkBase (src/repro_torch) on one
NVIDIA GPU, built for an H100.

    python3 chip_smoke.py [--records N] [--map-records N] [--durable-records N]

Phases, in order; any failed check exits non-zero:

1. Device: the card's name and power limit, torch and CUDA versions, and
   the build of every CUDA kernel from src/repro_torch/kernels/csrc (one
   nvcc per source, all started together), with each kernel's registers
   and spills as ptxas reports them; a kernel that spills fails.
2. Kernels against their plain PyTorch versions on the card, bit for bit,
   and against the golden constants of src/repro_torch/kernels/golden.py
   (fixed outputs of the JAX reference).  The bitmap also takes the edges
   of its 8192-byte tile and views of a stream at every offset 1..15 from
   its allocation's start; fphash_many takes chunks at
   every offset mod 16, chunks ending at the end of their buffer, batches
   of one and an index level of 300,000 chunks of 1-200 B.
3. The engine's main path at a real size: the paper's collaborative
   analytics dataset shape (5M records of 180 B on average: a 12 B key, two
   ints, variable text; ~0.9 GB, made from a numpy seed) put as one FBlob
   with fphash cids and verify-on-get, 1% of the records replaced in place
   and put again, a fork with an append, every version read back and
   compared with the host copy, and an FMap of 1M records.  The launch
   counters are zeroed just before and read just after; the v1 root cid is
   recomputed with the plain versions on the card.
4. The durable path on the same dataset shape, cut to 1M records by
   default (--durable-records; at 5M it takes ~6 min on one H100):
   ForkBase(durable_root=<a fresh temporary directory>, verify_get=True)
   with fphash cids puts v1, v2 and the fork, syncs and closes; a new
   engine reopens the root and reads every version back.  It checks the
   reads against the host copies, the reopened heads against the heads
   before the close, the uids against an in-memory engine's for the same
   values (phase 3's when the sizes agree), the segment bytes on disk
   against v1's bytes plus v2's new bytes (each x 1.05: dedup reaches the
   disk), and that every kernel launched; the counters are zeroed before
   the puts and again before the reopen, and the line "durable path:
   {...}" gives both counts.  With verify_get every chunk a durable store
   takes or serves is re-hashed one at a time, each a launch of the
   single-string fphash kernel; check_ms is the mean time of one such
   check on the dataset's leaf chunks.

The line before the last is one JSON object with each kernel's launches on
the main path, its time through its wrapper (ms), its kernel's device time
alone (kernel_ms, from torch.profiler), its plain version's time and its
bound; the last line is {"ok": true, "device": {...}}.  Needs no network.
Exits non-zero, printing no result, when no GPU is available.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet):
# device memory bandwidth, and the 32-bit rate outside the tensor cores,
# which also bounds its integer ALU rate (so the bound stays a lower bound)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

N_GRID = (1, 47, 48, 255, 4991, 4992, 4993, 8191, 8192, 8193, 16_383,
          16_384, 16_385, 39936, 100_001)
WQ_GRID = ((48, 12), (16, 8), (128, 10), (4, 4))
FP_LENGTHS = (0, 1, 31, 4095, 4096, 4097, 12288, 32768, 32769, 65536)
STREAM_BYTES = 64 << 20
# integer operations per byte / per 4 KB block / per chunk, counted from
# the algorithm (not from the kernels' instruction streams): the bitmap
# does h() (9) and one window update (6) per byte; fphash does an absorb
# XOR and 4 rounds of 7 per state word per block, and per chunk a length
# XOR, 2 rounds, a 1023-XOR lane fold and 8 mix32 (9 each)
CHUNKER_OPS_PER_BYTE = 15
FP_OPS_PER_BLOCK = 1024 * (1 + 4 * 7)
FP_OPS_PER_CHUNK = 1024 * (1 + 2 * 7) + 1023 + 8 * 9


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, name: str, reps: int) -> float:
    """Mean device time of one launch of kernel ``name``'s CUDA function
    over reps calls of fn(), as torch.profiler reads it: the kernel alone,
    without the host work of its wrapper that ``cuda_ms`` also sees.  The
    mean is over the launches the profiler recorded, which can be fewer
    than reps; a session that recorded none is taken again, twice at
    most."""
    from torch.profiler import ProfilerActivity, profile

    entry = next(k for k, v in ENTRY_FUNCTIONS.items() if v == name)
    fn()
    torch.cuda.synchronize()
    # a session can record none of a burst's launches; take up to three
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        seen = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and entry in e.key]
        launches = sum(e.count for e in seen)
        if launches:
            break
    check(launches > 0, f"torch.profiler saw no {entry} on the device")
    return sum(e.self_device_time_total for e in seen) / 1e3 / launches


def bound_ms(nbytes: float, nops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fp_ops(lengths: np.ndarray) -> float:
    blocks = np.maximum(1, -(-lengths // 4096))
    return float(blocks.sum() * FP_OPS_PER_BLOCK
                 + len(lengths) * FP_OPS_PER_CHUNK)


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


# ------------------------------------------------------------ phase 2

def kernels_vs_plain(dev) -> dict[str, int]:
    """Every kernel against its plain version on ``dev`` and against the
    golden constants; returns the largest |kernel - plain| of each."""
    from repro_torch.core import rolling
    from repro_torch.kernels import golden
    from repro_torch.kernels import ref
    from repro_torch.kernels.chunker import boundary_bitmap
    from repro_torch.kernels.fphash import fphash, fphash_many

    rng = np.random.default_rng(0)
    err = {"boundary_bitmap": 0, "fphash_many": 0, "fphash": 0}

    def bitmap_pair(x, w, q):
        k = boundary_bitmap(x, w, q)
        p = rolling.boundary_bitmap(x, w, q)
        check(torch.equal(k, p), f"bitmap differs from plain: n={x.numel()} "
                                 f"w={w} q={q}")
        err["boundary_bitmap"] = max(err["boundary_bitmap"], max_err(k, p))
        return k

    for n in N_GRID:
        for w, q in WQ_GRID:
            x = torch.from_numpy(rng.integers(0, 256, n, dtype=np.uint8))
            bitmap_pair(x.to(dev), w, q)
    blob = torch.from_numpy(np.frombuffer(golden.blob(), np.uint8).copy())
    for (w, q), want in golden.BITMAP.items():
        hits = torch.nonzero(bitmap_pair(blob.to(dev), w, q)).flatten()
        check(golden.bitmap_digest(hits.cpu().numpy()) == want,
              f"bitmap misses its golden value at w={w} q={q}")
    stream = torch.randint(0, 256, (STREAM_BYTES,), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1))
    bitmap_pair(stream.to(dev), 48, 12)
    # the stream's start at every misalignment mod 16: the kernel loads
    # aligned granules and shifts the bytes into place
    x = torch.from_numpy(rng.integers(0, 256, 100_001, dtype=np.uint8)).to(dev)
    for off in range(1, 16):
        for w, q in WQ_GRID:
            bitmap_pair(x[off:], w, q)
    print(f"boundary_bitmap: {len(N_GRID) * len(WQ_GRID)} grid cases, "
          f"{15 * len(WQ_GRID)} views at offsets 1..15, "
          f"{len(golden.BITMAP)} golden, 64 MiB stream: identical to plain")

    for n in FP_LENGTHS:
        x = torch.from_numpy(rng.integers(0, 256, n, dtype=np.uint8)).to(dev)
        k, p = fphash(x), ref.fphash_ref(x)
        check(torch.equal(k, p), f"fphash differs from plain at n={n}")
        err["fphash"] = max(err["fphash"], max_err(k, p))
    for n, data, want in zip(golden.FPHASH_LENGTHS, golden.fphash_inputs(),
                             golden.FPHASH):
        x = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(dev)
        got = fphash(x).cpu().numpy().astype("<i4").tobytes().hex()
        check(got == want, f"fphash misses its golden value at n={n}")
    print(f"fphash: {len(FP_LENGTHS)} lengths identical to plain, "
          f"{len(golden.FPHASH)} golden")

    def many_pair(data, offsets, lengths, what):
        offs = torch.as_tensor(offsets, dtype=torch.int64).to(dev)
        lens = torch.as_tensor(lengths, dtype=torch.int64).to(dev)
        k = fphash_many(data, offs, lens)
        p = ref.fphash_many_ref(data, offs, lens)
        check(torch.equal(k, p), f"fphash_many differs from plain on {what}")
        err["fphash_many"] = max(err["fphash_many"], max_err(k, p))

    def rand_bytes(n):
        return torch.from_numpy(rng.integers(0, 256, n, dtype=np.uint8)).to(dev)

    lengths = rng.integers(1, 32769, 10_000).astype(np.int64)
    many_pair(rand_bytes(int(lengths.sum())), np.cumsum(lengths) - lengths,
              lengths, "the ragged batch")
    # every misalignment mod 16, in a view of a larger random buffer: a read
    # past a chunk's end would change its digest; the chunk at offset 15
    # ends at the view's last byte
    for n in FP_LENGTHS + (3, 5, 32_800):
        many_pair(rand_bytes(n + 15 + 64)[:n + 15], np.arange(16),
                  np.full(16, n), f"length {n} at offsets 0..15")
    # batches of one: a chunk ending at the last byte of its allocation,
    # and an empty chunk at the very end
    n = 3 * 4096 + 7
    x = rand_bytes(n)
    many_pair(x, [5], [n - 5], "a chunk ending at its allocation's end")
    many_pair(x, [n], [0], "an empty chunk at the buffer's end")
    # an index level: 300,000 chunks of 1..200 bytes end to end
    small = rng.integers(1, 201, 300_000).astype(np.int64)
    many_pair(rand_bytes(int(small.sum())), np.cumsum(small) - small, small,
              "300,000 chunks of 1..200 B")
    ins = golden.fphash_inputs()
    gl = torch.tensor([len(b) for b in ins], dtype=torch.int64)
    go = torch.cumsum(gl, 0) - gl
    gd = torch.from_numpy(np.frombuffer(b"".join(ins), np.uint8).copy())
    got = fphash_many(gd.to(dev), go.to(dev), gl.to(dev)).cpu().numpy()
    check([r.astype("<i4").tobytes().hex() for r in got] == list(golden.FPHASH),
          "fphash_many misses its golden values")
    print(f"fphash_many: ragged batch of {len(lengths)} chunks "
          f"({lengths.sum() / 2**20:.1f} MiB), {len(FP_LENGTHS) + 3} lengths "
          f"at offsets 0..15, 2 batches of one, 300,000 chunks of 1..200 B: "
          f"identical to plain; {len(golden.FPHASH)} golden")
    return err


# ------------------------------------------------------------ phase 3

def make_records(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """n records laid end to end: a 12-byte key "pk%010d", two
    little-endian int32 in [0, 1000) and 100..220 bytes of printable text
    (180 B on average).  Returns the bytes and the n+1 record offsets."""
    rng = np.random.default_rng(seed)
    rec_len = 20 + rng.integers(100, 221, n)
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(rec_len, out=starts[1:])
    buf = rng.integers(32, 127, int(starts[-1]), dtype=np.uint8)
    hdr = np.empty((n, 20), dtype=np.uint8)
    hdr[:, 0], hdr[:, 1] = ord("p"), ord("k")
    ids = np.arange(n, dtype=np.int64)[:, None]
    hdr[:, 2:12] = ids // 10 ** np.arange(9, -1, -1) % 10 + ord("0")
    hdr[:, 12:20] = rng.integers(0, 1000, (n, 2), dtype="<i4").view(
        np.uint8).reshape(n, 8)
    buf[starts[:-1, None] + np.arange(20)] = hdr
    return buf, starts


def make_dataset(records: int, map_records: int, seed: int = 0) -> dict:
    """The versions the main path and the durable path put: v1 (``records``
    records), v2 (1% of the records replaced in place in 20 runs spread
    over the data: keys kept, ints and text rewritten at the same lengths),
    the tail the fork appends, and the first ``map_records`` records as a
    map of key -> rest of the record."""
    data, starts = make_records(records, seed)
    v1 = data.tobytes()
    rng = np.random.default_rng(seed + 1)
    runs, per_run = 20, max(1, records // 100 // 20)
    v2_arr = data.copy()
    edits = []
    for r in range(runs):
        i = r * (records // runs) + records // (2 * runs)
        j = min(i + per_run, records)
        lo, hi = int(starts[i]), int(starts[j])
        new = rng.integers(32, 127, hi - lo, dtype=np.uint8)
        keys = starts[i:j, None] - lo + np.arange(12)
        new[keys] = data[lo:hi][keys]
        v2_arr[lo:hi] = new
        edits.append((lo, hi - lo, new.tobytes()))
    v2 = v2_arr.tobytes()
    del v2_arr
    tail = make_records(max(1, records // 1000), seed + 2)[0].tobytes()
    mv = memoryview(v1)
    items = {bytes(mv[int(starts[i]):int(starts[i]) + 12]):
             bytes(mv[int(starts[i]) + 12:int(starts[i + 1])])
             for i in range(min(map_records, records))}
    return {"records": records, "v1": v1, "v2": v2, "edits": edits,
            "edited_records": len(edits) * per_run, "tail": tail,
            "items": items}


def main_path(ds: dict) -> dict:
    """The engine's put/get path at a real size on dataset ``ds``; returns
    the measurements and the handles the later checks need."""
    from repro_torch.core import FBlob, FMap, ForkBase
    from repro_torch.core import hashing
    from repro_torch.kernels import ops

    v1, v2, tail, items = ds["v1"], ds["v2"], ds["tail"], ds["items"]
    out = {"records": ds["records"], "bytes": len(v1),
           "map_records": len(items)}
    hashing.use_fphash()
    try:
        db = ForkBase(verify_get=True)
        ops.reset_launches()
        t = time.perf_counter()
        uid1 = db.put("dataset", FBlob(v1))
        out["put_s"] = time.perf_counter() - t
        root1 = db.get("dataset", uid=uid1).obj.data
        phys1 = db.store.stats.physical_bytes
        t = time.perf_counter()
        check(db.get("dataset", uid=uid1).blob().read() == v1,
              "v1 reads back wrong")
        out["get_s"] = time.perf_counter() - t
        b = db.get("dataset").blob()
        for lo, n, new in ds["edits"]:
            b.replace(lo, n, new)
        t = time.perf_counter()
        uid2 = db.put("dataset", b)
        out["put_v2_s"] = time.perf_counter() - t
        out["v2_new_bytes"] = db.store.stats.physical_bytes - phys1
        db.fork("dataset", "master", "dev")
        b = db.get("dataset", "dev").blob()
        b.append(tail)
        uid3 = db.put("dataset", b, "dev")
        check(db.get("dataset", uid=uid1).blob().read() == v1,
              "v1 reads back wrong after the edits")
        check(db.get("dataset").blob().read() == v2, "v2 reads back wrong")
        check(db.get("dataset", "dev").blob().read() == v2 + tail,
              "v3 reads back wrong")
        check([o.uid for o in db.track("dataset", "dev")] ==
              [uid3, uid2, uid1], "track of dev is wrong")
        t = time.perf_counter()
        db.put("table", FMap(items))
        out["map_put_s"] = time.perf_counter() - t
        t = time.perf_counter()
        check(list(db.get("table").map().items()) == sorted(items.items()),
              "the map reads back wrong")
        out["map_get_s"] = time.perf_counter() - t
        out["launches"] = ops.launches()
    finally:
        hashing.use_sha256()
    out.update(db=db, v1=v1, uids=[uid1, uid2, uid3], root1=root1,
               edits=ds["edited_records"])
    return out


def plain_root(v1: bytes) -> bytes:
    """The v1 root cid with both kernels' plain versions on the device."""
    from repro_torch.core import ChunkStore, POSTree
    from repro_torch.core import hashing
    from repro_torch.kernels import ops, ref

    ops.use_kernel_chunker(False)
    hashing.set_default_hash(
        lambda b: ops.hash_many_with(ref.fphash_many_ref, [bytes(b)])[0],
        lambda blobs: ops.hash_many_with(ref.fphash_many_ref, blobs))
    try:
        return POSTree.build_bytes(ChunkStore(), v1).root_cid
    finally:
        ops.use_kernel_chunker(True)
        hashing.use_sha256()


# ------------------------------------------------------------ phase 4

def put_versions(db, ds: dict) -> dict:
    """Put v1, v2 (the edits) and the fork's version (v2 and the tail, on
    branch dev) of dataset ``ds`` into engine ``db``; returns their uids,
    the two puts' seconds and v2's new physical bytes."""
    from repro_torch.core import FBlob

    out = {}
    t = time.perf_counter()
    uid1 = db.put("dataset", FBlob(ds["v1"]))
    out["put_s"] = time.perf_counter() - t
    phys1 = db.store.stats.physical_bytes
    b = db.get("dataset").blob()
    for lo, n, new in ds["edits"]:
        b.replace(lo, n, new)
    t = time.perf_counter()
    uid2 = db.put("dataset", b)
    out["put_v2_s"] = time.perf_counter() - t
    out["v2_new_bytes"] = db.store.stats.physical_bytes - phys1
    db.fork("dataset", "master", "dev")
    b = db.get("dataset", "dev").blob()
    b.append(ds["tail"])
    out["uids"] = [uid1, uid2, db.put("dataset", b, "dev")]
    return out


def memory_uids(ds: dict) -> list[bytes]:
    """The uids of ``put_versions`` in an in-memory engine with fphash
    cids: what the durable engine must reproduce."""
    from repro_torch.core import ForkBase, hashing

    hashing.use_fphash()
    try:
        return put_versions(ForkBase(), ds)["uids"]
    finally:
        hashing.use_sha256()


def durable_path(ds: dict, want_uids: list[bytes]) -> dict:
    """The durable engine on dataset ``ds``: ``ForkBase(durable_root=...,
    verify_get=True)`` with fphash cids in a fresh temporary directory puts
    v1, v2 and the fork, syncs and closes; a new engine reopens the root
    and reads every version back.  The uids must equal ``want_uids``, an
    in-memory engine's for the same values.  Then the mean time of one
    per-chunk check (``cid_of``, one single-string fphash launch) on leaf
    chunks of the dataset.  The directory is removed at the end."""
    import shutil
    import tempfile

    from repro_torch.core import ForkBase, POSTree, hashing
    from repro_torch.core import chunk as ck
    from repro_torch.kernels import ops

    v1, v2, tail = ds["v1"], ds["v2"], ds["tail"]
    out = {"records": ds["records"], "bytes": len(v1)}
    root = tempfile.mkdtemp(prefix="forkbase-durable-")
    hashing.use_fphash()
    try:
        db = ForkBase(durable_root=root, verify_get=True)
        ops.reset_launches()
        out.update(put_versions(db, ds))
        t = time.perf_counter()
        db.sync()
        out["sync_s"] = time.perf_counter() - t
        out["put_launches"] = ops.launches()
        snapshot = db.branches.snapshot()
        heads = db.branches.all_heads()
        db.store.close()
        del db

        ops.reset_launches()
        t = time.perf_counter()
        db = ForkBase(durable_root=root, verify_get=True)
        out["reopen_s"] = time.perf_counter() - t
        check(db.branches.snapshot() == snapshot
              and db.branches.all_heads() == heads,
              "the reopened heads differ from the heads before the close")
        uid1 = out["uids"][0]
        t = time.perf_counter()
        check(db.get("dataset", uid=uid1).blob().read() == v1,
              "durable v1 reads back wrong")
        check(db.get("dataset").blob().read() == v2,
              "durable v2 reads back wrong")
        check(db.get("dataset", "dev").blob().read() == v2 + tail,
              "durable v3 reads back wrong")
        out["get_s"] = time.perf_counter() - t
        out["get_launches"] = ops.launches()
        cold = db.store.cold
        out["segments"] = cold.segment_count()
        out["disk_bytes"] = cold.disk_bytes()

        tree = POSTree.from_root(db.store, ck.BLOB,
                                 db.get("dataset", uid=uid1).obj.data)
        raws = db.store.get_many([e.cid for e in tree.levels[0][:10_000]])
        t = time.perf_counter()
        for raw in raws:
            ck.cid_of(raw)
        out["check_ms"] = (time.perf_counter() - t) / len(raws) * 1e3
        out["check_bytes"] = sum(map(len, raws)) / len(raws)
        db.store.close()
    finally:
        hashing.use_sha256()
        shutil.rmtree(root, ignore_errors=True)
    check(out["uids"] == want_uids,
          "durable uids differ from the in-memory engine's")
    limit = 1.05 * len(v1) + 1.05 * out["v2_new_bytes"]
    check(out["disk_bytes"] < limit,
          f"segments hold {out['disk_bytes']} B, over {limit:.0f} B: "
          f"dedup does not reach the disk")
    return out


# ------------------------------------------------------------ breakdown

def profile_put(v1: bytes) -> dict:
    """Where one v1 put spends its time: the put again into a fresh engine,
    once under torch.profiler (device time of kernels and copies, host time
    of PyTorch ops; the rest of the wall time is the engine's own Python)
    and once under cProfile (the host functions with the most self time)."""
    import cProfile
    import pstats

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import FBlob, ForkBase, hashing

    hashing.use_fphash()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            ForkBase().put("dataset", FBlob(v1))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        prof_c = cProfile.Profile()
        prof_c.enable()
        ForkBase().put("dataset", FBlob(v1))
        prof_c.disable()
    finally:
        hashing.use_sha256()
    kernel_us = copy_us = host_op_us = 0.0
    device_events = []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # kernels and copies as the device ran them; the host ops that
            # launched them carry the same time again, so they are skipped
            device_events.append((e.self_device_time_total, e.key))
            if "memcpy" in e.key.lower():
                copy_us += e.self_device_time_total
            else:
                kernel_us += e.self_device_time_total
        else:
            host_op_us += e.self_cpu_time_total
    device_events.sort(reverse=True)
    stats = pstats.Stats(prof_c)
    top = sorted(stats.stats.items(), key=lambda kv: kv[1][2], reverse=True)
    return {
        "wall_s": wall, "device_kernel_s": kernel_us / 1e6,
        "device_copy_s": copy_us / 1e6,
        "device_busy_share": (kernel_us + copy_us) / 1e6 / wall,
        "torch_host_ops_s": host_op_us / 1e6,
        "device_top_s": [[k[:60], round(us / 1e6, 6)]
                         for us, k in device_events[:6]],
        "host_top_self_s": [[f"{os.path.basename(f)}:{ln}:{fn}", round(v[2], 4)]
                            for (f, ln, fn), v in top[:10]],
    }


# ------------------------------------------------------------ timing

def time_kernels(mp: dict, dev) -> list[dict]:
    """Each kernel at the shape the main path gives it, with its plain
    version and its bound."""
    from repro_torch.core import chunk as ck
    from repro_torch.core import rolling
    from repro_torch.core.postree import POSTree
    from repro_torch.kernels import ref
    from repro_torch.kernels.chunker import boundary_bitmap
    from repro_torch.kernels.fphash import fphash, fphash_many

    out = []
    db, v1 = mp["db"], mp["v1"]
    x = torch.frombuffer(bytearray(v1), dtype=torch.uint8).to(dev)
    k = boundary_bitmap(x)
    p = rolling.boundary_bitmap(x, 48, 12)
    check(torch.equal(k, p), "bitmap differs from plain on the dataset")
    b, by = bound_ms(2 * x.numel(), CHUNKER_OPS_PER_BYTE * x.numel())
    out.append({"name": "boundary_bitmap", "shape": f"uint8[{x.numel()}]",
                "ms": cuda_ms(lambda: boundary_bitmap(x), 5),
                "kernel_ms": kernel_ms(lambda: boundary_bitmap(x),
                                       "boundary_bitmap", 5),
                "plain_ms": cuda_ms(lambda: rolling.boundary_bitmap(
                    x, 48, 12), 1),
                "bound_ms": b, "bound_by": by, "max_abs_err": max_err(k, p)})
    del x, k, p

    meta = db.store.get(mp["uids"][0])
    tree = POSTree.from_root(db.store, ck.BLOB, mp["root1"])
    raws = db.store.get_many([e.cid for e in tree.levels[0]])
    lengths = np.fromiter(map(len, raws), dtype=np.int64, count=len(raws))
    offs = torch.from_numpy(np.cumsum(lengths) - lengths).to(dev)
    lens = torch.from_numpy(lengths).to(dev)
    data = torch.frombuffer(bytearray(b"".join(raws)), dtype=torch.uint8).to(dev)
    del raws
    k = fphash_many(data, offs, lens)
    p = ref.fphash_many_ref(data, offs, lens)
    check(torch.equal(k, p), "fphash_many differs from plain on the leaves")
    b, by = bound_ms(data.numel() + 48 * len(lengths), fp_ops(lengths))
    out.append({"name": "fphash_many",
                "shape": f"{len(lengths)} chunks, {data.numel()} B",
                "ms": cuda_ms(lambda: fphash_many(data, offs, lens), 5),
                "kernel_ms": kernel_ms(lambda: fphash_many(data, offs, lens),
                                       "fphash_many", 5),
                "plain_ms": cuda_ms(lambda: ref.fphash_many_ref(
                    data, offs, lens), 1),
                "bound_ms": b, "bound_by": by, "max_abs_err": max_err(k, p)})
    del data, offs, lens, k, p

    m = torch.frombuffer(bytearray(meta), dtype=torch.uint8).to(dev)
    k, p = fphash(m), ref.fphash_ref(m)
    check(torch.equal(k, p), "fphash differs from plain on a meta chunk")
    b, by = bound_ms(m.numel() + 32, fp_ops(np.array([m.numel()])))
    out.append({"name": "fphash", "shape": f"meta chunk, {m.numel()} B",
                "ms": cuda_ms(lambda: fphash(m), 100),
                "kernel_ms": kernel_ms(lambda: fphash(m), "fphash", 100),
                "plain_ms": cuda_ms(lambda: ref.fphash_ref(m), 10),
                "bound_ms": b, "bound_by": by, "max_abs_err": max_err(k, p)})
    return out


# the kernel function of each wrapper, as ptxas names it in its -v report
ENTRY_FUNCTIONS = {"chunker_kernel": "boundary_bitmap",
                   "fphash_many_kernel": "fphash_many",
                   "fphash_one_kernel": "fphash"}


def ptxas_report(log: str) -> dict[str, dict]:
    """Registers per thread and spill bytes of each kernel in an nvcc
    -Xptxas -v log."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = next((v for k, v in ENTRY_FUNCTIONS.items()
                         if k in m.group(1)), None)
            if name:
                out[name] = {"registers": None, "spill_bytes": 0}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


SOURCES = {
    "boundary_bitmap": ("src/repro_torch/kernels/csrc/chunker.cu",
                        "src/repro/kernels/chunker.py:88"),
    "fphash_many": ("src/repro_torch/kernels/csrc/fphash.cu",
                    "src/repro/kernels/fphash.py:161"),
    "fphash": ("src/repro_torch/kernels/csrc/fphash.cu",
               "src/repro/kernels/fphash.py:92"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--records", type=int, default=5_000_000)
    ap.add_argument("--map-records", type=int, default=1_000_000)
    ap.add_argument("--durable-records", type=int, default=1_000_000,
                    help="records of the durable path's dataset (phase 4); "
                         "5,000,000 runs it on phase 3's dataset")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs a GPU",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import build, ops

    dev = torch.device("cuda")
    ops.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t = time.perf_counter()
    logs = build.build_all()
    print(f"kernel build: {time.perf_counter() - t:.1f} s")
    ptx = {}
    for name, log in logs.items():
        for line in log.splitlines():
            if ("registers" in line or "spill" in line
                    or "error" in line.lower()):
                print(f"  {name}: {line.strip()}")
        ptx.update(ptxas_report(log))
    check(set(ptx) == set(SOURCES), f"no ptxas report for some kernels: {ptx}")
    check(not any(v["spill_bytes"] for v in ptx.values()),
          f"a kernel spills to local memory: {ptx}")

    t = time.perf_counter()
    err = kernels_vs_plain(dev)
    print(f"phase 2 (kernels vs plain): {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    ds = make_dataset(args.records, args.map_records)
    print(f"dataset: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    mp = main_path(ds)
    print(f"phase 3 (main path): {time.perf_counter() - t:.1f} s")
    launches = mp["launches"]
    check(all(v > 0 for v in launches.values()),
          f"a kernel never launched on the main path: {launches}")
    check(mp["v2_new_bytes"] < 0.05 * mp["bytes"],
          f"v2 stored {mp['v2_new_bytes']} new bytes of {mp['bytes']}")
    check(plain_root(mp["v1"]) == mp["root1"],
          "v1 root cid differs from the plain versions' root cid")
    mb = mp["bytes"] / 1e6
    summary = {
        "records": mp["records"], "bytes": mp["bytes"],
        "put_MB_s": mb / mp["put_s"], "get_MB_s": mb / mp["get_s"],
        "put_v2_s": mp["put_v2_s"], "edited_records": mp["edits"],
        "v2_new_bytes": mp["v2_new_bytes"],
        "v2_new_fraction": mp["v2_new_bytes"] / mp["bytes"],
        "map_records": mp["map_records"], "map_put_s": mp["map_put_s"],
        "map_get_s": mp["map_get_s"], "launches": launches,
    }
    print("main path: " + json.dumps(summary))

    print("v1 put breakdown: " + json.dumps(profile_put(mp["v1"])))

    t = time.perf_counter()
    timed = time_kernels(mp, dev)
    print(f"kernel timing: {time.perf_counter() - t:.1f} s")
    del mp["db"]

    t = time.perf_counter()
    if args.durable_records == args.records:
        dds, want = ds, mp["uids"]
    else:
        dds = make_dataset(args.durable_records, 0)
        want = memory_uids(dds)
    dp = durable_path(dds, want)
    print(f"phase 4 (durable path): {time.perf_counter() - t:.1f} s")
    phase = {k: dp["put_launches"][k] + dp["get_launches"][k]
             for k in dp["put_launches"]}
    check(all(v > 0 for v in phase.values()),
          f"a kernel never launched on the durable path: {phase}")
    print("durable path: " + json.dumps({
        "records": dp["records"], "bytes": dp["bytes"],
        "put_MB_s": dp["bytes"] / 1e6 / dp["put_s"],
        "put_v2_s": dp["put_v2_s"], "sync_s": dp["sync_s"],
        "reopen_s": dp["reopen_s"],
        "get_MB_s": (3 * dp["bytes"] + len(dds["tail"])) / 1e6 / dp["get_s"],
        "segments": dp["segments"], "disk_bytes": dp["disk_bytes"],
        "v2_new_bytes": dp["v2_new_bytes"],
        "check_ms": dp["check_ms"], "check_bytes": dp["check_bytes"],
        "put_launches": dp["put_launches"],
        "get_launches": dp["get_launches"]}))
    kernels = []
    for row in timed:
        src, replaces = SOURCES[row["name"]]
        kernels.append({
            "name": row["name"], "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[row["name"]],
            "max_abs_err": max(err[row["name"]], row["max_abs_err"]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "shape": row["shape"],
            "kernel_ms": row["kernel_ms"],
            "registers": ptx[row["name"]]["registers"]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
