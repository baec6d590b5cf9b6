#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of ForkBase (src/repro_torch) on one
NVIDIA GPU, built for an H100.

    python3 chip_smoke.py [--records N] [--map-records N] [--durable-records N]
                          [--ckpt-layers N] [--ckpt-breakdown]
                          [--ledger-accounts N] [--skew-edits N]

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
   of one and an index level of 300,000 chunks of 1-200 B; the engine's
   single-value route (ops.content_hash: the kernel reads the value from
   pinned host memory and writes the digest back there) takes every fphash
   length up to 1 MB + 3 and the golden inputs.  8 threads then hash 500
   distinct values each through ops.content_hash at once: every digest
   must equal the plain version's and the launch counter read exactly
   4,000.
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
5. The checkpoint path: the full-width TinyLlama-1.1B params (the JAX
   package's train-state leaves for tinyllama-1.1b, 12 leaves and
   2,200,281,088 B at 22 layers; --ckpt-layers cuts the depth) and
   opt/step, filled on the card from a seeded generator, through
   CheckpointStore(ForkBase(durable_root=<a fresh temporary directory>))
   with fphash cids: step 0 saved on branch run, the last layer's slice
   of every stacked tensor and final_norm edited on the card and step 1
   saved, a fork sweep of step 0, sync and close; a reopen (heads equal,
   the head verified against its uid), a restore of run onto the card,
   sweep removed and run pruned to its last checkpoint (stop-the-world
   GC, then sync: the compaction), a restore of only the edited leaves;
   then the training controller (run_resilient, in memory) on the real
   train step and the whole train state (params, fp32 master, mu, nu,
   step; ~3.07 GB a save) of TinyLlama-1.1B at full width cut to 2
   layers: 4 steps of 4 x 512 SyntheticLM tokens, a checkpoint every 2, a
   failure at step 3 (3 saves, 1 restore), under the controller's
   deterministic algorithms, against a plain loop of the same step that
   saves nothing.  It checks step 1's new bytes (under 1.05 x the edited
   bytes + 1 MiB), every restore and the replay bit for bit, the GC's
   swept, reclaimed and compacted bytes and the disk bytes falling, the
   params/embed root cid and every root cid of the controller's last
   checkpoint against the plain versions' (the bitmap and fphash_many
   held against theirs on those leaves and chunks), and that every
   kernel launched; the line "checkpoint path: {...}" gives the numbers.
   --ckpt-breakdown adds a mark timed alone before the GC (mark_s) and a
   save of step 0 into an in-memory store under torch.profiler
   (save_profile: device time of kernels and copies against the wall).
6. The ledger path, the paper's blockchain application (§5.1) with fphash
   cids: (a) ForkBaseLedger(ForkBase(), live=True) seeded with 500,000
   accounts of 64 seeded bytes under the "kv" contract in one commit
   (--ledger-accounts; 1,000,000 is live_bench.py's size), then 50
   blocks of 200 writes to seeded random accounts; the last state root
   against FMap(model) built directly with both kernels' plain versions,
   block lineage proofs of heights 0, 25 and 49 and 1,024 flat
   state proofs through a LightClient holding only the chain head, a
   proof with one flipped byte rejected and an absence proof;
   (b) attestation churn: 1,000 heads, then 20 rounds of 10 single-head
   updates and one delta attestation, each root against the full rebuild
   and every updated head's proof verified, with each path's launches;
   (c) an archival ledger on a 3-way ReplicatedBackend (2,048 accounts, 10
   blocks of 200 writes), 64 state proofs and an attested head refresh
   through a LightClient, the engine audit and a replica audit of every
   copy, clean, then with one copy on replica 1 overwritten: exactly that
   finding.  The line "ledger path: {...}" gives each part's numbers and
   launches.
7. The cluster path, ForkBase's distributed deployment (§4.1, §4.6) with
   fphash cids: (c) a threaded ClusterRuntime with its MaintenanceDaemon
   on a fresh Cluster(4), started before any put: 8 writers put 250 values
   of 1 KB each over 8 keys of their own, node 0 is quarantined once a
   quarter of the puts are done, then rereplicate(), a placement audit and
   a GC; every head is its writer's last put and reads back, node 0 ends
   empty; and per-request against coalesced puts (96 puts, 4 nodes, the
   same uids); (a) phase 3's dataset, v1, v2 and the fork, in Cluster(4,
   "2LP"), each read back, with phase 3's uids, v2's new bytes under 5%
   and the storage distribution's max/min under 1.10, node 1 quarantined
   and re-replicated whole (v1 read back again), and v1 in
   Cluster(4, "1LP") all on the key's home node; (b) Fig. 15: 10,000
   (--skew-edits) 8 KB values to 8 zipf(1.5)-hot pages, a branch each, on
   16 servlets in each mode, 2LP's coefficient of variation under 1LP's
   and under 0.10; (d) phase 4's dataset's v1 in Cluster(4,
   durable_root=<a fresh temporary directory>, verify=True), sync, close,
   a reopen with equal heads and index, v1 read back, phase 4's uid, an
   attestation and an audit clean, and after one data chunk on node 2 is
   overwritten an audit of every placement naming node 2 alone.  The
   kernels are held against their plain versions at the shapes the phase
   adds; the line "cluster path: {...}" gives each part's numbers and
   launches.

8. The model path (src/repro_torch/{configs,models,launch}, bf16 on the
   card): (a) every assigned arch at its smoke config on the card, in
   float32 and in bf16, against the CPU in float32 on the same params
   (train_loss, prefill logits and 4 decode steps); (b) every arch at its
   full widths with the depth cut to two layers (zamba2: one group of 6
   Mamba layers; xlstm: all 12), prefill B=2 x 128 and 8 greedy decodes,
   finite and in-vocab, a decode at S - 1 against prefill over S tokens
   (the MoE archs and xlstm exempt, as in the reference); (c)
   TinyLlama-1.1B at full width and depth through launch/serve.py's
   functions, B=4, prompt 512, 64 greedy tokens: prefill seconds, decode
   tokens a second, peak memory, each beside its bound, and the decode
   at S against prefill over S + 1 at full depth; (d) one forward and
   backward of its train_loss at B=1 x 2048 (tokens a second, peak
   memory, finite gradients, loss in (0, 2 ln V)); SDPA against the
   blocked attention at (c)'s and (d)'s shapes; the four engine examples
   of examples/torch on the card.  No kernel of csrc runs on the model
   path (the examples launch the bitmap through the engine's chunker);
   the line "model path: {...}" gives each part.
9. The training path (src/repro_torch/{train,launch/train.py}): (a)
   TinyLlama-1.1B at full width and depth, its whole train state (15.4
   GB) from init_train_state on the card, make_train_step on
   SyntheticLM.prefetch batches of 1 x 2048: a warm-up step, 3 timed
   steps, 3 more under the controller's deterministic algorithms (their
   cost; medians), the gradients of two deterministic runs on one batch
   (they must agree), apply_adamw alone, each beside its bound, peak
   memory and the busy share under torch.profiler; the loss in (0, 2 ln
   V), every param moved, params == master cast to bf16; (b) microbatch
   4 against 1 from one state at the 2-layer cut, B=4 x 512: params
   within the reference's 3e-2, gnorm within 1e-2 and loss within 1e-3
   relative, at most 5% of a leaf's step-1 directions turned; (c)
   launch/train.py's main (20 smoke steps) and examples/torch/
   train_with_forkbase_ckpt.py (40 steps, 2 injected failures) on the
   card: the loss falls, restarts equal the failures, and each run's last
   checkpoint has the plain versions' root cids (the bitmap held against
   its plain version on every leaf).  The line "training path: {...}"
   gives each part and (c)'s launches (the bitmap, through the
   checkpoints).
10. The mesh and cost tooling (src/repro_torch/{launch/mesh,launch/dryrun,
   roofline,shardings}.py): (b) first, alone, since it times calls:
   TinyLlama-1.1B at full width and depth, its train step at 1 x 2048,
   prefill 4 x 512 and one decode step against a 576-row cache, each
   counted on meta by roofline.OpCost and profiled on the card
   (torch.profiler with_flops): the census's matrix-product FLOPs must
   equal the profiler's within CENSUS_TOL, and each call's median time
   stands beside the roofline of its census; then (a) every arch x shape
   cell of the dry run at full width and depth on meta, both production
   meshes (16x16, 2x16x16) from one census a cell, in DRYRUN_WORKERS
   spawned processes: every cell completes, model FLOPs 6 N D (train) or
   2 N D, at most 80 GB of arguments a device on 16x16, a condensed table;
   while it runs, (c) olmoe-1b-7b at full width cut to two layers on
   Sharding(make_mesh_for(1), cfg): prefill through moe_shard_map equal
   bit for bit to the mesh-less gather path (deterministic algorithms),
   shard_batch onto the mesh, the params saved and restored onto the mesh
   with their specs and the smoke config's train state restored and
   remeshed with its state specs, bit for bit on the card, and the 16x16
   mesh's specs raising ConfigError in restore, moe_shard_map and
   shard_batch.  No kernel of csrc runs in (a) or (b); (c)'s saves (the
   params and the controller's checkpoints) launch the bitmap, counted
   from 0 just before them and read just after, and both saved heads
   have the plain versions' root cids (the bitmap held against its plain
   version on every leaf).  The line "mesh and cost path: {...}" gives
   each part and (c)'s launches.
11. Execution on a mesh of ranks (src/repro_torch/{mesh,launch/mesh,
   shardings}.py and the DTensor paths of the models, the train step,
   the checkpoint store and the controller): (0) a one-rank NCCL group
   builds a 1 x 1 DeviceMesh and runs one all-reduce; then the one-rank
   references here; then two spawned ranks that share the card over gloo
   (NCCL takes a card a rank) run (a) TinyLlama-1.1B whole on (data,
   model) = (1, 2), heads, ff and vocab over 'model' and the decode cache
   over 'model' on its sequence: prefill 4 x 512 and 16 teacher-forced
   decode steps within WIDE_TOL of the one-rank logits, and a train step
   at 1 x 2048 within phase 9 (b)'s limits of the one-rank step; (b)
   olmoe-1b-7b at full width, two layers, 32 experts a rank: prefill 2 x
   512 within WIDE_TOL of the one-rank gather path (deterministic
   algorithms on both); (c) (a)'s params saved from the mesh by a
   TrainController (the one-rank save's uid) and remeshed onto (2, 1)
   and back onto (1, 2), each rank's shards bit for bit the blocks the
   specs name, and the saved head against the plain versions
   (saved_vs_plain).  Each part's wall time, peak memory a rank and
   collective counts (CommDebugMode) are in the line "mesh of ranks:
   {...}"; (c)'s save launches the bitmap, counted from 0 just before it
   and read just after.

The line before the last is one JSON object with each kernel's launches on
the main path (and on phases 5, 6, 7, 9, 10 and 11), its largest
|kernel - plain| over phases 2, 5, 7, 9, 10 and 11, its time through its
wrapper (ms),
its kernel's device time alone (kernel_ms, from torch.profiler), its plain
version's time and its bound; the last line is {"ok": true, "device":
{...}}.  Needs no network.  Exits non-zero, printing no result, when no
GPU is available.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
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
# dense bf16 tensor-core rate (no sparsity): the model path's FLOP bounds
PEAK_BF16_FLOPS_PER_S = 989e12

N_GRID = (1, 47, 48, 255, 4991, 4992, 4993, 8191, 8192, 8193, 16_383,
          16_384, 16_385, 39936, 100_001)
WQ_GRID = ((48, 12), (16, 8), (128, 10), (4, 4))
FP_LENGTHS = (0, 1, 31, 4095, 4096, 4097, 12288, 32768, 32769, 65536)
# the single-value route's lengths beyond FP_LENGTHS: a meta chunk, a 4 KB
# leaf with its type byte, the largest chunk, one byte past the 9-block
# stage (the ring's first wrap) and a long value
HOST_LENGTHS = FP_LENGTHS + (63, 4097, 32_769, 36_865, (1 << 20) + 3)
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


def cid_tensor(cid: bytes) -> torch.Tensor:
    """A 32-byte cid as the int32 (8,) digest the kernels return."""
    return torch.frombuffer(bytearray(cid), dtype=torch.int32)


def host_ms(fn, reps: int) -> float:
    """Median host wall time of one call of fn(), which returns only when
    its result is on the host, over reps calls after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    return float(np.median(times)) * 1e3


def launch_floor_ms(dev, reps: int = 2000) -> float:
    """The least a single call that launches and waits can take: one tiny
    torch op on the card and a synchronisation of its stream, median of
    reps."""
    x = torch.zeros(1, device=dev)
    stream = torch.cuda.current_stream(dev)

    def call():
        x.add_(1)
        stream.synchronize()
    return host_ms(call, reps)


# ------------------------------------------------------------ phase 2

def kernels_vs_plain(dev) -> dict[str, int]:
    """Every kernel against its plain version on ``dev`` and against the
    golden constants; returns the largest |kernel - plain| of each."""
    from repro_torch.core import rolling
    from repro_torch.kernels import golden, ops
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

    # the engine's single-value route, from host bytes (and from a view at
    # an odd offset of a larger host buffer)
    for n in HOST_LENGTHS:
        data = rng.bytes(n)
        p = ref.fphash_ref(torch.frombuffer(bytearray(data) or bytearray(1),
                                            dtype=torch.uint8)[:n].to(dev))
        k = cid_tensor(ops.content_hash(data))
        check(torch.equal(k, p.cpu()),
              f"the single-value route differs from plain at n={n}")
        err["fphash"] = max(err["fphash"], max_err(k, p.cpu()))
        wide = b"\x07" * 7 + data + b"\x07" * 9
        check(ops.content_hash(memoryview(wide)[7:7 + n]) ==
              ops.content_hash(data),
              f"the single-value route differs on a view at n={n}")
    got = [ops.content_hash(b).hex() for b in golden.fphash_inputs()]
    check(got == list(golden.FPHASH),
          "the single-value route misses its golden values")
    print(f"fphash (single-value route): {len(HOST_LENGTHS)} lengths "
          f"identical to plain, {len(golden.FPHASH)} golden")

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


def threaded_launches(dev, threads: int = 8, each: int = 500) -> int:
    """``threads`` threads hash ``each`` distinct values each through the
    engine's single-value route (``ops.content_hash``, one launch of kernel
    #3 a value) at once; every digest must equal the plain version's.
    Returns the launch count read after they all joined, which must be
    exact (threads * each)."""
    import threading

    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(5)
    values = [[rng.bytes(int(n)) for n in rng.integers(0, 5000, each)]
              for _ in range(threads)]
    want = [ops.hash_many_with(ref.fphash_many_ref, vs) for vs in values]
    got: list[list[bytes]] = [[] for _ in range(threads)]
    ops.content_hash(b"")                 # the library is loaded before
    synchronize(dev)
    start = threading.Barrier(threads)
    errors: list[BaseException] = []

    def work(i):
        try:
            start.wait()
            for v in values[i]:
                got[i].append(ops.content_hash(v))
        except Exception as e:            # reported by the check below
            errors.append(e)

    ops.reset_launches()
    workers = [threading.Thread(target=work, args=(i,))
               for i in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=300)
    synchronize(dev)
    n = ops.launches()["fphash"]
    check(not errors and not any(w.is_alive() for w in workers),
          f"a launching thread failed or hung: {errors[:1]}")
    check(n == threads * each, f"{threads} threads x {each} launches of "
                               f"fphash counted {n}")
    check(got == want, "a thread's single-value digest differs from plain")
    return n


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


@contextlib.contextmanager
def plain_kernels(fphash: bool = True):
    """Boundary bitmaps by the kernel's plain version on the device and,
    with ``fphash``, fphash cids by theirs (no kernel launches); the
    kernel chunker after, and sha256 after fphash cids."""
    from repro_torch.core import hashing
    from repro_torch.kernels import ops, ref

    ops.use_kernel_chunker(False)
    if fphash:
        hashing.set_default_hash(
            lambda b: ops.hash_many_with(ref.fphash_many_ref, [bytes(b)])[0],
            lambda blobs: ops.hash_many_with(ref.fphash_many_ref, blobs))
    try:
        yield
    finally:
        ops.use_kernel_chunker(True)
        if fphash:
            hashing.use_sha256()


def plain_root(v1: bytes) -> bytes:
    """The v1 root cid with both kernels' plain versions on the device."""
    from repro_torch.core import ChunkStore, POSTree

    with plain_kernels():
        return POSTree.build_bytes(ChunkStore(), v1).root_cid


def saved_vs_plain(cs, branch: str, state, dev, fphash: bool) -> dict:
    """The head of ``branch`` in CheckpointStore ``cs``, which saved
    ``state``, against the plain versions on the same bytes on ``dev``:
    every leaf rebuilt as a POS-Tree with the plain bitmap (and plain
    fphash cids with ``fphash``, else the engine's sha256) must have the
    manifest's root cid.  Each kernel the save ran, at the shapes it ran
    them, against its plain version: the bitmap on every leaf's bytes
    and, with ``fphash``, fphash_many on every chunk of each tree (one
    batch a leaf).  Returns the largest |kernel - plain| of each, with
    the leaves and bytes compared."""
    from repro_torch.ckpt.store import _leaf_paths, _leaf_record
    from repro_torch.core import ChunkStore, POSTree, rolling
    from repro_torch.kernels import ops
    from repro_torch.kernels.chunker import boundary_bitmap
    from repro_torch.kernels.fphash import fphash_many

    manifest = cs.db.get(cs.key, branch).map()
    leaves = _leaf_paths(state)
    check(sorted(k.decode() for k, _ in manifest.items())
          == sorted(n for n, _ in leaves),
          f"the manifest of {branch} names other leaves than the state's")
    err = {"boundary_bitmap": 0, **({"fphash_many": 0} if fphash else {})}
    nbytes = 0
    for name, leaf in leaves:
        x = leaf.detach().reshape(-1).view(torch.uint8).to(dev)
        err["boundary_bitmap"] = max(err["boundary_bitmap"], max_err(
            boundary_bitmap(x), rolling.boundary_bitmap(x, 48, 12)))
        raw = _leaf_record(leaf)[0]
        nbytes += len(raw)
        store = ChunkStore()
        with plain_kernels(fphash):
            root = POSTree.build_bytes(store, raw).root_cid
        check(root.hex() == json.loads(manifest.get(name.encode()))["cid"],
              f"{branch}: the plain versions give {name} another root cid")
        if fphash:
            cids = list(store.iter_cids())
            got = ops.hash_many_with(fphash_many, store.get_many(cids))
            err["fphash_many"] = max(err["fphash_many"], max_err(
                torch.frombuffer(bytearray(b"".join(got)), dtype=torch.uint8),
                torch.frombuffer(bytearray(b"".join(cids)),
                                 dtype=torch.uint8)))
    check(not any(err.values()),
          f"{branch}: a kernel differs from its plain version on the saved "
          f"state: {err}")
    return {"max_abs_err": err, "leaves": len(leaves), "bytes": nbytes}


# ------------------------------------------------------------ phase 4

def put_versions(db, ds: dict, stored=None) -> dict:
    """Put v1, v2 (the edits) and the fork's version (v2 and the tail, on
    branch dev) of dataset ``ds`` into engine or cluster ``db``; returns
    their uids, the two puts' seconds and v2's new bytes as ``stored()``
    counts them (the engine store's physical bytes by default)."""
    from repro_torch.core import FBlob

    if stored is None:
        stored = lambda: db.store.stats.physical_bytes  # noqa: E731
    out = {}
    t = time.perf_counter()
    uid1 = db.put("dataset", FBlob(ds["v1"]))
    out["put_s"] = time.perf_counter() - t
    phys1 = stored()
    b = db.get("dataset").blob()
    for lo, n, new in ds["edits"]:
        b.replace(lo, n, new)
    t = time.perf_counter()
    uid2 = db.put("dataset", b)
    out["put_v2_s"] = time.perf_counter() - t
    out["v2_new_bytes"] = stored() - phys1
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


@contextlib.contextmanager
def queued_checks(out: dict):
    """fphash cids, whose single hashes also count the calls that found
    work still queued on the current stream, which their wait waits for as
    well: ``out["queued_checks"]`` of ``out["checks"]`` (one stream query a
    check; fphash cids stay on after)."""
    from repro_torch.core import hashing
    from repro_torch.kernels import ops

    out.update(queued_checks=0, checks=0)

    def single(data):
        out["checks"] += 1
        if not torch.cuda.current_stream().query():
            out["queued_checks"] += 1
        return ops.content_hash(data)

    hashing.set_default_hash(single, ops.content_hash_many)
    try:
        yield
    finally:
        hashing.use_fphash()


def durable_path(ds: dict, want_uids: list[bytes]) -> dict:
    """The durable engine on dataset ``ds``: ``ForkBase(durable_root=...,
    verify_get=True)`` with fphash cids in a fresh temporary directory puts
    v1, v2 and the fork, syncs and closes; a new engine reopens the root
    and reads every version back.  The uids must equal ``want_uids``, an
    in-memory engine's for the same values; the puts' single hashes count
    those that found work queued on the stream (``queued_checks``).  Then
    the mean time of one per-chunk check (``cid_of``, one single-string
    fphash launch) on leaf chunks of the dataset.  The directory is removed
    at the end."""
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
        with queued_checks(out):
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


# ------------------------------------------------------------ phase 5

# The params subtree of the JAX package's train state for tinyllama-1.1b
# (src/repro/configs/tinyllama_1_1b.py: 22 layers, d_model 2048, 32 heads
# with 4 KV heads, d_ff 5632, vocab 32000) as jax.eval_shape gives it:
# leaf name, shape ("L" is the stacked layer axis) and dtype.  At 22
# layers the leaves hold 2,200,281,088 bytes.
TINYLLAMA_PARAMS = (
    ("embed", (32000, 2048), "bfloat16"),
    ("final_norm", (2048,), "float32"),
    ("layers/attn/wk", ("L", 2048, 256), "bfloat16"),
    ("layers/attn/wo", ("L", 2048, 2048), "bfloat16"),
    ("layers/attn/wq", ("L", 2048, 2048), "bfloat16"),
    ("layers/attn/wv", ("L", 2048, 256), "bfloat16"),
    ("layers/ln1", ("L", 2048), "float32"),
    ("layers/ln2", ("L", 2048), "float32"),
    ("layers/mlp/w_gate", ("L", 2048, 5632), "bfloat16"),
    ("layers/mlp/w_in", ("L", 2048, 5632), "bfloat16"),
    ("layers/mlp/w_out", ("L", 5632, 2048), "bfloat16"),
    ("unembed", (2048, 32000), "bfloat16"),
)
TINYLLAMA_LAYERS = 22
TINYLLAMA_PARAM_BYTES = 2_200_281_088
# the controller's run: TinyLlama-1.1B at full width cut to 2 layers, its
# whole train state (~3.07 GB a save), 4 steps of 4 x 512 tokens, a
# checkpoint every 2 steps and a failure at step 3: 3 saves, 1 restore
CTL_LAYERS = 2
CTL_BATCH = (4, 512)
CTL_STEPS, CTL_CKPT_EVERY, CTL_FAIL_AT = 4, 2, (3,)


def synchronize(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def ckpt_state(table, n_layers: int, dev, seed: int) -> dict:
    """{"params": <the table's leaves, nested by name>, "opt": {"step": 0}}
    with the leaves drawn on ``dev`` from a seeded generator: weights
    N(0, 0.02), norms 1 + N(0, 0.02)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    params: dict = {}
    for name, shape, dtype in table:
        shape = tuple(n_layers if d == "L" else d for d in shape)
        x = torch.randn(shape, generator=gen, device=dev,
                        dtype=getattr(torch, dtype)).mul_(0.02)
        if "norm" in name or name.startswith("layers/ln"):
            x.add_(1)
        *path, leaf = name.split("/")
        node = params
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = x
    return {"params": params,
            "opt": {"step": torch.tensor(0, dtype=torch.int32, device=dev)}}


def tree_leaves(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(name, leaf) of a tree of dicts, keys sorted as the checkpoint
    names them."""
    out = []
    for k in sorted(tree):
        name = f"{prefix}{k}"
        if isinstance(tree[k], dict):
            out += tree_leaves(tree[k], name + "/")
        else:
            out.append((name, tree[k]))
    return out


def map_layers(params: dict, fn) -> dict:
    """``params`` with ``fn`` applied to every stacked layer tensor."""
    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else fn(v)
                for k, v in node.items()}
    return {**params, "layers": walk(params["layers"])}


def finetune(state: dict, dev, seed: int) -> tuple[dict, int]:
    """Step 1's "fine-tune": seeded noise added to the last layer's slice
    of every stacked tensor and to final_norm.  Returns the new state
    (the unedited leaves shared with ``state``) and the bytes edited."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def edit(x):
        x = x.clone()
        x[-1].add_(torch.randn(x[-1].shape, generator=gen, device=dev,
                               dtype=x.dtype).mul_(0.01))
        return x

    params = map_layers(state["params"], edit)
    params["final_norm"] = edit(state["params"]["final_norm"][None])[0]
    step = state["opt"]["step"] + 1
    edited = [x[-1] for _, x in tree_leaves(params["layers"])]
    edited += [params["final_norm"], step]
    return ({"params": params, "opt": {"step": step}},
            sum(x.numel() * x.element_size() for x in edited))


def trees_equal(got: dict, want: dict) -> bool:
    g, w = tree_leaves(got), tree_leaves(want)
    return ([n for n, _ in g] == [n for n, _ in w]
            and all(a.dtype == b.dtype and a.shape == b.shape
                    and a.device == b.device and torch.equal(a, b)
                    for (_, a), (_, b) in zip(g, w)))


def state_bytes(state) -> int:
    return sum(x.numel() * x.element_size() for _, x in tree_leaves(state))


def _tinyllama():
    from repro_torch.configs import ARCHS
    return ARCHS["tinyllama-1.1b"]


def controller_replay(dev, cfg, B: int, S: int) -> dict:
    """The training controller on ``cfg``'s whole train state (params, fp32
    master, mu, nu, step): ``run_resilient`` (an in-memory store, the
    engine's cid hash, fphash here) over CTL_STEPS real train steps on
    SyntheticLM batches of B x S, a checkpoint every CTL_CKPT_EVERY,
    failures at CTL_FAIL_AT; against a plain loop of the same step over
    the same batches that saves nothing, under the controller's
    ``deterministic()``.  The launch counters are zeroed before the
    controller and read after it; then its last checkpoint (the final
    state) is held against the plain versions (``saved_vs_plain``)."""
    from repro_torch.kernels import ops
    from repro_torch.runtime import deterministic, run_resilient
    from repro_torch.shardings import Sharding
    from repro_torch.train import (AdamWConfig, SyntheticLM,
                                   init_train_state, make_train_step,
                                   shard_batch)

    shd = Sharding(None, cfg)
    init = init_train_state(cfg, torch.Generator(device=dev).manual_seed(2),
                            shards=4, device=dev)
    data = SyntheticLM(cfg.vocab, S, B, seed=3)
    step = make_train_step(cfg, shd, AdamWConfig(
        lr=3e-4, warmup_steps=1, total_steps=CTL_STEPS))
    out = {"layers": cfg.n_layers, "batch": B, "seq": S, "steps": CTL_STEPS,
           "ckpt_every": CTL_CKPT_EVERY, "fail_at": list(CTL_FAIL_AT),
           "state_bytes": state_bytes(init)}
    ops.reset_launches()
    t = time.perf_counter()
    failed = run_resilient(step, init, data, n_steps=CTL_STEPS,
                           ckpt_every=CTL_CKPT_EVERY, fail_at=CTL_FAIL_AT)
    synchronize(dev)
    out["controller_s"] = time.perf_counter() - t
    out["controller_launches"] = ops.launches()
    t = time.perf_counter()
    plain = init
    with deterministic():
        for i in range(CTL_STEPS):
            plain, _ = step(plain, shard_batch(data.batch_at(i)))
    synchronize(dev)
    out["plain_s"] = time.perf_counter() - t
    history = failed.ckpt.history("run", 1 << 20)
    out["saves"] = len(history)
    out["restarts"] = failed.restarts
    out["losses"] = [loss for _, loss in failed.metrics_log]
    check(failed.restarts == len(set(CTL_FAIL_AT))
          and failed.step == CTL_STEPS,
          f"the controller restarted {failed.restarts} times and stopped at "
          f"step {failed.step}")
    check(trees_equal(failed.state, plain),
          "the controller's replayed run differs from the plain loop")
    after = dict(tree_leaves(plain["params"]))
    still = [n for n, x in tree_leaves(init["params"])
             if torch.equal(x, after[n])]
    check(not still, f"the train steps left params unchanged: {still}")
    check(history[0][1]["step"] == CTL_STEPS,
          f"the last checkpoint is of step {history[0][1]['step']}")
    t = time.perf_counter()
    out["vs_plain"] = saved_vs_plain(failed.ckpt, "run", failed.state, dev,
                                     fphash=True)
    out["vs_plain"]["s"] = time.perf_counter() - t
    return out


def profile_save(state: dict) -> dict:
    """Where a save of ``state`` (on the card) spends its time: the save
    again into an in-memory CheckpointStore under torch.profiler — the
    device time of the kernels, of the D2H copies of the leaves and of the
    H2D copies of their bytes back to the card (the chunker's stream and
    the hash batches), against the wall time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.ckpt import CheckpointStore

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        CheckpointStore().save(state, "run", step=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    us = {"kernel": 0.0, "d2h": 0.0, "h2d": 0.0, "other_copy": 0.0}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        key = e.key.lower()
        kind = ("d2h" if "dtoh" in key else "h2d" if "htod" in key
                else "other_copy" if "memcpy" in key else "kernel")
        us[kind] += e.self_device_time_total
    busy = sum(us.values()) / 1e6
    return {"wall_s": wall, **{f"device_{k}_s": v / 1e6 for k, v in us.items()},
            "device_busy_share": busy / wall}


def checkpoint_path(dev, n_layers: int = TINYLLAMA_LAYERS,
                    table=TINYLLAMA_PARAMS, breakdown: bool = False,
                    ctl_cfg=None, ctl_batch=None, **store_kw) -> dict:
    """Phase 5: the params of ``table`` at ``n_layers`` (and opt/step) on
    ``dev``, checkpointed through ``CheckpointStore(ForkBase(durable_root=
    <fresh temporary directory>))`` with fphash cids: save step 0 on
    branch run, fine-tune the last layer and save step 1, fork sweep from
    step 0, sync and close; reopen, restore run on ``dev``; remove sweep,
    prune run to its last checkpoint (stop-the-world GC) and sync (the
    compaction); restore only the edited leaves.  Then the training
    controller (``controller_replay``) on the whole train state of
    ``ctl_cfg`` (default TinyLlama-1.1B at full width, cut to 2 layers)
    with batches of ``ctl_batch`` (B, S), against a plain loop.  Every
    check fails the run; the directory is removed at the end.  ``breakdown`` adds two
    diagnostics no check reads: a mark alone before the prune's GC
    (``mark_s``; it warms the store's caches for that GC) and
    ``profile_save`` (on the card).
    ``store_kw`` (``hot_bytes``, ``segment_bytes``) scales the durable
    store down for a rehearsal at a small width; the card's run keeps
    the engine's defaults."""
    import shutil
    import tempfile

    from repro_torch.ckpt import CheckpointStore
    from repro_torch.core import ForkBase, hashing
    from repro_torch.gc import mark
    from repro_torch.kernels import ops

    out: dict = {"layers": n_layers}
    root = tempfile.mkdtemp(prefix="forkbase-ckpt-")
    hashing.use_fphash()
    try:
        state0 = ckpt_state(table, n_layers, dev, seed=0)
        leaves0 = tree_leaves(state0)
        out["bytes"] = sum(x.numel() * x.element_size() for _, x in leaves0)
        out["leaves"] = len(leaves0)
        synchronize(dev)
        t = time.perf_counter()
        for _, x in leaves0:
            x.reshape(-1).view(torch.uint8).cpu()
        out["d2h_s"] = time.perf_counter() - t

        cs = CheckpointStore(ForkBase(durable_root=root, **store_kw))
        stats = cs.db.store.stats
        ops.reset_launches()
        t = time.perf_counter()
        uid0 = cs.save(state0, "run", step=0)
        out["save0_s"] = time.perf_counter() - t
        phys0 = stats.physical_bytes
        state1, out["edited_bytes"] = finetune(state0, dev, seed=1)
        synchronize(dev)
        t = time.perf_counter()
        cs.save(state1, "run", step=1)
        out["save1_s"] = time.perf_counter() - t
        out["save1_new_bytes"] = stats.physical_bytes - phys0
        cs.fork(uid0, "sweep")
        t = time.perf_counter()
        cs.sync()
        out["sync_s"] = time.perf_counter() - t
        snapshot = cs.db.branches.snapshot()
        heads = cs.db.branches.all_heads()
        cs.db.store.close()
        del cs
        print(f"  phase 5: saved 2 checkpoints of {out['bytes']} B "
              f"({out['save0_s']:.1f} s, {out['save1_s']:.1f} s)",
              flush=True)

        t = time.perf_counter()
        cs = CheckpointStore(ForkBase(durable_root=root, **store_kw))
        out["reopen_s"] = time.perf_counter() - t
        check(cs.db.branches.snapshot() == snapshot
              and cs.db.branches.all_heads() == heads,
              "checkpoint store: the reopened heads differ from the heads "
              "before the close")
        # tamper evidence of the reopened head: its meta chunk re-hashed
        # against its uid (the single-string fphash kernel; the saves hash
        # every chunk, meta chunks included, in fphash_many batches)
        check(cs.db.get(cs.key, "run", verify=True) is not None,
              "the reopened head does not verify")
        t = time.perf_counter()
        restored = cs.restore(state1, "run")
        synchronize(dev)
        out["restore_s"] = time.perf_counter() - t
        check(trees_equal(restored, state1),
              "the restored step 1 differs from the saved state")
        del restored
        manifest = cs.db.get(cs.key, "run").map()
        embed_cid = json.loads(manifest.get(b"params/embed"))["cid"]
        embed_bytes = (state1["params"]["embed"].reshape(-1)
                       .view(torch.uint8).cpu().numpy().tobytes())
        print(f"  phase 5: reopened and restored "
              f"({out['restore_s']:.1f} s)", flush=True)

        cold = cs.db.store.cold
        out["disk_bytes_before"] = cold.disk_bytes()
        cs.db.remove(cs.key, "sweep")
        if breakdown:
            # the mark alone, as the prune's collection will run it:
            # every live chunk, leaves included, read back from the store
            t = time.perf_counter()
            mark(cs.db.store, cs.db.branches.all_heads(), cs.db.gc_hooks)
            out["mark_s"] = time.perf_counter() - t
        t = time.perf_counter()
        kept, rep = cs.prune("run", keep_last=1)
        out["gc_s"] = time.perf_counter() - t
        t = time.perf_counter()
        cs.sync()
        out["sync_after_gc_s"] = time.perf_counter() - t
        out["disk_bytes_after"] = cold.disk_bytes()
        out["gc"] = {"roots": rep.roots, "live_chunks": rep.live_chunks,
                     "swept_chunks": rep.swept_chunks,
                     "reclaimed_bytes": rep.reclaimed_bytes,
                     "mark_rounds": rep.mark_rounds,
                     "compacted_bytes": rep.compacted_bytes,
                     "compactions": cold.stats.compactions}
        check(kept == [cs.db.get(cs.key, "run", verify=True).uid]
              and [h[1]["step"] for h in cs.history("run")] == [1],
              "prune kept the wrong checkpoints")
        print(f"  phase 5: pruned and collected ({out['gc_s']:.1f} s)",
              flush=True)

        touched = {"params": {"final_norm": state1["params"]["final_norm"],
                              "layers": state1["params"]["layers"]}}
        t = time.perf_counter()
        part = cs.restore(touched, "run")
        synchronize(dev)
        out["partial_restore_s"] = time.perf_counter() - t
        out["partial_bytes"] = sum(x.numel() * x.element_size()
                                   for _, x in tree_leaves(touched))
        check(trees_equal(part, touched),
              "the partial restore differs from the saved leaves")
        del part
        out["launches"] = ops.launches()
        cs.db.store.close()
        del cs, state1, touched
        if breakdown and torch.device(dev).type == "cuda":
            out["save_profile"] = profile_save(state0)
        del state0

        ctl = controller_replay(dev, ctl_cfg or dataclasses.replace(
            _tinyllama(), n_layers=CTL_LAYERS), *(ctl_batch or CTL_BATCH))
        out["controller_launches"] = ctl.pop("controller_launches")
        out["controller"] = ctl
    finally:
        hashing.use_sha256()
        shutil.rmtree(root, ignore_errors=True)

    # the plain versions set their own hooks (and restore sha256 after)
    check(plain_root(embed_bytes).hex() == embed_cid,
          "the params/embed root cid differs from the plain versions'")
    limit = 1.05 * out["edited_bytes"] + (1 << 20)
    check(out["save1_new_bytes"] < limit,
          f"step 1 stored {out['save1_new_bytes']} new bytes, over "
          f"{limit:.0f}: dedup misses the unedited layers")
    g = out["gc"]
    check(g["swept_chunks"] > 0, "the GC swept nothing")
    check(g["reclaimed_bytes"] >= 0.9 * out["save1_new_bytes"],
          f"the GC reclaimed {g['reclaimed_bytes']} B, under 0.9 x step "
          f"1's {out['save1_new_bytes']} new bytes")
    check(g["compacted_bytes"] > 0, "the GC's flush compacted nothing")
    check(out["disk_bytes_after"] < out["disk_bytes_before"],
          "the disk bytes did not fall across the GC and sync()")
    return out


# ------------------------------------------------------------ phase 6

# The ledger's sizes come from the repo's benchmarks of these subsystems:
# 1M accounts (benchmarks/live_bench.py, n_keys), 64-byte values under the
# "kv" contract and blocks of 200 writes over 2,048 archival accounts
# (benchmarks/blockchain_ops.py:70-75), 1,024 state proofs
# (benchmarks/proof_bench.py, N_PROOFS) and the attestation churn of
# proof_bench.py's _attest_churn (1,000 heads, 20 rounds of 10 updates).
# The live accounts are cut to 500,000 by default (--ledger-accounts):
# at 1M the phase took 147-235 s on one H100, and its time grows with the
# accounts (every block splice and every proof walks the whole map's
# index on the host; PERF.md §4-5).
LEDGER_ACCOUNTS = 500_000
LEDGER_BLOCKS = 50
BLOCK_WRITES = 200
VALUE_BYTES = 64
STATE_PROOFS = 1024
STATE_LOADS = 16          # timed reloads of the state map's index
ARCHIVE_ACCOUNTS = 2048
ARCHIVE_BLOCKS = 10
ARCHIVE_PROOFS = 64
CHURN_HEADS, CHURN_UPDATES, CHURN_ROUNDS = 1000, 10, 20
SECRET = b"chip-smoke-attestation-key"


def seeded_blocks(led, model: dict, rng, accounts: int, blocks: int) -> list:
    """``blocks`` blocks of BLOCK_WRITES writes to seeded random accounts;
    returns each commit's milliseconds."""
    ms = []
    for _ in range(blocks):
        picks = rng.integers(0, accounts, BLOCK_WRITES)
        vals = rng.bytes(VALUE_BYTES * BLOCK_WRITES)
        for w, j in enumerate(picks):
            v = vals[VALUE_BYTES * w:VALUE_BYTES * (w + 1)]
            led.write("kv", f"key{int(j)}", v)
            model[f"kv/key{int(j)}".encode()] = v
        t = time.perf_counter()
        led.commit()
        ms.append((time.perf_counter() - t) * 1e3)
    return ms


def seed_accounts(led, model: dict, rng, accounts: int) -> float:
    """``accounts`` accounts of VALUE_BYTES seeded bytes each, then one
    commit; returns the seconds of the writes and the commit."""
    vals = rng.bytes(VALUE_BYTES * accounts)
    t = time.perf_counter()
    for i in range(accounts):
        v = vals[VALUE_BYTES * i:VALUE_BYTES * (i + 1)]
        led.write("kv", f"key{i}", v)
        model[f"kv/key{i}".encode()] = v
    led.commit()
    return time.perf_counter() - t


def live_ledger(accounts: int, blocks: int, proofs: int, seed: int) -> dict:
    """(a) A live-mode ledger: ``accounts`` seeded accounts, ``blocks``
    blocks, the last state root against a direct build with the plain
    kernels, block lineage and flat state proofs through a light client,
    a forged proof and an absence proof."""
    from repro_torch.apps.blockchain import (STATE_KEY, ForkBaseLedger,
                                             LightClient)
    from repro_torch.core import FMap, ForkBase, POSTree
    from repro_torch.kernels import ops
    from repro_torch.proof import InvalidProof, verify_member
    from repro_torch.proof.membership import ABSENCE
    from repro_torch.storage import MemoryBackend

    rng = np.random.default_rng(seed)
    out = {"accounts": accounts, "blocks": blocks}
    led = ForkBaseLedger(ForkBase(), live=True)
    model: dict[bytes, bytes] = {}
    ops.reset_launches()
    out["seed_s"] = seed_accounts(led, model, rng, accounts)
    out["seed_fold_s"] = led._state.stats.fold_seconds
    out["seed_folds"] = led._state.stats.folds
    ms = seeded_blocks(led, model, rng, accounts, blocks)
    out["block_ms_median"] = float(np.median(ms))
    out["block_ms_max"] = max(ms)

    root = led.db.get(STATE_KEY).obj.data
    head = led.db.get("chain").uid
    client = LightClient(head)
    for h in (0, blocks // 2, blocks - 1):
        try:
            d = client.verify_block(led.prove_block(h), led.block_uid(h))
        except InvalidProof as e:
            fail(f"the light client rejects block {h}: {e}")
        check(d == led.height - 1 - h, f"block {h} is {d} blocks from the "
              f"head, not {led.height - 1 - h}")
    picks = [f"key{int(j)}" for j in rng.integers(0, accounts, proofs)]
    t = time.perf_counter()
    flat = [led.prove_state_flat("kv", k) for k in picks]
    out["prove_s"] = time.perf_counter() - t
    # each flat proof reloads the state map's index from its root: that
    # reload alone, to split the prover's time
    obj = led.db.get(STATE_KEY).obj
    t = time.perf_counter()
    for _ in range(STATE_LOADS):
        POSTree.from_root(led.db.store, obj.type, obj.data, led.db.params)
    out["state_load_ms"] = (time.perf_counter() - t) * 1e3 / STATE_LOADS
    t = time.perf_counter()
    for p, k in zip(flat, picks):
        try:
            d, v = client.verify_state_flat(p, "kv", k)
        except InvalidProof as e:
            fail(f"the light client rejects the state proof of {k}: {e}")
        check(d == 0 and v == model[f"kv/{k}".encode()],
              f"the state proof of {k} gives {v!r} at distance {d}")
    out["verify_s"] = time.perf_counter() - t
    out["proofs"] = len(flat)
    out["proof_bytes_mean"] = float(np.mean([p.size for p in flat]))
    raw = flat[0].kv_entry
    i = len(raw) // 2
    forged = dataclasses.replace(
        flat[0], kv_entry=raw[:i] + bytes([raw[i] ^ 1]) + raw[i + 1:])
    try:
        client.verify_state_flat(forged, "kv", picks[0])
        fail("a state proof with a flipped byte verifies")
    except InvalidProof:
        pass
    gone = b"kv/never-written"
    try:
        claim = verify_member(root, led.db.prove_absence(STATE_KEY,
                                                         item_key=gone))
    except InvalidProof as e:
        fail(f"the absence proof does not verify: {e}")
    check(claim.mode == ABSENCE and claim.key == gone,
          f"the absence proof proves {claim}")
    out["launches"] = ops.launches()

    del led
    with plain_kernels():
        t = time.perf_counter()
        want = FMap(model).commit(MemoryBackend())
        out["plain_build_s"] = time.perf_counter() - t
    check(root == want, "the live ledger's state root differs from the "
          "direct build with the plain kernels")
    out["roots_bit_identical"] = True
    return out


def attest_churn(heads: int, updates: int, rounds: int, seed: int) -> dict:
    """(b) ``heads`` heads, then ``rounds`` rounds of ``updates``
    single-head updates and one delta attestation, each against the full
    rebuild; every updated head's proof verifies.  Also the mean time of
    one Merkle node hash (one single-string fphash launch and its digest
    back on the host) as attestation calls it."""
    from repro_torch.core import FBlob, ForkBase
    from repro_torch.kernels import ops
    from repro_torch.proof import InvalidProof, attest_heads, verify_head
    from repro_torch.proof.attest import node_hash
    from repro_torch.storage import MemoryBackend

    rng = np.random.default_rng(seed)
    db = ForkBase(MemoryBackend())
    keys = [b"key%06d" % i for i in range(heads)]
    ops.reset_launches()
    for i, key in enumerate(keys):
        db.put(key, FBlob(b"v%d" % i))
    out = {"heads": heads, "updates": updates, "rounds": rounds}
    sums = {"delta_s": 0.0, "full_s": 0.0}
    per = {f"{w}_{k}": 0 for w in ("delta", "full")
           for k in ("fphash", "fphash_many")}
    l0 = ops.launches()
    t = time.perf_counter()
    db.attest()
    out["first_attest_ms"] = (time.perf_counter() - t) * 1e3
    out["first_attest_fphash"] = ops.launches()["fphash"] - l0["fphash"]
    version = 0
    for _ in range(rounds):
        picks = [keys[int(p)] for p in rng.integers(0, heads, updates)]
        for key in picks:
            version += 1
            db.put(key, FBlob(b"u%d" % version))
        for what in ("delta", "full"):
            l0 = ops.launches()
            t = time.perf_counter()
            att = db.attest() if what == "delta" else attest_heads(
                db.branches)
            sums[f"{what}_s"] += time.perf_counter() - t
            l1 = ops.launches()
            for k in ("fphash", "fphash_many"):
                per[f"{what}_{k}"] += l1[k] - l0[k]
            if what == "delta":
                delta = att
        check(delta.root == att.root, "a delta attestation root differs "
              "from the full rebuild")
        for key in set(picks):
            try:
                got = verify_head(delta, db.prove_head(key))
            except InvalidProof as e:
                fail(f"the head proof of {key!r} does not verify: {e}")
            check(got == (key, "master", db.branches.head(key, "master")),
                  f"the head proof of {key!r} proves {got}")
    out["delta_attest_ms"] = sums["delta_s"] / rounds * 1e3
    out["full_attest_ms"] = sums["full_s"] / rounds * 1e3
    out.update({f"{k}_per_attest": v / rounds for k, v in per.items()})
    out["delta_stats"] = dataclasses.asdict(db._delta().stats)
    out["launches"] = ops.launches()
    a, b = bytes(32), bytes(range(32))
    n = 2 * heads                 # the nodes of about two full rebuilds
    t = time.perf_counter()
    for _ in range(n):
        a = node_hash(a, b)
    out["node_hash_ms"] = (time.perf_counter() - t) / n * 1e3
    return out


def archival_ledger(accounts: int, blocks: int, proofs: int,
                    seed: int) -> dict:
    """(c) An archival ledger on a 3-way ReplicatedBackend: ``accounts``
    seeded accounts and ``blocks`` blocks, state proofs and a head
    refresh through a light client, then the engine audit and a full
    replica audit, clean, and again after one copy of one chunk on
    replica 1 is overwritten."""
    from repro_torch.apps.blockchain import ForkBaseLedger, LightClient
    from repro_torch.core import ForkBase
    from repro_torch.kernels import ops
    from repro_torch.proof import Auditor, InvalidProof
    from repro_torch.storage import MemoryBackend, ReplicatedBackend

    rng = np.random.default_rng(seed)
    out = {"accounts": accounts, "blocks": blocks}
    rb = ReplicatedBackend([MemoryBackend() for _ in range(3)], k=3)
    led = ForkBaseLedger(ForkBase(rb))
    model: dict[bytes, bytes] = {}
    ops.reset_launches()
    out["seed_s"] = seed_accounts(led, model, rng, accounts)
    ms = seeded_blocks(led, model, rng, accounts, blocks)
    out["block_ms_median"] = float(np.median(ms))
    out["block_ms_max"] = max(ms)
    head = led.db.get("chain").uid
    client = LightClient(head)
    picks = [f"key{int(j)}" for j in rng.integers(0, accounts, proofs)]
    t = time.perf_counter()
    for k in picks:
        try:
            d, v = client.verify_state(led.prove_state("kv", k), "kv", k)
        except InvalidProof as e:
            fail(f"the light client rejects the archival proof of {k}: {e}")
        check(d == 0 and v == model[f"kv/{k}".encode()],
              f"the archival proof of {k} gives {v!r} at distance {d}")
    out["prove_verify_ms"] = (time.perf_counter() - t) / len(picks) * 1e3
    att = led.attest(secret=SECRET)
    try:
        got = client.refresh_head(att, led.prove_chain_head(), secret=SECRET)
    except InvalidProof as e:
        fail(f"the light client rejects the attested chain head: {e}")
    check(got == head, "the attested chain head is not the ledger's head")
    out["launches"] = ops.launches()

    ops.reset_launches()
    t = time.perf_counter()
    rep = led.db.audit(sample=64, secret=SECRET)
    out["engine_audit_ms"] = (time.perf_counter() - t) * 1e3
    check(rep.ok, f"the engine audit has findings: {rep}")
    out["engine_audit"] = {"heads": rep.heads_checked,
                           "proofs": rep.proofs_verified}
    t = time.perf_counter()
    rep = Auditor(sample=len(rb)).audit_replicas(rb)
    out["replica_audit_ms"] = (time.perf_counter() - t) * 1e3
    check(rep.ok and rep.chunks_checked == len(rb)
          and rep.copies_checked == 3 * len(rb),
          f"the replica audit is not clean over every copy: {rep}")
    out["audit_chunks"] = rep.chunks_checked
    out["audit_copies"] = rep.copies_checked
    cids = sorted(rb.stores[1].iter_cids())
    cid = cids[int(rng.integers(0, len(cids)))]
    raw = rb.stores[1]._data[cid]
    rb.stores[1]._data[cid] = raw[:-1] + bytes([raw[-1] ^ 0xFF])
    rep = Auditor(sample=len(rb)).audit_replicas(rb)
    check([(f.node, f.kind, f.cid) for f in rep.findings]
          == [("replica1", "corrupt", cid)],
          f"the audit of one corrupted copy reports {rep}")
    out["audit_launches"] = ops.launches()
    return out


def ledger_path(dev, accounts: int = LEDGER_ACCOUNTS,
                blocks: int = LEDGER_BLOCKS, proofs: int = STATE_PROOFS,
                archive_accounts: int = ARCHIVE_ACCOUNTS,
                archive_blocks: int = ARCHIVE_BLOCKS,
                archive_proofs: int = ARCHIVE_PROOFS,
                churn: tuple = (CHURN_HEADS, CHURN_UPDATES, CHURN_ROUNDS)
                ) -> dict:
    """Phase 6 on ``dev`` with fphash cids: (a) the live ledger, (b)
    attestation churn, (c) the archival ledger and its replica audit.
    ``launches`` gives each part's launches per kernel."""
    from repro_torch.core import hashing

    try:
        hashing.use_fphash()
        live = live_ledger(accounts, blocks, proofs, seed=0)
        synchronize(dev)
        hashing.use_fphash()      # the plain build of (a) restored sha256
        churned = attest_churn(*churn, seed=1)
        arch = archival_ledger(archive_accounts, archive_blocks,
                               archive_proofs, seed=2)
        synchronize(dev)
    finally:
        hashing.use_sha256()
    return {"live": live, "churn": churned, "archival": arch,
            "launches": {"live": live.pop("launches"),
                         "churn": churned.pop("launches"),
                         "archival": arch.pop("launches"),
                         "audit": arch.pop("audit_launches")}}


# ------------------------------------------------------------ phase 7

CLUSTER_NODES = 4
MAX_BALANCE = 1.10        # max / min of a 2LP storage distribution
SKEW_NODES = 16           # Fig. 15, benchmarks/wiki_bench.py:90-101
SKEW_PAGES = 8
SKEW_VALUE_BYTES = 8192
SKEW_EDITS = 10_000       # per mode; wiki_bench.py puts 400
MAX_SKEW_CV = 0.10
RUNTIME_WRITERS = 8       # tests/test_runtime.py's _stress, scaled up
RUNTIME_PUTS = 250        # per writer, over 8 keys each
RUNTIME_VALUE_BYTES = 1024
COALESCE_OPS = 96         # benchmarks/cluster_bench.py's shape


def cluster_full_width(ds: dict, want_uids: list[bytes]) -> dict:
    """(a) Dataset ``ds`` in ``Cluster(4, "2LP")``: v1, v2 and the fork
    as phase 3 puts them, each read back; node 1 quarantined and drained
    by ``rereplicate()``, v1 read back again; then v1 in ``Cluster(4,
    "1LP")``, which must hold every byte on the key's home node."""
    from repro_torch.core import Cluster, FBlob
    from repro_torch.kernels import ops

    v1, v2, tail = ds["v1"], ds["v2"], ds["tail"]
    ops.reset_launches()
    cl = Cluster(CLUSTER_NODES, "2LP")
    out = put_versions(cl, ds, lambda: sum(cl.storage_distribution()))
    out["bytes"] = len(v1)
    uid1 = out["uids"][0]
    t = time.perf_counter()
    check(cl.get("dataset", uid=uid1).blob().read() == v1,
          "cluster v1 reads back wrong")
    check(cl.get("dataset").blob().read() == v2, "cluster v2 reads back wrong")
    check(cl.get("dataset", "dev").blob().read() == v2 + tail,
          "cluster v3 reads back wrong")
    out["get_s"] = time.perf_counter() - t
    dist = cl.storage_distribution()
    out.update(distribution=dist, balance=max(dist) / max(1, min(dist)),
               index_chunks=len(cl.index),
               requests=[n.stats.requests for n in cl.nodes])
    # a whole node re-replicated: one fphash_many launch per chunk moved
    t = time.perf_counter()
    out["rerep_queued"] = cl.quarantine_node(1, reason="phase 7")
    out["rerep_moved"] = cl.rereplicate()
    out["rerep_s"] = time.perf_counter() - t
    check(cl.rerep_lost == 0 and cl.rerep_done == out["rerep_queued"]
          and len(cl.nodes[1].store) == 0
          and 1 not in set(cl.index.values()),
          "node 1 was not drained by the re-replication")
    check(cl.get("dataset", uid=uid1).blob().read() == v1,
          "cluster v1 reads back wrong after the re-replication")
    out["distribution_rerep"] = cl.storage_distribution()
    del cl
    one = Cluster(CLUSTER_NODES, "1LP")
    t = time.perf_counter()
    uid = one.put("dataset", FBlob(v1))
    out["put_1lp_s"] = time.perf_counter() - t
    home = one._home_index("dataset")
    dist1 = one.storage_distribution()
    out.update(distribution_1lp=dist1, home_1lp=home)
    check(uid == uid1, "the 1LP cluster's v1 uid differs from the 2LP's")
    check(dist1[home] >= len(v1) and sum(dist1) == dist1[home]
          and len(one.nodes[home].store) == len(one.index),
          f"1LP placed bytes off the home node {home}: {dist1}")
    del one
    out["launches"] = ops.launches()
    check(out["uids"] == want_uids,
          "the cluster's uids differ from the engine's (phase 3)")
    check(out["v2_new_bytes"] < 0.05 * len(v1),
          f"cluster v2 stored {out['v2_new_bytes']} new bytes of {len(v1)}")
    check(out["balance"] < MAX_BALANCE,
          f"2LP storage max/min {out['balance']:.4f}: {dist}")
    return out


def cluster_skew(edits: int, seed: int = 3) -> dict:
    """(b) Fig. 15: ``edits`` 8 KB random values to 8 zipf(1.5)-hot
    pages, one branch each, on 16 servlets in 1LP and in 2LP (the same
    draws); the coefficient of variation of the storage distribution."""
    import statistics

    from repro_torch.core import Cluster, FBlob
    from repro_torch.kernels import ops

    out = {"nodes": SKEW_NODES, "pages": SKEW_PAGES, "edits": edits,
           "value_bytes": SKEW_VALUE_BYTES}
    ops.reset_launches()
    for mode in ("1LP", "2LP"):
        rng = np.random.default_rng(seed)
        cl = Cluster(SKEW_NODES, mode)
        zipf = rng.zipf(1.5, size=edits)
        t = time.perf_counter()
        for i, z in enumerate(zipf):
            cl.put(f"hot{int(z) % SKEW_PAGES}",
                   FBlob(rng.bytes(SKEW_VALUE_BYTES)), branch=f"b{i}")
        put_s = time.perf_counter() - t
        dist = cl.storage_distribution()
        build = cl.build_distribution()
        out[mode] = {
            "cv": statistics.pstdev(dist) / max(1, statistics.mean(dist)),
            "build_cv": statistics.pstdev(build) / max(1, statistics.mean(build)),
            "min_bytes": min(dist), "max_bytes": max(dist),
            "put_ms": put_s / edits * 1e3}
    out["launches"] = ops.launches()
    check(out["2LP"]["cv"] < out["1LP"]["cv"]
          and out["2LP"]["cv"] < MAX_SKEW_CV,
          f"2LP does not spread the skewed load: {out}")
    return out


def put_batches(cl) -> int:
    return sum(n.servlet.store.stats.put_batches for n in cl.nodes)


def coalescing(ops_n: int, seed: int) -> dict:
    """Per-request ``Cluster.put`` against coalesced ``ClusterRuntime``
    puts of the same ``ops_n`` 1 KB values into fresh 4-node clusters,
    twice each in the order per, coalesced, coalesced, per: µs per op and
    the routing stores' put batches.  Both must give the same uids."""
    from repro_torch.core import Cluster, FBlob, RuntimeConfig

    rng = np.random.default_rng(seed)
    vals = [rng.bytes(RUNTIME_VALUE_BYTES) for _ in range(ops_n)]

    def per_request():
        cl = Cluster(CLUSTER_NODES)
        t = time.perf_counter()
        uids = [cl.put(f"k{i}", FBlob(v)) for i, v in enumerate(vals)]
        return time.perf_counter() - t, uids, put_batches(cl)

    def coalesced():
        cl = Cluster(CLUSTER_NODES)
        rt = cl.runtime(RuntimeConfig(queue_depth=4 * ops_n))
        t = time.perf_counter()
        futs = [rt.submit_put(f"k{i}", FBlob(v)) for i, v in enumerate(vals)]
        rt.drain()
        uids = [f.result() for f in futs]
        return time.perf_counter() - t, uids, put_batches(cl)

    runs = {"per_request": [], "coalesced": []}
    for mode in ("per_request", "coalesced", "coalesced", "per_request"):
        runs[mode].append((per_request if mode == "per_request"
                           else coalesced)())
    uids = {tuple(u) for mode in runs.values() for _, u, _ in mode}
    check(len(uids) == 1, "coalesced puts give other uids than single puts")
    out = {"ops": ops_n}
    for mode, rs in runs.items():
        out[f"{mode}_us"] = sum(s for s, _, _ in rs) / len(rs) / ops_n * 1e6
        out[f"{mode}_put_batches"] = rs[0][2]
    out["speedup"] = out["per_request_us"] / out["coalesced_us"]
    return out


def cluster_runtime(writers: int, puts_each: int, coalesce_ops: int,
                    seed: int = 4) -> dict:
    """(c) A threaded ``ClusterRuntime`` with its ``MaintenanceDaemon`` on
    a fresh 4-node cluster, started before any put: ``writers`` threads
    put ``puts_each`` 1 KB values each over 8 keys of their own; node 0
    is quarantined once a quarter of the puts are done.  Then
    ``rereplicate()``, a placement audit and a stop-the-world GC; every
    head must be its writer's last put and read back, and node 0 must end
    empty.  Launches come from several threads here, so only > 0 holds."""
    import threading

    from repro_torch.core import Cluster, FBlob, RuntimeConfig
    from repro_torch.kernels import ops
    from repro_torch.proof.audit import Auditor

    out = {"nodes": CLUSTER_NODES, "writers": writers,
           "puts": writers * puts_each, "value_bytes": RUNTIME_VALUE_BYTES}
    ops.reset_launches()
    cl = Cluster(CLUSTER_NODES)
    cfg = RuntimeConfig(queue_depth=4096, gc_cycle_ticks=3,
                        tick_interval_s=0.001, fold_every=2, audit_every=3)
    t = time.perf_counter()
    rt = cl.runtime(cfg).start(daemon=True)
    errors: list = []
    last: dict[str, tuple[bytes, bytes]] = {}
    lock = threading.Lock()
    done = [0]
    quarter = threading.Event()

    def writer(w):
        r = np.random.default_rng(seed * 1000 + w)
        for i in range(puts_each):
            key = f"w{w}-k{i % 8}"
            value = r.bytes(RUNTIME_VALUE_BYTES)
            try:
                uid = rt.submit_put(key, FBlob(value)).result(timeout=120)
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append((key, repr(e)))
                continue
            with lock:
                last[key] = (uid, value)
                done[0] += 1
                if 4 * done[0] >= out["puts"]:
                    quarter.set()

    threads = [threading.Thread(target=writer, args=(w,))
               for w in range(writers)]
    for th in threads:
        th.start()
    quarter.wait(timeout=300)
    with lock:
        out["done_at_quarantine"] = done[0]
    out["quarantine_backlog"] = cl.quarantine_node(0, reason="mid-run")
    for th in threads:
        th.join(timeout=600)
    out["daemon_ticks"] = rt.daemon.ticks
    rt.stop()
    out["run_s"] = time.perf_counter() - t
    out["puts_per_s"] = out["puts"] / out["run_s"]
    check(not errors, f"runtime puts failed: {errors[:3]}")
    check(not any(th.is_alive() for th in threads), "a writer never ended")
    check(0 < out["done_at_quarantine"] < out["puts"],
          f"the quarantine did not land mid-run: {out}")

    def heads_hold(when):
        for key, (uid, value) in last.items():
            h = cl.get(key)
            check(h is not None and h.uid == uid
                  and h.blob().read() == value,
                  f"{key}'s head is not its writer's last put {when}")

    heads_hold("after the run")
    t = time.perf_counter()
    cl.rereplicate()
    out["rereplicate_s"] = time.perf_counter() - t
    rep = Auditor(sample=64).audit_placement(cl)
    check(rep.ok, f"the placement audit after rereplicate: {rep}")
    gc = cl.gc()
    out["gc"] = {"swept": gc.swept_chunks, "live": gc.live_chunks}
    heads_hold("after the GC")
    check(0 not in set(cl.index.values()) and len(cl.nodes[0].store) == 0,
          "the quarantined node 0 still holds chunks")
    out.update(rerep_done=cl.rerep_done, rerep_lost=cl.rerep_lost,
               distribution=cl.storage_distribution())
    out["launches"] = ops.launches()
    out["sample_raw"] = cl.nodes[1].store.get(
        next(iter(cl.nodes[1].store.iter_cids())))
    out["coalescing"] = coalescing(coalesce_ops, seed)
    return out


def overwrite_chunk(store, cid: bytes) -> None:
    """Flip the last byte of ``cid`` in a durable node store (a
    ``TieredBackend``): on disk in its segment, and in the hot tier when a
    copy is resident there."""
    store.flush()
    cold = store.cold
    seg = cold._segments[cold._index[cid]]
    off, ln = seg.live[cid]
    with open(seg.path, "r+b") as f:
        f.seek(off + ln - 1)
        last = f.read(1)[0]
        f.seek(off + ln - 1)
        f.write(bytes([last ^ 0x55]))
    raw = store._hot.get(cid)
    if raw is not None:
        store._hot[cid] = raw[:-1] + bytes([raw[-1] ^ 0x55])


def cluster_durable(ds: dict, want_uid: bytes) -> dict:
    """(d) v1 of dataset ``ds`` into ``Cluster(4, durable_root=<a fresh
    temporary directory>, verify=True)``, ``sync()``, close; a new
    cluster reopens the root with equal heads and index and reads v1 back
    (every chunk checked by the single-string kernel); an attestation and
    an audit are clean, and after one data chunk on node 2 is overwritten
    an audit of every placement names node 2 alone."""
    import shutil
    import tempfile

    from repro_torch.core import Cluster, FBlob
    from repro_torch.core import chunk as ck
    from repro_torch.kernels import ops

    v1 = ds["v1"]
    out = {"records": ds["records"], "bytes": len(v1)}
    root = tempfile.mkdtemp(prefix="forkbase-cluster-")
    try:
        ops.reset_launches()
        cl = Cluster(CLUSTER_NODES, durable_root=root, verify=True)
        t = time.perf_counter()
        uid = cl.put("dataset", FBlob(v1))
        out["put_s"] = time.perf_counter() - t
        t = time.perf_counter()
        cl.sync()
        out["sync_s"] = time.perf_counter() - t
        snaps = [n.servlet.branches.snapshot() for n in cl.nodes]
        index = dict(cl.index)
        for n in cl.nodes:
            n.store.close()
        del cl
        t = time.perf_counter()
        cl = Cluster(CLUSTER_NODES, durable_root=root, verify=True)
        out["reopen_s"] = time.perf_counter() - t
        check([n.servlet.branches.snapshot() for n in cl.nodes] == snaps,
              "the reopened cluster's heads differ")
        check(dict(cl.index) == index, "the reopened cluster's index differs")
        t = time.perf_counter()
        check(cl.get("dataset").blob().read() == v1,
              "durable cluster v1 reads back wrong")
        out["get_s"] = time.perf_counter() - t
        check(uid == want_uid, "the durable cluster's uid differs from the "
                               "engine's (phase 4)")
        catt, atts = cl.attest(context=b"phase7", secret=SECRET)
        check(catt.count == CLUSTER_NODES
              and sum(a.count for a in atts) == 1,
              "the cluster attestation does not commit one head")
        t = time.perf_counter()
        rep = cl.audit(secret=SECRET)
        out["audit_ms"] = (time.perf_counter() - t) * 1e3
        check(rep.ok, f"the durable cluster's audit: {rep}")
        store = cl.nodes[2].store
        victim = next(c for c in sorted(store.iter_cids())
                      if ck.chunk_type(store.get(c)) != ck.META)
        out["sample_raw"] = store.get(victim)
        overwrite_chunk(store, victim)
        t = time.perf_counter()
        rep = cl.audit(sample=len(cl.index), secret=SECRET)
        out["full_audit_s"] = time.perf_counter() - t
        out["audit_chunks"] = rep.chunks_checked
        named = {f.node for f in rep.findings}
        check(named == {"node2"} and any(f.cid == victim
                                         for f in rep.findings),
              f"the audit of one overwritten chunk on node 2 reports {rep}")
        out["launches"] = ops.launches()
        out.update(index_chunks=len(cl.index),
                   distribution=cl.storage_distribution())
        for n in cl.nodes:
            n.store.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def cluster_kernels_vs_plain(dev, rerep_raw: bytes, leaf_raw: bytes,
                             seed: int = 3) -> dict[str, int]:
    """Each kernel at the shapes phase 7 adds, against its plain version:
    the bitmap on one 8 KB skew value, fphash_many on a batch of one chunk
    (as ``rereplicate_step`` hashes it) and fphash on one leaf chunk
    through the engine's single-value route (as a verifying node store
    checks it)."""
    from repro_torch.core import rolling
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.chunker import boundary_bitmap
    from repro_torch.kernels.fphash import fphash_many

    x = torch.from_numpy(np.frombuffer(
        np.random.default_rng(seed).bytes(SKEW_VALUE_BYTES), np.uint8)
        .copy()).to(dev)
    k, p = boundary_bitmap(x), rolling.boundary_bitmap(x, 48, 12)
    check(torch.equal(k, p), "bitmap differs from plain on a skew value")
    err = {"boundary_bitmap": max_err(k, p)}
    r = torch.from_numpy(np.frombuffer(rerep_raw, np.uint8).copy()).to(dev)
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    n = torch.full((1,), r.numel(), dtype=torch.int64, device=dev)
    k, p = fphash_many(r, zero, n), ref.fphash_many_ref(r, zero, n)
    check(torch.equal(k, p), "fphash_many differs from plain on a batch of one")
    err["fphash_many"] = max_err(k, p)
    m = torch.from_numpy(np.frombuffer(leaf_raw, np.uint8).copy()).to(dev)
    k, p = cid_tensor(ops.content_hash(leaf_raw)), ref.fphash_ref(m).cpu()
    check(torch.equal(k, p), "fphash differs from plain on a leaf chunk")
    err["fphash"] = max_err(k, p)
    return err


def cluster_path(dev, ds: dict, want_uids: list[bytes],
                 dds: dict, want_durable_uid: bytes, *,
                 skew_edits: int = SKEW_EDITS,
                 writers: int = RUNTIME_WRITERS,
                 puts_each: int = RUNTIME_PUTS,
                 coalesce_ops: int = COALESCE_OPS) -> dict:
    """Phase 7 on ``dev`` with fphash cids: (c) the threaded runtime runs
    first, so that when the phase runs alone its workers load the kernels;
    then (a) the full-width dataset ``ds``, (b) the Fig. 15 skew and (d)
    the durable cluster on ``dds``.  ``launches`` gives each part's
    launches per kernel; ``max_abs_err`` the kernel checks at phase 7's
    shapes, made after every count was read."""
    from repro_torch.core import hashing

    try:
        hashing.use_fphash()
        t = time.perf_counter()
        runtime = cluster_runtime(writers, puts_each, coalesce_ops)
        synchronize(dev)
        runtime["part_s"] = time.perf_counter() - t
        t = time.perf_counter()
        full = cluster_full_width(ds, want_uids)
        synchronize(dev)
        full["part_s"] = time.perf_counter() - t
        t = time.perf_counter()
        skew = cluster_skew(skew_edits)
        synchronize(dev)
        skew["part_s"] = time.perf_counter() - t
        t = time.perf_counter()
        durable = cluster_durable(dds, want_durable_uid)
        synchronize(dev)
        durable["part_s"] = time.perf_counter() - t
        err = cluster_kernels_vs_plain(dev, runtime.pop("sample_raw"),
                                       durable.pop("sample_raw"))
    finally:
        hashing.use_sha256()
    return {"full_width": full, "skew": skew, "runtime": runtime,
            "durable": durable, "max_abs_err": err,
            "launches": {"full_width": full.pop("launches"),
                         "skew": skew.pop("launches"),
                         "runtime": runtime.pop("launches"),
                         "durable": durable.pop("launches")}}


# ------------------------------------------------------------ phase 8

# (a): the card against the CPU on the same params.  In float32 on both,
# the parity tests' 1e-3 (tests/torch_model_parity.py) on logits and 2e-3
# on the loss; in bfloat16 on the card, 1e-1 of the largest |logit| and 1e-1
# on the loss: bf16 rounds weights and activations to 8 bits (2^-8
# relative a step), which a CPU run of the smoke archs puts at 1-4% of
# the largest logit, and routes an MoE token to another expert when its
# top-k scores nearly tie (5.6% for olmoe on the CPU)
SMOKE_F32_TOL, SMOKE_F32_LOSS_TOL = 1e-3, 2e-3
SMOKE_BF16_TOL = 1e-1
SMOKE_B, SMOKE_S, SMOKE_DECODES = 2, 64, 4
# (b): full widths, depth cut; decode at position S - 1 against prefill
# over S tokens, both in bf16 on the card: 5e-2 of the largest |logit|, 1e-1
# with the int8 KV cache (a quantum of each cached row besides)
WIDE_B, WIDE_S, WIDE_DECODES = 2, 128, 8
WIDE_TOL, WIDE_QUANT_TOL = 5e-2, 1e-1
# archs whose decode differs from prefill by design in the reference as
# well: MoE capacity depends on the tokens in the call (B*S at prefill, B
# at decode), and xLSTM's parallel form exponentiates q.k where its
# recurrent form does not (ROADMAP, faults section)
PREFILL_DECODE_EXEMPT = {"olmoe-1b-7b": "MoE capacity drops",
                         "deepseek-moe-16b": "MoE capacity drops",
                         "xlstm-125m": "parallel vs recurrent mLSTM"}
# (c), (d): TinyLlama-1.1B at full width and depth
SERVE_B, SERVE_S, SERVE_GEN = 4, 512, 64
TRAIN_B, TRAIN_S = 1, 2048
ATTN_TOL = 2e-2           # SDPA vs the blocked form, bf16 outputs of O(1)
EXAMPLES = ("quickstart", "blockchain_demo", "collab_analytics", "wiki_demo")


def depth_cut(cfg):
    """(b)'s configuration: full widths, two layers; zamba2 one group of
    its attn_every Mamba layers; xLSTM at its full 12 layers."""
    if cfg.family == "ssm":
        return cfg
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, n_layers=cfg.attn_every)
    return dataclasses.replace(cfg, n_layers=2)


def _leaves(tree) -> list:
    from repro_torch.models import model as M
    out = []
    M.tree_map(out.append, tree)
    return out


def _tokens(vocab: int, shape, seed: int, dev) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, shape, generator=gen,
                         dtype=torch.int32).to(dev)


def _vision(cfg, B: int, dev, dtype=torch.bfloat16) -> dict:
    if cfg.frontend != "vision":
        return {}
    gen = torch.Generator().manual_seed(7)
    pe = torch.randn((B, cfg.n_patches, cfg.d_model), generator=gen)
    return {"patch_embeds": pe.to(dtype).to(dev)}


def rel_err(got: torch.Tensor, want: torch.Tensor, vocab: int) -> float:
    """max |got - want| over the real vocabulary / max |want|."""
    g, w = got[..., :vocab].float().cpu(), want[..., :vocab].float().cpu()
    return float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))


def _smoke_sequence(params, batch: dict, cfg, tokens=None):
    """train_loss, then prefill and SMOKE_DECODES decode steps; the decode
    inputs are ``tokens`` or, if None, this run's greedy tokens.  Returns
    (loss, [logits of each step] on the CPU, the decode tokens)."""
    from repro_torch.models import model as M
    from repro_torch.shardings import Sharding

    shd = Sharding(None, cfg)
    dev = batch["tokens"].device
    B = batch["tokens"].shape[0]
    with torch.no_grad():
        loss, _ = M.train_loss(params, batch, cfg, shd)
        pb = {k: v for k, v in batch.items() if k != "labels"}
        cache, logits = M.prefill(params, pb, cfg, shd,
                                  cache_len=SMOKE_S + SMOKE_DECODES)
        seq, used = [logits.float().cpu()], []
        for i in range(SMOKE_DECODES):
            tok = (torch.argmax(logits[:, :cfg.vocab], -1)[:, None].int()
                   if tokens is None else tokens[i].to(dev))
            used.append(tok.cpu())
            pos = torch.full((B,), SMOKE_S + i, dtype=torch.int32, device=dev)
            cache, logits = M.decode_step(params, cache,
                                          {"tokens": tok, "pos": pos}, cfg,
                                          shd)
            seq.append(logits.float().cpu())
    return float(loss), seq, used


def smoke_on_card(dev) -> dict:
    """(a) Every arch at its smoke config on ``dev`` against the CPU, on
    the same params (init_params' bf16 leaves): the CPU in float32 is the
    reference; the card in float32 and in bf16.  train_loss, prefill logits
    and SMOKE_DECODES decode steps on the CPU's greedy tokens."""
    from repro_torch.configs import ARCHS, smoke
    from repro_torch.models import model as M

    out = {}
    for name in sorted(ARCHS):
        cfg = smoke(ARCHS[name])
        params = M.init_params(cfg, torch.Generator().manual_seed(0),
                               shards=4, device=dev)
        St = SMOKE_S - (cfg.n_patches if cfg.frontend == "vision" else 0)
        toks = _tokens(cfg.vocab, (SMOKE_B, St), 1, "cpu")
        batch = {"tokens": toks, "labels": toks,
                 **_vision(cfg, SMOKE_B, "cpu", torch.float32)}
        card = {k: v.to(dev) for k, v in batch.items()}
        ref = M.tree_map(lambda t: t.float().cpu(), params)
        rloss, rseq, toks_used = _smoke_sequence(ref, batch, cfg)
        row = {"loss_cpu": rloss}
        for dt, tol, ltol in (("f32", SMOKE_F32_TOL, SMOKE_F32_LOSS_TOL),
                              ("bf16", SMOKE_BF16_TOL, SMOKE_BF16_TOL)):
            p = params if dt == "bf16" else M.tree_map(
                lambda t: t.float(), params)
            loss, seq, _ = _smoke_sequence(p, card, cfg, toks_used)
            if dt == "f32":
                err = max(float((a[:, :cfg.vocab] - b[:, :cfg.vocab]
                                 ).abs().max()) for a, b in zip(seq, rseq))
            else:
                err = max(rel_err(a, b, cfg.vocab) for a, b in zip(seq, rseq))
            row[f"loss_{dt}"], row[f"err_{dt}"] = loss, err
            check(abs(loss - rloss) <= ltol,
                  f"{name}: the card's {dt} loss {loss} differs from the "
                  f"CPU's {rloss}")
            check(err <= tol, f"{name}: the card's {dt} logits differ from "
                              f"the CPU's by {err:.5f}")
        out[name] = row
    return out


def full_width(dev, make_cfg=depth_cut, B: int = WIDE_B, S: int = WIDE_S,
               decodes: int = WIDE_DECODES) -> dict:
    """(b) Every arch at its full widths, depth cut by ``make_cfg``: prefill
    B x S, then ``decodes`` greedy decode steps, in bf16 on ``dev``;
    finite logits and in-vocab greedy tokens; and prefill over the first
    S - 1 tokens then a decode of token S - 1 against the prefill over S
    (S - 1 and S, not S and S + 1: zamba2's SSD scan takes a prompt of
    min(128, S) chunks only)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import model as M
    from repro_torch.shardings import Sharding

    out = {}
    for name in sorted(ARCHS):
        cfg = make_cfg(ARCHS[name])
        shd = Sharding(None, cfg)
        params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(
            0), shards=4, device=dev)
        nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
        P = cfg.n_patches if cfg.frontend == "vision" else 0
        toks = _tokens(cfg.vocab, (B, S), 2, dev)
        vis = _vision(cfg, B, dev)
        synchronize(dev)
        t = time.perf_counter()
        with torch.no_grad():
            cache, full = M.prefill(params, {"tokens": toks, **vis}, cfg,
                                    shd, cache_len=P + S + decodes)
            synchronize(dev)
            prefill_s = time.perf_counter() - t
            logits = full
            t = time.perf_counter()
            for i in range(decodes):
                check(bool(torch.isfinite(logits.float()).all()),
                      f"{name}: non-finite logits")
                tok = torch.argmax(logits, -1)[:, None].int()
                check(int(tok.max()) < cfg.vocab,
                      f"{name}: greedy token outside the vocabulary")
                pos = torch.full((B,), P + S + i, dtype=torch.int32,
                                 device=dev)
                cache, logits = M.decode_step(params, cache,
                                              {"tokens": tok, "pos": pos},
                                              cfg, shd)
            synchronize(dev)
            decode_s = time.perf_counter() - t
            check(bool(torch.isfinite(logits.float()).all()),
                  f"{name}: non-finite logits")
            short, _ = M.prefill(params, {"tokens": toks[:, :-1], **vis},
                                 cfg, shd, cache_len=P + S)
            _, step = M.decode_step(params, short, {
                "tokens": toks[:, -1:], "pos": torch.full(
                    (B,), P + S - 1, dtype=torch.int32, device=dev)},
                cfg, shd)
        agree = rel_err(step, full, cfg.vocab)
        tol = WIDE_QUANT_TOL if cfg.kv_quant else WIDE_TOL
        exempt = PREFILL_DECODE_EXEMPT.get(name)
        out[name] = {"layers": cfg.n_layers, "param_bytes": nbytes,
                     "prefill_s": prefill_s,
                     "decode_step_ms": decode_s / decodes * 1e3,
                     "decode_vs_prefill": agree,
                     "argmax_equal": bool(torch.equal(
                         step[:, :cfg.vocab].argmax(-1),
                         full[:, :cfg.vocab].argmax(-1))),
                     **({"exempt": exempt} if exempt else {})}
        check(exempt is not None or agree <= tol,
              f"{name}: decode at S - 1 differs from prefill over S by "
              f"{agree:.4f} of the largest logit")
        del params, cache, short
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def attention_forms(dev, shapes) -> dict:
    """flash_attention's CUDA route (scaled_dot_product_attention) against
    the blocked online softmax at each (B, S, H, dh) of ``shapes``, bf16."""
    from repro_torch.models import layers

    out = {}
    for B, S, H, dh in shapes:
        gen = torch.Generator().manual_seed(S)
        q, k, v = (torch.randn((B, S, H, dh), generator=gen).to(
            torch.bfloat16).to(dev) for _ in range(3))
        fused = layers.sdpa_attention(q, k, v)
        blocked = layers.blocked_attention(q, k, v)
        err = float((fused.float() - blocked.float()).abs().max())
        check(err <= ATTN_TOL, f"SDPA differs from the blocked form by {err}"
                               f" at {(B, S, H, dh)}")
        row = {"max_abs_err": err}
        if dev.type == "cuda":
            row["sdpa_ms"] = cuda_ms(lambda: layers.sdpa_attention(q, k, v),
                                     10)
            row["blocked_ms"] = cuda_ms(
                lambda: layers.blocked_attention(q, k, v), 3)
        out[f"{B}x{S}x{H}x{dh}"] = row
    return out


def device_share(fn, reps: int) -> dict:
    """Where ``reps`` calls of fn() spend their time, under torch.profiler:
    the wall time a call (with the profiler's own host cost), the device
    time of its kernels and copies, their ratio (the card's busy share)
    and the device operations a call launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_s = sum(e.self_device_time_total for e in ev) / 1e6
    return {"wall_ms": wall / reps * 1e3, "device_ms": dev_s / reps * 1e3,
            "busy_share": dev_s / wall,
            "device_ops": sum(e.count for e in ev) / reps}


def serve_tinyllama(dev, cfg, B: int = SERVE_B, S: int = SERVE_S,
                    gen: int = SERVE_GEN) -> dict:
    """(c) launch/serve.py's functions on ``cfg``: a warm-up run, then
    prefill B x S and ``gen`` greedy tokens, timed; the decode at S against
    prefill over S + 1 tokens at full depth; peak device memory."""
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.shardings import Sharding

    shd = Sharding(None, cfg)
    rng = torch.Generator(device=dev).manual_seed(0)
    params = M.init_params(cfg, rng, shards=4, device=dev)
    batch = serve.make_batch(cfg, B, S, rng, dev)
    with torch.no_grad():
        serve.generate(params, batch, cfg, shd, 4)              # warm-up
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        run = serve.generate(params, batch, cfg, shd, gen)
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else None)
        toks = run["tokens"]
        check(int(toks.max()) < cfg.vocab
              and bool(torch.isfinite(run["logits"].float()).all()),
              "tinyllama: greedy decode left the vocabulary or the logits "
              "are not finite")
        cache, _ = M.prefill(params, batch, cfg, shd, cache_len=S + 1)
        _, step = M.decode_step(params, cache, {
            "tokens": toks[:, :1], "pos": torch.full(
                (B,), S, dtype=torch.int32, device=dev)}, cfg, shd)
        _, full = M.prefill(params, {"tokens": torch.cat(
            [batch["tokens"], toks[:, :1]], 1)}, cfg, shd)
        profiles = {} if dev.type != "cuda" else {
            "prefill_profile": device_share(lambda: M.prefill(
                params, batch, cfg, shd, cache_len=S + gen), 2),
            "decode_profile": device_share(lambda: M.decode_step(
                params, cache, {"tokens": toks[:, :1], "pos": torch.full(
                    (B,), S, dtype=torch.int32, device=dev)}, cfg, shd), 5)}
    agree = rel_err(step, full, cfg.vocab)
    check(agree <= WIDE_TOL, f"tinyllama: decode at S differs from prefill "
                             f"over S + 1 by {agree:.4f} of the largest logit")
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    step_s = run["decode_s"] / (gen - 1)
    return {**profiles, "batch": B, "prompt": S, "gen": gen, "param_bytes": nbytes,
            "prefill_s": run["prefill_s"],
            "prefill_bound_s": 2 * cfg.params_count() * B * S
            / PEAK_BF16_FLOPS_PER_S,
            "decode_s": run["decode_s"], "decode_step_ms": step_s * 1e3,
            "decode_tok_s": B * (gen - 1) / run["decode_s"],
            "decode_step_bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
            "decode_tok_s_bound": B * PEAK_BYTES_PER_S / nbytes,
            "peak_bytes": peak, "decode_vs_prefill": agree,
            "sample": toks[0, :12].tolist()}


def train_tinyllama(dev, cfg, B: int = TRAIN_B, S: int = TRAIN_S) -> dict:
    """(d) One forward and backward of train_loss from a seeded init (a
    warm-up pass first): tokens a second, peak memory, finite gradients
    and a loss in (0, 2 ln V)."""
    from repro_torch.models import model as M
    from repro_torch.shardings import Sharding

    shd = Sharding(None, cfg)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(1),
                           shards=4, device=dev)
    leaves = [t.requires_grad_() for t in _leaves(params)
              if t.is_floating_point()]
    toks = _tokens(cfg.vocab, (B, S), 3, dev)
    batch = {"tokens": toks, "labels": toks}
    out = {"batch": B, "seq": S}
    for timed in (False, True):
        for t in leaves:
            t.grad = None
        if timed and dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        synchronize(dev)
        t0 = time.perf_counter()
        loss, _ = M.train_loss(params, batch, cfg, shd)
        loss.backward()
        synchronize(dev)
        out["step_s"] = time.perf_counter() - t0
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                         if dev.type == "cuda" else None)
    out["loss"] = loss.item()
    if dev.type == "cuda":
        def step():
            lo, _ = M.train_loss(params, batch, cfg, shd)
            lo.backward()
        out["profile"] = device_share(step, 1)
    out["tok_s"] = B * S / out["step_s"]
    out["step_bound_s"] = 6 * cfg.params_count() * B * S \
        / PEAK_BF16_FLOPS_PER_S
    check(0 < out["loss"] < 2 * np.log(cfg.vocab),
          f"tinyllama: loss {out['loss']} outside (0, 2 ln V)")
    gn = sum(float(t.grad.float().pow(2).sum()) for t in leaves)
    check(np.isfinite(gn) and gn > 0, f"tinyllama: grad norm^2 {gn}")
    out["grad_norm"] = float(np.sqrt(gn))
    return out


def run_examples(dev) -> dict:
    """The four engine examples of examples/torch, each run in this process
    on the engine's device (its main(), output captured): seconds and the
    number of lines each printed."""
    import io
    import runpy

    out = {}
    for name in EXAMPLES:
        mod = runpy.run_path(os.path.join(ROOT, "examples", "torch",
                                          f"{name}.py"), run_name=name)
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            mod["main"]()
        synchronize(dev)
        out[name] = {"s": time.perf_counter() - t,
                     "lines": len(buf.getvalue().splitlines())}
    return out


def model_path(dev, *, make_cfg=depth_cut, serve_cfg=None, wide=None,
               serve=None, train=None, attn_shapes=None) -> dict:
    """Phase 8 on ``dev``: (a) every arch at its smoke config against the
    CPU, (b) every arch at full width with the depth cut, (c) TinyLlama-1.1B
    served at full width and depth, (d) its forward and backward, SDPA
    against the blocked attention at (c)'s and (d)'s shapes, and the four
    engine examples.  The keyword arguments shrink the parts for a
    rehearsal on the CPU."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops

    tl = serve_cfg or ARCHS["tinyllama-1.1b"]
    parts = {}
    ops.reset_launches()
    for part, fn in (
            ("smoke", lambda: smoke_on_card(dev)),
            ("full_width", lambda: full_width(dev, make_cfg, **(wide or {}))),
            ("serve", lambda: serve_tinyllama(dev, tl, **(serve or {}))),
            ("train", lambda: train_tinyllama(dev, tl, **(train or {}))),
            ("attention", lambda: attention_forms(dev, attn_shapes or (
                (SERVE_B, SERVE_S, tl.n_heads, tl.dh),
                (TRAIN_B, TRAIN_S, tl.n_heads, tl.dh))))):
        t = time.perf_counter()
        parts[part] = fn()
        synchronize(dev)
        parts[part + "_s"] = time.perf_counter() - t
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    parts["model_launches"] = ops.launches()
    ops.reset_launches()
    parts["examples"] = run_examples(dev)
    parts["example_launches"] = ops.launches()
    return parts


# ------------------------------------------------------------ phase 9

# (a) TinyLlama-1.1B at full width and depth, B=1 x 2048 (phase 8 (d)'s
# shape): a warm-up step, TRAIN_STEPS timed steps, TRAIN_DET_STEPS more
# under deterministic(), each set summed up by its median (the host
# stalls now and then for a step); (b) microbatch 4 against 1 from one state at the
# 2-layer cut, B=4 x 512, params within the reference's 3e-2
# (tests/test_train_runtime.py:51-53); (c) the launcher (20 smoke steps)
# and the example (EXAMPLE_STEPS steps, failures at a third and two thirds)
TRAIN_STEPS, TRAIN_DET_STEPS = 3, 3
MB_B, MB_S, MB_TOL = 4, 512, 3e-2
# microbatch 4 against 1 beyond the reference's params check, which a
# step-0 lr of 3e-6 cannot fail: gnorm (bfloat16 accumulation rounds each
# entry by ~2^-9; a missing / microbatch gives 4x) and loss (the mean of
# 4 slice means) relative, and the share of a leaf's step-1 directions
# turned (bfloat16 activations turn ~1% between the two packages on one
# batch, tests/test_torch_train_parity.py; a dropped slice, most)
MB_GNORM_REL, MB_LOSS_REL, MB_DIR_OFF = 1e-2, 1e-3, 0.05
LAUNCHER_STEPS, EXAMPLE_STEPS = 20, 40
# elementwise float32 operations of one AdamW update per param, counted
# from apply_adamw's arithmetic (scale, two moments, bias corrections,
# sqrt, eps, division, decay, learning rate, subtraction)
ADAMW_OPS_PER_PARAM = 17


def adamw_bytes(state) -> int:
    """Bytes apply_adamw must move: read each gradient (the param's dtype),
    mu, nu and master once, write mu, nu, master and the params once."""
    p = state_bytes(state["params"])
    o = state["opt"]
    return (2 * p + 2 * (state_bytes(o["mu"]) + state_bytes(o["nu"])
                         + state_bytes(o["master"])))


def train_full(dev, cfg, B: int = TRAIN_B, S: int = TRAIN_S) -> dict:
    """(a) ``init_train_state`` on ``dev``, then make_train_step on
    SyntheticLM.prefetch batches: a warm-up step, TRAIN_STEPS timed steps
    (each ending in a synchronisation), TRAIN_DET_STEPS under the
    controller's ``deterministic()`` (each set's median is its step
    time); the gradient leaves that differ between two deterministic runs
    on one batch (``grads_vary_det``, which must be empty); apply_adamw
    alone on the last step's gradients; peak memory of the timed steps;
    the busy share of one step under torch.profiler.  Checks the loss in
    (0, 2 ln V), every param leaf moved over the timed steps, and params
    == master cast to each param's dtype."""
    from repro_torch.runtime import deterministic
    from repro_torch.shardings import Sharding
    from repro_torch.train import (AdamWConfig, SyntheticLM, apply_adamw,
                                   init_train_state, make_train_step)
    from repro_torch.train.step import value_and_grad

    shd = Sharding(None, cfg)
    opt = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=100)
    step = make_train_step(cfg, shd, opt)
    out = {"layers": cfg.n_layers, "batch": B, "seq": S,
           "params": cfg.params_count()}
    synchronize(dev)
    t = time.perf_counter()
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(4),
                             shards=4, device=dev)
    synchronize(dev)
    out["init_s"] = time.perf_counter() - t
    out["state_bytes"] = state_bytes(state)
    it = SyntheticLM(cfg.vocab, S, B, seed=5).prefetch(0)
    try:
        _, batch = next(it)
        state, m = step(state, batch)                            # warm-up
        before = {n: x.clone() for n, x in tree_leaves(state["params"])}
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        times, losses = [], []
        for _ in range(TRAIN_STEPS):
            synchronize(dev)
            t = time.perf_counter()
            _, batch = next(it)
            state, m = step(state, batch)
            synchronize(dev)
            times.append(time.perf_counter() - t)
            losses.append(float(m["loss"]))
        out["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                             if dev.type == "cuda" else None)
        det = []
        with deterministic():
            for _ in range(TRAIN_DET_STEPS):
                synchronize(dev)
                t = time.perf_counter()
                _, batch = next(it)
                state, m = step(state, batch)
                synchronize(dev)
                det.append(time.perf_counter() - t)
                losses.append(float(m["loss"]))
    finally:
        it.close()
    out["step_s"] = float(np.median(times))
    out["step_s_each"] = times
    out["det_step_s"] = float(np.median(det)) if det else None
    out["det_step_s_each"] = det
    out["det_cost"] = (out["det_step_s"] / out["step_s"]) if det else None
    out["tok_s"] = B * S / out["step_s"]
    out["step_bound_s"] = 6 * cfg.params_count() * B * S \
        / PEAK_BF16_FLOPS_PER_S
    out["tok_s_bound"] = B * S / out["step_bound_s"]
    out["losses"] = losses
    out["gnorm"] = float(m["gnorm"])
    out["lr"] = float(m["lr"])
    check(all(0 < x < 2 * np.log(cfg.vocab) for x in losses),
          f"training: a loss outside (0, 2 ln V): {losses}")
    after = dict(tree_leaves(state["params"]))
    still = [n for n, x in before.items() if torch.equal(x, after[n])]
    check(not still, f"training: params unchanged over the steps: {still}")
    master = dict(tree_leaves(state["opt"]["master"]))
    off = [n for n, x in after.items()
           if not torch.equal(x, master[n].to(x.dtype))]
    check(not off, f"training: params differ from master cast: {off}")
    del before, after, master

    # the gradients of two deterministic runs on one batch
    with deterministic():
        g0 = value_and_grad(state["params"], batch, cfg, shd)[2]
        g1 = dict(tree_leaves(value_and_grad(state["params"], batch, cfg,
                                             shd)[2]))
    out["grads_vary_det"] = [n for n, g in tree_leaves(g0)
                             if not torch.equal(g, g1[n])]
    del g0, g1
    check(not out["grads_vary_det"], "training: gradients vary between two "
          f"deterministic runs: {out['grads_vary_det']}")
    _, _, grads = value_and_grad(state["params"], batch, cfg, shd)
    nbytes = adamw_bytes(state)
    nparams = sum(x.numel() for _, x in tree_leaves(state["params"]))
    out["adamw_bytes"] = nbytes
    out["adamw_bound_ms"], out["adamw_bound_by"] = bound_ms(
        nbytes, ADAMW_OPS_PER_PARAM * nparams)
    if dev.type == "cuda":
        with torch.no_grad():
            out["adamw_ms"] = cuda_ms(lambda: apply_adamw(
                opt, state["params"], state["opt"], grads), 3)
        del grads
        torch.cuda.empty_cache()
        it = SyntheticLM(cfg.vocab, S, B, seed=6).prefetch(0)
        try:
            _, batch = next(it)
            out["profile"] = device_share(lambda: step(state, batch), 1)
        finally:
            it.close()
    return out


def microbatch_gap(init: dict, runs: dict) -> dict:
    """How far microbatch 4's step lies from microbatch 1's, both from
    state ``init`` (``runs[1]`` and ``runs[4]``, each (state, metrics);
    phase 11 holds a mesh's step in 4 against one rank's in 1): the
    largest |param difference|, the relative gaps of gnorm and loss, and
    (``dir_off``) the largest share, over the leaves, of the entries whose
    step-1 direction (new master - old master) / lr differs by more than 1
    (a step-1 Adam update moves an entry by about lr x sign(g), so a
    flipped gradient sign moves it by about 2)."""
    (s1, m1), (s4, m4) = runs[1], runs[4]
    lr = float(m1["lr"])
    p4 = dict(tree_leaves(s4["params"]))
    old = tree_leaves(init["opt"]["master"])
    new1 = dict(tree_leaves(s1["opt"]["master"]))
    new4 = dict(tree_leaves(s4["opt"]["master"]))
    return {
        "max_abs_diff": max(float((x.float() - p4[n].float()).abs().max())
                            for n, x in tree_leaves(s1["params"])),
        "gnorm_rel": abs(float(m4["gnorm"]) / float(m1["gnorm"]) - 1),
        "loss_rel": abs(float(m4["loss"]) / float(m1["loss"]) - 1),
        "dir_off": max(float(((new4[n] - new1[n]).abs() > lr)
                             .float().mean()) for n, _ in old)}


def check_microbatch(gap: dict) -> None:
    check(gap["max_abs_diff"] <= MB_TOL,
          f"microbatch 4 differs from 1 by {gap['max_abs_diff']}")
    check(gap["gnorm_rel"] <= MB_GNORM_REL and gap["loss_rel"] <= MB_LOSS_REL,
          f"microbatch 4's gnorm or loss differs from 1's: {gap}")
    check(gap["dir_off"] <= MB_DIR_OFF,
          f"microbatch 4 turns {gap['dir_off']} of a leaf's step-1 "
          f"directions against 1's")


def train_microbatch(dev, cfg, B: int = MB_B, S: int = MB_S) -> dict:
    """(b) microbatch=4 against microbatch=1 from one state on one batch,
    ``cfg`` cut to CTL_LAYERS: every param within MB_TOL, as the
    reference's test_microbatch_equivalence holds them (its
    AdamWConfig()), and ``microbatch_gap``'s gnorm, loss and direction
    limits."""
    from repro_torch.shardings import Sharding
    from repro_torch.train import (AdamWConfig, SyntheticLM,
                                   init_train_state, make_train_step,
                                   shard_batch)

    cfg = dataclasses.replace(cfg, n_layers=CTL_LAYERS)
    shd = Sharding(None, cfg)
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(7),
                             shards=4, device=dev)
    batch = shard_batch(SyntheticLM(cfg.vocab, S, B, seed=8).batch_at(0))
    out = {"layers": cfg.n_layers, "batch": B, "seq": S}
    runs = {}
    for mb in (1, 4):
        step = make_train_step(cfg, shd, AdamWConfig(), microbatch=mb)
        synchronize(dev)
        t = time.perf_counter()
        runs[mb] = step(state, batch)
        synchronize(dev)
        out[f"mb{mb}_s"] = time.perf_counter() - t
        out[f"mb{mb}_loss"] = float(runs[mb][1]["loss"])
    out.update(microbatch_gap(state, runs))
    check_microbatch(out)
    return out


def train_entry_points(dev, launcher_steps: int = LAUNCHER_STEPS,
                       example_steps: int = EXAMPLE_STEPS) -> dict:
    """(c) launch/train.py's main and examples/torch/
    train_with_forkbase_ckpt.py on ``dev`` (their output captured), the
    launch counters zeroed before them and read after them
    (``launches``): the loss falls (the mean of the last 5 steps under
    the first 5's), the example restarts once per injected failure.
    Then the last checkpoint of each run, restored, is held against the
    plain versions (``saved_vs_plain``; sha256 cids, as they save)."""
    import io
    import runpy

    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train

    out = {}
    runs = {
        "launcher": lambda: launch_train.main(
            ["--smoke", "--steps", str(launcher_steps),
             "--device", dev.type]),
        "example": lambda: runpy.run_path(os.path.join(
            ROOT, "examples", "torch", "train_with_forkbase_ckpt.py"),
            run_name="example")["main"](
            ["--steps", str(example_steps), "--device", dev.type])}
    ctls = {}
    ops.reset_launches()
    for name, run in runs.items():
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            ctls[name] = ctl = run()
        synchronize(dev)
        losses = [loss for _, loss in ctl.metrics_log]
        out[name] = {"s": time.perf_counter() - t, "steps": ctl.step,
                     "restarts": ctl.restarts, "first_loss": losses[0],
                     "last_loss": losses[-1],
                     "last_line": buf.getvalue().splitlines()[-1]}
        check(np.mean(losses[-5:]) < np.mean(losses[:5]),
              f"{name}: the loss did not fall: {losses}")
    out["launches"] = ops.launches()
    want = len({example_steps // 3, 2 * example_steps // 3})
    check(out["launcher"]["restarts"] == 0
          and out["example"]["restarts"] == want,
          f"restarts {out['launcher']['restarts']} (launcher), "
          f"{out['example']['restarts']} (example, {want} injected)")
    for name, ctl in ctls.items():
        out[name]["vs_plain"] = saved_vs_plain(
            ctl.ckpt, ctl.branch, ctl.ckpt.restore(ctl.state, ctl.branch),
            dev, fphash=False)
    return out


def training_path(dev, *, cfg=None, full=None, mb=None, entry=None) -> dict:
    """Phase 9 on ``dev``: (a) ``train_full`` on ``cfg`` (default
    TinyLlama-1.1B), (b) ``train_microbatch`` on its 2-layer cut, (c)
    ``train_entry_points``, whose launches the counters (zeroed before
    it) count.  The keyword arguments shrink the parts for a rehearsal on
    the CPU."""
    cfg = cfg or _tinyllama()
    parts = {}
    for part, fn in (
            ("full", lambda: train_full(dev, cfg, **(full or {}))),
            ("microbatch", lambda: train_microbatch(dev, cfg, **(mb or {}))),
            ("entry_points", lambda: train_entry_points(dev, **(entry or {})))):
        t = time.perf_counter()
        parts[part] = fn()
        synchronize(dev)
        parts[part + "_s"] = time.perf_counter() - t
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    parts["train_launches"] = parts["entry_points"].pop("launches")
    return parts


# ------------------------------------------------------------ phase 10

# (a) every arch x shape cell of the dry run (launch/dryrun.py) at full
# width and depth on meta, both production meshes from one census a cell,
# DRYRUN_WORKERS processes at once; argument bytes a device on 16x16 at
# most one H100's 80 GB
DRYRUN_WORKERS = 6
DRYRUN_ARG_LIMIT = 80e9
# (b) TinyLlama-1.1B: the census's matrix-product FLOPs (mm, bmm, addmm,
# baddbmm) against torch.profiler's with_flops for the same call on the
# card.  Both count 2 x M x N x K a product from the same shapes, so they
# should agree exactly; the tolerance leaves room for a product that one
# side reaches through another aten op
CENSUS_TOL = 1e-3
PRODUCT_OPS = ("mm", "bmm", "addmm", "baddbmm")
CENSUS_CALLS = {"train": (1, 2048), "prefill": (SERVE_B, SERVE_S),
                "decode": (SERVE_B, SERVE_S + SERVE_GEN)}
# (c) olmoe-1b-7b at full width, two layers (phase 8 (b)'s cut), prefill
# B x S through the one-card mesh's moe_shard_map against the mesh-less
# gather path, both under deterministic algorithms (the combine's
# index_add adds with atomics otherwise): equal bit for bit
MESH_ARCH, MESH_B, MESH_S = "olmoe-1b-7b", WIDE_B, WIDE_S


def _dryrun_cell(job: tuple) -> tuple:
    """One catalogue cell in a worker process: its records on both
    production meshes and the seconds it took."""
    from repro_torch.launch import dryrun
    torch.set_num_threads(1)
    t = time.perf_counter()
    recs = dryrun.lower_both(*job)
    return job, recs, time.perf_counter() - t


def start_catalogue():
    """(a) Start the whole catalogue: each cell's census in one of
    DRYRUN_WORKERS spawned processes, the slowest (the xLSTM's per-step
    sLSTM loop, the 110B train step) first.  Returns what
    ``finish_catalogue`` takes."""
    import concurrent.futures as cf
    import multiprocessing as mp

    from repro_torch.configs import ARCHS, shapes_for

    cells = [(a, s) for a in ARCHS for s in shapes_for(ARCHS[a])]
    slow = {("xlstm-125m", "prefill_32k"), ("xlstm-125m", "train_4k"),
            ("qwen1.5-110b", "train_4k")}
    cells = sorted(cells, key=lambda c: c not in slow)
    ex = cf.ProcessPoolExecutor(DRYRUN_WORKERS,
                                mp_context=mp.get_context("spawn"))
    return ex, [ex.submit(_dryrun_cell, c) for c in cells], \
        time.perf_counter()


def finish_catalogue(started) -> dict:
    """(a) Wait for every cell (the pool's processes end with it), then
    check that each completed, that each record's model FLOPs are 6 N D
    (train) or 2 N D, and the argument bytes a device on 16x16; print the
    seconds and a condensed table."""
    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.roofline import roofline_terms

    ex, futures, t = started
    with ex:
        done = [f.result() for f in futures]
    wall = time.perf_counter() - t
    rows = {}
    for (arch, shape), recs, secs in done:
        cfg, sh = ARCHS[arch], SHAPES[shape]
        n = cfg.active_params_count() or cfg.params_count()
        tokens = sh.global_batch * (sh.seq_len if sh.kind != "decode" else 1)
        want = (6 if sh.kind == "train" else 2) * n * tokens
        for rec in recs.values():
            terms = roofline_terms(rec)
            got = terms["model_flops_per_device"] * rec["n_chips"]
            check(abs(got - want) <= 1e-9 * want,
                  f"{arch} {shape} {rec['mesh']}: model FLOPs {got} != {want}")
            row = rows.setdefault(f"{arch} {shape}", {"s": secs})
            row[rec["mesh"]] = {
                "arg_GB": rec["memory"]["argument_bytes"] / 1e9,
                "peak_GB": rec["memory"]["peak_per_device_gb"],
                "flops_dev": rec["cost"]["flops_per_device"],
                "dominant": terms["dominant"],
                "roofline_fraction": terms["roofline_fraction"]}
        arg = recs[False]["memory"]["argument_bytes"]
        check(arg <= DRYRUN_ARG_LIMIT,
              f"{arch} {shape}: {arg / 1e9:.1f} GB of arguments a device on "
              f"16x16")
    print(f"  dry run: {len(rows)} cells x 2 meshes in {wall:.1f} s "
          f"({DRYRUN_WORKERS} processes)")
    print(f"  {'cell':34s} {'s':>6s} {'argGB':>6s} {'peakGB':>7s} "
          f"{'flops/dev':>10s} {'dom':>7s} {'roof':>6s} | 2x16x16 peakGB")
    for cell, row in rows.items():
        a, b = row["16x16"], row["2x16x16"]
        print(f"  {cell:34s} {row['s']:6.1f} {a['arg_GB']:6.2f} "
              f"{a['peak_GB']:7.2f} {a['flops_dev']:10.3g} "
              f"{a['dominant']:>7s} {a['roofline_fraction']:6.3f} | "
              f"{b['peak_GB']:7.2f}")
    return {"cells": len(rows), "wall_s": wall, "workers": DRYRUN_WORKERS,
            "slowest": max((r["s"], c) for c, r in rows.items()),
            "max_arg_GB_16x16": max(r["16x16"]["arg_GB"]
                                    for r in rows.values()),
            "max_peak_GB_16x16": max(r["16x16"]["peak_GB"]
                                     for r in rows.values())}


def _product_flops(by_op: dict) -> int:
    return sum(v for k, v in by_op.items() if k in PRODUCT_OPS)


def _census_and_call(dev, cfg, kind: str, B: int, S: int):
    """The census on meta of one ``kind`` call of ``cfg`` at B x S (a
    train step at microbatch 1, a prefill, or one decode step against an
    S-row cache), and the same call on ``dev`` as a function of no
    arguments with its inputs built (seeded)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.models import model as M
    from repro_torch.shardings import Sharding
    from repro_torch.train import AdamWConfig, init_train_state, \
        make_train_step

    census = dryrun.census_cell(cfg, ShapeConfig(kind, S, B, kind), 1, 1,
                                device="meta")
    shd = Sharding(None, cfg)
    gen = torch.Generator(device=dev).manual_seed(5)
    toks = _tokens(cfg.vocab, (B, S if kind != "decode" else 1), 6, dev)
    if kind == "train":
        state = init_train_state(cfg, gen, shards=1, device=dev)
        step = make_train_step(cfg, shd, AdamWConfig(), microbatch=1)
        batch = {"tokens": toks, "labels": toks}
        return census, lambda: step(state, batch)
    params = M.init_params(cfg, gen, shards=1, device=dev)
    if kind == "prefill":
        def call():
            with torch.no_grad():
                return M.prefill(params, {"tokens": toks}, cfg, shd)
        return census, call
    cache = M.init_cache(cfg, B, S, device=dev)
    pos = torch.full((B,), S // 2, dtype=torch.int32, device=dev)

    def call():
        with torch.no_grad():
            return M.decode_step(params, cache, {"tokens": toks, "pos": pos},
                                 cfg, shd)
    return census, call


def census_vs_profiler(dev) -> dict:
    """(b) For each call of CENSUS_CALLS (kind -> (B, S)) on TinyLlama-1.1B
    at full width and depth: the census's product FLOPs against torch.profiler's for one
    call on the card (a warm-up call first), the census's other totals,
    the call's median time over 3, and the roofline of the census's record
    on the one-card mesh beside that time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.roofline import PEAK_FLOPS, roofline_terms

    cfg = _tinyllama()
    mesh = make_mesh_for(1, device=dev)
    out = {}
    for kind, (B, S) in CENSUS_CALLS.items():
        census, call = _census_and_call(dev, cfg, kind, B, S)
        call()
        synchronize(dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     with_flops=True) as prof:
            call()
            synchronize(dev)
        prof_flops = sum(e.flops for e in prof.key_averages()
                         if e.key.removeprefix("aten::") in PRODUCT_OPS)
        times = []
        for _ in range(3):
            t = time.perf_counter()
            call()
            synchronize(dev)
            times.append(time.perf_counter() - t)
        measured = float(np.median(times))
        rec = dryrun.cell_record(census, mesh, cfg.name, kind)
        terms = roofline_terms(rec)
        got = _product_flops(census.totals["flops_by_op"])
        rel = abs(got - prof_flops) / max(prof_flops, 1)
        check(rel <= CENSUS_TOL,
              f"{kind}: census product FLOPs {got} against the profiler's "
              f"{prof_flops} ({rel:.2e} relative)")
        bound = max(terms["compute_s"], terms["memory_s"],
                    terms["collective_s"])
        out[kind] = {
            "batch": B, "seq": S, "census_product_flops": got,
            "profiler_product_flops": prof_flops, "rel_err": rel,
            "census_flops": census.totals["flops_per_device"],
            "flops_by_op": census.totals["flops_by_op"],
            "census_bytes": census.totals["hbm_bytes_per_device"],
            "census_ops": census.totals["ops"],
            "census_s": census.census_s,
            "measured_s": measured, "compute_s": terms["compute_s"],
            "memory_s": terms["memory_s"], "dominant": terms["dominant"],
            "roofline_fraction": terms["roofline_fraction"],
            "measured_fraction": terms["model_flops_per_device"]
            / PEAK_FLOPS / measured,
            "bound_over_measured": bound / measured}
        del call
        torch.cuda.empty_cache()
    return out


def mesh_path(dev) -> dict:
    """(c) olmoe-1b-7b at full width, phase 8 (b)'s two-layer cut, on
    ``Sharding(make_mesh_for(1), cfg)``: prefill through ``moe_shard_map``
    against the mesh-less gather path (bit for bit, under deterministic
    algorithms); ``shard_batch`` onto the mesh; the params saved and the
    smoke config's train state trained 2 steps by a ``TrainController``
    that checkpoints each, the launch counters zeroed before those saves
    and read after them (``launches``);
    ``CheckpointStore.restore(mesh=..., specs=...)`` of the params (param
    specs) and of the train state (state specs), and
    ``TrainController.remesh`` onto the mesh, every leaf bit for bit on
    the card; both saved heads against the plain versions
    (``saved_vs_plain``); specs and the expert-parallel MoE over an axis
    of size > 1 (the 16x16 mesh) raise ConfigError."""
    from repro_torch.ckpt import CheckpointStore
    from repro_torch.configs import ARCHS, smoke
    from repro_torch.errors import ConfigError
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh_for, make_production_mesh
    from repro_torch.models import model as M
    from repro_torch.runtime import TrainController, deterministic
    from repro_torch.shardings import Sharding
    from repro_torch.train import (AdamWConfig, SyntheticLM,
                                   init_train_state, make_train_step,
                                   shard_batch)

    cfg = depth_cut(ARCHS[MESH_ARCH])
    mesh = make_mesh_for(1, device=dev)
    shd = Sharding(mesh, cfg, MESH_B)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(8),
                           shards=shd.tp, device=dev)
    toks = _tokens(cfg.vocab, (MESH_B, MESH_S), 9, dev)
    out = {"mesh": repr(mesh), "tp": shd.tp, "dp_size": shd.dp_size}
    with torch.no_grad(), deterministic():
        t = time.perf_counter()
        c_mesh, l_mesh = M.prefill(params, {"tokens": toks}, cfg, shd)
        synchronize(dev)
        out["prefill_mesh_s"] = time.perf_counter() - t
        c_flat, l_flat = M.prefill(params, {"tokens": toks}, cfg,
                                   Sharding(None, cfg))
    out["max_abs_err"] = max(
        float((a.float() - b.float()).abs().max()) for a, b in
        zip([l_mesh, *_leaves(c_mesh)], [l_flat, *_leaves(c_flat)]))
    check(out["max_abs_err"] == 0,
          f"{cfg.name}: prefill through moe_shard_map differs from the "
          f"gather path by {out['max_abs_err']}")
    batch = shard_batch(SyntheticLM(cfg.vocab, MESH_S, MESH_B).batch_at(0),
                        mesh, shd)
    check(all(v.device.type == dev.type for v in batch.values()),
          "shard_batch did not place the batch on the mesh's card")

    scfg = smoke(ARCHS[MESH_ARCH])
    sshd = Sharding(mesh, scfg, 4)
    state = init_train_state(scfg, torch.Generator(device=dev).manual_seed(
        10), shards=sshd.tp, device=dev)
    step = make_train_step(scfg, sshd, AdamWConfig(), microbatch=1)
    ck = CheckpointStore()
    ops.reset_launches()
    t = time.perf_counter()
    ck.save(params, "params", step=0)
    out["save_s"] = time.perf_counter() - t
    ctl = TrainController(step, state, SyntheticLM(scfg.vocab, 32, 4),
                          CheckpointStore(), ckpt_every=1)
    ctl.run(2)
    out["launches"] = ops.launches()

    t = time.perf_counter()
    back = ck.restore(params, "params", mesh=mesh,
                      specs=shd.param_specs(params))
    synchronize(dev)
    out["restore_s"] = time.perf_counter() - t
    out["param_bytes"] = state_bytes(params)
    check(trees_equal(back, params),
          "restore onto the one-card mesh is not the saved params")
    specs = sshd.state_specs(ctl.state)
    got = ctl.ckpt.restore(ctl.state, ctl.branch, mesh=mesh, specs=specs)
    before = ctl.state
    moved = ctl.remesh(mesh, specs)
    check(trees_equal(got, before) and trees_equal(moved, before),
          "restore / remesh of the train state onto the mesh differ")
    out["state_leaves"] = len(_leaves(moved))
    t = time.perf_counter()
    out["params_vs_plain"] = saved_vs_plain(ck, "params", params, dev,
                                            fphash=False)
    out["state_vs_plain"] = saved_vs_plain(ctl.ckpt, ctl.branch, got, dev,
                                           fphash=False)
    out["vs_plain_s"] = time.perf_counter() - t

    wide = Sharding(make_production_mesh(), cfg, 256)
    raised = []
    for what, fn in (
            ("restore", lambda: ck.restore(
                params, "params", mesh=make_production_mesh(),
                specs=wide.param_specs(params))),
            ("moe_shard_map", lambda: wide.moe_shard_map(
                None, toks, params["layers"]["moe"])),
            ("shard_batch", lambda: shard_batch(
                {"tokens": np.zeros((256, 8), np.int32)},
                make_production_mesh(), wide))):
        try:
            fn()
        except ConfigError:
            raised.append(what)
    check(len(raised) == 3, f"only {raised} raised ConfigError for an axis "
                            f"of size > 1")
    out["raised"] = raised
    del params, back, c_mesh, c_flat
    torch.cuda.empty_cache()
    return out


def mesh_cost_path(dev) -> dict:
    """Phase 10: (b) the census against the profiler on TinyLlama-1.1B
    first, alone, since it times calls; then (a) the dry-run catalogue in
    worker processes while (c), the mesh path of olmoe-1b-7b, runs here."""
    parts = {}
    t = time.perf_counter()
    parts["census"] = census_vs_profiler(dev)
    parts["census_s"] = time.perf_counter() - t
    t = time.perf_counter()
    started = start_catalogue()
    try:
        parts["mesh"] = mesh_path(dev)
    except BaseException:
        started[0].shutdown(wait=True, cancel_futures=True)
        raise
    parts["mesh_s"] = time.perf_counter() - t
    parts["dryrun"] = finish_catalogue(started)
    parts["dryrun_s"] = time.perf_counter() - t
    parts["mesh_launches"] = parts["mesh"].pop("launches")
    return parts


# ------------------------------------------------------------ phase 11

# Execution on a mesh of ranks.  Two ranks share the card over gloo (NCCL
# takes a card a rank; a one-rank NCCL group shows that its path starts).
# (a) TinyLlama-1.1B whole on (data, model) = (1, 2): TP over heads, ff
# and vocab, the decode cache over 'model' on its sequence; prefill
# MC_B x MC_S and MC_DECODES teacher-forced decode steps against the
# one-rank port within WIDE_TOL of the largest logit, and one train step at
# TRAIN_B x TRAIN_S against the one-rank step within phase 9 (b)'s limits
# (MB_TOL on params, loss and gnorm relative, step-1 directions turned).
# (b) olmoe-1b-7b at full width, phase 8 (b)'s two layers, on (1, 2):
# expert parallelism, 32 experts a rank, prefill MC_MOE_B x MC_MOE_S
# against the one-rank gather path, both under deterministic algorithms,
# within WIDE_TOL.  (c) (a)'s params saved from the mesh (the
# TrainController's first checkpoint): the one-rank save's uid; remeshed
# onto (2, 1) and back onto (1, 2), each rank's shards bit for bit the
# blocks of the one-rank params that the specs name.
MC_RANKS = 2
MC_B, MC_S, MC_DECODES = SERVE_B, SERVE_S, 16
MC_MOE_B, MC_MOE_S = 2, 512
MC_TIMEOUT_S = 300.0      # a collective that waits longer fails its rank
MC_SEEDS = {"params": 20, "tokens": 21, "moe": 22, "moe_tokens": 23,
            "state": 24, "data": 25}


def mc_configs():
    """(a)'s and (b)'s configurations: TinyLlama-1.1B whole, olmoe-1b-7b
    cut to phase 8 (b)'s two layers."""
    from repro_torch.configs import ARCHS
    return ARCHS["tinyllama-1.1b"], depth_cut(ARCHS["olmoe-1b-7b"])


def _mc_nccl() -> dict:
    """(0) In a one-rank NCCL group: a 1 x 1 DeviceMesh and one all-reduce
    over its 'model' axis."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh_for
    mesh = make_mesh_for(1)
    x = torch.full((4,), 3.0, device=mesh.device)
    dist.all_reduce(x, group=mesh.group("model"))
    torch.cuda.synchronize()
    return {"backend": dist.get_backend(), "mesh": repr(mesh),
            "device_mesh": list(mesh.device_mesh.shape), "sum": x.tolist()}


def _mc_serve_inputs(cfg, dev):
    """(a)'s prompt and forced decode tokens, and (b)'s prompt."""
    toks = _tokens(cfg.vocab, (MC_B, MC_S + MC_DECODES),
                   MC_SEEDS["tokens"], dev)
    return toks[:, :MC_S], [toks[:, MC_S + i:MC_S + i + 1]
                            for i in range(MC_DECODES)]


def _mc_sequence(params, cfg, shd, prompt, forced, place) -> list:
    """Prefill ``prompt`` into a cache of MC_S + MC_DECODES rows, then a
    decode step a forced token; each step's logits, whole, on the host."""
    from repro_torch.models import model as M

    def host(x):
        return (x.full_tensor() if hasattr(x, "full_tensor") else x
                ).float().cpu()
    B = prompt.shape[0]
    cache, logits = M.prefill(params, place({"tokens": prompt}), cfg, shd,
                              cache_len=MC_S + MC_DECODES)
    out = [host(logits)]
    for i, tok in enumerate(forced):
        pos = torch.full((B,), MC_S + i, dtype=torch.int32,
                         device=tok.device)
        cache, logits = M.decode_step(params, cache, place(
            {"tokens": tok, "pos": pos}), cfg, shd)
        out.append(host(logits))
    return out


def _mc_block(full: torch.Tensor, local: torch.Tensor, placements,
              coords) -> bool:
    """Whether ``local`` is the block of ``full`` that ``placements`` give
    the rank at mesh ``coords``."""
    idx = [slice(0, n) for n in full.shape]
    for p, (c, n) in zip(placements, coords):
        if p.is_shard():       # cuts the slice the axes before it left
            lo, hi = idx[p.dim].start, idx[p.dim].stop
            w = (hi - lo) // n
            idx[p.dim] = slice(lo + c * w, lo + (c + 1) * w)
    return torch.equal(full[tuple(idx)], local)


def _mc_shards_equal(tree, whole, mesh) -> bool:
    coords = [(mesh.device_mesh.get_local_rank(i), n)
              for i, n in enumerate(mesh.shape.values())]
    want = dict(tree_leaves(whole))
    got = dict(tree_leaves(tree))
    return sorted(got) == sorted(want) and all(
        _mc_block(want[n], d.to_local(), d.placements, coords)
        for n, d in got.items())


def _mc_rank() -> dict:
    """One rank of phase 11's (a), (b) and (c); rank 0 returns the whole
    logits and the comparisons, every rank its times, peak memory and
    collective counts."""
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.ckpt import CheckpointStore
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.mesh import all_gather_routed
    from repro_torch.models import model as M
    from repro_torch.runtime import TrainController, deterministic
    from repro_torch.shardings import Sharding
    from repro_torch.train import (AdamWConfig, SyntheticLM,
                                   init_train_state, make_train_step,
                                   shard_batch)

    m12 = make_mesh_for(MC_RANKS)
    m21 = make_mesh_for(MC_RANKS, model_axis=1)
    dev = m12.device
    cuda = dev.type == "cuda"
    rank = dist.get_rank()
    cfg, ocfg = mc_configs()
    out = {"rank": rank, "meshes": [repr(m12), repr(m21)],
           "routed": all_gather_routed()}

    inner_peaks: list = []     # peaks that ``extra`` reset inside a part

    def part(name, fn):
        synchronize(dev)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        inner_peaks.clear()
        t = time.perf_counter()
        with CommDebugMode() as comm:
            res = fn()
        synchronize(dev)
        out[name] = {"s": time.perf_counter() - t,
                     "peak_bytes": max([torch.cuda.max_memory_allocated(),
                                        *inner_peaks]) if cuda else None,
                     "collectives": {str(k).split(".")[-1]: v for k, v in
                                     comm.get_comm_counts().items()}}
        return res

    def extra(fn):
        """``fn()`` and the most memory it held on this rank's card beyond
        what the rank held before it (None off CUDA)."""
        if not cuda:
            return fn(), None
        synchronize(dev)
        inner_peaks.append(torch.cuda.max_memory_allocated())
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = fn()
        synchronize(dev)
        return res, torch.cuda.max_memory_allocated() - held

    # (a) serving
    shd = Sharding(m12, cfg, MC_B)
    prompt, forced = _mc_serve_inputs(cfg, dev)

    def place(b):
        return shard_batch({k: v.cpu().numpy() for k, v in b.items()},
                           m12, shd)

    def serve():
        params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(
            MC_SEEDS["params"]), shards=4, device=dev, shd=shd)
        with torch.no_grad():
            return params, _mc_sequence(params, cfg, shd, prompt, forced,
                                        place)
    params, logits = part("serve", serve)
    if rank == 0:
        out["serve_logits"] = logits

    # (c) save from the mesh, remesh onto (2, 1) and back onto (1, 2)
    def save_remesh():
        ck = CheckpointStore()
        ops.reset_launches()
        t = time.perf_counter()
        ctl, save_extra = extra(lambda: TrainController(
            make_train_step(cfg, shd), params, None, ck, branch="run"))
        res = {"save_s": time.perf_counter() - t,
               "launches": ops.launches(), "save_extra_bytes": save_extra,
               "shard_bytes": sum(d.to_local().nbytes
                                  for d in _leaves(params))}
        if rank == 0:
            res["uid"] = ck.db.get(ck.key, "run").uid.hex()
        whole = M.init_params(cfg, torch.Generator(device=dev).manual_seed(
            MC_SEEDS["params"]), shards=4, device=dev)
        res["leaf_bytes"] = max(a.nbytes for a in _leaves(whole))
        for name, mesh in (("r21", m21), ("r12", m12)):
            t = time.perf_counter()
            got, res[f"{name}_extra_bytes"] = extra(lambda: ctl.remesh(
                mesh, Sharding(mesh, cfg, MC_B).param_specs(whole)))
            res[f"{name}_s"] = time.perf_counter() - t
            res[f"{name}_equal"] = _mc_shards_equal(got, whole, mesh)
            res[f"{name}_placements"] = sorted({str(tuple(
                map(str, d.placements))) for d in _leaves(got)})
            del got
        if rank == 0:
            t = time.perf_counter()
            res["vs_plain"] = saved_vs_plain(ck, "run", whole, dev,
                                             fphash=False)
            res["vs_plain_s"] = time.perf_counter() - t
        return res
    out["ckpt"] = part("save_remesh", save_remesh)
    del params
    if cuda:
        torch.cuda.empty_cache()

    # (b) expert parallelism
    oshd = Sharding(m12, ocfg, MC_MOE_B)

    def moe():
        p = M.init_params(ocfg, torch.Generator(device=dev).manual_seed(
            MC_SEEDS["moe"]), shards=4, device=dev, shd=oshd)
        toks = _tokens(ocfg.vocab, (MC_MOE_B, MC_MOE_S),
                       MC_SEEDS["moe_tokens"], dev)
        with torch.no_grad(), deterministic():
            _, lg = M.prefill(p, shard_batch({"tokens": toks.cpu().numpy()},
                                             m12, oshd), ocfg, oshd)
        return lg.full_tensor().float().cpu()
    lg = part("moe", moe)
    if rank == 0:
        out["moe_logits"] = lg

    # (a) one train step, then (rank 0) the one-rank step from the same init
    tshd = Sharding(m12, cfg, TRAIN_B)
    data = SyntheticLM(cfg.vocab, TRAIN_S, TRAIN_B,
                       seed=MC_SEEDS["data"]).batch_at(0)

    def train():
        state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(
            MC_SEEDS["state"]), shards=4, device=dev, shd=tshd)
        step = make_train_step(cfg, tshd, AdamWConfig())
        with deterministic():
            new, m = step(state, shard_batch(data, m12, tshd))
        m = {k: float(v.full_tensor()) if hasattr(v, "full_tensor")
             else float(v) for k, v in m.items()}
        keep = {"params": M.tree_map(lambda a: a.full_tensor(),
                                     new["params"]),
                "opt": {"master": M.tree_map(lambda a: a.full_tensor(),
                                             new["opt"]["master"])}}
        return (keep if rank == 0 else None), m
    keep, m = part("train", train)
    if cuda:
        torch.cuda.empty_cache()
    out["train_metrics"] = m
    if rank == 0:
        t = time.perf_counter()
        state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(
            MC_SEEDS["state"]), shards=4, device=dev)
        step = make_train_step(cfg, Sharding(None, cfg), AdamWConfig())
        with deterministic():
            one = step(state, shard_batch(data))
        out["train_gap"] = microbatch_gap(state, {1: one, 4: (keep, m)})
        out["train_one_rank_s"] = time.perf_counter() - t
        out["train_one_metrics"] = {k: float(v) for k, v in one[1].items()}
    dist.barrier()
    return out


def multicard_path(dev) -> dict:
    """Phase 11: (0) a one-rank NCCL group, then the one-rank references
    here, then (a), (b) and (c) in MC_RANKS ranks that share the card over
    gloo; every comparison is checked."""
    from repro_torch.ckpt import CheckpointStore
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import model as M
    from repro_torch.runtime import deterministic
    from repro_torch.shardings import Sharding

    out = {}
    if dev.type == "cuda":
        t = time.perf_counter()
        out["nccl"] = run_ranks(_mc_nccl, 1, backend="nccl", device="cuda",
                                timeout_s=MC_TIMEOUT_S)[0]
        out["nccl_s"] = time.perf_counter() - t
        check(out["nccl"]["sum"] == [3.0] * 4
              and out["nccl"]["device_mesh"] == [1, 1],
              f"the one-rank NCCL group: {out['nccl']}")

    # the one-rank references
    t = time.perf_counter()
    cfg, ocfg = mc_configs()
    one = Sharding(None, cfg)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(
        MC_SEEDS["params"]), shards=4, device=dev)
    prompt, forced = _mc_serve_inputs(cfg, dev)
    with torch.no_grad():
        want = _mc_sequence(params, cfg, one, prompt, forced, lambda b: b)
    want_uid = CheckpointStore().save(params, "run", step=0).hex()
    del params
    p = M.init_params(ocfg, torch.Generator(device=dev).manual_seed(
        MC_SEEDS["moe"]), shards=4, device=dev)
    toks = _tokens(ocfg.vocab, (MC_MOE_B, MC_MOE_S), MC_SEEDS["moe_tokens"],
                   dev)
    with torch.no_grad(), deterministic():
        _, want_moe = M.prefill(p, {"tokens": toks}, ocfg,
                                Sharding(None, ocfg))
    want_moe = want_moe.float().cpu()
    del p
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["one_rank_s"] = time.perf_counter() - t

    t = time.perf_counter()
    ranks = run_ranks(_mc_rank, MC_RANKS, backend="gloo", device=dev.type,
                      timeout_s=MC_TIMEOUT_S)
    out["ranks_s"] = time.perf_counter() - t
    routed = [r["routed"] for r in ranks]
    check(routed == [dev.type == "cuda"] * MC_RANKS,
          f"torch's functional all-gather routed through c10d on the ranks: "
          f"{routed} (every CUDA mesh of ranks installs the route)")
    r0 = ranks[0]
    serve = [rel_err(g, w, cfg.vocab) for g, w in
             zip(r0.pop("serve_logits"), want)]
    out["serve_rel_err"] = max(serve)
    check(len(serve) == MC_DECODES + 1 and max(serve) <= WIDE_TOL,
          f"tinyllama on (1, 2): logits differ from one rank's by "
          f"{serve} of the largest")
    out["moe_rel_err"] = rel_err(r0.pop("moe_logits"), want_moe, ocfg.vocab)
    check(out["moe_rel_err"] <= WIDE_TOL,
          f"olmoe on (1, 2): prefill differs from the one-rank gather path "
          f"by {out['moe_rel_err']} of the largest logit")
    gap = r0["train_gap"]
    check(gap["max_abs_diff"] <= MB_TOL and gap["gnorm_rel"] <= MB_GNORM_REL
          and gap["loss_rel"] <= MB_LOSS_REL and gap["dir_off"] <= MB_DIR_OFF,
          f"tinyllama's train step on (1, 2) against one rank's: {gap}")
    ck = r0["ckpt"]
    check(ck["uid"] == want_uid,
          f"the save from the mesh has uid {ck['uid']}, one rank's "
          f"{want_uid}")
    check(all(r["ckpt"][f"{m}_equal"] for r in ranks for m in ("r21", "r12")),
          "a remeshed shard is not its block of the saved params")
    if dev.type == "cuda":
        # leaf by leaf: a rank other than 0 sends its blocks and holds no
        # leaf whole; a sharded restore holds the rank's shards and, on
        # rank 0, the leaf being read and its parts
        for r in ranks:
            c = r["ckpt"]
            check((r["rank"] == 0 or c["save_extra_bytes"] <= c["leaf_bytes"])
                  and c["r12_extra_bytes"] <= c["shard_bytes"]
                  + 2 * c["leaf_bytes"],
                  f"rank {r['rank']} held more than its shards and a leaf "
                  f"or two while saving or restoring: {c}")
    check(ck["launches"]["boundary_bitmap"] > 0,
          f"the bitmap never launched on the save from the mesh: "
          f"{ck['launches']}")
    out["ranks"] = ranks
    out["launches"] = ck["launches"]
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
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.chunker import boundary_bitmap
    from repro_torch.kernels.fphash import fphash, fphash_host, fphash_many

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
    leaf = min(raws, key=lambda r: abs(len(r) - 4097))   # a 4 KB leaf
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

    # kernel #3: the engine's single-value route (fphash_host, from pinned
    # host memory) against its plain version, and the old route (fphash on
    # a tensor already on the card; to_device and _digest_bytes around it
    # for a host value) timed beside it
    m = torch.frombuffer(bytearray(meta), dtype=torch.uint8).to(dev)
    k, p = cid_tensor(fphash_host(meta, dev)), ref.fphash_ref(m).cpu()
    check(torch.equal(k, p), "fphash differs from plain on a meta chunk")
    check(torch.equal(fphash(m).cpu(), p),
          "the old fphash route differs from plain on a meta chunk")
    b, by = bound_ms(m.numel() + 32, fp_ops(np.array([m.numel()])))

    def old_route(raw):
        return ops._digest_bytes(fphash(ops.to_device(raw))[None])[0]

    values = {"meta": meta, "leaf": leaf}
    check(all(ops.content_hash(v) == old_route(v) for v in values.values()),
          "the single-value routes differ on the timed values")
    out.append({"name": "fphash", "shape": f"meta chunk, {m.numel()} B",
                "ms": cuda_ms(lambda: fphash_host(meta, dev), 100),
                "kernel_ms": kernel_ms(lambda: fphash_host(meta, dev),
                                       "fphash", 100),
                "old_ms": cuda_ms(lambda: fphash(m), 100),
                "old_kernel_ms": kernel_ms(lambda: fphash(m), "fphash_one",
                                           100),
                "host_ms": {k: host_ms(lambda: ops.content_hash(v), 2000)
                            for k, v in values.items()},
                "old_host_ms": {k: host_ms(lambda: old_route(v), 2000)
                                for k, v in values.items()},
                "host_bytes": {k: len(v) for k, v in values.items()},
                "launch_floor_ms": launch_floor_ms(dev),
                "plain_ms": cuda_ms(lambda: ref.fphash_ref(m), 10),
                "bound_ms": b, "bound_by": by, "max_abs_err": max_err(k, p)})
    return out


# the kernel function of each wrapper, as ptxas names it in its -v report:
# kernel #3's row is the engine's route (fphash_host, counted as "fphash");
# fphash_one is the old route on a tensor already on the card
ENTRY_FUNCTIONS = {"chunker_kernel": "boundary_bitmap",
                   "fphash_many_kernel": "fphash_many",
                   "fphash_host_kernel": "fphash",
                   "fphash_one_kernel": "fphash_one"}


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


# kernel #3's row also gives the old route and the single-call floor
ROUTE_KEYS = ("old_ms", "old_kernel_ms", "host_ms", "old_host_ms",
              "host_bytes", "launch_floor_ms")

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
    ap.add_argument("--ckpt-layers", type=int, default=TINYLLAMA_LAYERS,
                    help="layers of the TinyLlama-1.1B checkpoint of "
                         "phase 5 (its depth; the width stays full)")
    ap.add_argument("--ckpt-breakdown", action="store_true",
                    help="phase 5 also times a mark alone before the GC "
                         "and profiles a save of step 0 (about 20 s)")
    ap.add_argument("--ledger-accounts", type=int, default=LEDGER_ACCOUNTS,
                    help="accounts of phase 6's live ledger; 1000000 runs "
                         "live_bench.py's size (about 150-240 s)")
    ap.add_argument("--skew-edits", type=int, default=SKEW_EDITS,
                    help="8 KB edits per placement mode of phase 7's Fig. 15 "
                         "skew (wiki_bench.py puts 400)")
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
    check(set(ptx) == set(ENTRY_FUNCTIONS.values()),
          f"no ptxas report for some kernels: {ptx}")
    check(not any(v["spill_bytes"] for v in ptx.values()),
          f"a kernel spills to local memory: {ptx}")

    t = time.perf_counter()
    err = kernels_vs_plain(dev)
    counted = threaded_launches(dev)
    print(f"launch counter: 8 threads x 500 distinct values through "
          f"ops.content_hash, every digest right, {counted} fphash launches")
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
        "queued_checks": dp["queued_checks"], "put_checks": dp["checks"],
        "put_launches": dp["put_launches"],
        "get_launches": dp["get_launches"]}))

    t = time.perf_counter()
    cp = checkpoint_path(dev, args.ckpt_layers, breakdown=args.ckpt_breakdown)
    print(f"phase 5 (checkpoint path): {time.perf_counter() - t:.1f} s")
    both = {k: cp["launches"][k] + cp["controller_launches"][k]
            for k in cp["launches"]}
    check(all(v > 0 for v in both.values()),
          f"a kernel never launched on the checkpoint path: {both}")
    mb = cp["bytes"] / 1e6
    print("checkpoint path: " + json.dumps({
        "layers": cp["layers"], "leaves": cp["leaves"], "bytes": cp["bytes"],
        "save0_s": cp["save0_s"], "save0_MB_s": mb / cp["save0_s"],
        "save1_s": cp["save1_s"], "save1_MB_s": mb / cp["save1_s"],
        "edited_bytes": cp["edited_bytes"],
        "save1_new_bytes": cp["save1_new_bytes"], "d2h_s": cp["d2h_s"],
        "sync_s": cp["sync_s"], "reopen_s": cp["reopen_s"],
        "restore_s": cp["restore_s"], "restore_MB_s": mb / cp["restore_s"],
        "partial_bytes": cp["partial_bytes"],
        "partial_restore_s": cp["partial_restore_s"],
        "gc": cp["gc"], "gc_s": cp["gc_s"],
        "sync_after_gc_s": cp["sync_after_gc_s"],
        "disk_bytes_before": cp["disk_bytes_before"],
        "disk_bytes_after": cp["disk_bytes_after"],
        "disk_ratio": cp["disk_bytes_after"] / cp["disk_bytes_before"],
        "controller": cp["controller"], "launches": cp["launches"],
        "controller_launches": cp["controller_launches"],
        **{k: cp[k] for k in ("mark_s", "save_profile") if k in cp}}))

    t = time.perf_counter()
    lp = ledger_path(dev, args.ledger_accounts)
    print(f"phase 6 (ledger path): {time.perf_counter() - t:.1f} s")
    ledger = {k: sum(part[k] for part in lp["launches"].values())
              for k in SOURCES}
    check(all(v > 0 for v in ledger.values()),
          f"a kernel never launched on the ledger path: {lp['launches']}")
    live, churn, arch = lp["live"], lp["churn"], lp["archival"]
    print("ledger path: " + json.dumps({
        "accounts": live["accounts"], "blocks": live["blocks"],
        "seed_s": live["seed_s"], "seed_fold_s": live["seed_fold_s"],
        "seed_folds": live["seed_folds"],
        "block_ms_median": live["block_ms_median"],
        "block_ms_max": live["block_ms_max"],
        "roots_bit_identical": live["roots_bit_identical"],
        "plain_build_s": live["plain_build_s"], "proofs": live["proofs"],
        "proofs_per_s": live["proofs"] / live["prove_s"],
        "state_load_ms": live["state_load_ms"],
        "proof_bytes_mean": live["proof_bytes_mean"],
        "verify_us": live["verify_s"] / live["proofs"] * 1e6,
        "attest": churn,
        "archival": arch,
        "launches": lp["launches"]}))

    t = time.perf_counter()
    cp7 = cluster_path(dev, ds, mp["uids"], dds, want[0],
                       skew_edits=args.skew_edits)
    print(f"phase 7 (cluster path): {time.perf_counter() - t:.1f} s")
    cluster = {k: sum(part[k] for part in cp7["launches"].values())
               for k in SOURCES}
    check(all(v > 0 for v in cluster.values()),
          f"a kernel never launched on the cluster path: {cp7['launches']}")
    full, skew = cp7["full_width"], cp7["skew"]
    rt, dur = cp7["runtime"], cp7["durable"]
    mb, dmb = full["bytes"] / 1e6, dur["bytes"] / 1e6
    print("cluster path: " + json.dumps({
        "full_width": {
            "records": ds["records"], "bytes": full["bytes"],
            "put_MB_s": mb / full["put_s"], "put_v2_s": full["put_v2_s"],
            "get_MB_s": (3 * full["bytes"] + len(ds["tail"])) / 1e6
            / full["get_s"],
            "v2_new_bytes": full["v2_new_bytes"],
            "v2_new_fraction": full["v2_new_bytes"] / full["bytes"],
            "distribution": full["distribution"], "balance": full["balance"],
            "index_chunks": full["index_chunks"],
            "requests": full["requests"],
            "put_1lp_MB_s": mb / full["put_1lp_s"],
            "distribution_1lp": full["distribution_1lp"],
            "home_1lp": full["home_1lp"],
            "rerep_queued": full["rerep_queued"],
            "rerep_moved": full["rerep_moved"], "rerep_s": full["rerep_s"],
            "distribution_rerep": full["distribution_rerep"],
            "part_s": full["part_s"]},
        "skew": skew,
        "runtime": rt,
        "durable": {
            "records": dur["records"], "bytes": dur["bytes"],
            "put_MB_s": dmb / dur["put_s"], "sync_s": dur["sync_s"],
            "reopen_s": dur["reopen_s"], "get_MB_s": dmb / dur["get_s"],
            "audit_ms": dur["audit_ms"], "full_audit_s": dur["full_audit_s"],
            "audit_chunks": dur["audit_chunks"],
            "index_chunks": dur["index_chunks"],
            "distribution": dur["distribution"], "part_s": dur["part_s"]},
        "max_abs_err": cp7["max_abs_err"],
        "launches": cp7["launches"]}))

    t = time.perf_counter()
    m8 = model_path(dev)
    print(f"phase 8 (model path): {time.perf_counter() - t:.1f} s")
    print("model path: " + json.dumps(m8))

    t = time.perf_counter()
    m9 = training_path(dev)
    print(f"phase 9 (training path): {time.perf_counter() - t:.1f} s")
    train = m9["train_launches"]
    check(train["boundary_bitmap"] > 0,
          f"the bitmap never launched on the training path: {train}")
    print("training path: " + json.dumps(m9))

    t = time.perf_counter()
    m10 = mesh_cost_path(dev)
    print(f"phase 10 (mesh and cost tooling): {time.perf_counter() - t:.1f} s")
    mesh = m10["mesh_launches"]
    check(mesh["boundary_bitmap"] > 0,
          f"the bitmap never launched on the mesh path: {mesh}")
    print("mesh and cost path: " + json.dumps(m10))

    t = time.perf_counter()
    m11 = multicard_path(dev)
    print(f"phase 11 (mesh of ranks): {time.perf_counter() - t:.1f} s")
    multicard = m11["launches"]
    print("mesh of ranks: " + json.dumps(m11))
    # each kernel's largest |kernel - plain| over phase 2, the timed
    # shapes, phase 7 and the saved states of phases 5, 9, 10 and 11
    saved = [cp["controller"]["vs_plain"]["max_abs_err"]] + [
        m9["entry_points"][k]["vs_plain"]["max_abs_err"]
        for k in ("launcher", "example")] + [
        m10["mesh"][k]["max_abs_err"]
        for k in ("params_vs_plain", "state_vs_plain")] + [
        m11["ranks"][0]["ckpt"]["vs_plain"]["max_abs_err"]]
    kernels = []
    for row in timed:
        src, replaces = SOURCES[row["name"]]
        kernels.append({
            "name": row["name"], "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[row["name"]],
            "max_abs_err": max(err[row["name"]], row["max_abs_err"],
                               cp7["max_abs_err"][row["name"]],
                               *(e.get(row["name"], 0) for e in saved)),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "shape": row["shape"],
            "ckpt_launches": both[row["name"]],
            "ledger_launches": ledger[row["name"]],
            "cluster_launches": cluster[row["name"]],
            "train_launches": train[row["name"]],
            "mesh_launches": mesh[row["name"]],
            "multicard_launches": multicard[row["name"]],
            "kernel_ms": row["kernel_ms"],
            "registers": ptx[row["name"]]["registers"],
            **{k: row[k] for k in ROUTE_KEYS if k in row}})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
