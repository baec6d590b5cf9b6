"""The analytics family: a dataset of records kept as one Blob in a durable,
verifying ForkBase, versioned by commits (paper §6.3, Fig. 16-17).

Its operations (``ops/``, named by a mix's ``op``) use two steps:

  * ``commit``: rewrite ``count`` records (``pattern`` ``scattered`` or
    ``contiguous``), put the version and ``sync()``, optionally on a new
    fork of master;
  * ``read``: read one version back whole through the verifying store.

Set-up puts v1 (``records`` records), then ``setup_versions`` commits that
each rewrite a ``setup_edit_share`` of the records.  After the window the
family reads what the program produced and checks, through the store the
window used, that a chunk put under a wrong cid and a chunk altered in the
memory tier are both refused; the judge holds the versions, the reads and
what a reopened engine finds against the plain reference
(``reference/plain.py``).
"""
from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np

from bench.harness import gen
from bench.harness.core import reservoir_slot
from bench.reference import plain

KEY = "dataset"


class Family:
    def __init__(self, config: dict, traffic: dict, seed: int):
        self.cfg, self.mix, self.seed = config, traffic, seed
        self.rng = np.random.default_rng([seed, 1])
        self.records = int(config["records"])
        self.chunking = plain.Chunking(**config["chunking"])
        self.versions: list[dict] = []   # uid, branch, base (index), edits
        # a reservoir of ``check_reads`` reads drawn from the seed, and the
        # last read: what the judge compares
        self.reads: dict[int, tuple[int, bytes]] = {}
        self.n_reads = 0
        self.pick = np.random.default_rng([seed, 3])
        self.commits = 0
        self.root = None

    # -------------------------------------------------------------- set-up
    def setup(self, spans) -> None:
        from repro_torch.core import FBlob, ForkBase, hashing
        from repro_torch.core.chunker import ChunkParams

        dep = self.cfg["deployment"]
        self.data, self.starts = gen.make_records(self.records, self.seed)
        self.root = tempfile.mkdtemp(prefix="bench-analytics-",
                                     dir=os.environ.get("TMPDIR"))
        if dep["cid_hash"] != "fphash":
            raise ValueError(f"unknown cid hash {dep['cid_hash']!r}")
        hashing.use_fphash()
        self.db = ForkBase(None, ChunkParams(**self.cfg["chunking"]),
                           verify_get=bool(dep["verify_get"]),
                           durable_root=self.root,
                           hot_bytes=int(dep["hot_bytes"]),
                           segment_bytes=int(dep["segment_bytes"]))
        with spans.span("setup.v1"):
            uid = self.db.put(KEY, FBlob(self.data.tobytes()))
            self.db.sync()
        self.versions.append({"uid": uid, "branch": "master", "base": None,
                              "edits": []})
        self.head = {"master": 0}
        n = int(self.mix.get("setup_versions", 0))
        for _ in range(n):
            with spans.span("setup.commit"):
                self.commit(max(1, round(self.records
                                         * self.mix["setup_edit_share"])),
                            self.mix["setup_edit_pattern"], False, spans)
        self.choices = list(range(len(self.versions)))

    # ---------------------------------------------------------------- steps
    def commit(self, count: int, pattern: str, fork: bool, spans) -> None:
        """Rewrite ``count`` records, put the version (on a new fork of
        master when ``fork``) and ``sync()``."""
        idx = gen.pick_records(self.records, count, pattern, self.rng)
        edits = gen.rewrite_records(self.data, self.starts, idx, self.rng)
        base = self.head["master"]
        branch = "master"
        if fork:
            branch = f"fork{len(self.versions)}"
            with spans.span("fork"):
                self.db.fork(KEY, "master", branch)
        with spans.span("put"):
            b = self.db.get(KEY, branch).blob()
            for lo, n, new in edits:
                b.replace(lo, n, new)
            uid = self.db.put(KEY, b, branch)
        with spans.span("sync"):
            self.db.sync()
        self.versions.append({"uid": uid, "branch": branch, "base": base,
                              "edits": edits})
        self.head[branch] = len(self.versions) - 1
        self.commits += 1

    def read(self, v: int, spans) -> int:
        """Read version ``v`` back whole; keeps it for the judge when the
        seeded reservoir of ``check_reads`` draws it, and the last read.
        Returns its bytes."""
        with spans.span("read"):
            got = self.db.get(KEY, uid=self.versions[v]["uid"]).blob().read()
        slot = reservoir_slot(self.n_reads, int(self.mix.get("check_reads",
                                                             0)), self.pick)
        if slot is not None:
            self.reads[slot] = (v, got)
        self.reads[-1] = (v, got)
        self.n_reads += 1
        return len(got)

    # -------------------------------------------------------------- counters
    def counters(self) -> dict:
        from repro_torch.kernels import ops
        return {"launches": ops.launches(),
                "store": self.db.store.stats.as_dict()}

    # ---------------------------------------------------- after the window
    def finish(self) -> None:
        """What only the program can still show, read before it is freed:
        every version's meta chunk; whether the store the window used
        refuses a chunk put under a wrong cid, and a leaf of master's head
        altered in its memory tier when the head is read; the
        heads and master's bytes a reopened engine finds."""
        from repro_torch.core import ForkBase, hashing
        from repro_torch.core.chunker import ChunkParams
        from repro_torch.errors import ReproError

        self.metas = [self.db.store.get(v["uid"])
                      if self.db.store.has(v["uid"]) else None
                      for v in self.versions]
        self.tamper_undetected = self._put_probe() + self._read_probe()
        self.db.store.close()
        self.reopened = {"heads": {}, "bytes": None}
        try:                                 # a reopen that fails loses all
            db = ForkBase(durable_root=self.root, verify_get=True,
                          params=ChunkParams(**self.cfg["chunking"]))
        except ReproError:
            db = None
        if db is not None:
            got = db.get(KEY, "master")
            self.reopened = {
                "heads": {b: db.branches.head(KEY.encode(), b)
                          for b in self.head},
                "bytes": got.blob().read() if got else None}
            db.store.close()
        hashing.use_sha256()
        self.db = None
        shutil.rmtree(self.root, ignore_errors=True)

    def _put_probe(self) -> int:
        """Puts a batch of fresh chunks, with their right cids but one,
        drawn from the seed, and flushes the store; 1 unless the put or
        the flush refuses the batch."""
        from repro_torch.errors import ReproError

        rng = np.random.default_rng([self.seed, 4])
        raws = [rng.bytes(int(n)) for n in rng.integers(64, 8192, 16)]
        cids = plain.cids(raws, "cpu")
        bad = int(rng.integers(len(raws)))
        cids[bad] = plain.cid(raws[bad][::-1], "cpu")
        try:
            self.db.store.put_many(raws, cids)
            self.db.store.flush()
        except ReproError:
            return 0
        self.db.store.delete_many(cids)
        return 1

    def _read_probe(self) -> int:
        """Alters one leaf of master's head in the memory tier and reads
        the head back; 1 unless the read is refused or, unaltered, right."""
        from repro_torch.core import POSTree
        from repro_torch.errors import ReproError

        want = self._bytes_of(self.head["master"]).tobytes()
        try:
            obj = self.db.get(KEY, "master", verify=False).obj
            tree = POSTree.from_root(self.db.store, obj.type, obj.data,
                                     self.db.params)
            cid = tree.levels[0][len(tree.levels[0]) // 2].cid
            self.db.store.get(cid)               # in the memory tier
        except ReproError:
            return 1
        hot = self.db.store._hot
        raw = hot[cid]
        hot[cid] = raw[:-1] + bytes([raw[-1] ^ 1])
        try:
            undetected = int(self.db.get(KEY, "master").blob().read()
                             != want)
        except ReproError:
            undetected = 0
        hot[cid] = raw
        return undetected

    # ------------------------------------------------------------- judging
    def _bytes_of(self, v: int) -> np.ndarray:
        chain = []
        while v is not None:
            chain.append(v)
            v = self.versions[v]["base"]
        out = self.data.copy()
        for i in reversed(chain):
            for lo, n, new in self.versions[i]["edits"]:
                out[lo:lo + n] = np.frombuffer(new, dtype=np.uint8)
        return out

    def judge(self, device) -> dict[str, tuple[int, int]]:
        """Every version's record against the reference's, the root of
        ``check_versions`` versions drawn from the seed (and the last)
        rebuilt from the reference's bytes, the sampled reads, and what
        the durable store gives back after a reopen; each a count of
        mismatches, whose limit is 0."""
        rng = np.random.default_rng([self.seed, 2])
        n = len(self.versions)
        roots = set(rng.choice(n, size=min(int(self.mix["check_versions"]),
                                           n), replace=False).tolist())
        roots.add(n - 1)
        depth: list[int] = []
        version_bad = root_bad = 0
        for i, v in enumerate(self.versions):
            depth.append(0 if v["base"] is None else depth[v["base"]] + 1)
            raw = self.metas[i]
            try:
                meta = plain.Meta.decode(raw)
            except (TypeError, ValueError, IndexError):
                version_bad += 1
                continue
            base = (() if v["base"] is None
                    else (self.versions[v["base"]]["uid"],))
            want = plain.Meta(plain.BLOB, KEY.encode(), meta.data,
                              depth[i], base, b"")
            if meta != want or plain.cid(raw, device) != v["uid"]:
                version_bad += 1
            if i in roots and meta.data != plain.blob_root(
                    self._bytes_of(i), self.chunking, device):
                root_bad += 1
        read_bad = sum(got != self._bytes_of(v).tobytes()
                       for v, got in self.reads.values())
        lost = sum(self.reopened["heads"].get(b) != self.versions[i]["uid"]
                   for b, i in self.head.items())
        lost += self.reopened["bytes"] != self._bytes_of(
            self.head["master"]).tobytes()
        out = {"version_mismatch": version_bad, "root_mismatch": root_bad,
               "read_mismatch": read_bad,
               "tamper_undetected": self.tamper_undetected,
               "durable_mismatch": lost}
        return {k: (int(v), 0) for k, v in out.items()}
