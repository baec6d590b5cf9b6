"""The ledger family: Hyperledger's state on ForkBase in live mode (paper
§5.1, Fig. 9-10) under Blockbench's KVStore: ``accounts`` accounts of
``value_bytes``-byte values in contract ``kv``, each block a batch of reads
and writes, committed by ``ForkBaseLedger.commit``.

Its operations (``ops/``, named by a mix's ``op``) use two steps:

  * ``block``: reads and writes in a given order, then ``commit()``;
  * ``query``: a light client's state query, ``prove_state_flat`` of an
    account at the head, then ``verify_state_flat`` by a ``LightClient``
    whose anchor ``refresh`` renewed from a signed attestation.

Set-up writes every account and commits (block 0).  The judge replays the
same inputs through the plain reference.

A config whose ``deployment`` is ``durable`` keeps the engine's chunks and
heads under a fresh directory of ``TMPDIR`` (``hot_bytes`` of memory tier
over ``segment_bytes`` segments) and acknowledges each block after
``sync()``; after the window the engine is reopened there, verifying
every chunk it reads, and the judge holds the chain's head, its state uid,
that state's root and the accounts it reads back to the last block's.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np

from bench.harness import gen
from bench.harness.core import reservoir_slot
from bench.reference import plain

CONTRACT = "kv"
SECRET = b"bench-ledger-attestation"
# accounts beside the last block's writes that a durable deployment's
# reopened engine reads back
READ_BACK = 256


class Family:
    def __init__(self, config: dict, traffic: dict, seed: int):
        self.cfg, self.mix, self.seed = config, traffic, seed
        self.rng = np.random.default_rng([seed, 1])
        self.n = int(config["accounts"])
        self.vb = int(config["value_bytes"])
        self.chunking = plain.Chunking(**config["chunking"])
        # every block: its uid and its operations in order, (account,
        # value written or None, value a read got); every query, with its
        # proof where it is in the seeded sample of ``check_queries``
        self.blocks: list[dict] = []
        self.queries: list[dict] = []
        self.sampled: list[int] = []
        self.pick = np.random.default_rng([seed, 3])
        self.durable = bool(config["deployment"].get("durable"))
        self.root = None

    # -------------------------------------------------------------- set-up
    def setup(self, spans) -> None:
        from repro_torch.apps.blockchain import ForkBaseLedger, LightClient
        from repro_torch.core import ForkBase, hashing
        from repro_torch.core.chunker import ChunkParams

        dep = self.cfg["deployment"]
        if dep["cid_hash"] != "fphash" or not dep["live"]:
            raise ValueError("the ledger family runs live, with fphash cids")
        hashing.use_fphash()
        params = ChunkParams(**self.cfg["chunking"])
        if self.durable:
            self.root = tempfile.mkdtemp(prefix="bench-ledger-",
                                         dir=os.environ.get("TMPDIR"))
            db = ForkBase(None, params, durable_root=self.root,
                          hot_bytes=int(dep["hot_bytes"]),
                          segment_bytes=int(dep["segment_bytes"]))
        else:
            db = ForkBase(None, params)
        self.led = ForkBaseLedger(db, live=True)
        vals = self.rng.bytes(self.vb * self.n)
        with spans.span("setup.accounts"):
            for i in range(self.n):
                self.led.write(CONTRACT, gen.account_key(i),
                               vals[self.vb * i:self.vb * (i + 1)])
            # block 0: every account, in order
            uid = self.led.commit()
            if self.durable:
                self.led.db.sync()
            self.blocks.append({"uid": uid, "ops": vals})
        self.client = LightClient(self.blocks[-1]["uid"])
        self.refresh()

    def refresh(self) -> None:
        att = self.led.attest(secret=SECRET)
        self.client.refresh_head(att, self.led.prove_chain_head(),
                                 secret=SECRET)

    # ---------------------------------------------------------------- steps
    def draw(self, size: int) -> np.ndarray:
        """``size`` accounts drawn by the mix's ``key_dist``."""
        return gen.draw_keys(self.mix["key_dist"], self.n, size, self.rng)

    def values(self, count: int) -> list[bytes]:
        """``count`` fresh values of ``value_bytes`` bytes."""
        vals = self.rng.bytes(self.vb * count)
        return [vals[self.vb * j:self.vb * (j + 1)] for j in range(count)]

    def block(self, ops, spans) -> None:
        """One block: ``ops`` in order ((account, None) a read, (account,
        value) a write), then commit.  Records each operation with the
        value a read got."""
        led = self.led
        done = []
        with spans.span("block.ops"):
            for k, v in ops:
                if v is None:
                    done.append((k, None,
                                 led.read(CONTRACT, gen.account_key(k))))
                else:
                    led.write(CONTRACT, gen.account_key(k), v)
                    done.append((k, v, None))
        with spans.span("block.commit"):
            uid = led.commit()
        if self.durable:
            with spans.span("sync"):
                led.db.sync()
        self.blocks.append({"uid": uid, "ops": done})

    def query(self, k: int, spans) -> float:
        """Proves account ``k``'s state at the head and verifies it;
        returns the seconds the two took."""
        key = gen.account_key(k)
        t0 = time.perf_counter()
        with spans.span("prove"):
            proof = self.led.prove_state_flat(CONTRACT, key)
        with spans.span("verify"):
            d, v = self.client.verify_state_flat(proof, CONTRACT, key)
        lat = time.perf_counter() - t0
        q = {"block": len(self.blocks) - 1, "account": k, "distance": d,
             "value": v, "proof": None}
        i = len(self.queries)
        slot = reservoir_slot(i, int(self.mix["check_queries"]), self.pick)
        if slot is not None:
            if slot < len(self.sampled):
                self.queries[self.sampled[slot]]["proof"] = None
                self.sampled[slot] = i
            else:
                self.sampled.append(i)
            q["proof"] = proof
        self.queries.append(q)
        return lat

    # -------------------------------------------------------------- counters
    def counters(self) -> dict:
        from repro_torch import obs
        from repro_torch.kernels import ops
        h = obs.REGISTRY.histogram("live_fold_us")
        return {"launches": ops.launches(),
                "store": self.led.db.store.stats.as_dict(),
                "live_fold_us": h.sum_us, "live_folds": h.count}

    # ---------------------------------------------------- after the window
    def finish(self) -> None:
        """Reads, before the program is freed, each block's meta chunk,
        the state uid its map binds and that state version's meta chunk;
        of a durable deployment, also what a reopened engine finds
        (``_reopen``)."""
        from repro_torch.apps.blockchain import STATE_KEY
        from repro_torch.core import hashing

        db = self.led.db
        for b in self.blocks:
            b["meta"] = db.store.get(b["uid"]) if db.store.has(b["uid"]) \
                else None
            m = db.get("chain", uid=b["uid"]).map() if b["meta"] else None
            state = m.get(b"state") if m is not None else None
            b["state_uid"] = bytes(state) if state is not None else None
            b["state_meta"] = (db.store.get(b["state_uid"])
                               if b["state_uid"] else None)
        self.state_key = STATE_KEY.encode()
        if self.durable:
            self.reopened = self._reopen()
        hashing.use_sha256()
        self.led = self.client = None

    def _reopen(self) -> dict:
        """Closes the store, reopens the engine on its directory, verifying
        every chunk it reads, and reads the ``chain`` head on master, the
        state uid that block binds, that state version's meta chunk and,
        from its map, the accounts of ``_read_back``; each None where the
        reopened engine lacks it."""
        from repro_torch.apps.blockchain import STATE_KEY
        from repro_torch.core import ForkBase
        from repro_torch.core.chunker import ChunkParams
        from repro_torch.errors import ReproError

        self.led.db.store.close()
        got = dict.fromkeys(("head", "state_uid", "state_meta"))
        got["values"] = dict.fromkeys(self._read_back())
        try:                                 # a reopen that fails loses all
            db = ForkBase(durable_root=self.root, verify_get=True,
                          params=ChunkParams(**self.cfg["chunking"]))
        except ReproError:
            db = None
        if db is not None:
            got["head"] = db.branches.head(b"chain", "master")
            try:
                if got["head"] is not None:
                    state = db.get("chain", uid=got["head"]).map()
                    got["state_uid"] = bytes(state.get(b"state"))
                    got["state_meta"] = db.store.get(got["state_uid"])
                    accounts = db.get(STATE_KEY, uid=got["state_uid"]).map()
                    for k in got["values"]:
                        got["values"][k] = accounts.get(
                            f"{CONTRACT}/{gen.account_key(k)}".encode())
            except (ReproError, TypeError):   # TypeError: no "state" entry
                pass
            db.store.close()
        shutil.rmtree(self.root, ignore_errors=True)
        return got

    def _read_back(self) -> list[int]:
        """The accounts read back from a reopened engine: every account
        the last block wrote, and ``READ_BACK`` others drawn from the
        seed."""
        ops = self.blocks[-1]["ops"] if len(self.blocks) > 1 else ()
        written = {k for k, v, _ in ops if v is not None}
        drawn = np.random.default_rng([self.seed, 4]).choice(
            self.n, size=min(READ_BACK, self.n), replace=False)
        return sorted(written | set(drawn.tolist()))

    # ------------------------------------------------------------- judging
    def _sorted_ids(self) -> np.ndarray:
        keys = np.array([f"{CONTRACT}/{gen.account_key(i)}".encode()
                         for i in range(self.n)], dtype=object)
        return np.argsort(keys, kind="stable")

    def _block_ok(self, h: int, device) -> bool:
        """Block ``h``'s record, its map and its state version's record
        against the reference's: the state root itself is left to the
        caller."""
        b, prev = self.blocks[h], self.blocks[h - 1]
        if not (b["meta"] and b["state_meta"] and prev["state_meta"]):
            return False
        try:
            meta = plain.Meta.decode(b["meta"])
            state = plain.Meta.decode(b["state_meta"])
            before = plain.Meta.decode(prev["state_meta"])
        except (ValueError, IndexError):
            return False
        txs = plain.block_txs([gen.account_key(k) for k, v, _ in b["ops"]
                               if v is not None])
        root = plain.map_root([(b"state", b["state_uid"]), (b"txs", txs)],
                              self.chunking, device)
        ctx = plain.height_context(h)
        got = plain.cids([b["meta"], b["state_meta"]], device)
        return (got == [b["uid"], b["state_uid"]]
                and meta == plain.Meta(plain.MAP, b"chain", root, h,
                                       (prev["uid"],), ctx)
                and state == plain.Meta(plain.MAP, self.state_key,
                                        state.data, before.depth + 1,
                                        (prev["state_uid"],), ctx))

    def _query_ok(self, q: dict, values: list, device) -> bool:
        """A query's verdict and value; a sampled one's proof as well, by
        the plain verifier, anchored on the head block at the time."""
        key = gen.account_key(q["account"])
        want = values[q["account"]]
        if q["distance"] != 0 or q["value"] != want:
            return False
        p = q["proof"]
        if p is None:
            return True
        head = self.blocks[q["block"]]
        try:
            raws = plain.lineage_raws(p.lineage)
            got = plain.cids([raws[0], p.block_raw, p.state_raw], device)
            if got[:2] != [head["uid"], head["uid"]]:
                return False
            block = plain.Meta.decode(p.block_raw)
            state_uid = plain.member_by_key(block.data, p.state_entry,
                                            b"state", device)
            if state_uid != got[2] or state_uid != head["state_uid"]:
                return False
            state = plain.Meta.decode(p.state_raw)
            skey = f"{CONTRACT}/{key}".encode()
            return plain.member_by_key(state.data, p.kv_entry, skey,
                                       device) == want
        except (plain.Rejected, ValueError, IndexError):
            return False

    def judge(self, device) -> dict[str, tuple[int, int]]:
        """Replays every block: each read against the value it should see
        (the block's own earlier writes first, then the state before the
        block); each block's records (``_block_ok``); the state root of
        ``check_blocks`` blocks drawn from the seed (and the last)
        rebuilt from the replayed accounts; every query's verdict and
        value, and each sampled proof by the plain verifier.  Each a count
        of mismatches, whose limit is 0."""
        rng = np.random.default_rng([self.seed, 2])
        n = len(self.blocks)
        check = {n - 1}
        if n > 1:
            check |= set((1 + rng.choice(n - 1, size=min(
                int(self.mix["check_blocks"]), n - 1),
                replace=False)).tolist())
        order = self._sorted_ids()
        keys = [f"{CONTRACT}/{gen.account_key(int(i))}".encode()
                for i in order]
        queries: dict[int, list] = {}
        for q in self.queries:
            queries.setdefault(q["block"], []).append(q)
        bad = dict.fromkeys(("block_mismatch", "root_mismatch",
                             "read_mismatch", "proof_mismatch"), 0)
        vals = self.blocks[0]["ops"]
        values: list = [vals[self.vb * i:self.vb * (i + 1)]
                        for i in range(self.n)]
        for h, b in enumerate(self.blocks):
            pending: dict[int, bytes] = {}
            for k, v, got in (b["ops"] if h else ()):
                if v is None:
                    bad["read_mismatch"] += got != pending.get(k, values[k])
                else:
                    pending[k] = v
            for k, v in pending.items():
                values[k] = v
            for q in queries.get(h, ()):
                bad["proof_mismatch"] += not self._query_ok(q, values,
                                                            device)
            if h == 0:                       # the set-up's accounts
                continue
            bad["block_mismatch"] += not self._block_ok(h, device)
            if h in check:
                try:
                    data = plain.Meta.decode(b["state_meta"]).data
                except (TypeError, ValueError, IndexError):
                    data = None
                want = plain.map_root([(k, values[i]) for k, i in
                                       zip(keys, order.tolist())],
                                      self.chunking, device)
                bad["root_mismatch"] += data != want
        if self.durable:
            bad["durable_mismatch"] = self._durable_bad(
                want if n > 1 else plain.map_root(
                    [(k, values[i]) for k, i in zip(keys, order.tolist())],
                    self.chunking, device), values)
        return {k: (int(v), 0) for k, v in bad.items()}

    def _durable_bad(self, root: bytes, values: list) -> int:
        """What the reopened engine found against the last block: its
        head, its state uid, that state's root against ``root``, the
        reference's, and each account read back against ``values``, the
        reference's after the last block; one a mismatch."""
        got, last = self.reopened, self.blocks[-1]
        try:
            data = plain.Meta.decode(got["state_meta"]).data
        except (TypeError, ValueError, IndexError):
            data = None
        lost = sum(v != values[k] for k, v in got["values"].items())
        return ((got["head"] != last["uid"])
                + (got["state_uid"] != last["state_uid"]) + (data != root)
                + lost)
