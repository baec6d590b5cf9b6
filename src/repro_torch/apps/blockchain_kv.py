"""Baseline: Hyperledger v0.6's original storage design on a plain KV
store (paper §5.1.1, Fig. 7a) — what ForkBase replaces.

Components, faithful to the paper's description:
  * a key-value store (stand-in for RocksDB);
  * a Merkle **bucket tree** over the state: a fixed number of buckets,
    key-hash -> bucket, bucket hash = H(sorted kv pairs), state hash =
    binary Merkle reduction over bucket hashes.  Fewer buckets => more
    write amplification per commit (Fig. 11);
  * an alternative **trie** (Patricia-style over key nibbles) with
    per-path rehashing (Fig. 11's 'trie' series);
  * **state deltas**: each commit stores the overwritten values, so
    historical reads require replaying deltas backward — analytics need a
    pre-processing pass over all blocks (Fig. 12's Rocksdb series).
"""
from __future__ import annotations

import hashlib
import json
from collections import defaultdict
from dataclasses import dataclass


def H(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


# ----------------------------------------------------------- bucket tree

class BucketTree:
    def __init__(self, n_buckets: int = 1024):
        self.n = n_buckets
        self.kv: dict[bytes, bytes] = {}
        self.bucket_hash = [b"\x00" * 32] * n_buckets
        self.hashed_bytes = 0        # write-amplification counter

    def _bucket(self, k: bytes) -> int:
        return int.from_bytes(H(k)[:8], "little") % self.n

    def update(self, writes: dict[bytes, bytes]) -> bytes:
        touched = set()
        for k, v in writes.items():
            self.kv[k] = v
            touched.add(self._bucket(k))
        for b in touched:
            items = sorted((k, v) for k, v in self.kv.items()
                           if self._bucket(k) == b)
            payload = b"".join(k + v for k, v in items)
            self.hashed_bytes += len(payload)
            self.bucket_hash[b] = H(payload)
        return self.root()

    def root(self) -> bytes:
        level = list(self.bucket_hash)
        while len(level) > 1:
            nxt = []
            for i in range(0, len(level), 2):
                pair = level[i] + (level[i + 1] if i + 1 < len(level)
                                   else b"")
                nxt.append(H(pair))
            level = nxt
        return level[0]


# ----------------------------------------------------------------- trie

class TrieNode:
    __slots__ = ("children", "value", "hash")

    def __init__(self):
        self.children: dict[int, "TrieNode"] = {}
        self.value: bytes | None = None
        self.hash = b"\x00" * 32


class MerkleTrie:
    def __init__(self):
        self.root = TrieNode()
        self.hashed_bytes = 0

    def update(self, writes: dict[bytes, bytes]) -> bytes:
        for k, v in writes.items():
            nibbles = [b >> 4 for b in H(k)[:8]] + \
                      [b & 15 for b in H(k)[:8]]
            path = [self.root]
            node = self.root
            for nb in nibbles:
                node = node.children.setdefault(nb, TrieNode())
                path.append(node)
            node.value = v
            for n in reversed(path):        # rehash the touched path
                payload = (n.value or b"") + b"".join(
                    c.hash for c in n.children.values())
                self.hashed_bytes += len(payload)
                n.hash = H(payload)
        return self.root.hash


# ------------------------------------------------------------- the ledger

@dataclass
class Block:
    height: int
    prev: bytes
    state_hash: bytes
    txs: list
    delta: dict          # key -> previous value (state delta)

    def hash(self) -> bytes:
        return H(self.prev + self.state_hash
                 + json.dumps(self.txs).encode())


class KVLedger:
    """The Fig. 7(a) stack: KV store + Merkle structure + state deltas."""

    def __init__(self, merkle: str = "bucket", n_buckets: int = 1024):
        self.kv: dict[bytes, bytes] = {}          # "RocksDB"
        self.tree = (BucketTree(n_buckets) if merkle == "bucket"
                     else MerkleTrie())
        self.blocks: list[Block] = []
        self._writes: dict[bytes, bytes] = {}
        self._pending: list = []
        self.storage_bytes = 0

    def read(self, contract: str, key: str) -> bytes | None:
        kk = f"{contract}/{key}".encode()
        return self._writes.get(kk, self.kv.get(kk))

    def write(self, contract: str, key: str, value: bytes) -> None:
        # must eagerly maintain temporary structures (paper: "Rocksdb and
        # ForkBase-KV need to compute temporary updates for the internal
        # structures")
        kk = f"{contract}/{key}".encode()
        self._writes[kk] = value
        self._pending.append((contract, "put", key))

    def commit(self) -> bytes:
        delta = {k.decode(): (self.kv.get(k) or b"").decode("latin1")
                 for k in self._writes}
        state_hash = self.tree.update(dict(self._writes))
        for k, v in self._writes.items():
            self.kv[k] = v
            self.storage_bytes += len(k) + len(v)
        prev = self.blocks[-1].hash() if self.blocks else b"\x00" * 32
        blk = Block(len(self.blocks), prev, state_hash,
                    list(self._pending), delta)
        self.blocks.append(blk)
        self.storage_bytes += sum(len(k) + len(v.encode("latin1"))
                                  for k, v in delta.items()) + 96
        self._writes.clear()
        self._pending.clear()
        return blk.hash()

    # -------------------------------------------------------- analytics
    def build_scan_index(self):
        """Pre-processing pass (paper §5.1.2): parse every block's delta
        to build an in-memory history index."""
        index: dict[str, list] = defaultdict(list)
        for blk in self.blocks:
            for k, old in blk.delta.items():
                index[k].append((blk.height, old))
        return index

    def state_scan(self, contract: str, key: str, index=None):
        if index is None:
            index = self.build_scan_index()   # cost paid per query
        kk = f"{contract}/{key}"
        cur = self.kv.get(kk.encode())
        hist = [cur]
        for _h, old in reversed(index.get(kk, [])):
            hist.append(old.encode("latin1"))
        return hist[:-1]

    def block_scan(self, height: int, index=None):
        """Replay deltas backward from the head to `height`."""
        state = dict(self.kv)
        for blk in reversed(self.blocks[height + 1:]):
            for k, old in blk.delta.items():
                state[k.encode()] = old.encode("latin1")
        return state
