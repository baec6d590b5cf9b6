"""Wiki engine (paper §5.2): ForkBase Blob pages vs a Redis-style
multi-versioned list baseline.

ForkBase: each page is a Blob under its name; every edit is a Put on the
default branch — versioning, diff and chunk dedup come from the engine.
Client-side chunk caching makes reading consecutive versions cheap
(Fig. 14): unchanged chunks hit the cache.

Redis baseline: page -> list of full version payloads (RPUSH per edit),
optionally zlib-compressed at rest (the paper notes Redis compresses on
persistence).
"""
from __future__ import annotations

import zlib

from ..core import FBlob, ForkBase


class ForkBaseWiki:
    def __init__(self, db: ForkBase | None = None):
        self.db = db if db is not None else ForkBase()

    def create(self, page: str, text: bytes) -> bytes:
        return self.db.put(page, FBlob(text))

    def load(self, page: str) -> bytes:
        return self.db.get(page).blob().read()

    def edit(self, page: str, fn) -> bytes:
        """fn: FBlob -> None applies buffered edits (insert/remove/append);
        commit is one incremental Put."""
        b = self.db.get(page).blob()
        fn(b)
        return self.db.put(page, b)

    def read_version(self, page: str, back: int, chunk_cache: set | None = None):
        """Read the version `back` steps behind head; with a client chunk
        cache, returns (bytes, chunks_fetched, chunks_cached)."""
        objs = self.db.track(page, "master", (back, back + 1))
        h = self.db.get(page, uid=objs[0].uid)
        tree = h.blob().tree
        fetched = cached = 0
        parts = []
        for i, e in enumerate(tree.levels[0]):
            if chunk_cache is not None and e.cid in chunk_cache:
                cached += 1
            else:
                fetched += 1
                if chunk_cache is not None:
                    chunk_cache.add(e.cid)
            parts.append(tree._leaf_payload(i))
        return b"".join(parts), fetched, cached

    def diff(self, page: str, back1: int, back2: int):
        objs = self.db.track(page, "master", (0, max(back1, back2) + 1))
        return self.db.diff(objs[back1].uid, objs[back2].uid)

    def storage_bytes(self) -> int:
        return self.db.store.stats.physical_bytes


class LiveWiki:
    """Forkless flat-path wiki (repro_torch.live): every page's current
    text lives as one entry of a LiveTable on key ``__wiki__``, so loads and
    edits are O(1) dict operations with Redis-like latency — while each
    epoch ``fold()`` batch-splices the accumulated edits into the
    backing POS-Tree map, keeping per-epoch history, chunk dedup and
    membership proofs.  The live answer to §5.2's Redis baseline:
    flat-path speed without giving up the archive."""

    PAGES_KEY = "__wiki__"

    def __init__(self, db: ForkBase | None = None, *, policy=None):
        self.db = db if db is not None else ForkBase()
        self.pages = self.db.live(self.PAGES_KEY, policy=policy)

    def create(self, page: str, text: bytes) -> None:
        self.pages.put(page.encode(), text)

    def load(self, page: str) -> bytes:
        return self.pages.get(page.encode())

    def edit(self, page: str, new_text: bytes) -> None:
        self.pages.put(page.encode(), new_text)

    def fold(self):
        """Epoch boundary: one batched Merkle commitment of all edits
        since the last fold; returns the live.FoldReport."""
        return self.pages.fold()

    def read_version(self, page: str, back: int) -> bytes:
        """Read the page as of ``back`` epochs behind the folded head
        (live history granularity is per-fold, not per-edit)."""
        objs = self.db.track(self.PAGES_KEY, "master", (back, back + 1))
        m = self.db.get(self.PAGES_KEY, uid=objs[0].uid).map()
        return bytes(m.get(page.encode()))

    def storage_bytes(self) -> int:
        return self.db.store.stats.physical_bytes


class RedisWiki:
    """Baseline: list-of-versions per page (paper §5.2)."""

    def __init__(self, compress: bool = True):
        self.pages: dict[str, list[bytes]] = {}
        self.compress = compress

    def create(self, page: str, text: bytes) -> None:
        self.pages[page] = [self._enc(text)]

    def load(self, page: str) -> bytes:
        return self._dec(self.pages[page][-1])

    def edit(self, page: str, new_text: bytes) -> None:
        self.pages[page].append(self._enc(new_text))   # full copy (RPUSH)

    def read_version(self, page: str, back: int) -> bytes:
        return self._dec(self.pages[page][-1 - back])

    def storage_bytes(self) -> int:
        return sum(len(v) for vs in self.pages.values() for v in vs)

    def _enc(self, b: bytes) -> bytes:
        return zlib.compress(b) if self.compress else b

    def _dec(self, b: bytes) -> bytes:
        return zlib.decompress(b) if self.compress else b
