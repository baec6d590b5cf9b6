"""k-way replication over several backends (paper §4.4): dedup is
preserved globally — at most k copies of any chunk exist — and reads
fail over across the replica ring."""
from __future__ import annotations

from ..errors import ConfigError
from .backend import (BackendBase, ChunkMissing, delete_via, group_by,
                      put_via, resolve_cids)


class ReplicatedBackend(BackendBase):
    OBS_NAME = "replicated"

    def __init__(self, stores: list, k: int = 2):
        super().__init__()
        if not stores:
            raise ConfigError("ReplicatedBackend needs at least one store")
        self.stores = list(stores)
        self.k = min(k, len(stores))
        self._known: set[bytes] = set()   # distinct cids (for __len__)

    def _ring(self, cid: bytes) -> list[int]:
        h = int.from_bytes(cid[:8], "little")
        n = len(self.stores)
        return [(h + i) % n for i in range(self.k)]

    # ------------------------------------------------------------ batched
    def _put_many_impl(self, raws, cids=None) -> list[bytes]:
        raws = [bytes(r) for r in raws]
        out = resolve_cids(raws, cids)
        st = self.stats
        st.put_batches += 1
        groups: dict[int, tuple[list[bytes], list[bytes]]] = {}
        for raw, cid in zip(raws, out):
            st.puts += 1
            st.logical_bytes += len(raw)
            if cid in self._known:
                st.dedup_hits += 1
            else:
                self._known.add(cid)
            for si in self._ring(cid):
                g = groups.setdefault(si, ([], []))
                g[0].append(raw)
                g[1].append(cid)
        for si, (rs, cs) in groups.items():
            # dedup counted once via _known, not per replica copy
            put_via(st, self.stores[si], rs, cs, count_dedup=False)
        self._notify_put(out)
        return out

    def _get_many_impl(self, cids) -> list[bytes]:
        """Batched read: group cids by primary replica, one get_many per
        store; only lost replicas fail over per-cid around the ring."""
        st = self.stats
        st.get_batches += 1
        st.gets += len(cids)
        out: list[bytes | None] = [None] * len(cids)
        primary = lambda i, c: self._ring(c)[0]  # noqa: E731
        for si, (idx, cs, _) in group_by(primary, cids).items():
            present = self.stores[si].has_many(cs)
            hit_i = [i for i, p in zip(idx, present) if p]
            hit_c = [c for c, p in zip(cs, present) if p]
            if hit_c:
                for i, raw in zip(hit_i, self.stores[si].get_many(hit_c)):
                    out[i] = raw
            for i, cid in zip(idx, cs):
                if out[i] is not None:
                    continue
                for ri in self._ring(cid)[1:]:  # replica lost -> fail over
                    # repro: allow(PERF001): failover path, off the batched
                    # fast path — walk the ring and stop at the first live
                    # copy; a batch per replica would read chunks it is
                    # about to discard
                    if self.stores[ri].has(cid):
                        # repro: allow(PERF001): single fetch of the one
                        # surviving copy found by the probe above
                        out[i] = self.stores[ri].get(cid)
                        break
                else:
                    raise ChunkMissing(cid)
        return out  # type: ignore[return-value]

    def has_many(self, cids) -> list[bool]:
        out = [False] * len(cids)
        primary = lambda i, c: self._ring(c)[0]  # noqa: E731
        for si, (idx, cs, _) in group_by(primary, cids).items():
            for i, cid, p in zip(idx, cs, self.stores[si].has_many(cs)):
                # repro: allow(PERF001): ring-walk short-circuits at the
                # first replica that holds the cid; misses are rare
                out[i] = p or any(self.stores[ri].has(cid)
                                  for ri in self._ring(cid)[1:])
        return out

    def _delete_many_impl(self, cids) -> int:
        """All-replica delete: a swept chunk leaves every copy in the ring
        (deletes counted once per distinct chunk, like dedup on Put)."""
        st = self.stats
        n = 0
        groups: dict[int, list[bytes]] = {}
        for cid in cids:
            if cid not in self._known:
                continue
            self._known.discard(cid)
            n += 1
            st.deletes += 1
            for si in self._ring(cid):
                groups.setdefault(si, []).append(cid)
        for si, cs in groups.items():
            delete_via(st, self.stores[si], cs, count_deletes=False)
        return n

    def iter_cids(self):
        return iter(list(self._known))

    def audit(self, sample: int = 64, seed: int = 0):
        """Sampled cross-replica tamper audit (proof subsystem): every
        ring copy of each sampled cid must exist and hash back to the
        cid; returns an ``AuditReport`` naming offending replicas.  The
        proof subsystem is not ported yet, so this raises ``ConfigError``."""
        raise ConfigError("ReplicatedBackend.audit needs the proof "
                          "subsystem, which is not ported yet")

    def __len__(self) -> int:
        return len(self._known)

    def flush(self) -> None:
        for s in self.stores:
            s.flush()
