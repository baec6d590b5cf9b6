"""cid-hash sharded in-process backend: the cluster's layer-2 chunk
partitioning (§4.6) as a standalone composable store.  Because cids are
cryptographic hashes, chunks spread uniformly across shards even under
severely skewed key workloads (Fig. 15)."""
from __future__ import annotations

from ..errors import ConfigError
from .backend import (BackendBase, delete_via, group_by, put_via,
                      resolve_cids)
from .memory import MemoryBackend


class ShardedBackend(BackendBase):
    OBS_NAME = "sharded"

    def __init__(self, shards=4, factory=MemoryBackend):
        super().__init__()
        if isinstance(shards, int):
            shards = [factory() for _ in range(shards)]
        if not shards:
            raise ConfigError("ShardedBackend needs at least one shard")
        self.shards = list(shards)

    def _owner(self, cid: bytes) -> int:
        return int.from_bytes(cid[:8], "little") % len(self.shards)

    # ------------------------------------------------------------ batched
    def _put_many_impl(self, raws, cids=None) -> list[bytes]:
        raws = [bytes(r) for r in raws]
        out = resolve_cids(raws, cids)
        st = self.stats
        st.put_batches += 1
        st.puts += len(raws)
        st.logical_bytes += sum(len(r) for r in raws)
        for si, (_, cs, rs) in group_by(lambda i, c: self._owner(c),
                                        out, raws).items():
            put_via(st, self.shards[si], rs, cs)
        self._notify_put(out)
        return out

    def _get_many_impl(self, cids) -> list[bytes]:
        st = self.stats
        st.get_batches += 1
        st.gets += len(cids)
        out: list[bytes | None] = [None] * len(cids)
        for si, (idx, cs, _) in group_by(lambda i, c: self._owner(c),
                                         cids).items():
            for i, raw in zip(idx, self.shards[si].get_many(cs)):
                out[i] = raw
        return out  # type: ignore[return-value]

    def has_many(self, cids) -> list[bool]:
        return [self.shards[self._owner(cid)].has(cid) for cid in cids]

    def _delete_many_impl(self, cids) -> int:
        """Sweep fan-out: one delete_many per owning shard."""
        n = 0
        for si, (_, cs, _) in group_by(lambda i, c: self._owner(c),
                                       cids).items():
            n += delete_via(self.stats, self.shards[si], cs)
        return n

    def iter_cids(self):
        for s in self.shards:
            yield from s.iter_cids()

    def __len__(self) -> int:
        return sum(len(s) for s in self.shards)

    def flush(self) -> None:
        for s in self.shards:
            s.flush()

    def distribution(self) -> list[int]:
        """Physical bytes per shard (uniformity check, Fig. 15)."""
        return [s.stats.physical_bytes for s in self.shards]
