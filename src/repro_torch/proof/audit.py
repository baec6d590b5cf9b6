"""Replica & cluster auditor: sampled tamper-evidence checks.

The auditor is the *consumer* of the proof subsystem: it anchors on
attested heads, samples chunks and branches, and verifies everything
with the stateless verifiers — so a passing audit means an external
verifier holding only the attestations would accept the same state.

  audit_replicas   every ring copy of each sampled cid must be present
                   and hash back to the cid (corrupt / missing copies
                   are reported with the offending replica index);
  audit_engine     sampled heads of one servlet: head proofs against a
                   fresh attestation, meta chunks re-hashed, membership
                   proofs of sampled elements, lineage proofs one step
                   into history — all through the stateless verifiers;
  audit_cluster    the dispatcher's view: per-node placement checks of
                   the master index, per-servlet engine audits, and
                   key-routing divergence (a key with branch state on
                   two servlets means the dispatch rule was violated).

All content hashing is batched: one ``content_hash_many`` per audit
phase (one ``fphash_many`` launch on the engine's device under fphash
cids), not one hash per copy.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import obs
from ..core.fobject import CHUNKABLE_TYPES, FObject
from ..core.hashing import content_hash_many
from ..core.postree import POSTree
from .attest import verify_head
from .lineage import LineageProof, verify_lineage
from .membership import (InvalidProof, VerifyMemo, prove_member,
                         verify_member_many)


@dataclass(frozen=True)
class AuditFinding:
    node: str                 # offending replica / cluster node
    kind: str                 # "corrupt" | "missing" | "diverged" | "bad-proof"
    detail: str
    cid: bytes = b""

    def __str__(self) -> str:
        at = f" cid={self.cid.hex()[:16]}" if self.cid else ""
        return f"[{self.kind}] {self.node}: {self.detail}{at}"


@dataclass
class AuditReport:
    chunks_checked: int = 0
    copies_checked: int = 0
    heads_checked: int = 0
    proofs_verified: int = 0
    findings: list[AuditFinding] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.findings

    def merge(self, other: "AuditReport") -> "AuditReport":
        self.chunks_checked += other.chunks_checked
        self.copies_checked += other.copies_checked
        self.heads_checked += other.heads_checked
        self.proofs_verified += other.proofs_verified
        self.findings.extend(other.findings)
        return self

    def __str__(self) -> str:
        head = (f"audit: {self.chunks_checked} chunks "
                f"({self.copies_checked} copies), {self.heads_checked} "
                f"heads, {self.proofs_verified} proofs verified")
        if self.ok:
            return head + " — OK"
        return head + "\n" + "\n".join(f"  {f}" for f in self.findings)


class Auditor:
    """Sampling auditor; ``sample`` bounds per-phase work so audits stay
    cheap enough to run continuously against production replicas."""

    def __init__(self, sample: int = 64, seed: int = 0):
        self.sample = sample
        self._rng = np.random.default_rng(seed)
        # decoded-node memo persists across audit rounds: an auditor
        # re-checking the same trees round after round hashes/decodes
        # only nodes it has never seen (content addressing keeps the
        # memo coherent for free)
        self.memo = VerifyMemo()

    def _sample(self, seq):
        seq = list(seq)
        if len(seq) <= self.sample:
            return seq
        idx = self._rng.choice(len(seq), size=self.sample, replace=False)
        return [seq[int(i)] for i in sorted(idx)]

    # -------------------------------------------------------- replicas
    def audit_replicas(self, backend) -> AuditReport:
        """Cross-replica audit of a ReplicatedBackend: each sampled cid
        must be present on every ring member and every copy must hash
        back to the cid (one batched hash over all copies)."""
        rep = AuditReport()
        cids = self._sample(backend.iter_cids())
        rep.chunks_checked = len(cids)
        copies: list[tuple[int, bytes, bytes]] = []   # (store idx, cid, raw)
        for cid in cids:
            for si in backend._ring(cid):
                store = backend.stores[si]
                # repro: allow(PERF001): audit probes per copy on purpose
                # — fault attribution needs to know WHICH replica lost the
                # chunk, and the walk continues past failures (a batched
                # has_many can't name the offender per ring member)
                if not store.has(cid):
                    rep.findings.append(AuditFinding(
                        f"replica{si}", "missing",
                        "ring member lost its copy", cid))
                    continue
                try:
                    # repro: allow(PERF001): per-copy get so one corrupt
                    # replica is named without masking the healthy ones
                    copies.append((si, cid, store.get(cid)))
                except ValueError as e:   # verify-enabled leaf caught it
                    rep.findings.append(AuditFinding(
                        f"replica{si}", "corrupt", str(e), cid))
                except KeyError:
                    rep.findings.append(AuditFinding(
                        f"replica{si}", "missing",
                        "copy vanished mid-audit", cid))
        digests = content_hash_many([raw for _, _, raw in copies])
        rep.copies_checked = len(copies)
        for (si, cid, _), digest in zip(copies, digests):
            if digest != cid:
                rep.findings.append(AuditFinding(
                    f"replica{si}", "corrupt",
                    "copy does not hash to its cid", cid))
        return rep

    # --------------------------------------------------------- servlets
    def audit_engine(self, db, node: str = "servlet",
                     secret: bytes | None = None) -> AuditReport:
        """One engine's branch state, end-to-end through the stateless
        verifiers, anchored on a fresh attestation."""
        rep = AuditReport()
        att = db.attest(context=node.encode(), secret=secret)
        heads: list[tuple[bytes, str, bytes]] = []
        for key in db.branches.keys():
            for tag, uid in db.branches.tagged(key).items():
                heads.append((key, tag, uid))
        heads = self._sample(heads)
        rep.heads_checked = len(heads)
        # 1) every sampled head is committed by the attestation; the
        # audit paths come straight off the engine's resident delta
        # attestation tree — no re-Merkle-ization per audit round
        committed: list[tuple[bytes, str, bytes]] = []
        for key, tag, uid in heads:
            try:
                verify_head(att, db.prove_head(key, tag), secret=secret)
                rep.proofs_verified += 1
                committed.append((key, tag, uid))
            except (InvalidProof, KeyError) as e:
                rep.findings.append(AuditFinding(
                    node, "bad-proof", f"head {key!r}@{tag}: {e}", uid))
        # 2) meta-chunk integrity, one hash batch for every head
        metas: list[tuple[bytes, str, bytes, bytes]] = []
        for key, tag, uid in committed:
            try:
                # repro: allow(PERF001): per-head get so a single tampered
                # meta chunk is attributed to its branch head, not the batch
                metas.append((key, tag, uid, db.store.get(uid)))
            except ValueError as e:     # TamperedChunk from a verify store
                rep.findings.append(AuditFinding(
                    node, "corrupt",
                    f"head meta chunk {key!r}@{tag}: {e}", uid))
            except KeyError:
                rep.findings.append(AuditFinding(
                    node, "missing", f"head meta chunk {key!r}@{tag}", uid))
        digests = content_hash_many([raw for *_, raw in metas])
        member_batch: list[tuple[bytes, object]] = []
        with_bases: list[tuple[bytes, str, bytes, bytes, bytes]] = []
        for (key, tag, uid, raw), digest in zip(metas, digests):
            if digest != uid:
                rep.findings.append(AuditFinding(
                    node, "corrupt", f"head meta chunk {key!r}@{tag}", uid))
                continue
            obj = FObject.deserialize(raw, uid)
            rep.chunks_checked += 1
            # 3) a sampled element of the value, by stateless proof
            if obj.type in CHUNKABLE_TYPES:
                try:
                    tree = POSTree.from_root(db.store, obj.type, obj.data,
                                             db.params)
                    if tree.total_count > 0:
                        pos = int(self._rng.integers(0, tree.total_count))
                        member_batch.append(
                            (obj.data, prove_member(tree, pos=pos)))
                except (KeyError, ValueError) as e:   # lost/tampered node
                    rep.findings.append(AuditFinding(
                        node, "corrupt",
                        f"value tree {key!r}@{tag}: {e}", obj.data))
            if obj.bases:
                with_bases.append((key, tag, uid, raw, obj.bases[0]))
        # 4) one step of history for every head: build each 1-link
        # lineage proof from the already-authenticated head raw + one
        # batched base fetch, then verify them all through ONE hash
        # dispatch (the lineage analogue of verify_member_many)
        base_raws: list[bytes | None]
        try:                        # optimistic: ONE get_many round-trip
            base_raws = list(db.store.get_many(
                [base for *_, base in with_bases])) if with_bases else []
        except (KeyError, ValueError):
            base_raws = []          # degrade per-item to name offenders
            for key, tag, _uid, _, base in with_bases:
                try:
                    # repro: allow(PERF001): deliberate degrade path — the
                    # batched get_many above already failed; re-walk per
                    # item to name the offending base uid(s)
                    base_raws.append(db.store.get(base))
                except (KeyError, ValueError) as e:
                    rep.findings.append(AuditFinding(
                        node, "missing" if isinstance(e, KeyError)
                        else "corrupt", f"base of {key!r}@{tag}: {e}",
                        base))
                    base_raws.append(None)
        lineage_items = [(hb, braw) for hb, braw in zip(with_bases,
                                                        base_raws)
                         if braw is not None]
        base_digests = content_hash_many(
            [braw for _, braw in lineage_items])
        for ((key, tag, uid, raw, base), braw), digest in zip(
                lineage_items, base_digests):
            try:
                if digest != base:
                    raise InvalidProof("base chunk hash mismatch")
                verify_lineage(uid, base, LineageProof((raw, braw)))
                rep.proofs_verified += 1
            except (InvalidProof, ValueError) as e:
                rep.findings.append(AuditFinding(
                    node, "bad-proof", f"lineage {key!r}@{tag}: {e}", uid))
        # batched membership verification: ONE hash dispatch for the
        # nodes this round sees for the first time (memo persists)
        results = verify_member_many(member_batch, strict=False,
                                     memo=self.memo)
        for (root, _), res in zip(member_batch, results):
            if isinstance(res, InvalidProof):
                rep.findings.append(AuditFinding(
                    node, "bad-proof", f"membership: {res}", root))
            else:
                rep.proofs_verified += 1
        return rep

    # ---------------------------------------------------------- cluster
    def audit_placement(self, cluster) -> AuditReport:
        """Sampled master-index placement checks: every sampled index
        entry must be held by the owning node and hash back to its cid
        (one batched hash over everything held)."""
        rep = AuditReport()
        lock = getattr(cluster, "_index_lock", None)
        if lock is not None:     # snapshot under the routing index lock
            with lock:
                entries = list(cluster.index.items())
        else:
            entries = cluster.index.items()
        placed = self._sample(entries)
        rep.chunks_checked += len(placed)
        held: list[tuple[int, bytes, bytes]] = []
        for cid, ni in placed:
            store = cluster.nodes[ni].store
            # repro: allow(PERF001): placement audit asks one node about
            # one cid — per-node attribution is the product, not an N+1
            # accident
            if not store.has(cid):
                rep.findings.append(AuditFinding(
                    f"node{ni}", "missing",
                    "master index points at a chunk the node lost", cid))
                continue
            try:
                # repro: allow(PERF001): per-chunk get keeps the audit
                # walking past a corrupt node instead of failing the sample
                held.append((ni, cid, store.get(cid)))
            except ValueError as e:       # verify-enabled node caught it
                rep.findings.append(AuditFinding(
                    f"node{ni}", "corrupt", str(e), cid))
            except KeyError:
                rep.findings.append(AuditFinding(
                    f"node{ni}", "missing", "chunk vanished mid-audit",
                    cid))
        rep.copies_checked += len(held)
        for (ni, cid, _), digest in zip(
                held, content_hash_many([raw for _, _, raw in held])):
            if digest != cid:
                rep.findings.append(AuditFinding(
                    f"node{ni}", "corrupt",
                    "stored bytes do not hash to the indexed cid", cid))
        return rep

    def audit_cluster(self, cluster,
                      secret: bytes | None = None) -> AuditReport:
        """Dispatcher-side audit: master-index placement, per-servlet
        engine audits, and key-routing divergence."""
        # 1) sampled placement checks against the owning node's store
        rep = self.audit_placement(cluster)
        # 2) key-routing divergence: branch state must live only on the
        # key's home servlet
        owner_of: dict[bytes, list[int]] = {}
        for ni, nd in enumerate(cluster.nodes):
            with nd.lock:
                keys = nd.servlet.branches.keys()
            for key in keys:
                owner_of.setdefault(key, []).append(ni)
        for key, nis in owner_of.items():
            home = cluster._home_index(key)
            for ni in nis:
                if ni != home:
                    rep.findings.append(AuditFinding(
                        f"node{ni}", "diverged",
                        f"branch state for key {key!r} belongs on "
                        f"node{home}"))
        # 3) per-servlet engine audits through the stateless verifiers
        for ni, nd in enumerate(cluster.nodes):
            with nd.lock:
                rep.merge(self.audit_engine(nd.servlet, node=f"node{ni}",
                                            secret=secret))
        return rep


# ------------------------------------------------------------------ daemon

class AuditDaemon:
    """Continuous audit loop for a cluster (ROADMAP "continuous audit
    daemon"): instead of on-demand ``Cluster.audit`` calls, the serving
    loop calls ``tick(budget)`` and the daemon spreads sampled audits
    over time —

      * per-node exponential backoff: a node that keeps auditing clean
        is re-audited at a doubling interval (capped at
        ``max_interval`` ticks), so steady-state audit load decays to a
        heartbeat;
      * a finding triggers an IMMEDIATE re-audit of the node (transient
        read races don't quarantine) and, if anything is still wrong,
        the node is quarantined: recorded in ``self.quarantined``,
        reported via the tick's AuditReport, and kept under base-rate
        audit so repair is observed;
      * the master-index placement/routing checks run as their own
        backoff target beside the per-node engine audits.

    The daemon's Auditor carries the persistent decoded-node memo, so
    successive ticks over unchanged trees skip re-hashing shared nodes.
    Target scheduling is tick-counted (the caller decides what a tick
    means — request batches, seconds, GC slices), keeping the daemon
    deterministic and testable."""

    PLACEMENT = "placement"
    MAX_FINDINGS = 1024       # retained findings (a quarantined node
                              # keeps auditing at base rate forever)

    def __init__(self, cluster, *, sample: int = 32, seed: int = 0,
                 secret: bytes | None = None, base_interval: int = 1,
                 max_interval: int = 64):
        self.cluster = cluster
        self.auditor = Auditor(sample=sample, seed=seed)
        self.secret = secret
        self.base_interval = max(1, base_interval)
        self.max_interval = max(self.base_interval, max_interval)
        self.ticks = 0
        self.audits = 0
        self.quarantined: set[str] = set()
        self.findings: list[AuditFinding] = []
        targets = [f"node{i}" for i in range(len(cluster.nodes))]
        targets.append(self.PLACEMENT)
        # stagger first-due ticks so a fresh daemon does not audit the
        # whole cluster in its first tick
        self._interval = {t: self.base_interval for t in targets}
        self._due = {t: 1 + i for i, t in enumerate(targets)}

    # ---------------------------------------------------------- internals
    def _audit_target(self, target: str) -> AuditReport:
        self.audits += 1
        obs.inc("audit_audits_total")
        if target == self.PLACEMENT:
            return self.auditor.audit_placement(self.cluster)
        ni = int(target[4:])
        nd = self.cluster.nodes[ni]
        # engine audits attest and walk the branch table — hold the
        # servlet lock so a daemon-thread audit can't race a foreground
        # put on the same servlet
        lock = getattr(nd, "lock", None)
        if lock is None:
            return self.auditor.audit_engine(nd.servlet, node=target,
                                             secret=self.secret)
        with lock:
            return self.auditor.audit_engine(nd.servlet, node=target,
                                             secret=self.secret)

    def _quarantine_of(self, report: AuditReport) -> set[str]:
        return {f.node for f in report.findings}

    def _record(self, findings) -> None:
        """Append to the findings log, keeping only the newest
        MAX_FINDINGS — an unrepaired node would grow it forever."""
        self.findings.extend(findings)
        for f in findings:
            obs.inc("audit_findings_total")
            obs.emit("audit.finding", node=f.node, finding_kind=f.kind,
                     detail=f.detail, cid=f.cid)
        if len(self.findings) > self.MAX_FINDINGS:
            del self.findings[:len(self.findings) - self.MAX_FINDINGS]

    # -------------------------------------------------------------- tick
    def tick(self, budget: int = 1) -> AuditReport:
        """Advance the daemon one tick: audit up to ``budget`` due
        targets (earliest-due first) and return the merged report of
        everything audited this tick."""
        if budget < 1:
            raise ValueError(f"budget must be >= 1, got {budget}")
        self.ticks += 1
        obs.inc("audit_ticks_total")
        rep = AuditReport()
        due = sorted((t for t, d in self._due.items() if d <= self.ticks),
                     key=lambda t: (self._due[t], t))
        for target in due[:budget]:
            r = self._audit_target(target)
            rep.merge(r)
            if r.ok:
                self._interval[target] = min(self.max_interval,
                                             self._interval[target] * 2)
            else:
                # immediate re-audit: only a repeatable finding
                # quarantines (a transient read race does not), but
                # either way the target drops back to the base rate
                r2 = self._audit_target(target)
                rep.merge(r2)
                self._record(r.findings)
                if not r2.ok:
                    self._record(r2.findings)
                    bad = self._quarantine_of(r2)
                    fresh = bad - self.quarantined
                    self.quarantined |= bad
                    for node in sorted(fresh):
                        reason = ",".join(sorted(
                            {f.kind for f in r2.findings
                             if f.node == node})) or "repeatable-finding"
                        obs.inc("audit_quarantines_total")
                        obs.emit("audit.quarantine", node=node,
                                 reason=reason, target=target,
                                 tick=self.ticks)
                        # ENFORCE at the routing layer: a direct call
                        # (not an event tap), so placement stops using
                        # the node and re-replication queues even with
                        # observability disabled
                        self._enforce(node, "quarantine", reason)
                    obs.set_gauge("audit_quarantined_nodes",
                                  len(self.quarantined))
                    # a quarantined node drops to base-rate auditing so
                    # repair is observed — even when the finding came
                    # from another target (e.g. the placement check)
                    for node in bad:
                        if node in self._interval:
                            self._interval[node] = self.base_interval
                            self._due[node] = min(self._due[node],
                                                  self.ticks + 1)
                self._interval[target] = self.base_interval
            self._due[target] = self.ticks + self._interval[target]
        return rep

    def _enforce(self, node: str, verb: str, reason: str = "") -> None:
        """Forward a quarantine/release decision to the cluster's
        routing-layer enforcement verbs.  Only ``nodeN`` names map to
        cluster nodes (replica/servlet findings from standalone audits
        have no placement to enforce against)."""
        if not (node.startswith("node") and node[4:].isdigit()):
            return
        ni = int(node[4:])
        if verb == "quarantine":
            fn = getattr(self.cluster, "quarantine_node", None)
            if fn is not None:
                fn(ni, reason=reason)
        else:
            fn = getattr(self.cluster, "release_node", None)
            if fn is not None:
                fn(ni)

    def release(self, node: str) -> None:
        """Operator verb: lift a quarantine after repair; the node
        re-enters the rotation at the base audit rate."""
        if node in self.quarantined:
            obs.inc("audit_releases_total")
            obs.emit("audit.release", node=node, reason="operator-release",
                     tick=self.ticks)
            self._enforce(node, "release")
        self.quarantined.discard(node)
        obs.set_gauge("audit_quarantined_nodes", len(self.quarantined))
        if node in self._interval:
            self._interval[node] = self.base_interval
            self._due[node] = self.ticks + 1
