"""Tamper-evidence proof subsystem: stateless verifiers over the
Merkle structure (paper §3.2, §4.3; UStore's verifiable access).

A verifier holding only a trusted anchor — a POS-Tree root cid, a
version uid, or a signed head attestation — can check:

  membership   an element/key is (or is not) in a value
               (prove_member / prove_absence -> verify_member[_many])
  lineage      a version is an ancestor of a trusted head, and at what
               distance (prove_lineage -> verify_lineage)
  attestation  a branch head is committed to by an engine/servlet
               (ForkBase.attest -> prove_head -> verify_head)
  audit        sampled cross-replica / cluster integrity, anchored on
               attestations (Auditor)

No verifier touches the store; proofs carry the raw chunks whose hashes
close the chain.  Batch verification routes all hashing through
``content_hash_many`` — one ``fphash_many`` launch per batch on the
engine's device under fphash cids.
"""
from .attest import (Attestation, HeadProof, attest_heads, head_entries,
                     merkle_root, prove_head, verify_attestation,
                     verify_head)
from .audit import AuditDaemon, AuditFinding, Auditor, AuditReport
from .delta import (DeltaAttestor, DeltaStats, attestation_epoch,
                    pack_epoch, unpack_epoch)
from .lineage import (LineageProof, lineage_path, prove_lineage,
                      verify_lineage)
from .membership import (Claim, InvalidProof, MembershipProof,
                         ProofCache, VerifyMemo, prove_absence,
                         prove_member, verify_member, verify_member_many)
from ..core.fobject import FObject
from ..core.hashing import content_hash_many


def verify_version(uid: bytes, meta_raw: bytes) -> FObject:
    """Stateless uid -> version record binding: the meta chunk must hash
    to the trusted uid; returns the authenticated FObject (whose ``data``
    is the value root cid for chunkable types — the anchor for
    membership proofs underneath)."""
    from ..core import chunk as ck
    if content_hash_many([bytes(meta_raw)])[0] != bytes(uid):
        raise InvalidProof("meta chunk does not hash to uid")
    try:
        if ck.chunk_type(meta_raw) != ck.META:
            raise InvalidProof("not a meta chunk")
        return FObject.deserialize(bytes(meta_raw), bytes(uid))
    except InvalidProof:
        raise
    except Exception as e:
        raise InvalidProof(f"malformed meta chunk: {e}") from e


__all__ = [
    "Attestation", "HeadProof", "attest_heads", "head_entries",
    "merkle_root", "prove_head", "verify_attestation", "verify_head",
    "AuditDaemon", "AuditFinding", "Auditor", "AuditReport",
    "DeltaAttestor", "DeltaStats", "attestation_epoch", "pack_epoch",
    "unpack_epoch",
    "LineageProof", "lineage_path", "prove_lineage", "verify_lineage",
    "Claim", "InvalidProof", "MembershipProof", "ProofCache",
    "VerifyMemo", "prove_absence", "prove_member", "verify_member",
    "verify_member_many", "verify_version",
]
