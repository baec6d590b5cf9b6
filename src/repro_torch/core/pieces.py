"""Piece table for client-side edit buffering (paper §3.5, Fig. 4: "Changes
are buffered in client"; "When multiple updates of the same object are
batched, ForkBase only retains the final version").

Buffers an arbitrary sequence of virtual-coordinate splices against a base
of known length and, at commit time, emits the minimal list of
*base-coordinate* splices — exactly what POSTree.splice_bytes /
splice_elements consume in one incremental pass.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from ..errors import InvariantViolation


@dataclass
class _Piece:
    base_start: int   # -1 for NEW pieces
    length: int
    new: Any = None   # NEW payload: list (elements) or bytes


class PieceTable:
    def __init__(self, base_len: int):
        self.base_len = base_len
        self.pieces: list[_Piece] = (
            [_Piece(0, base_len)] if base_len > 0 else [])

    def __len__(self) -> int:
        return sum(p.length for p in self.pieces)

    def splice(self, vstart: int, vend: int, new: Any, new_len: int) -> None:
        if not (0 <= vstart <= vend <= len(self)):
            raise InvariantViolation(
                f"splice range out of bounds: {(vstart, vend, len(self))}")
        out: list[_Piece] = []
        pos = 0
        inserted = False

        def emit_new():
            nonlocal inserted
            if not inserted:
                if new_len > 0:
                    out.append(_Piece(-1, new_len, new))
                inserted = True

        for p in self.pieces:
            pend = pos + p.length
            if pend <= vstart or pos >= vend:
                if pos >= vend:
                    emit_new()
                out.append(p)
            else:
                # head fragment
                if pos < vstart:
                    head = vstart - pos
                    if p.base_start >= 0:
                        out.append(_Piece(p.base_start, head))
                    else:
                        out.append(_Piece(-1, head, p.new[:head]))
                emit_new()
                # tail fragment
                if pend > vend:
                    tail = pend - vend
                    off = p.length - tail
                    if p.base_start >= 0:
                        out.append(_Piece(p.base_start + off, tail))
                    else:
                        out.append(_Piece(-1, tail, p.new[off:]))
            pos = pend
        emit_new()
        self.pieces = [p for p in out if p.length > 0]

    def read(self, vstart: int, vend: int, base_read: Callable[[int, int], Any],
             joiner: Callable[[list], Any]) -> Any:
        """Materialize virtual range [vstart, vend)."""
        parts = []
        pos = 0
        for p in self.pieces:
            pend = pos + p.length
            lo, hi = max(pos, vstart), min(pend, vend)
            if lo < hi:
                off = lo - pos
                if p.base_start >= 0:
                    parts.append(base_read(p.base_start + off,
                                           p.base_start + off + (hi - lo)))
                else:
                    parts.append(p.new[off:off + (hi - lo)])
            pos = pend
            if pos >= vend:
                break
        return joiner(parts)

    @property
    def dirty(self) -> bool:
        if len(self.pieces) != (1 if self.base_len else 0):
            return True
        return bool(self.pieces) and (self.pieces[0].base_start != 0 or
                                      self.pieces[0].length != self.base_len)

    def base_edits(self, joiner: Callable[[list], Any]):
        """Emit [(base_start, base_end, replacement)] splices, sorted and
        non-overlapping.  BASE pieces stay in increasing order because
        splices never reorder retained content."""
        edits = []
        cursor = 0  # position in base coords
        pending: list[Any] = []
        for p in self.pieces:
            if p.base_start >= 0:
                if p.base_start != cursor or pending:
                    edits.append((cursor, p.base_start, joiner(pending)))
                    pending = []
                cursor = p.base_start + p.length
            else:
                pending.append(p.new)
        if cursor != self.base_len or pending:
            edits.append((cursor, self.base_len, joiner(pending)))
        return edits
