"""ForkBase core — the paper's storage engine (this slice of the port).

Public surface:
  ForkBase (db.py)          — embedded engine: put/get (single and
                              batched), branch views, fork/rename/remove,
                              track/lca/diff/merge (Table 1)
  from_state (db.py)        — an engine over carried-over chunks and heads
  FBlob/FList/FMap/FSet     — chunkable types (POS-Tree backed)
  FString/FTuple/FInt       — primitive types
  POSTree (postree.py)      — Pattern-Oriented-Split Tree
  ChunkStore                — content-addressed chunk storage (alias of
                              storage.MemoryBackend)

The cluster and its runtime come with a later slice.
"""
from .branch import (DEFAULT_BRANCH, BranchExists, GuardFailed, NoSuchRef)
from .chunker import ChunkParams, DEFAULT_PARAMS
from .chunkstore import ChunkStore
from .db import ForkBase, TypeNotMatch, ValueHandle, from_state
from .fobject import FObject, load_fobject, make_fobject
from .merge import (BUILTIN_RESOLVERS, Conflict, MergeConflict,
                    aggregate_resolver, append_resolver, choose_one, lca)
from .postree import POSTree
from .types import FBlob, FInt, FList, FMap, FSet, FString, FTuple
from ..storage import (ChunkMissing, StorageBackend, TamperedChunk,
                       WriteBuffer, make_backend)

__all__ = [
    "ForkBase", "ChunkStore", "POSTree", "from_state",
    "FBlob", "FList", "FMap", "FSet", "FString", "FTuple", "FInt",
    "FObject", "ChunkParams", "DEFAULT_PARAMS", "DEFAULT_BRANCH",
    "GuardFailed", "BranchExists", "NoSuchRef", "TypeNotMatch",
    "ValueHandle", "MergeConflict", "Conflict", "BUILTIN_RESOLVERS",
    "choose_one", "append_resolver", "aggregate_resolver", "lca",
    "load_fobject", "make_fobject", "StorageBackend", "ChunkMissing",
    "TamperedChunk", "WriteBuffer", "make_backend",
]
