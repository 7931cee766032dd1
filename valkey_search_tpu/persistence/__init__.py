"""Checkpoint / restore (the reference's chunked aux-RDB equivalent).

Reference: src/rdb_serialization.{h,cc} + rfc/rdb-format.md — versioned
RDBSection records with streamed SupplementalContent chunks so huge HNSW
graphs serialize without an in-memory copy, a min-semantic-version header
for up/downgrade gating, vector graphs + key→id+magnitude maps saved,
non-vector indexes rebuilt on load from the key list, and a skip-load
config that drops the vector payload and rebuilds via backfill.

Device design: device state is already struct-of-arrays on the host
(HostVectorStore + native graph), so a checkpoint is a framed stream of
(json section header, raw ndarray chunks) — the orbax-style chunked host
streaming SURVEY.md §5.4 calls for, without the orbax dependency.
"""

from valkey_search_tpu.persistence.format import ChunkReader, ChunkWriter, FormatError
from valkey_search_tpu.persistence.checkpoint import (
    CheckpointError,
    load_engine,
    save_engine,
)

__all__ = [
    "ChunkReader",
    "ChunkWriter",
    "FormatError",
    "CheckpointError",
    "save_engine",
    "load_engine",
]
