"""Index structures: vector (flat / HNSW), tag, numeric, text.

device-native equivalents of reference src/indexes/: vector indexes are
struct-of-arrays device residents searched by matmul kernels; tag/numeric keep
host-side authoritative structures (postings / sorted arrays) plus device
arrays for predicate fusion.
"""

from valkey_search_tpu.indexes.base import IndexBase, RecordResult  # noqa: F401
from valkey_search_tpu.indexes.flat import FlatVectorIndex  # noqa: F401
