"""valkey_search_tpu — a device-native vector index-and-query engine.

A from-scratch reimplementation of the capabilities of valkey-io/valkey-search
(reference layout surveyed in SURVEY.md) designed accelerator-first:

- distances run as matmul tiles (ops/distance.py) instead of SIMD loops
  (reference: third_party/hnswlib/space_l2.h, space_ip.h, simsimd),
- flat exact KNN is a blocked scan + streaming top-k (ops/topk.py; reference:
  third_party/hnswlib/bruteforce.h),
- HNSW is a device-resident neighbor-list array searched by batched beam
  search (ops/hnsw_search.py; reference: third_party/hnswlib/hnswalg.h),
- hybrid tag/numeric predicates become device bitmasks fused into the
  distance kernels (reference: src/indexes/tag.h, src/indexes/numeric.h,
  src/query/planner.cc),
- the cluster coordinator's scatter/gather fanout becomes corpus sharding
  over a jax.sharding.Mesh with an all-gather top-k merge (parallel/;
  reference: src/query/fanout.cc, src/coordinator/).

Public API mirrors the reference's command surface (FT.CREATE / FT.SEARCH /
FT.AGGREGATE / FT.INFO / FT.DROPINDEX / FT._LIST / FT._DEBUG; reference:
src/module_loader.cc:33-129) through `valkey_search_tpu.server`.
"""

from valkey_search_tpu.version import __version__  # noqa: F401

__all__ = ["__version__"]
