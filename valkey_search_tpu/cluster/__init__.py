"""Cluster layer: metadata gossip, slot routing, cross-shard query fanout.

Reference: src/coordinator/ (SURVEY.md §2.4) — a gRPC data plane
(GetGlobalMetadata / SearchIndexPartition / InfoIndexPartition,
coordinator.proto:21-31) plus cluster-bus gossip of a top-level
highwayhash fingerprint over all index definitions; mismatching nodes
pull and reconcile per-entry last-writer-wins (metadata_manager.h:138).
Every cross-shard search carries index fingerprint/version and
slot-ownership fingerprints; mismatch → FAILED_PRECONDITION → retry
(server.h:60-65).

device-native mapping: the sharded-corpus data plane lives on the device
mesh (parallel/fanout.py — shard_map + all_gather top-k across devices); this
package is the host control plane: an in-process cluster bus standing in
for gossip/gRPC so N-node behavior (metadata convergence, slot routing,
scatter/gather merge, consistency retries, partial results) runs and
tests without sockets, mirroring how the reference unit-tests cluster
logic against canned CLUSTER SLOTS data (vmsdk cluster_map_test.cc).
"""

from valkey_search_tpu.cluster.metadata import (
    ClusterBus,
    MetadataEntry,
    MetadataManager,
    fingerprint64,
)
from valkey_search_tpu.cluster.node import ClusterEngine, ClusterNode

__all__ = [
    "ClusterBus",
    "MetadataEntry",
    "MetadataManager",
    "fingerprint64",
    "ClusterNode",
    "ClusterEngine",
]
