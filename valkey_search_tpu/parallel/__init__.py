"""Distributed execution over a device mesh.

device-native replacement for the reference's cluster layer (L6): the gRPC
coordinator fanout (src/query/fanout.cc, src/coordinator/) becomes corpus
sharding over a `jax.sharding.Mesh` axis with an all-gather top-k merge
riding the interconnect, and the shard/index fingerprint consistency checks
(src/coordinator/server.h:60-65) become device-side version scalars
compared inside the collective program.
"""
