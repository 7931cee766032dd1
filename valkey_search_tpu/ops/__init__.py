"""Device-side compute kernels (XLA + Pallas).

The reference computes distances with runtime-dispatched SIMD loops
(third_party/hnswlib/space_l2.h:32-235, space_ip.h, third_party/simsimd).
Here every distance is an tensor-core contraction over a batch of queries, and
top-k selection streams over corpus blocks so the full [B, N] score matrix
is never materialized.
"""
