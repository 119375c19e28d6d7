"""Geometry op library (replaces the reference CUDA ops).

Public API (channels-last):

- ``chamfer_distance``, ``emd_auction``               (metric kernels)
- ``furthest_point_sample``, ``furthest_point_sample_with_dist``
- ``ball_query``, ``knn_indices``, ``knn_points``, ``knn_query``
- ``three_nn``, ``three_nn_upsampling``, ``three_interpolate``
- ``gather_points``, ``grouping_operation``, ``group_max``
- ``edge_mlp``, ``sim_mlp``, ``gnn_edge``, ``gnn_propagate`` (per-edge MLPs)
- ``square_distance``

Dispatch policy (``dispatch``): chamfer and FPS run the Triton kernels of
``gpu_kernels`` on the GPU; everything else, and everything on the CPU, is
the plain ``jnp_ref`` formulation. Both share the semantics of the
reference CUDA extensions (see jnp_ref docstrings for file:line citations).
"""

from mvp_benchmark_tpu.ops.jnp_ref import (
    ball_query,
    edge_mlp,
    emd_auction,
    furthest_point_sample_with_dist,
    gather_points,
    gnn_edge,
    gnn_propagate,
    group_max,
    grouping_operation,
    knn_indices,
    knn_points,
    knn_query,
    sim_mlp,
    square_distance,
    three_interpolate,
    three_nn,
    three_nn_upsampling,
    top_k,
)

from mvp_benchmark_tpu.ops.dispatch import (
    chamfer_distance,
    furthest_point_sample,
)

from mvp_benchmark_tpu.ops.grouping import (
    QueryAndGroup,
    GroupAll,
    PointsSampler,
)

__all__ = [
    "ball_query",
    "chamfer_distance",
    "edge_mlp",
    "emd_auction",
    "furthest_point_sample",
    "furthest_point_sample_with_dist",
    "gather_points",
    "gnn_edge",
    "gnn_propagate",
    "group_max",
    "grouping_operation",
    "knn_indices",
    "knn_points",
    "knn_query",
    "sim_mlp",
    "square_distance",
    "three_interpolate",
    "three_nn",
    "three_nn_upsampling",
    "top_k",
    "QueryAndGroup",
    "GroupAll",
    "PointsSampler",
]
