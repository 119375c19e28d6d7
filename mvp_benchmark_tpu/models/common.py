"""Model-utility layer shared by the completion models.

Channels-last rebuild of reference ``completion/model_utils.py``:
``edge_preserve_sampling`` (:88-110), ``EF_expansion`` (:26-55),
``get_uniform_loss`` (:201-227), ``get_repulsion_loss`` (:181-198),
``symmetric_sample`` (:275-283), ``gen_grid`` (:127-137).
"""

from __future__ import annotations

import math
from typing import Tuple

import jax.numpy as jnp
from mvp_benchmark_tpu.models import nn

from mvp_benchmark_tpu import ops
from mvp_benchmark_tpu.models import layers


def edge_preserve_sampling(
    features: jnp.ndarray, points: jnp.ndarray, num_samples: int, k: int = 10,
    knn_idx: jnp.ndarray | None = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """FPS + kNN max-pooled neighbourhood features (model_utils.py:88-110).

    features: (B, N, C), points: (B, N, 3) ->
      (net (B, M, 2C), p_idx (B, M), pn_idx (B, M, pk), sampled points (B, M, 3))

    knn_idx: optional precomputed SELF-kNN of ``points`` (B, N, k') with
    k' >= pk. The sampled centers are a subset of ``points``, so their
    pk-NN rows are exactly rows of the self-kNN table (same top-k, same
    tie-breaking, neighbours in ascending-distance order —
    slicing the first pk of a k'-NN list IS the pk-NN list). Passing it
    replaces this call's full (M, N) kNN with an O(M*k') row gather.
    """
    N = points.shape[1]
    p_idx = ops.furthest_point_sample(points, num_samples)
    point_output = ops.gather_points(points, p_idx)

    pk = min(k, N)
    if knn_idx is not None and knn_idx.shape[-1] >= pk:
        pn_idx = jnp.take_along_axis(
            knn_idx[..., :pk], p_idx[:, :, None], axis=1
        )
    else:
        _, pn_idx = ops.knn_points(point_output, points, pk)
    neighbor = ops.group_max(features, pn_idx)
    center = ops.gather_points(features, p_idx)
    net = jnp.concatenate([center, neighbor], axis=-1)
    return net, p_idx, pn_idx, point_output


class EFExpansion(nn.Module):
    """Edge-feature expansion upsampler (model_utils.py:26-55).

    (B, N, C) -> (B, N * step_ratio, output_size).
    """

    input_size: int
    output_size: int = 64
    step_ratio: int = 2
    k: int = 4

    @nn.compact
    def __call__(self, x):
        B, N, C = x.shape
        edge_in = layers.get_graph_feature(
            x, self.k, minus_center=False, include_center_first=True
        )  # (B, N, k, 2C)
        h = layers.TorchDense(self.output_size)(edge_in)
        h = nn.relu(jnp.concatenate([h, edge_in], axis=-1))
        h = nn.relu(layers.TorchDense(self.output_size * self.step_ratio)(h))
        # (B, N, k, sr*out) -> (B, N*sr, k, out): the sr*out channel block of
        # point n becomes sr new points (reference reshape at :47-50).
        h = h.transpose(0, 2, 1, 3)                       # (B, k, N, sr*out)
        h = h.reshape(B, self.k, N * self.step_ratio, self.output_size)
        h = h.transpose(0, 2, 1, 3)                       # (B, N*sr, k, out)
        h = layers.TorchDense(self.output_size)(h)
        return jnp.max(h, axis=2)


def get_uniform_loss(
    pcd: jnp.ndarray,
    percentages=(0.004, 0.006, 0.008, 0.010, 0.012),
    radius: float = 1.0,
) -> jnp.ndarray:
    """Surface-uniformity loss (model_utils.py:201-227). pcd: (B, N, 3)."""
    B, N, _ = pcd.shape
    npoint = int(N * 0.05)
    loss = 0.0
    # FPS is deterministic: the reference recomputes the identical sampling
    # inside every percentage iteration (model_utils.py:209-210); hoist it.
    fps_idx = ops.furthest_point_sample(pcd, npoint)
    new_xyz = ops.gather_points(pcd, fps_idx)
    for p in percentages:
        nsample = int(N * p)
        if nsample < 2:
            # Tiny clouds (tests): a <2-point disk has no nearest-neighbour
            # spacing to score; the reference never hits this (N=2048 ->
            # nsample >= 8).
            continue
        r = math.sqrt(p * radius)
        disk_area = math.pi * radius**2 * p / nsample
        idx = ops.ball_query(0.0, r, nsample, pcd, new_xyz)
        expect_len = math.sqrt(disk_area)

        grouped = ops.grouping_operation(pcd, idx)       # (B, npoint, ns, 3)
        grouped = grouped.reshape(-1, nsample, 3)

        var, _ = ops.knn_points(grouped, grouped, 2)
        uniform_dis = -var[:, :, 1:]                      # squared dists
        uniform_dis = jnp.sqrt(jnp.abs(uniform_dis) + 1e-8)
        uniform_dis = jnp.mean(uniform_dis, axis=-1)
        uniform_dis = (uniform_dis - expect_len) ** 2 / (expect_len + 1e-8)
        loss += jnp.mean(uniform_dis) * math.pow(p * 100, 2)
    return loss / len(percentages)


def get_repulsion_loss(
    pred: jnp.ndarray, nsample: int = 20, radius: float = 0.07
) -> jnp.ndarray:
    """Repulsion loss (model_utils.py:181-198). pred: (B, N, 3)."""
    idx = ops.knn_indices(pred, nsample)
    grouped = ops.grouping_operation(pred, idx) - pred[:, :, None, :]
    dist_square = jnp.sum(grouped**2, axis=-1)           # (B, N, nsample)
    neg_top, _ = ops.top_k(-dist_square, 5)
    dist_square = -neg_top[:, :, 1:]                     # drop self
    dist_square = jnp.maximum(dist_square, 1e-12)
    dist = jnp.sqrt(dist_square)
    h = 0.03
    weight = jnp.exp(-dist_square / h**2)
    return jnp.mean(radius - dist * weight)


def symmetric_sample(points: jnp.ndarray, num: int = 512) -> jnp.ndarray:
    """FPS subset + z-mirrored copy (model_utils.py:275-283)."""
    idx = ops.furthest_point_sample(points, num)
    fps = ops.gather_points(points, idx)
    flipped = jnp.concatenate(
        [fps[..., 0:1], fps[..., 1:2], -fps[..., 2:3]], axis=-1
    )
    return jnp.concatenate([fps, flipped], axis=1)


def gen_grid(num_grid_point: int) -> jnp.ndarray:
    """(num^2, 2) grid in [-0.05, 0.05] (model_utils.py:127-131)."""
    x = jnp.linspace(-0.05, 0.05, num_grid_point)
    gx, gy = jnp.meshgrid(x, x, indexing="ij")
    return jnp.stack([gx, gy], axis=-1).reshape(num_grid_point**2, 2)
