"""PointNet++-style grouping helpers: QueryAndGroup, GroupAll, PointsSampler.

Functional equivalents of the reference wrappers around the CUDA ops
(``utils/mm3d_pn2/ops/group_points/group_points.py:11-163`` and
``utils/mm3d_pn2/ops/furthest_point_sample/points_sampler.py:34-158``),
in channels-last layout.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import jax.numpy as jnp

from mvp_benchmark_tpu.ops import jnp_ref
from mvp_benchmark_tpu.ops.dispatch import furthest_point_sample
from mvp_benchmark_tpu.ops.jnp_ref import (
    ball_query,
    grouping_operation,
    knn_points,
)


@dataclasses.dataclass
class QueryAndGroup:
    """Ball-query (or kNN) grouping with relative-xyz features.

    Mirrors reference ``QueryAndGroup`` (group_points.py:11-122):
    ``max_radius is None`` selects kNN instead of ball query; grouped xyz are
    recentered on the query point and optionally normalized by the radius.

    Call: (points_xyz (B,N,3), center_xyz (B,M,3), features (B,N,C)|None)
      -> grouped (B, M, sample_num, 3+C) channels-last.
    """

    max_radius: Optional[float]
    sample_num: int
    min_radius: float = 0.0
    use_xyz: bool = True
    return_grouped_xyz: bool = False
    normalize_xyz: bool = False

    def __post_init__(self):
        if self.max_radius is None and self.normalize_xyz:
            raise ValueError("cannot normalize grouped xyz when max_radius is None")

    def __call__(self, points_xyz, center_xyz, features=None):
        if self.max_radius is None:
            _, idx = knn_points(center_xyz, points_xyz, self.sample_num)
        else:
            idx = ball_query(
                self.min_radius, self.max_radius, self.sample_num,
                points_xyz, center_xyz,
            )
        grouped_xyz = grouping_operation(points_xyz, idx)  # (B,M,K,3)
        grouped_xyz = grouped_xyz - center_xyz[:, :, None, :]
        if self.normalize_xyz:
            grouped_xyz = grouped_xyz / self.max_radius

        if features is not None:
            grouped_features = grouping_operation(features, idx)
            if self.use_xyz:
                new_features = jnp.concatenate([grouped_xyz, grouped_features], -1)
            else:
                new_features = grouped_features
        else:
            if not self.use_xyz:
                raise ValueError("cannot have no features and not use xyz")
            new_features = grouped_xyz

        if self.return_grouped_xyz:
            return new_features, grouped_xyz
        return new_features


@dataclasses.dataclass
class GroupAll:
    """Group the whole cloud as one neighbourhood (reference GroupAll:125-163).

    Call: (xyz (B,N,3), new_xyz ignored, features (B,N,C)|None)
      -> (B, 1, N, 3+C) channels-last.
    """

    use_xyz: bool = True

    def __call__(self, xyz, new_xyz=None, features=None):
        grouped_xyz = xyz[:, None, :, :]
        if features is not None:
            grouped = features[:, None, :, :]
            if self.use_xyz:
                return jnp.concatenate([grouped_xyz, grouped], -1)
            return grouped
        return grouped_xyz


@dataclasses.dataclass
class PointsSampler:
    """Multi-mode FPS sampler (reference Points_Sampler, points_sampler.py:34-105).

    Modes per segment: 'D-FPS' (xyz distances), 'F-FPS' (xyz+feature
    distances), 'FS' (both, concatenated indices).

    Call: (points_xyz (B,N,3), features (B,N,C)|None) -> idx (B, sum(num_point)).
    """

    num_point: Sequence[int]
    fps_mod_list: Sequence[str] = ("D-FPS",)
    fps_sample_range_list: Sequence[int] = (-1,)

    def __post_init__(self):
        if not (len(self.num_point) == len(self.fps_mod_list)
                == len(self.fps_sample_range_list)):
            raise ValueError("num_point / fps_mod_list / fps_sample_range_list "
                             "must have equal lengths")
        for mod in self.fps_mod_list:
            if mod not in ("D-FPS", "F-FPS", "FS"):
                raise ValueError(f"unsupported fps mode {mod!r}")

    def __call__(self, points_xyz, features=None):
        indices: List[jnp.ndarray] = []
        last = 0
        for rng, mod, npoint in zip(
            self.fps_sample_range_list, self.fps_mod_list, self.num_point
        ):
            if rng == -1:
                pts = points_xyz[:, last:]
                feats = features[:, last:] if features is not None else None
            else:
                pts = points_xyz[:, last:rng]
                feats = features[:, last:rng] if features is not None else None

            if mod == "D-FPS":
                idx = furthest_point_sample(pts, npoint)
            else:
                if feats is None:
                    raise ValueError(f"{mod} requires features")
                ffps_in = jnp.concatenate([pts, feats], -1)
                dist = jnp_ref.square_distance(ffps_in, ffps_in)
                idx_f = jnp_ref.furthest_point_sample_with_dist(dist, npoint)
                if mod == "F-FPS":
                    idx = idx_f
                else:  # FS
                    idx_d = furthest_point_sample(pts, npoint)
                    idx = jnp.concatenate([idx_f, idx_d], 1)
            indices.append(idx + last)
            last += rng
        return jnp.concatenate(indices, axis=1)
