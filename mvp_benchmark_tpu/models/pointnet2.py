"""PointNet++ set-abstraction / feature-propagation modules.

Channels-last flax rebuild of the reference's vendored mm3d_pn2 modules
(``utils/mm3d_pn2/ops/pointnet_modules/point_sa_module.py:12-230`` and
``point_fp_module.py:10-77``) — not used by the six benchmark models but part
of the op library's public API (SURVEY.md §2.3).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax.numpy as jnp
from mvp_benchmark_tpu.models import nn

from mvp_benchmark_tpu import ops
from mvp_benchmark_tpu.models import layers


class SharedMLP(nn.Module):
    """Conv(1x1)+BN+ReLU stack on the last axis."""

    channels: Sequence[int]

    @nn.compact
    def __call__(self, x, train: bool):
        for ch in self.channels:
            x = layers.TorchDense(ch, use_bias=False)(x)
            x = layers.BatchNorm()(x, train)
            x = nn.relu(x)
        return x


class PointSAModuleMSG(nn.Module):
    """Multi-scale-grouping set abstraction (point_sa_module.py:12-128).

    Call: (points_xyz (B, N, 3), features (B, N, C)|None) ->
      (new_xyz (B, num_point, 3), new_features (B, num_point, sum(mlps[-1])),
       indices (B, num_point)).
    """

    num_point: int
    radii: Sequence[Optional[float]]
    sample_nums: Sequence[int]
    mlp_channels: Sequence[Sequence[int]]
    fps_mod: Sequence[str] = ("D-FPS",)
    fps_sample_range_list: Sequence[int] = (-1,)
    use_xyz: bool = True
    pool_mod: str = "max"
    normalize_xyz: bool = False

    @nn.compact
    def __call__(self, points_xyz, features=None, train: bool = True):
        sampler = ops.PointsSampler(
            [self.num_point], self.fps_mod, self.fps_sample_range_list
        )
        indices = sampler(points_xyz, features)
        new_xyz = ops.gather_points(points_xyz, indices)

        outs = []
        for radius, ns, mlp in zip(self.radii, self.sample_nums,
                                   self.mlp_channels):
            grouper = ops.QueryAndGroup(
                max_radius=radius, sample_num=ns, use_xyz=self.use_xyz,
                normalize_xyz=self.normalize_xyz,
            )
            grouped = grouper(points_xyz, new_xyz, features)  # (B,M,ns,C)
            h = SharedMLP(mlp)(grouped, train)
            if self.pool_mod == "max":
                h = jnp.max(h, axis=2)
            elif self.pool_mod == "avg":
                h = jnp.mean(h, axis=2)
            else:
                raise ValueError(f"unsupported pool_mod {self.pool_mod!r}")
            outs.append(h)
        return new_xyz, jnp.concatenate(outs, axis=-1), indices


class PointSAModule(nn.Module):
    """Single-scale set abstraction (point_sa_module.py:131-230)."""

    mlp_channels: Sequence[int]
    num_point: Optional[int] = None
    radius: Optional[float] = None
    num_sample: Optional[int] = None
    use_xyz: bool = True
    pool_mod: str = "max"
    normalize_xyz: bool = False

    @nn.compact
    def __call__(self, points_xyz, features=None, train: bool = True):
        if self.num_point is None:
            # GroupAll: one global neighbourhood.
            grouped = ops.GroupAll(self.use_xyz)(points_xyz, None, features)
            h = SharedMLP(self.mlp_channels)(grouped, train)
            h = jnp.max(h, 2) if self.pool_mod == "max" else jnp.mean(h, 2)
            return None, h, None
        msg = PointSAModuleMSG(
            num_point=self.num_point, radii=(self.radius,),
            sample_nums=(self.num_sample,), mlp_channels=(self.mlp_channels,),
            use_xyz=self.use_xyz, pool_mod=self.pool_mod,
            normalize_xyz=self.normalize_xyz,
        )
        return msg(points_xyz, features, train)


class PointFPModule(nn.Module):
    """Feature propagation via 3-NN inverse-distance interpolation
    (point_fp_module.py:10-77).

    Call: (target (B, N, 3), source (B, M, 3), target_feats (B, N, C1)|None,
           source_feats (B, M, C2)) -> (B, N, mlp[-1]).
    """

    mlp_channels: Sequence[int]

    @nn.compact
    def __call__(self, target, source, target_feats, source_feats,
                 train: bool = True):
        if source is not None:
            idx, weight = ops.three_nn_upsampling(target, source)
            interpolated = ops.three_interpolate(source_feats, idx, weight)
        else:
            interpolated = jnp.broadcast_to(
                source_feats, (target.shape[0], target.shape[1],
                               source_feats.shape[-1])
            )
        if target_feats is not None:
            h = jnp.concatenate([interpolated, target_feats], axis=-1)
        else:
            h = interpolated
        return SharedMLP(self.mlp_channels)(h, train)
