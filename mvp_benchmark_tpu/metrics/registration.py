"""Registration metrics and SE(3) helpers.

Numerics match reference ``registration/train_utils.py:36-100``:
- rotation_error: trace -> clamped acos, DEGREES.
- translation_error: L2 norm.
- rmse_loss: mean point distance between the two transformed clouds.
- rotation_geodesic_error: clamped acos, RADIANS.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
from jax import lax

# Small 3x3/4x4 pose math must not round through bf16 or TF32 (what a
# default-precision f32 matmul may use on an accelerator).
_HI = lax.Precision.HIGHEST


def quat2mat(quat: jnp.ndarray) -> jnp.ndarray:
    """Quaternion (x, y, z, w) batch -> rotation matrices (B, 3, 3).

    Matches reference ``registration/train_utils.py:36-48``.
    """
    x, y, z, w = quat[:, 0], quat[:, 1], quat[:, 2], quat[:, 3]
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    rot = jnp.stack(
        [
            w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
            2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
            2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
        ],
        axis=1,
    ).reshape(-1, 3, 3)
    return rot


def transform_point_cloud(
    point_cloud: jnp.ndarray, rotation: jnp.ndarray, translation: jnp.ndarray
) -> jnp.ndarray:
    """Apply (R|t) to channels-first clouds (B, 3, N), like the reference."""
    rot_mat = quat2mat(rotation) if rotation.ndim == 2 else rotation
    return jnp.matmul(rot_mat, point_cloud, precision=_HI) + translation[..., None]


def rt_to_transformation(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """(B,3,3), (B,3,1) -> homogeneous (B,4,4)."""
    B = R.shape[0]
    bot = jnp.tile(jnp.array([[[0.0, 0.0, 0.0, 1.0]]], R.dtype), (B, 1, 1))
    return jnp.concatenate([jnp.concatenate([R, t], axis=2), bot], axis=1)


def rotation_error(R: jnp.ndarray, R_gt: jnp.ndarray) -> jnp.ndarray:
    """Rotation error in degrees, per sample (B,)."""
    cos_theta = (jnp.einsum("bij,bij->b", R, R_gt) - 1.0) / 2.0
    cos_theta = jnp.clip(cos_theta, -1.0, 1.0)
    return jnp.arccos(cos_theta) * 180.0 / math.pi


def translation_error(t: jnp.ndarray, t_gt: jnp.ndarray) -> jnp.ndarray:
    """Translation L2 error, per sample (B,)."""
    return jnp.linalg.norm(t - t_gt, axis=1)


def rmse_loss(pts: jnp.ndarray, T: jnp.ndarray, T_gt: jnp.ndarray) -> jnp.ndarray:
    """Mean point error between clouds transformed by T vs T_gt.

    pts: (B, N, 3) channels-last; T/T_gt: (B, 4, 4). Returns (B,).
    """
    pts_pred = jnp.matmul(pts, jnp.swapaxes(T[:, :3, :3], 1, 2), precision=_HI) + T[:, :3, 3][:, None, :]
    pts_gt = jnp.matmul(pts, jnp.swapaxes(T_gt[:, :3, :3], 1, 2), precision=_HI) + T_gt[:, :3, 3][:, None, :]
    return jnp.linalg.norm(pts_pred - pts_gt, axis=2).mean(axis=1)


def rotation_geodesic_error(m1: jnp.ndarray, m2: jnp.ndarray) -> jnp.ndarray:
    """Geodesic rotation distance in radians, per sample (B,)."""
    m = jnp.matmul(m1, jnp.swapaxes(m2, 1, 2), precision=_HI)
    cos = (m[:, 0, 0] + m[:, 1, 1] + m[:, 2, 2] - 1.0) / 2.0
    cos = jnp.clip(cos, -1.0, 1.0)
    return jnp.arccos(cos)
