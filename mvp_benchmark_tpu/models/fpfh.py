"""Fast Point Feature Histograms (FPFH) — on-device jnp implementation.

The reference IDAM's ``use_fpfh`` path (reference
``registration/model_utils.py:129-148``) hops to Open3D on the CPU per batch
element: normal estimation (hybrid radius/max_nn search) followed by
``compute_fpfh_feature`` -> a 33-dim histogram descriptor per point. That is
a per-sample KD-tree pipeline — this rebuild computes the same
descriptor batched on device from dense distance matrices (fixed 2048-point
clouds make the O(N^2) matrix cheap, SURVEY.md §5 "keep everything dense").

Faithful to Open3D 0.9's algorithm (Feature.cpp / ComputePairFeatures,
ComputeSPFHFeature, ComputeFPFHFeature):

- hybrid neighbourhoods: the ``max_nn`` nearest neighbours, masked to the
  search radius;
- pair features (theta, alpha, phi) in the Darboux frame with the
  source/target swap when ``acos|n1.d| > acos|n2.d|``;
- 3 x 11-bin histograms with ``hist_incr = 100 / (#neighbours)``;
- FPFH = SPFH(p) + per-segment-normalised sum of SPFH(q) / dist^2(p, q)
  (Open3D weights by the KD-tree's SQUARED distance).

NOT bit-identical to Open3D: normal SIGN (Open3D leaves eigenvector sign
arbitrary; here it is fixed deterministically) and degenerate-pair handling
(zero-distance pairs are skipped rather than histogrammed at the zero
feature) differ. The descriptor is non-differentiable in the reference
(numpy round-trip) — ``stop_gradient`` reproduces that.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax import lax

from mvp_benchmark_tpu.ops.jnp_ref import square_distance, top_k


def _fix_sign(n: jnp.ndarray) -> jnp.ndarray:
    """Deterministic eigenvector sign: largest-|component| made positive."""
    comp = jnp.take_along_axis(
        n, jnp.argmax(jnp.abs(n), axis=-1, keepdims=True), axis=-1
    )
    s = jnp.where(comp >= 0, 1.0, -1.0)
    return n * s


def estimate_normals(
    xyz: jnp.ndarray, radius: float = 0.1, max_nn: int = 30
) -> jnp.ndarray:
    """PCA normals over hybrid (radius, max_nn) neighbourhoods.

    xyz: (B, N, 3) -> unit normals (B, N, 3). Mirrors Open3D
    ``estimate_normals(KDTreeSearchParamHybrid(radius, max_nn))`` with a
    deterministic sign convention.
    """
    B, N, _ = xyz.shape
    k = min(max_nn, N)
    d2 = square_distance(xyz, xyz)
    neg, idx = top_k(-d2, k)                              # self first
    valid = (-neg) <= radius * radius                     # (B, N, k)
    pts = jax.vmap(lambda p, i: p[i])(xyz, idx)           # (B, N, k, 3)
    w = valid[..., None].astype(jnp.float32)
    cnt = jnp.maximum(jnp.sum(w, axis=2), 1.0)            # (B, N, 1)
    mu = jnp.sum(pts * w, axis=2) / cnt
    diff = (pts - mu[:, :, None, :]) * w
    cov = jnp.einsum("bnkc,bnkd->bncd", diff, diff)
    _, evecs = jnp.linalg.eigh(cov)                       # ascending
    normal = evecs[..., :, 0]                             # smallest eigval
    norm = jnp.linalg.norm(normal, axis=-1, keepdims=True)
    normal = jnp.where(norm > 0, normal / jnp.maximum(norm, 1e-12),
                       jnp.array([0.0, 0.0, 1.0]))
    return _fix_sign(normal)


def _pair_features(p1, n1, p2, n2):
    """Open3D ComputePairFeatures, vectorized. Inputs broadcast to
    (..., 3); returns (theta, alpha, phi, dist) each (...,)."""
    d = p2 - p1
    dist = jnp.linalg.norm(d, axis=-1)
    ok = dist > 0
    dsafe = jnp.where(ok[..., None], d / jnp.maximum(dist, 1e-12)[..., None], 0.0)
    angle1 = jnp.sum(n1 * dsafe, axis=-1)
    angle2 = jnp.sum(n2 * dsafe, axis=-1)
    # acos|a1| > acos|a2|  <=>  |a1| < |a2|  -> swap source/target.
    swap = jnp.abs(angle1) < jnp.abs(angle2)
    n1c = jnp.where(swap[..., None], n2, n1)
    n2c = jnp.where(swap[..., None], n1, n2)
    dd = jnp.where(swap[..., None], -dsafe, dsafe)
    phi = jnp.where(swap, -angle2, angle1)
    v = jnp.cross(dd, n1c)
    vnorm = jnp.linalg.norm(v, axis=-1)
    ok = ok & (vnorm > 0)
    v = v / jnp.maximum(vnorm, 1e-12)[..., None]
    w = jnp.cross(n1c, v)
    alpha = jnp.sum(v * n2c, axis=-1)
    theta = jnp.arctan2(jnp.sum(w * n2c, axis=-1), jnp.sum(n1c * n2c, axis=-1))
    return theta, alpha, phi, dist, ok


def _hist11(values, lo, hi, weights):
    """Weighted 11-bin histogram over the last axis -> (..., 11)."""
    b = jnp.floor(11.0 * (values - lo) / (hi - lo)).astype(jnp.int32)
    b = jnp.clip(b, 0, 10)
    onehot = (b[..., None] == jnp.arange(11)).astype(jnp.float32)
    return jnp.sum(onehot * weights[..., None], axis=-2)


def fpfh_features(
    xyz: jnp.ndarray,
    radius_normal: float = 0.1,
    radius_feature: float = 0.2,
    max_nn_normal: int = 30,
    max_nn_feature: int = 100,
) -> jnp.ndarray:
    """33-dim FPFH descriptors. xyz: (B, N, 3) -> (B, N, 33).

    Matches the reference FPFH module's protocol (radius_normal=0.1,
    radius_feature=0.2; reference ``registration/model_utils.py:129-133``,
    Open3D hybrid search caps 30/100).
    """
    xyz = lax.stop_gradient(xyz)
    B, N, _ = xyz.shape
    normals = estimate_normals(xyz, radius_normal, max_nn_normal)

    k = min(max_nn_feature, N)
    d2 = square_distance(xyz, xyz)
    neg, idx = top_k(-d2, k)                              # self first
    nd2 = -neg                                            # (B, N, k) squared
    valid = (nd2 <= radius_feature * radius_feature) & (nd2 > 0)

    take = jax.vmap(lambda a, i: a[i])
    p2 = take(xyz, idx)                                   # (B, N, k, 3)
    n2 = take(normals, idx)
    theta, alpha, phi, _, ok = _pair_features(
        xyz[:, :, None, :], normals[:, :, None, :], p2, n2
    )
    valid = valid & ok
    cnt = jnp.sum(valid, axis=-1)                         # neighbours used
    hist_incr = jnp.where(cnt > 0, 100.0 / jnp.maximum(cnt, 1), 0.0)
    wgt = valid.astype(jnp.float32) * hist_incr[..., None]

    spfh = jnp.concatenate(
        [
            _hist11(theta, -math.pi, math.pi, wgt),
            _hist11(alpha, -1.0, 1.0, wgt),
            _hist11(phi, -1.0, 1.0, wgt),
        ],
        axis=-1,
    )                                                     # (B, N, 33)

    # FPFH: neighbour SPFHs weighted by 1 / squared distance, each 11-bin
    # segment renormalised to sum 100, plus the point's own SPFH.
    wdist = jnp.where(valid, 1.0 / jnp.maximum(nd2, 1e-12), 0.0)
    neigh_spfh = take(spfh, idx)                          # (B, N, k, 33)
    acc = jnp.einsum("bnk,bnkc->bnc", wdist, neigh_spfh)
    seg = acc.reshape(B, N, 3, 11)
    seg_sum = jnp.sum(seg, axis=-1, keepdims=True)
    seg = jnp.where(seg_sum > 0, seg * (100.0 / jnp.maximum(seg_sum, 1e-12)),
                    0.0)
    return seg.reshape(B, N, 33) + spfh
