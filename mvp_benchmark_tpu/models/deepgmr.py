"""DeepGMR registration model.

Reference: ``registration/models/deepgmr.py`` — optional RRI features
(:54-95, a torch+numpy hybrid there; fully vectorized jnp here), PointNet
with global-feature concat (:174-197), softmax gamma -> GMM params (:98-120),
closed-form weighted-SVD GMM registration (:123-143; the reference hops to
CPU for ``torch.svd`` — here it is a batched on-device ``jnp.linalg.svd``),
symmetric loss ``mse(T12 Tgt^-1, I) + mse(T21 Tgt, I)`` (:243-246).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from mvp_benchmark_tpu.models import nn
from jax import lax

from mvp_benchmark_tpu import metrics, ops
from mvp_benchmark_tpu.models import layers

_HI = lax.Precision.HIGHEST


def _diamond_key(s: jnp.ndarray, c: jnp.ndarray) -> jnp.ndarray:
    """Pseudo-angle in [0, 4): strictly monotone in atan2(s, c) mod 2pi.

    Piecewise-rational per quadrant — orders angles WITHOUT transcendentals
    (cheaper than an atan2/mod pair per element). (0, 0) maps to 0,
    matching IEEE atan2(0, 0) == 0."""
    zero = (jnp.abs(s) + jnp.abs(c)) == 0.0
    sd = jnp.where(zero, 1.0, 0.0)  # keep denominators non-zero under where
    q1 = s / (s + c + sd)
    q2 = 1.0 + (-c) / (s - c + sd)
    q3 = 2.0 + (-s) / (-s - c + sd)
    q4 = 3.0 + c / (c - s + sd)
    key = jnp.where(
        s >= 0.0, jnp.where(c >= 0.0, q1, q2), jnp.where(c < 0.0, q3, q4)
    )
    return jnp.where(zero, 0.0, key)


def get_rri_features(pts: jnp.ndarray, k: int) -> jnp.ndarray:
    """Rotation-invariant RRI features (deepgmr.py get_rri_cluster:54-95).

    pts: (B, S, 3) -> (B, S, 4k). The reference computes the cross-product /
    argpartition block in numpy on host (non-differentiable); this version
    is one fused jnp graph under an equivalent stop_gradient.

    phi needs only the SECOND-SMALLEST pairwise angle per row (the diagonal
    is 0 = smallest). Ordering runs on the transcendental-free diamond key
    (monotone in the angle); the exact atan2/mod evaluates only at the one
    selected (B, S, k) pair — not all (B, S, k, k) pairs — and lax.top_k's
    per-row sort becomes two masked min-reductions.
    """
    pts = lax.stop_gradient(pts)
    idx = ops.knn_indices(pts, k + 1)[..., 1:]            # exclude self
    q = ops.grouping_operation(pts, idx)                  # (B, S, k, 3)
    p = jnp.broadcast_to(pts[:, :, None, :], q.shape)

    rp = jnp.linalg.norm(p, axis=-1, keepdims=True)
    rq = jnp.linalg.norm(q, axis=-1, keepdims=True)
    pn = p / rp
    qn = q / rq
    dot = jnp.sum(pn * qn, axis=-1, keepdims=True)
    theta = jnp.arccos(jnp.clip(dot, -1.0, 1.0))

    T_q = q - dot * p                                      # (B, S, k, 3)
    # psi[i, j] = atan2((T_q[j] x T_q[i]) . pn[j], T_q[j] . T_q[i]) mod 2pi
    cross = jnp.cross(T_q[:, :, None, :, :], T_q[:, :, :, None, :])
    sin_psi = jnp.sum(cross * pn[:, :, None, :, :], axis=-1)   # (B,S,k,k)
    cos_psi = jnp.sum(T_q[:, :, None, :, :] * T_q[:, :, :, None, :], axis=-1)
    key = _diamond_key(sin_psi, cos_psi)
    # argmin (== the diagonal's 0 barring exact ties), mask that single
    # occurrence, argmin again = second-smallest — same first-index
    # tie-breaks as lax.top_k(-psi, 2).
    i1 = jnp.argmin(key, axis=-1)
    cols = jnp.arange(key.shape[-1])
    key2 = jnp.where(cols == i1[..., None], jnp.inf, key)
    # Select (sin, cos) at the second-smallest index with masked reductions:
    # an iota-compare mask + reduce fuses into one elementwise pass per
    # plane instead of a gather on the minor axis.
    mask2 = cols == jnp.argmin(key2, axis=-1)[..., None]   # (B, S, k, k)
    s_sel = jnp.sum(jnp.where(mask2, sin_psi, 0.0), axis=-1, keepdims=True)
    c_sel = jnp.sum(jnp.where(mask2, cos_psi, 0.0), axis=-1, keepdims=True)
    phi = jnp.mod(jnp.arctan2(s_sel, c_sel), 2.0 * jnp.pi)  # (B, S, k, 1)

    feat = jnp.concatenate([rp, rq, theta, phi], axis=-1)  # (B, S, k, 4)
    B, S = pts.shape[:2]
    return feat.reshape(B, S, 4 * k)


def gmm_params(gamma: jnp.ndarray, pts: jnp.ndarray):
    """Soft GMM parameters (deepgmr.py:98-120).

    gamma: (B, N, J), pts: (B, N, 3) ->
      pi (B, J), mu (B, J, 3), sigma (B, J, 3, 3) (isotropic, like the ref).
    """
    N = gamma.shape[1]
    pi = gamma.mean(axis=1)                               # (B, J)
    Npi = pi * N
    mu = (
        jnp.einsum("bnj,bnc->bjc", gamma, pts,
                   preferred_element_type=jnp.float32, precision=_HI)
        / Npi[..., None]
    )
    diff = pts[:, :, None, :] - mu[:, None, :, :]          # (B, N, J, 3)
    sq = jnp.sum(diff * diff, axis=-1)                     # (B, N, J)
    var = jnp.sum(sq * gamma, axis=1) / Npi                # (B, J)
    eye = jnp.eye(3)
    sigma = var[:, :, None, None] * eye
    return pi, mu, sigma


def gmm_register(pi_s, mu_s, mu_t, sigma_t):
    """Closed-form weighted GMM registration (deepgmr.py:123-143)."""
    c_s = jnp.einsum("bj,bjc->bc", pi_s, mu_s, precision=_HI)[:, None, :]
    c_t = jnp.einsum("bj,bjc->bc", pi_s, mu_t, precision=_HI)[:, None, :]
    sigma_inv = jnp.linalg.inv(sigma_t)                    # (B, J, 3, 3)
    ws = pi_s[:, :, None] * (mu_s - c_s)                   # (B, J, 3)
    Ms = jnp.einsum(
        "bja,bjk,bjkc->bac", ws, (mu_t - c_t), sigma_inv, precision=_HI
    )
    U, _, Vt = jnp.linalg.svd(Ms.astype(jnp.float32))
    V = jnp.swapaxes(Vt, -1, -2)
    det = jnp.linalg.det(
        jnp.matmul(V, jnp.swapaxes(U, -1, -2), precision=_HI)
    )
    S = jnp.tile(jnp.eye(3), (Ms.shape[0], 1, 1))
    S = S.at[:, 2, 2].set(det)
    R = jnp.matmul(jnp.matmul(V, S, precision=_HI),
                   jnp.swapaxes(U, -1, -2), precision=_HI)
    t = jnp.swapaxes(c_t, 1, 2) - jnp.matmul(
        R, jnp.swapaxes(c_s, 1, 2), precision=_HI
    )
    return metrics.rt_to_transformation(R, t)


class TNet(nn.Module):
    """Learned canonical rotation (deepgmr.py:146-171). pts: (B, N, 3)."""

    @nn.compact
    def __call__(self, pts, train: bool):
        h = layers.MLP((64, 128, 256), bn=True, use_bias=False)(pts, train)
        h = jnp.max(h, axis=1)
        h = layers.MLP((128, 64), bn=True, use_bias=False)(h, train)
        f = layers.TorchDense(6)(h)
        r1 = f[:, :3] / jnp.linalg.norm(f[:, :3], axis=1, keepdims=True)
        proj = jnp.sum(r1 * f[:, 3:], axis=1, keepdims=True)
        r2 = f[:, 3:] - proj * r1
        r2 = r2 / jnp.linalg.norm(r2, axis=1, keepdims=True)
        r3 = jnp.cross(r1, r2)
        R = jnp.stack([r1, r2, r3], axis=2)                # (B, 3, 3)
        return jnp.einsum("bij,bnj->bni", jnp.swapaxes(R, 1, 2), pts,
                          precision=_HI)


class PointNet(nn.Module):
    """Per-point group logits (deepgmr.py:174-197). (B,N,C_in)->(B,N,J)."""

    num_groups: int
    use_tnet: bool = False

    @nn.compact
    def __call__(self, feats, train: bool):
        if self.use_tnet:
            feats = TNet()(feats, train)
        f_loc = layers.MLP((64, 128, 256, 1024), bn=True, use_bias=False)(
            feats, train
        )
        f_glob = jnp.max(f_loc, axis=1, keepdims=True)
        # virtual concat [f_loc, tile(f_glob)] into the first decoder layer
        h = layers.DenseCat(512, use_bias=False)(f_loc, f_glob)
        h = nn.relu(layers.BatchNorm()(h, train))
        h = layers.MLP((256, 128), bn=True, use_bias=False)(h, train)
        return layers.TorchDense(self.num_groups)(h)


def build(args) -> "Model":
    return Model(
        num_groups=int(args.num_groups or 16),
        use_rri=bool(args.use_rri),
        rri_size=int(args.rri_size or 20),
        use_tnet=bool(args.use_tnet),
    )


class Model(nn.Module):
    """DeepGMR. forward(pts1, pts2, T_gt, prefix) like the reference Model
    (deepgmr.py:200-255)."""

    num_groups: int = 16
    use_rri: bool = True
    rri_size: int = 20
    use_tnet: bool = False

    @nn.compact
    def __call__(self, pts1, pts2, T_gt=None, prefix: str = "train"):
        train = prefix == "train"
        backbone = PointNet(self.num_groups, self.use_tnet)

        if self.use_rri:
            feats1 = get_rri_features(pts1, self.rri_size)
            feats2 = get_rri_features(pts2, self.rri_size)
        else:
            feats1 = pts1 - pts1.mean(axis=1, keepdims=True)
            feats2 = pts2 - pts2.mean(axis=1, keepdims=True)

        gamma1 = jax.nn.softmax(backbone(feats1, train), axis=2)
        pi1, mu1, sigma1 = gmm_params(gamma1, pts1)
        gamma2 = jax.nn.softmax(backbone(feats2, train), axis=2)
        pi2, mu2, sigma2 = gmm_params(gamma2, pts2)

        T_12 = gmm_register(pi1, mu1, mu2, sigma2)
        if prefix == "test":
            return T_12

        T_21 = gmm_register(pi2, mu2, mu1, sigma1)
        eye = jnp.broadcast_to(jnp.eye(4), T_gt.shape)
        mse1 = jnp.mean(
            (jnp.matmul(T_12, jnp.linalg.inv(T_gt), precision=_HI) - eye) ** 2
        )
        mse2 = jnp.mean((jnp.matmul(T_21, T_gt, precision=_HI) - eye) ** 2)
        loss = mse1 + mse2

        r_err = metrics.rotation_error(T_12[:, :3, :3], T_gt[:, :3, :3])
        t_err = metrics.translation_error(T_12[:, :3, 3], T_gt[:, :3, 3])
        rmse = metrics.rmse_loss(pts1, T_12, T_gt)
        mse = (
            metrics.rotation_geodesic_error(T_12[:, :3, :3], T_gt[:, :3, :3])
            + metrics.translation_error(T_12[:, :3, 3], T_gt[:, :3, 3])
        )
        return loss, r_err, t_err, rmse, mse
