"""IDAM registration model.

Reference: ``registration/models/idam.py`` — GNN edge-conv embedding on a
fixed 12-NN graph (:115-149), significance scores, hard point elimination to
N/6 (train: sampled by gt-match probability via numpy ``batch_choice``
:19-25,238-243 — here ``jax.random.choice`` under key threading; eval: top-k
:245-248), 3 iterations of distance-augmented similarity-matrix convolution +
hybrid point elimination + weighted SVD (:267-342), auxiliary negative-entropy
/ match / weight losses (:300-327).

The FPFH variant (``use_fpfh``) — Open3D CPU features in the reference —
is provided on-device by ``models/fpfh.py`` (33-dim histograms, batched).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from mvp_benchmark_tpu.models import nn
from jax import lax

from mvp_benchmark_tpu import metrics, ops
from mvp_benchmark_tpu.models import layers
from mvp_benchmark_tpu.parallel.mesh import per_shard

_HI = lax.Precision.HIGHEST


class ConvBlock(nn.Module):
    """Conv(BN,ReLU)* -> plain Conv over the last axis (idam.py:73-112).

    ``dtype`` locally overrides the activation policy (the similarity stack
    runs bf16 — see Model below); None follows the global policy."""

    channels: tuple
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, x, train: bool):
        for ch in self.channels[:-1]:
            x = layers.TorchDense(ch, use_bias=False, dtype=self.dtype)(x)
            x = layers.BatchNorm(dtype=self.dtype)(x, train)
            x = nn.relu(x)
        return layers.TorchDense(self.channels[-1], dtype=self.dtype)(x)


class Propagate(nn.Module):
    """Edge conv on a fixed neighbour graph (idam.py:115-128).

    The first 1x1 conv commutes with the gather/subtraction:
    Dense(x_j - x_i) == gather(Dense(x)) - Dense(x), so the projection runs
    on N points (not N*k) and only emb-dim features are gathered. The
    edge build (gather - center, bf16) and the BN -> relu -> Dense -> max_k
    body are ops.gnn_propagate.
    """

    emb_dims: int

    @nn.compact
    def __call__(self, x, idx, train: bool):
        emb = self.emb_dims
        p = layers.TorchDense(emb, use_bias=False)(x)            # (B, N, emb)
        W = self.param("edge_W", layers.torch_linear_init, (emb, emb))
        b = self.param("edge_b", layers.torch_bias_init(emb), (emb,))
        gamma = self.param("edge_scale", nn.initializers.ones, (emb,))
        beta = self.param("edge_bias", nn.initializers.zeros, (emb,))
        ra_mean = self.variable("batch_stats", "edge_mean", jnp.zeros, (emb,))
        ra_var = self.variable("batch_stats", "edge_var", jnp.ones, (emb,))
        h, batch_stats = ops.gnn_propagate(
            p, idx, W, b, gamma, beta, ra_mean.value, ra_var.value, train)
        if train and batch_stats is not None and (
            self.is_mutable_collection("batch_stats")
        ):
            # ra = 0.9 * ra + 0.1 * batch stat (torch
            # BatchNorm momentum 0.1).
            ra_mean.value = 0.9 * ra_mean.value + 0.1 * batch_stats[0]
            ra_var.value = 0.9 * ra_var.value + 0.1 * batch_stats[1]
        return ConvBlock((emb,))(h, train)


class GNN(nn.Module):
    """5-layer propagate stack on 12-NN (idam.py:131-149). (B,N,3)->(B,N,emb)."""

    emb_dims: int = 64

    @nn.compact
    def __call__(self, pts, train: bool):
        idx = ops.knn_indices(pts, 12)
        x = pts
        for dims in (64, 64, 64, 64, self.emb_dims):
            x = Propagate(dims)(x, idx, train)
        return x


def weighted_svd(src, src_corr, weights):
    """Weighted Kabsch head (idam.py:152-188), batched SVD.

    src/src_corr: (B, M, 3), weights: (B, M) normalized. -> R (B,3,3), t (B,3).
    """
    src_centered = src - src.mean(axis=1, keepdims=True)
    corr_centered = src_corr - src_corr.mean(axis=1, keepdims=True)
    H = jnp.einsum(
        "bmc,bmd->bcd", src_centered * weights[..., None], corr_centered,
        preferred_element_type=jnp.float32, precision=_HI,
    )
    R = layers.symmetric_svd_rotation(H)
    t = (
        -jnp.einsum("bij,bj->bi", R,
                    jnp.sum(weights[..., None] * src, axis=1), precision=_HI)
        + jnp.sum(weights[..., None] * src_corr, axis=1)
    )
    return R, t


def _batch_take(x, idx):
    """x: (B, N, ...), idx: (B, M) -> (B, M, ...)."""
    return jax.vmap(lambda a, i: a[i])(x, idx)


def _median_lower(x, axis=-1, keepdims=True):
    """torch.median semantics: lower of the two middle order statistics."""
    n = x.shape[axis]
    s = jnp.sort(x, axis=axis)
    return jnp.take(s, jnp.array([(n - 1) // 2]), axis=axis) if keepdims else (
        jnp.take(s, (n - 1) // 2, axis=axis)
    )


def build(args) -> "Model":
    # emb_dims = 33 if use_fpfh (the FPFH histogram width) else
    # descriptor_size — reference idam.py:194.
    return Model(
        emb_dims=33 if args.use_fpfh else int(args.descriptor_size or 64),
        num_iters=int(args.num_iters or 3),
        use_fpfh=bool(args.use_fpfh),
    )


class Model(nn.Module):
    """IDAM. forward(src, tgt, T_gt, prefix) like the reference Model
    (idam.py:191-355)."""

    emb_dims: int = 64
    num_iters: int = 3
    use_fpfh: bool = False

    @nn.compact
    def __call__(self, src, tgt, T_gt=None, prefix: str = "train"):
        train = prefix == "train"
        B, N, _ = src.shape
        pts = src

        if T_gt is not None:
            R_gt = T_gt[:, :3, :3]
            t_gt = T_gt[:, :3, 3]

        if self.use_fpfh:
            # Non-learned 33-dim FPFH descriptor (reference idam.py:196,
            # model_utils.py:129-148 — Open3D CPU there, on-device here).
            from mvp_benchmark_tpu.models.fpfh import fpfh_features

            emb_nn = lambda p, _train: fpfh_features(p)
        else:
            gnn = GNN(self.emb_dims)
            emb_nn = lambda p, _train: gnn(p, _train)
        significance_fc = ConvBlock((64, 32, 1))

        tgt_embedding = emb_nn(tgt, train)
        src_embedding = emb_nn(src, train)
        src_sig_score = significance_fc(src_embedding, train).squeeze(-1)
        tgt_sig_score = significance_fc(tgt_embedding, train).squeeze(-1)

        num_preserved = N // 6
        if train:
            # gt correspondences + probability-weighted point sampling
            src_gt = (
                jnp.einsum("bij,bnj->bni", R_gt, src, precision=_HI)
                + t_gt[:, None, :]
            )
            d2 = ops.square_distance(src_gt, tgt)
            min_dist = jnp.sqrt(jnp.min(d2, axis=-1))
            min_idx = jnp.argmin(d2, axis=-1)                    # (B, N)
            match_labels_full = (min_dist < 0.05).astype(jnp.float32)
            indicator = match_labels_full + 1e-5
            pos_probs = indicator / indicator.sum(-1, keepdims=True)
            neg_ind = 1.0 + 2e-5 - indicator
            neg_probs = neg_ind / neg_ind.sum(-1, keepdims=True)

            rng = self.make_rng("sample")
            n_pos = num_preserved // 2
            n_neg = num_preserved - n_pos

            def sample(key, p_pos, p_neg):
                k1, k2 = jax.random.split(key)
                pos = jax.random.choice(k1, N, (n_pos,), replace=False, p=p_pos)
                neg = jax.random.choice(k2, N, (n_neg,), replace=False, p=p_neg)
                return jnp.concatenate([pos, neg])

            keys = jax.random.split(rng, B)
            # per_shard: the sampler's top-k would be gathered whole
            # onto every device of a data-parallel mesh.
            src_idx = per_shard(jax.vmap(sample), keys, pos_probs, neg_probs)
            src_idx = lax.stop_gradient(src_idx)
            tgt_idx = jnp.take_along_axis(min_idx, src_idx, axis=1)
            match_labels = jnp.take_along_axis(
                match_labels_full, src_idx, axis=1
            )
        else:
            _, src_idx = ops.top_k(src_sig_score, num_preserved)
            _, tgt_idx = ops.top_k(tgt_sig_score, num_preserved)

        src = _batch_take(src, src_idx)
        src_embedding = _batch_take(src_embedding, src_idx)
        src_sig_score = jnp.take_along_axis(src_sig_score, src_idx, axis=1)
        tgt = _batch_take(tgt, tgt_idx)
        tgt_embedding = _batch_take(tgt_embedding, tgt_idx)
        tgt_sig_score = jnp.take_along_axis(tgt_sig_score, tgt_idx, axis=1)

        M = num_preserved
        R = jnp.broadcast_to(jnp.eye(3), (B, 3, 3))
        t = jnp.zeros((B, 3))
        loss = 0.0

        # The whole (B, M, M, 32) similarity stack — DenseCat over the
        # virtual [src_emb_i, tgt_emb_j, dist_ij, dir_ij] concat, BN, relu,
        # Dense, {max_j head, Dense->BN->relu->Dense(1) logits} — is
        # ops.sim_mlp; the reference materializes the (B, M, M, 2*emb+4)
        # stack (idam.py:267-279).
        emb = self.emb_dims
        SC = 32
        for i in range(self.num_iters):
            Wcat = self.param(f"sim{i}_Wcat", layers.torch_linear_init,
                              (2 * emb + 4, SC))
            W2 = self.param(f"sim{i}_W2", layers.torch_linear_init, (SC, SC))
            b2 = self.param(f"sim{i}_b2", layers.torch_bias_init(SC), (SC,))
            W3 = self.param(f"sim{i}_W3", layers.torch_linear_init, (SC, SC))
            W4 = self.param(f"sim{i}_W4", layers.torch_linear_init, (SC, 1))
            b4 = self.param(f"sim{i}_b4", layers.torch_bias_init(SC), (1,))
            g1 = self.param(f"sim{i}_scale1", nn.initializers.ones, (SC,))
            be1 = self.param(f"sim{i}_bias1", nn.initializers.zeros, (SC,))
            g2 = self.param(f"sim{i}_scale2", nn.initializers.ones, (SC,))
            be2 = self.param(f"sim{i}_bias2", nn.initializers.zeros, (SC,))
            ra = [
                self.variable("batch_stats", f"sim{i}_{nm}",
                              init, (SC,))
                for nm, init in (("mean1", jnp.zeros), ("var1", jnp.ones),
                                 ("mean2", jnp.zeros), ("var2", jnp.ones))
            ]
            sim, wmax, batch_stats = ops.sim_mlp(
                src, tgt, src_embedding, tgt_embedding,
                Wcat, W2, b2, W3, W4, b4, g1, be1, g2, be2,
                ra[0].value, ra[1].value, ra[2].value, ra[3].value, train,
            )
            if train and batch_stats is not None and (
                self.is_mutable_collection("batch_stats")
            ):
                st1, st2 = batch_stats
                # ra = 0.9 * ra + 0.1 * batch stat
                # (torch BatchNorm default momentum 0.1).
                for v, new in zip(ra, (st1[0], st1[1], st2[0], st2[1])):
                    v.value = 0.9 * v.value + 0.1 * new

            weights = ConvBlock((32, 1))(wmax, train).squeeze(-1)

            if train and i == 0:
                src_neg_ent = jax.nn.softmax(sim, axis=-1)
                src_neg_ent = jnp.sum(
                    src_neg_ent * jnp.log(src_neg_ent), axis=-1
                )
                tgt_neg_ent = jax.nn.softmax(sim, axis=-2)
                tgt_neg_ent = jnp.sum(
                    tgt_neg_ent * jnp.log(tgt_neg_ent), axis=-2
                )
                loss = loss + jnp.mean(
                    (src_sig_score - lax.stop_gradient(src_neg_ent)) ** 2
                ) + jnp.mean(
                    (tgt_sig_score - lax.stop_gradient(tgt_neg_ent)) ** 2
                )

            if train:
                temp = jax.nn.softmax(sim, axis=-1)
                diag = jnp.diagonal(temp, axis1=1, axis2=2)
                match_loss = jnp.sum(-jnp.log(diag) * match_labels) / (
                    jnp.sum(match_labels)
                )
                loss = loss + match_loss

            corr_idx = jnp.argmax(sim, axis=-1)
            src_corr = _batch_take(tgt, corr_idx)

            if train:
                weight_labels = (
                    corr_idx == jnp.arange(M)[None, :]
                ).astype(jnp.float32)
                # binary_cross_entropy_with_logits, mean reduction
                weight_loss = jnp.mean(
                    jnp.maximum(weights, 0.0)
                    - weights * weight_labels
                    + jnp.log1p(jnp.exp(-jnp.abs(weights)))
                )
                loss = loss + weight_loss

            weights = jax.nn.sigmoid(weights)
            med = _median_lower(weights, axis=-1)
            weights = weights * (weights >= med).astype(jnp.float32)
            weights = weights / (weights.sum(-1, keepdims=True) + 1e-8)

            rotation_ab, translation_ab = weighted_svd(src, src_corr, weights)
            rotation_ab = lax.stop_gradient(rotation_ab)
            translation_ab = lax.stop_gradient(translation_ab)
            src = (
                jnp.einsum("bij,bnj->bni", rotation_ab, src, precision=_HI)
                + translation_ab[:, None, :]
            )
            R = jnp.matmul(rotation_ab, R, precision=_HI)
            t = (
                jnp.einsum("bij,bj->bi", rotation_ab, t, precision=_HI)
                + translation_ab
            )

        T = metrics.rt_to_transformation(R, t[..., None])
        if T_gt is None:
            return T

        mse = metrics.rotation_geodesic_error(R, R_gt) + metrics.translation_error(
            t, t_gt
        )
        r_err = metrics.rotation_error(R, R_gt)
        t_err = metrics.translation_error(t, t_gt)
        rmse = metrics.rmse_loss(pts, T, T_gt)
        return loss, r_err, t_err, rmse, mse
