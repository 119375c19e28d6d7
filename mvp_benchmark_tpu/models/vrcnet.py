"""VRCNet completion model — the flagship/perf config.

Reference: ``completion/models/vrcnet.py`` — dual-path probabilistic
completion: PCN encoder -> posterior/prior nets (``Linear_ResBlock`` :95-105)
-> KLD (or MMD) distribution loss -> ``MSAP_SKN_decoder`` (:299-409) with
point self-attention (``SA_module`` :21-57), selective-kernel attention
(``SK_SA_module`` :108-155), a 4-level edge pool/unpool pyramid
(pts 3072->1536->768->384, ``SA_SKN_Res_encoder`` :179-296), FPS +
learned-score top-k selection (:380-393), local folding (:60-92). Train
duplicates the batch (reconstruction path on FPS-resampled gt + completion
path, :450-454); loss ``10 L1 + 0.5 L2 + L3 + a L4 + 20 (KL_rec + KL_g)``
(:516-517).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from mvp_benchmark_tpu.models import nn
from jax import lax

from mvp_benchmark_tpu import ops
from mvp_benchmark_tpu.metrics import calc_cd, calc_emd
from mvp_benchmark_tpu.models import common, layers


class LinearResBlock(nn.Module):
    """FC residual block (vrcnet.py:95-105)."""

    output_size: int

    @nn.compact
    def __call__(self, x):
        h = nn.relu(layers.TorchDense(x.shape[-1])(nn.relu(x)))
        return layers.TorchDense(self.output_size)(h) + layers.TorchDense(
            self.output_size
        )(x)


class SAModule(nn.Module):
    """Point self-attention over kNN groups (vrcnet.py:21-57).

    x: (B, N, C) with fixed neighbour idx (B, N, k). Returns (B, N, out).
    """

    rel_planes: int
    mid_planes: int
    out_planes: int
    share_planes: int = 8
    k: int = 16

    @nn.compact
    def __call__(self, x, idx):
        rel, mid, share, k = (
            self.rel_planes, self.mid_planes, self.share_planes, self.k
        )
        ms = mid // share
        identity = x
        h = nn.relu(x)
        # 1x1 convs commute with the neighbour gather: project to the small
        # rel/mid widths FIRST, then gather ONE concatenated (rel+mid)-dim
        # tensor — identical math/params to Dense(grouping(h)) with
        # (rel+mid)/C of the gather/scatter traffic and a single gather's
        # row overhead. The three heads (x1-rel, proj-rel, proj-mid) run as
        # ONE concatenated GEMM (layers.MultiDense).
        y = layers.MultiDense((rel, rel, mid))(h)          # (B, N, 2rel+mid)
        x1 = y[..., :rel]                                  # (B, N, rel)
        proj = y[..., rel:]                                # (B, N, rel+mid)
        # w-MLP parameters (reference vrcnet.py:36-41: Dense(ms, no bias),
        # Dense(k*ms)).
        W1 = self.param("w_mlp1", layers.torch_linear_init,
                        ((1 + k) * rel, ms))
        W2 = self.param("w_mlp2", layers.torch_linear_init, (ms, k * ms))
        b_bound = 1.0 / math.sqrt(ms)
        b2 = self.param(
            "w_mlp2_bias",
            lambda key, s: jax.random.uniform(
                key, s, jnp.float32, -b_bound, b_bound
            ),
            (k * ms,),
        )

        B, N = h.shape[:2]
        pn = ops.grouping_operation(proj, idx)             # (B, N, k, C)
        x2 = pn[..., :rel].reshape(B, N, k * rel)
        x3 = pn[..., rel:]
        w = nn.relu(jnp.concatenate([x1, x2], axis=-1))
        u = nn.relu(jnp.dot(w, W1, preferred_element_type=jnp.float32))
        w = jnp.dot(u, W2, preferred_element_type=jnp.float32) + b2
        w = w.reshape(B, N, k, ms)
        w = jnp.tile(w, (1, 1, 1, share))
        out = jnp.sum(w * x3, axis=2)                      # (B, N, mid)
        out = nn.relu(out)
        out = layers.TorchDense(self.out_planes)(out)
        return out + identity


class SKSAModule(nn.Module):
    """Selective-kernel attention over SA branches (vrcnet.py:108-155)."""

    rel_planes: int
    mid_planes: int
    out_planes: int
    share_planes: int = 8
    k: Sequence[int] = (10, 20)
    r: int = 2
    L: int = 32

    @nn.compact
    def __call__(self, x, idxs):
        assert len(self.k) == len(idxs)
        d = max(self.out_planes // self.r, self.L)
        feas = []
        for i, ki in enumerate(self.k):
            fea = SAModule(self.rel_planes, self.mid_planes, self.out_planes,
                           self.share_planes, ki)(x, idxs[i])
            feas.append(nn.relu(fea))
        feas = jnp.stack(feas, axis=1)                     # (B, nk, N, C)

        fea_U = jnp.sum(feas, axis=1)                      # (B, N, C)
        fea_s = fea_U.mean(axis=1)                         # (B, C)
        fea_z = layers.TorchDense(d)(fea_s)
        vectors = jnp.stack(
            [layers.TorchDense(self.out_planes)(fea_z) for _ in self.k],
            axis=1,
        )                                                  # (B, nk, C)
        attn = jax.nn.softmax(vectors, axis=1)[:, :, None, :]
        return jnp.sum(feas * attn, axis=1)


class SKNResUnit(nn.Module):
    """SK-SA residual unit (vrcnet.py:158-176)."""

    output_size: int
    k: Sequence[int]
    layers_n: int = 1

    @nn.compact
    def __call__(self, feat, idxs):
        x = layers.TorchDense(self.output_size, use_bias=False)(feat)
        for _ in range(self.layers_n):
            x = SKSAModule(
                self.output_size // 16, self.output_size // 4,
                self.output_size, 8, self.k,
            )(x, idxs)
        x = layers.TorchDense(self.output_size, use_bias=False)(nn.relu(x))
        return x + layers.TorchDense(self.output_size, use_bias=False)(feat)


class SASKNResEncoder(nn.Module):
    """4-level SK-SA pyramid with edge pool/unpool (vrcnet.py:179-296).

    features: (B, N, C_in) with xyz in the first 3 channels.
    """

    k: Sequence[int] = (10, 20)
    pk: int = 16
    output_size: int = 64
    layers_cfg: Sequence[int] = (2, 2, 2, 2)
    pts_num: Sequence[int] = (3072, 1536, 768, 384)
    dropout_rate: float = 0.5

    def _knn_idxs(self, pts):
        return [ops.knn_indices(pts, ki) for ki in self.k]

    def _eps_idx(self, idxs):
        """Widest precomputed self-kNN branch usable by edge_preserve_sampling
        (its pk-NN rows are a prefix-slice + row-gather of any k >= pk self-kNN
        — see common.edge_preserve_sampling). None if every branch is narrower.
        """
        widest = max(range(len(self.k)), key=lambda i: self.k[i])
        return idxs[widest] if self.k[widest] >= self.pk else None

    @nn.compact
    def __call__(self, features, train: bool):
        B = features.shape[0]
        pt1 = features[..., 0:3]
        c1 = 64

        idx1 = self._knn_idxs(pt1)
        x = SKNResUnit(c1, self.k, self.layers_cfg[0])(features, idx1)
        x1 = nn.relu(x)

        x, _, _, pt2 = common.edge_preserve_sampling(
            x1, pt1, self.pts_num[1], self.pk, knn_idx=self._eps_idx(idx1)
        )
        idx2 = self._knn_idxs(pt2)
        x = SKNResUnit(c1 * 2, self.k, self.layers_cfg[1])(x, idx2)
        x2 = nn.relu(x)

        x, _, _, pt3 = common.edge_preserve_sampling(
            x2, pt2, self.pts_num[2], self.pk, knn_idx=self._eps_idx(idx2)
        )
        idx3 = self._knn_idxs(pt3)
        x = SKNResUnit(c1 * 4, self.k, self.layers_cfg[2])(x, idx3)
        x3 = nn.relu(x)

        x, _, _, pt4 = common.edge_preserve_sampling(
            x3, pt3, self.pts_num[3], self.pk, knn_idx=self._eps_idx(idx3)
        )
        idx4 = self._knn_idxs(pt4)
        x = SKNResUnit(c1 * 8, self.k, self.layers_cfg[3])(x, idx4)
        x4 = nn.relu(x)

        x = layers.TorchDense(1024)(x4)
        x = jnp.max(x, axis=1)
        drop = nn.Dropout(self.dropout_rate, deterministic=not train)
        x = drop(nn.relu(layers.TorchDense(512)(x)))
        x = drop(nn.relu(layers.TorchDense(1024)(x)))

        # virtual concat [tile(global), x4] (layers.DenseCat)
        x = nn.relu(layers.DenseCat(c1 * 8)(x[:, None, :], x4))
        idx, w = ops.three_nn_upsampling(pt3, pt4)
        x = ops.three_interpolate(x, idx, w)
        x = nn.relu(layers.TorchDense(c1 * 4)(
            jnp.concatenate([x, x3], axis=-1)
        ))
        idx, w = ops.three_nn_upsampling(pt2, pt3)
        x = ops.three_interpolate(x, idx, w)
        x = nn.relu(layers.TorchDense(c1 * 2)(
            jnp.concatenate([x, x2], axis=-1)
        ))
        idx, w = ops.three_nn_upsampling(pt1, pt2)
        x = ops.three_interpolate(x, idx, w)
        x = nn.relu(layers.TorchDense(c1)(
            jnp.concatenate([x, x1], axis=-1)
        ))
        return layers.TorchDense(self.output_size)(x)


class Folding(nn.Module):
    """Local folding upsampler (vrcnet.py:60-92).

    point_feat: (B, N, C), global_feat: (B, G) ->
      (B, N * step_ratio, output_size).
    """

    output_size: int
    step_ratio: int

    @nn.compact
    def __call__(self, point_feat, global_feat):
        B, N, C = point_feat.shape
        sr = self.step_ratio
        pf = jnp.repeat(point_feat, sr, axis=1)            # (B, N*sr, C)
        gf = global_feat[:, None, :]                       # broadcast lazily
        # grid: linspace over [-0.2, 0.2]; tiled per input point
        # (reference builds it via gen_grid_up-style factorization).
        sqrted = int(math.sqrt(sr)) + 1
        num_x, num_y = 1, sr
        for i in reversed(range(1, sqrted + 1)):
            if sr % i == 0:
                num_x, num_y = i, sr // i
                break
        gx = jnp.linspace(-0.2, 0.2, num_x)
        gy = jnp.linspace(-0.2, 0.2, num_y)
        mx, my = jnp.meshgrid(gx, gy, indexing="ij")
        grid = jnp.stack([mx, my], axis=-1).reshape(-1, 2)  # (sr, 2)
        grid_feat = jnp.tile(grid, (N, 1))                  # (N*sr, 2)
        grid_feat = jnp.broadcast_to(grid_feat[None], (B, N * sr, 2))
        # virtual concat [tile(global), point, grid] (layers.DenseCat)
        return nn.relu(layers.DenseCat(self.output_size)(gf, pf, grid_feat))


class MSAPSKNDecoder(nn.Module):
    """Multi-scale attentive decoder (vrcnet.py:299-409)."""

    num_coarse_raw: int
    num_fps: int
    num_coarse: int
    num_fine: int
    layers_cfg: Sequence[int] = (2, 2, 2, 2)
    knn_list: Sequence[int] = (10, 20)
    pk: int = 10
    points_label: bool = False
    local_folding: bool = False

    @nn.compact
    def __call__(self, global_feat, point_input, train: bool):
        B = global_feat.shape[0]
        dense_feature_size = 256
        expand_feature_size = 64

        h = nn.relu(layers.TorchDense(1024)(global_feat))
        h = nn.relu(layers.TorchDense(1024)(h))
        coarse_raw = layers.TorchDense(self.num_coarse_raw * 3,
                                       dtype=jnp.float32)(h)
        coarse_raw = coarse_raw.reshape(B, self.num_coarse_raw, 3)

        input_points_num = point_input.shape[1]
        org_points_input = point_input

        if self.points_label:
            id0 = jnp.zeros((B, self.num_coarse_raw, 1))
            coarse_input = jnp.concatenate([coarse_raw, id0], axis=-1)
            id1 = jnp.ones((B, input_points_num, 1))
            org_points_input = jnp.concatenate(
                [org_points_input, id1], axis=-1
            )
        else:
            coarse_input = coarse_raw

        points = jnp.concatenate([coarse_input, org_points_input], axis=1)
        n_total = self.num_coarse_raw + input_points_num
        pts_num = (n_total, n_total // 2, n_total // 4, n_total // 8)
        dense_feat = SASKNResEncoder(
            k=self.knn_list, pk=self.pk, output_size=dense_feature_size,
            layers_cfg=self.layers_cfg, pts_num=pts_num,
        )(points, train)

        up_scale = int(np.ceil(self.num_fine / (self.num_coarse_raw + 2048)))
        if up_scale >= 2:
            dense_feat = common.EFExpansion(
                input_size=dense_feature_size,
                output_size=expand_feature_size,
                step_ratio=up_scale, k=4,
            )(dense_feat)
            coarse_features = nn.relu(
                layers.TorchDense(expand_feature_size)(dense_feat)
            )
        else:
            coarse_features = nn.relu(
                layers.TorchDense(expand_feature_size)(dense_feat)
            )
        coarse_high = layers.TorchDense(3, dtype=jnp.float32)(coarse_features)

        if coarse_high.shape[1] > self.num_fps:
            idx_fps = ops.furthest_point_sample(coarse_high, self.num_fps)
            coarse_fps = ops.gather_points(coarse_high, idx_fps)
            coarse_features = ops.gather_points(coarse_features, idx_fps)
        else:
            coarse_fps = coarse_high

        if coarse_fps.shape[1] > self.num_coarse:
            scores = layers.TorchDense(16)(coarse_features)
            scores = layers.TorchDense(8)(nn.relu(scores))
            scores = layers.TorchDense(1)(nn.relu(scores))
            scores = jax.nn.softplus(scores).squeeze(-1)
            _, idx_scores = ops.top_k(scores, self.num_coarse)
            coarse = ops.gather_points(coarse_fps, idx_scores.astype(jnp.int32))
            coarse_features = ops.gather_points(
                coarse_features, idx_scores.astype(jnp.int32)
            )
        else:
            coarse = coarse_fps

        if coarse.shape[1] < self.num_fine:
            sr = self.num_fine // self.num_coarse
            if self.local_folding:
                up_features = Folding(dense_feature_size, sr)(
                    coarse_features, global_feat
                )
                center = jnp.repeat(coarse, sr, axis=1)
                fine = layers.TorchDense(3, dtype=jnp.float32)(
                    nn.relu(layers.TorchDense(expand_feature_size)(up_features))
                ) + center
            else:
                up_features = common.EFExpansion(
                    input_size=expand_feature_size,
                    output_size=dense_feature_size,
                    step_ratio=sr, k=4,
                )(coarse_features)
                fine = layers.TorchDense(3, dtype=jnp.float32)(
                    nn.relu(layers.TorchDense(expand_feature_size)(up_features))
                )
        else:
            assert coarse.shape[1] == self.num_fine
            fine = coarse

        return coarse_raw, coarse_high, coarse, fine


def _kl_normal(mu1, std1, mu2, std2):
    """KL(N(mu1,std1) || N(mu2,std2)), elementwise (torch semantics)."""
    return (
        jnp.log(std2 / std1)
        + (std1**2 + (mu1 - mu2) ** 2) / (2.0 * std2**2)
        - 0.5
    )


def _mmd_kernel(x, y):
    """Gaussian kernel matrix over batch rows (vrcnet.py:432-439):
    k[i, j] = exp(-mean((x_i - y_j)^2) / dim)."""
    dim = x.shape[1]
    sq = jnp.mean((x[:, None, :] - y[None, :, :]) ** 2, axis=2)
    return jnp.exp(-sq / float(dim))


def mmd_loss(x, y):
    """Kernel MMD between two batches of latents (vrcnet.py:441-445)."""
    return (
        jnp.mean(_mmd_kernel(x, x))
        + jnp.mean(_mmd_kernel(y, y))
        - 2.0 * jnp.mean(_mmd_kernel(x, y))
    )


def build(args) -> "Model":
    from mvp_benchmark_tpu.train.config import parse_int_list

    return Model(
        num_points=int(args.num_points),
        layers_cfg=tuple(parse_int_list(args.layers or "2,2,2,2")),
        knn_list=tuple(parse_int_list(args.knn_list or "10,20")),
        pk=int(args.pk or 10),
        points_label=bool(args.points_label),
        local_folding=bool(args.local_folding),
        num_coarse_raw=int(args.num_coarse_raw or 1024),
        num_fps=int(args.num_fps or 2048),
        num_coarse=int(args.num_coarse or 2048),
        distribution_loss=str(args.distribution_loss or "KLD"),
        train_loss=str(args.loss or "cd"),
        eval_emd=bool(args.eval_emd),
    )


class Model(nn.Module):
    """VRCNet. forward(x, gt, prefix, alpha) like the reference Model
    (vrcnet.py:412-527)."""

    num_points: int = 2048
    layers_cfg: Sequence[int] = (1, 1, 1, 1)
    knn_list: Sequence[int] = (16,)
    pk: int = 10
    points_label: bool = True
    local_folding: bool = True
    num_coarse_raw: int = 1024
    num_fps: int = 2048
    num_coarse: int = 2048
    size_z: int = 128
    global_feature_size: int = 1024
    distribution_loss: str = "KLD"
    train_loss: str = "cd"
    eval_emd: bool = False

    @nn.compact
    def __call__(self, x, gt=None, prefix: str = "train", alpha=None):
        from mvp_benchmark_tpu.models.pcn import PCNEncoder

        if alpha is None:
            alpha = 1.0
        train = prefix == "train"
        num_input = x.shape[1]

        encoder = PCNEncoder(self.global_feature_size)
        posterior_infer1 = LinearResBlock(self.global_feature_size)
        posterior_infer2 = LinearResBlock(self.size_z * 2)
        prior_infer = LinearResBlock(self.size_z * 2)
        generator = LinearResBlock(self.global_feature_size)
        decoder = MSAPSKNDecoder(
            num_coarse_raw=self.num_coarse_raw, num_fps=self.num_fps,
            num_coarse=self.num_coarse, num_fine=self.num_points,
            layers_cfg=self.layers_cfg, knn_list=self.knn_list, pk=self.pk,
            points_label=self.points_label, local_folding=self.local_folding,
        )

        if train:
            # Dual path: reconstruction on FPS-resampled gt + completion on x
            # (vrcnet.py:450-454) — batch doubles.
            if num_input == gt.shape[1]:
                # fps(gt, N) with N == |gt| selects EVERY point, so the
                # reference's resampling is a permutation; the encoder is
                # permutation-invariant and all losses are CD, so skip the
                # N-step greedy FPS + gather.
                # (Only differs if gt contains exactly-duplicated points,
                # where the CUDA FPS would emit repeats.)
                y = gt
            else:
                y = ops.gather_points(
                    gt, ops.furthest_point_sample(gt, num_input)
                )
            gt = jnp.concatenate([gt, gt], axis=0)
            points = jnp.concatenate([x, y], axis=0)
            x = jnp.concatenate([x, x], axis=0)
        else:
            points = x

        feat = encoder(points)

        if train:
            B2 = feat.shape[0]
            feat_x, feat_y = jnp.split(feat, 2, axis=0)
            o_x = posterior_infer2(posterior_infer1(feat_x))
            q_mu, q_std = jnp.split(o_x, 2, axis=1)
            o_y = prior_infer(feat_y)
            p_mu, p_std = jnp.split(o_y, 2, axis=1)
            q_std = jax.nn.softplus(q_std)
            p_std = jax.nn.softplus(p_std)

            rng = self.make_rng("sample")
            k1, k2 = jax.random.split(rng)
            z_q = q_mu + q_std * jax.random.normal(k1, q_mu.shape)
            z_p = p_mu + p_std * jax.random.normal(k2, p_mu.shape)
            z = jnp.concatenate([z_q, z_p], axis=0)
            feat = jnp.concatenate([feat_x, feat_x], axis=0)
        else:
            o_x = posterior_infer2(posterior_infer1(feat))
            q_mu, q_std = jnp.split(o_x, 2, axis=1)
            q_std = jax.nn.softplus(q_std)
            rng = self.make_rng("sample")
            z = q_mu + q_std * jax.random.normal(rng, q_mu.shape)

        feat = feat + generator(z)
        coarse_raw, coarse_high, coarse, fine = decoder(feat, x, train)

        if train:
            if self.distribution_loss == "KLD":
                # dl_rec = KL(N(0,1) || p); dl_g = KL(p_detached || q)
                # (vrcnet.py:502-504).
                dl_rec = _kl_normal(
                    jnp.zeros_like(p_mu), jnp.ones_like(p_std), p_mu, p_std
                )
                dl_g = _kl_normal(
                    lax.stop_gradient(p_mu), lax.stop_gradient(p_std),
                    q_mu, q_std,
                )
            elif self.distribution_loss == "MMD":
                # Reference vrcnet.py:495-501: fresh rsamples from the
                # standard normal, posterior, prior, and detached prior, then
                # kernel MMDs. (The reference calls `self.mmd_loss2` for the
                # second term — an attribute that does not exist, so its MMD
                # branch crashes; `mmd_loss` is the evident intent.)
                k3, k4, k5, k6 = jax.random.split(self.make_rng("sample"), 4)
                z_m = jax.random.normal(k3, p_mu.shape)
                z_q2 = q_mu + q_std * jax.random.normal(k4, q_mu.shape)
                z_p2 = p_mu + p_std * jax.random.normal(k5, p_mu.shape)
                z_p_fix = lax.stop_gradient(p_mu) + lax.stop_gradient(
                    p_std
                ) * jax.random.normal(k6, p_mu.shape)
                dl_rec = mmd_loss(z_m, z_p2)
                dl_g = mmd_loss(z_q2, z_p_fix)
            else:
                raise NotImplementedError(
                    "Distribution loss is either MMD or KLD "
                    "(reference vrcnet.py:495-504)."
                )

            if self.train_loss != "cd":
                raise NotImplementedError("Only CD is supported")
            loss1, _ = calc_cd(coarse_raw, gt)
            loss2, _ = calc_cd(coarse_high, gt)
            loss3, _ = calc_cd(coarse, gt)
            loss4, _ = calc_cd(fine, gt)
            total = (
                loss1.mean() * 10.0 + loss2.mean() * 0.5
                + loss3.mean() + loss4.mean() * alpha
            )
            total = total + (dl_rec.mean() + dl_g.mean()) * 20.0
            return fine, loss4, total
        elif prefix == "val":
            if self.eval_emd:
                emd = calc_emd(fine, gt, eps=0.004, iterations=3000)
            else:
                emd = jnp.zeros(fine.shape[0])
            cd_p, cd_t, f1 = calc_cd(fine, gt, calc_f1=True)
            return {"out1": coarse_raw, "out2": fine, "emd": emd,
                    "cd_p": cd_p, "cd_t": cd_t, "f1": f1}
        else:
            return {"result": fine}
