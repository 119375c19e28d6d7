"""ECG completion model.

Reference: ``completion/models/ecg.py`` — PCN encoder + edge-aware dense
graph-conv hierarchical encoder-decoder (``EF_encoder`` with DGCNN
``Dense_conv`` blocks :36-65, 4-level FPS downsampling via
``edge_preserve_sampling`` and ``three_interpolate`` upsampling :68-159),
``EF_expansion`` upsampler, uniform loss (:213-254).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax.numpy as jnp
import numpy as np
from mvp_benchmark_tpu.models import nn

from mvp_benchmark_tpu import ops
from mvp_benchmark_tpu.metrics import calc_cd, calc_emd
from mvp_benchmark_tpu.models import common, layers
from mvp_benchmark_tpu.models.pcn import PCNEncoder


class DenseConv(nn.Module):
    """DGCNN dense-graph-conv block (ecg.py:21-65, Stack_conv + Dense_conv).

    (B, N, C) -> (B, N, C + growth_rate * dense_n) via kNN edge features and
    a densely-connected conv stack, max-pooled over neighbours.

    The dense-block concatenations are kept VIRTUAL: each stacked conv is a
    DenseCat over the running list of parts (identical parameters to Dense on
    the materialized concat), and because max over neighbours commutes with
    channel concatenation the parts are only concatenated after the k-max —
    the reference's (B, N, k, C+i*growth) intermediates never exist.
    """

    growth_rate: int = 64
    dense_n: int = 3
    k: int = 16

    @nn.compact
    def __call__(self, x):
        from mvp_benchmark_tpu import ops

        # edge features + 1x1 conv as a project-then-gather DenseEdge
        # (identical math/params to Dense(get_graph_feature(x)))
        idx = ops.knn_indices(x, self.k)
        e = nn.relu(
            layers.DenseEdge(self.growth_rate, mode="center_minus")(x, idx)
        )
        center = x[:, :, None, :]                       # broadcast over k
        parts = [e, center]
        for i in range(self.dense_n - 1):
            y = layers.DenseCat(self.growth_rate)(*parts)
            if i != self.dense_n - 2:
                y = nn.relu(y)
            parts.append(y)
        # max_k(cat(parts)) == cat(max_k(p) for p in parts)
        pooled = [
            p[:, :, 0, :] if p.shape[2] == 1 else jnp.max(p, axis=2)
            for p in parts
        ]
        return jnp.concatenate(pooled, axis=-1)


class EFEncoder(nn.Module):
    """Hierarchical edge-feature encoder-decoder (ecg.py:68-159).

    Input points (B, N, 3) -> per-point features (B, N, output_size).
    """

    growth_rate: int = 24
    dense_n: int = 3
    k: int = 16
    hierarchy: Sequence[int] = (1024, 256, 64)
    output_size: int = 256

    @nn.compact
    def __call__(self, x):
        pc1 = x[..., 0:3]
        comp = self.growth_rate * 2

        x0 = nn.relu(layers.TorchDense(24)(x))
        x1 = nn.relu(DenseConv(self.growth_rate, self.dense_n, self.k)(x0))
        x1 = jnp.concatenate([x1, x0], axis=-1)                       # 120
        x1d, _, _, pc2 = common.edge_preserve_sampling(
            x1, pc1, self.hierarchy[0], self.k
        )                                                              # 240

        x2 = nn.relu(layers.TorchDense(comp)(x1d))
        x2 = nn.relu(DenseConv(self.growth_rate, self.dense_n, self.k)(x2))
        x2 = jnp.concatenate([x2, x1d], axis=-1)                      # 360
        x2d, _, _, pc3 = common.edge_preserve_sampling(
            x2, pc2, self.hierarchy[1], self.k
        )                                                              # 720

        x3 = nn.relu(layers.TorchDense(comp)(x2d))
        x3 = nn.relu(DenseConv(self.growth_rate, self.dense_n, self.k)(x3))
        x3 = jnp.concatenate([x3, x2d], axis=-1)                      # 840
        x3d, _, _, pc4 = common.edge_preserve_sampling(
            x3, pc3, self.hierarchy[2], self.k
        )                                                              # 1680

        x4 = nn.relu(layers.TorchDense(comp)(x3d))
        x4 = nn.relu(DenseConv(self.growth_rate, self.dense_n, self.k)(x4))
        x4 = jnp.concatenate([x4, x3d], axis=-1)                      # 1800

        gf = layers.TorchDense(1024)(x4)
        gf = jnp.max(gf, axis=1)
        gf = nn.relu(layers.TorchDense(512)(gf))
        gf = nn.relu(layers.TorchDense(1024)(gf))

        # virtual concat [tile(gf), x4] (layers.DenseCat)
        x4 = nn.relu(layers.DenseCat(1024)(gf[:, None, :], x4))
        idx, w = ops.three_nn_upsampling(pc3, pc4)
        x4 = ops.three_interpolate(x4, idx, w)

        x3 = nn.relu(layers.DenseCat(768)(x3, x4))
        idx, w = ops.three_nn_upsampling(pc2, pc3)
        x3 = ops.three_interpolate(x3, idx, w)

        x2 = nn.relu(layers.DenseCat(512)(x2, x3))
        idx, w = ops.three_nn_upsampling(pc1, pc2)
        x2 = ops.three_interpolate(x2, idx, w)

        return layers.DenseCat(self.output_size)(x1, x2)


class ECGDecoder(nn.Module):
    """FC coarse + EF refinement decoder (ecg.py:162-210)."""

    num_coarse: int
    num_fine: int
    num_input: int
    hierarchy: tuple = (1024, 256, 64)

    @nn.compact
    def __call__(self, global_feat, point_input):
        B = global_feat.shape[0]
        scale = int(np.ceil(self.num_fine / (self.num_coarse + self.num_input)))

        h = nn.relu(layers.TorchDense(1024)(global_feat))
        h = nn.relu(layers.TorchDense(1024)(h))
        coarse = layers.TorchDense(self.num_coarse * 3, dtype=jnp.float32)(h)
        coarse = coarse.reshape(B, self.num_coarse, 3)

        points = jnp.concatenate([coarse, point_input], axis=1)
        dense_feat = EFEncoder(
            growth_rate=24, dense_n=3, k=16, hierarchy=self.hierarchy,
            output_size=256,
        )(points)

        if scale >= 2:
            dense_feat = common.EFExpansion(
                input_size=256, output_size=64, step_ratio=scale, k=4
            )(dense_feat)
        feat = nn.relu(layers.TorchDense(64)(dense_feat))
        fine = layers.TorchDense(3, dtype=jnp.float32)(feat)

        num_out = fine.shape[1]
        if num_out > self.num_fine:
            fps_idx = ops.furthest_point_sample(fine, self.num_fine)
            fine = ops.gather_points(fine, fps_idx)
        return coarse, fine


def build(args) -> "Model":
    num_points = int(args.num_points)
    # Reference hierarchy (1024, 256, 64) assumes 3072 encoder points
    # (1024 coarse + 2048 input); scale proportionally for other sizes.
    scale = num_points / 2048.0
    hierarchy = tuple(max(int(h * scale), 8) for h in (1024, 256, 64))
    return Model(
        num_points=num_points,
        num_coarse=max(int(1024 * scale), 16),
        num_input=num_points,
        hierarchy=hierarchy,
        train_loss=str(args.loss or "cd"),
        eval_emd=bool(args.eval_emd),
    )


class Model(nn.Module):
    """ECG. forward(x, gt, prefix, alpha) like the reference Model
    (ecg.py:213-254; num_coarse 1024, num_input 2048)."""

    num_points: int = 2048
    num_coarse: int = 1024
    num_input: int = 2048
    hierarchy: tuple = (1024, 256, 64)
    train_loss: str = "cd"
    eval_emd: bool = False

    @nn.compact
    def __call__(self, x, gt=None, prefix: str = "train", alpha=None):
        if alpha is None:
            alpha = 1.0
        feat = PCNEncoder()(x)
        out1, out2 = ECGDecoder(self.num_coarse, self.num_points,
                                self.num_input, self.hierarchy)(feat, x)

        if prefix == "train":
            uniform1 = common.get_uniform_loss(out1)
            uniform2 = common.get_uniform_loss(out2)
            if self.train_loss == "emd":
                loss1 = calc_emd(out1, gt)
                loss2 = calc_emd(out2, gt)
            elif self.train_loss == "cd":
                loss1, _ = calc_cd(out1, gt)
                loss2, _ = calc_cd(out2, gt)
            else:
                raise NotImplementedError("Train loss is either CD or EMD!")
            total = (
                loss1.mean() + uniform1 * 0.1
                + (loss2.mean() + uniform2 * 0.1) * alpha
            )
            return out2, loss2, total
        elif prefix == "val":
            if self.eval_emd:
                emd = calc_emd(out2, gt, eps=0.004, iterations=3000)
            else:
                emd = jnp.zeros(out2.shape[0])
            cd_p, cd_t, f1 = calc_cd(out2, gt, calc_f1=True)
            return {"out1": out1, "out2": out2, "emd": emd,
                    "cd_p": cd_p, "cd_t": cd_t, "f1": f1}
        else:
            return {"result": out2}
