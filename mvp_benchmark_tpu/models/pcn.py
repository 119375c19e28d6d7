"""PCN completion model.

Reference: ``completion/models/pcn.py`` — PointNet-style encoder with two
max-pools (:13-30), FC coarse decoder + folding-grid upsampling (:33-71),
alpha-weighted two-scale CD/EMD loss (:88-114).
"""

from __future__ import annotations

import math
from typing import Optional

import jax.numpy as jnp
from mvp_benchmark_tpu.models import nn

from mvp_benchmark_tpu.metrics import calc_cd, calc_emd
from mvp_benchmark_tpu.models import layers


class PCNEncoder(nn.Module):
    """(B, N, 3) -> (B, output_size) global feature (pcn.py:13-30)."""

    output_size: int = 1024

    @nn.compact
    def __call__(self, x):
        h = nn.relu(layers.TorchDense(128)(x))
        h = layers.TorchDense(256)(h)
        g = jnp.max(h, axis=1, keepdims=True)                    # (B,1,256)
        # concat([h, tile(g)]) @ W done as sliced matmuls (layers.DenseCat)
        h = nn.relu(layers.DenseCat(512)(h, g))
        h = layers.TorchDense(self.output_size)(h)
        return jnp.max(h, axis=1)                                # (B, out)


class PCNDecoder(nn.Module):
    """FC coarse + folding fine decoder (pcn.py:33-71)."""

    num_coarse: int
    num_fine: int
    scale: int

    @nn.compact
    def __call__(self, feat):
        B = feat.shape[0]
        h = nn.relu(layers.TorchDense(1024)(feat))
        h = nn.relu(layers.TorchDense(1024)(h))
        coarse = layers.TorchDense(self.num_coarse * 3, dtype=jnp.float32)(h)
        coarse = coarse.reshape(B, self.num_coarse, 3)

        grid = layers.gen_grid_up(2 ** int(math.log2(self.scale)), 0.05)
        grid_feat = jnp.tile(grid, (self.num_coarse, 1))          # (fine, 2)
        grid_feat = jnp.broadcast_to(grid_feat[None], (B, self.num_fine, 2))

        point_feat = jnp.repeat(coarse, self.scale, axis=1)       # (B, fine, 3)
        # virtual concat [grid, point, tile(global)]: the 1024-dim global
        # feature is matmul'd once per batch element, not per point
        h = nn.relu(
            layers.DenseCat(512)(grid_feat, point_feat, feat[:, None, :])
        )
        h = nn.relu(layers.TorchDense(512)(h))
        fine = layers.TorchDense(3, dtype=jnp.float32)(h) + point_feat
        return coarse, fine


def build(args) -> "Model":
    return Model(
        num_points=int(args.num_points),
        num_coarse=int(args.num_coarse or 1024),
        train_loss=str(args.loss or "cd"),
        eval_emd=bool(args.eval_emd),
    )


class Model(nn.Module):
    """PCN. forward(x (B,N,3), gt, prefix, alpha) like the reference Model
    (pcn.py:74-114; num_coarse fixed at 1024)."""

    num_points: int = 2048
    num_coarse: int = 1024
    train_loss: str = "cd"
    eval_emd: bool = False

    @nn.compact
    def __call__(self, x, gt=None, prefix: str = "train", alpha=None):
        if alpha is None:
            alpha = 1.0
        scale = self.num_points // self.num_coarse
        feat = PCNEncoder()(x)
        out1, out2 = PCNDecoder(self.num_coarse, self.num_points, scale)(feat)

        if prefix == "train":
            if self.train_loss == "emd":
                loss1 = calc_emd(out1, gt)
                loss2 = calc_emd(out2, gt)
            elif self.train_loss == "cd":
                loss1, _ = calc_cd(out1, gt)
                loss2, _ = calc_cd(out2, gt)
            else:
                raise NotImplementedError("Train loss is either CD or EMD!")
            total = loss1.mean() + loss2.mean() * alpha
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
