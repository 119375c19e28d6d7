"""DCP-v2 registration model.

Reference: ``registration/models/dcp.py`` — DGCNN embedding (:269-301),
transformer cross-attention pointer (:304-328, the annotated-transformer
encoder/decoder stack :69-243), softmax soft-correspondence + weighted SVD
head (:331-381), loss ``mse(T_12 @ T_gt^-1, I)`` (:420-430).

Changes from the reference: channels-last layout, batched ``jnp.linalg.svd``
with a vectorized reflection fix instead of the per-sample ``torch.svd``
python loop, dense kNN via one matmul.
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp
from mvp_benchmark_tpu.models import nn
from jax import lax

from mvp_benchmark_tpu import metrics
from mvp_benchmark_tpu.models import layers

_HI = lax.Precision.HIGHEST


class DGCNN(nn.Module):
    """Edge-conv embedding (reference dcp.py:269-301). (B,N,3) -> (B,N,emb).

    All four edge-conv blocks run as one per-edge chain (ops.edge_mlp) on
    the bf16 (B, 20, N, 8) edge tensor [x_j | x_i | 0 0]. The two zero
    channels are transparent: W0's two pad rows see zero input, so their
    gradient is exactly zero and is sliced off (the parameter keeps the
    reference's 6 input rows).
    """

    emb_dims: int = 512
    fused_chs: tuple = (64, 64, 128, 256)

    @nn.compact
    def __call__(self, x, train: bool):
        from mvp_benchmark_tpu import ops

        # Edge tensor [x_j | x_i | 0 0] built straight in the chain's
        # (B, k, N, 8) layout: one gather of slot-major rows from the
        # zero-padded coordinate table plus one broadcast-add for the
        # center channels.
        idx = ops.knn_indices(x, k=20)                   # (B, N, 20)
        idxT = jnp.swapaxes(idx, 1, 2)                   # (B, 20, N) int32
        x8 = jnp.pad(x, ((0, 0), (0, 0), (0, 5)))       # x_j -> ch 0:3
        neigh8 = ops.grouping_operation(x8, idxT)
        center8 = jnp.pad(x, ((0, 0), (0, 0), (3, 2)))  # x_i -> ch 3:6
        a1 = (neigh8 + center8[:, None]).astype(jnp.bfloat16)

        cins = (6,) + self.fused_chs[:-1]
        Ws = tuple(
            self.param(f"fused_W{i}", layers.torch_linear_init, (cin, ch))
            for i, (cin, ch) in enumerate(zip(cins, self.fused_chs))
        )
        Ws = (jnp.pad(Ws[0], ((0, 2), (0, 0))),) + Ws[1:]
        gammas = tuple(
            self.param(f"fused_scale{i}", nn.initializers.ones, (ch,))
            for i, ch in enumerate(self.fused_chs)
        )
        betas = tuple(
            self.param(f"fused_bias{i}", nn.initializers.zeros, (ch,))
            for i, ch in enumerate(self.fused_chs)
        )
        ra_means = [
            self.variable("batch_stats", f"fused_mean{i}",
                          lambda s: jnp.zeros(s, jnp.float32), (ch,))
            for i, ch in enumerate(self.fused_chs)
        ]
        ra_vars = [
            self.variable("batch_stats", f"fused_var{i}",
                          lambda s: jnp.ones(s, jnp.float32), (ch,))
            for i, ch in enumerate(self.fused_chs)
        ]

        xs, batch_stats = ops.edge_mlp(
            a1, Ws, gammas, betas,
            tuple(v.value for v in ra_means),
            tuple(v.value for v in ra_vars),
            train,
        )
        if train and batch_stats is not None and (
            self.is_mutable_collection("batch_stats")
        ):
            # ra = momentum * ra + (1 - momentum) * batch
            # (momentum 0.9 == torch BatchNorm2d default 0.1).
            for rm, rv, st in zip(ra_means, ra_vars, batch_stats):
                rm.value = 0.9 * rm.value + 0.1 * st[0]
                rv.value = 0.9 * rv.value + 0.1 * st[1]

        cat = jnp.concatenate(list(xs), axis=-1)         # (B,N,512)
        h = layers.TorchDense(self.emb_dims, use_bias=False)(cat)
        h = layers.BatchNorm()(h, train)
        return nn.relu(h)


class MultiHeadedAttention(nn.Module):
    """h-head attention with shared projections (reference dcp.py:198-229).

    ``dtype``: storage dtype for the projections/attention activations.
    The transformer block is LayerNorm-based (no BatchNorm); the f32
    residual stream and LayerNorm stats are preserved by the callers.
    """

    h: int
    d_model: int
    dtype: Optional[jnp.dtype] = None
    # Which operands share one input (and therefore one fused MultiDense
    # GEMM + its param names): "qkv" (self-attention), "kv" (cross-
    # attention), "none". EXPLICIT module field — not inferred from
    # argument object identity — so a caller-side refactor that breaks
    # aliasing (masking/casting an operand) fails loudly in the assert
    # below instead of silently renaming the checkpoint param tree
    # (ADVICE r4).
    shared: str = "qkv"

    @nn.compact
    def __call__(self, query, key, value, mask=None):
        B = query.shape[0]
        d_k = self.d_model // self.h

        # Projection-native (B, N, h, d_k) layout. Projections with a
        # SHARED input (self-attention q=k=v; cross-attention k=v) run as
        # one concatenated GEMM (layers.MultiDense).
        d = self.d_model

        def heads(y):
            return y.reshape(B, -1, self.h, d_k)

        if self.shared == "qkv":
            assert query is key and key is value, (
                "shared='qkv' requires aliased q/k/v operands")
            y = layers.MultiDense((d, d, d), dtype=self.dtype)(query)
            q, k, v = (heads(y[..., :d]), heads(y[..., d:2 * d]),
                       heads(y[..., 2 * d:]))
        elif self.shared == "kv":
            assert key is value, "shared='kv' requires aliased k/v operands"
            q = heads(layers.TorchDense(d, dtype=self.dtype)(query))
            y = layers.MultiDense((d, d), dtype=self.dtype)(key)
            k, v = heads(y[..., :d]), heads(y[..., d:])
        else:
            q = heads(layers.TorchDense(d, dtype=self.dtype)(query))
            k = heads(layers.TorchDense(d, dtype=self.dtype)(key))
            v = heads(layers.TorchDense(d, dtype=self.dtype)(value))
        x = layers.mha_attention_bnhd(q, k, v, mask=mask)
        x = x.reshape(B, -1, self.h * d_k)
        return layers.TorchDense(self.d_model, dtype=self.dtype)(x)


class FeedForward(nn.Module):
    d_model: int
    d_ff: int
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, x):
        h = nn.relu(layers.TorchDense(self.d_ff, dtype=self.dtype)(x))
        return layers.TorchDense(self.d_model, dtype=self.dtype)(h)


class EncoderLayer(nn.Module):
    d_model: int
    d_ff: int
    n_heads: int
    dtype: Optional[jnp.dtype] = None
    # Residual-stream storage dtype. None keeps the stream (and LN outputs)
    # f32 like the reference; bf16 halves the LN/residual memory traffic
    # (14 LayerNorms + 6 residual adds on (32, 2048, 512)). LN statistics
    # are always computed in f32 (see layers.UnbiasedLayerNorm).
    rdt: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, x, mask=None):
        if self.rdt is not None:
            x = x.astype(self.rdt)
        a = layers.UnbiasedLayerNorm(dtype=self.dtype)(x)
        x = x + MultiHeadedAttention(self.n_heads, self.d_model,
                                     self.dtype)(a, a, a, mask)
        a = layers.UnbiasedLayerNorm(dtype=self.dtype)(x)
        return x + FeedForward(self.d_model, self.d_ff, self.dtype)(a)


class DecoderLayer(nn.Module):
    d_model: int
    d_ff: int
    n_heads: int
    dtype: Optional[jnp.dtype] = None
    rdt: Optional[jnp.dtype] = None  # see EncoderLayer

    @nn.compact
    def __call__(self, x, memory, src_mask=None, tgt_mask=None):
        if self.rdt is not None:
            x = x.astype(self.rdt)
        a = layers.UnbiasedLayerNorm(dtype=self.dtype)(x)
        x = x + MultiHeadedAttention(self.n_heads, self.d_model,
                                     self.dtype)(a, a, a, tgt_mask)
        a = layers.UnbiasedLayerNorm(dtype=self.dtype)(x)
        x = x + MultiHeadedAttention(self.n_heads, self.d_model, self.dtype,
                                     shared="kv")(a, memory, memory, src_mask)
        a = layers.UnbiasedLayerNorm(dtype=self.dtype)(x)
        return x + FeedForward(self.d_model, self.d_ff, self.dtype)(a)


class Transformer(nn.Module):
    """Pointer network: cross-attend src<->tgt (reference dcp.py:304-328).

    ``dtype=bfloat16`` stores the sublayer activations in bf16 (f32
    residual stream / LayerNorm stats / parameter math): half the memory
    traffic at a one-rounding numerics change.
    """

    emb_dims: int = 512
    n_blocks: int = 1
    n_heads: int = 4
    ff_dims: int = 1024
    dtype: Optional[jnp.dtype] = None
    rdt: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, src, tgt):
        encoder = [
            EncoderLayer(self.emb_dims, self.ff_dims, self.n_heads,
                         self.dtype, self.rdt)
            for _ in range(self.n_blocks)
        ]
        decoder = [
            DecoderLayer(self.emb_dims, self.ff_dims, self.n_heads,
                         self.dtype, self.rdt)
            for _ in range(self.n_blocks)
        ]
        enc_norm = layers.UnbiasedLayerNorm()
        dec_norm = layers.UnbiasedLayerNorm()

        def run(s, t):
            m = s
            for layer in encoder:
                m = layer(m)
            m = enc_norm(m)
            x = t
            for layer in decoder:
                x = layer(x, m)
            return dec_norm(x)

        tgt_embedding = run(src, tgt)
        src_embedding = run(tgt, src)
        return src_embedding, tgt_embedding


def svd_head(src_embedding, tgt_embedding, src, tgt):
    """Soft correspondence + weighted Kabsch (reference dcp.py:338-381).

    All clouds channels-last (B, N, 3); embeddings (B, N, d).
    Returns R (B,3,3), t (B,3).
    """
    d_k = src_embedding.shape[-1]
    # Soft correspondence: softmax(src_emb tgt_emb^T / sqrt(d)) @ tgt.
    # Scores run at default precision like every other embedding matmul;
    # the 3x3 covariance below is HIGHEST — that is where rotation accuracy
    # is decided.
    scores = jnp.einsum(
        "bnd,bmd->bnm", src_embedding, tgt_embedding,
        preferred_element_type=jnp.float32,
    ) / math.sqrt(d_k)
    scores = jax.nn.softmax(scores, axis=2)
    src_corr = jnp.einsum(
        "bnm,bmc->bnc", scores, tgt,
        preferred_element_type=jnp.float32,
    )
    src_centered = src - src.mean(axis=1, keepdims=True)
    corr_centered = src_corr - src_corr.mean(axis=1, keepdims=True)
    H = jnp.einsum(
        "bnc,bnd->bcd", src_centered, corr_centered,
        preferred_element_type=jnp.float32, precision=_HI,
    )
    R = layers.symmetric_svd_rotation(H)
    t = (
        -jnp.einsum("bij,bj->bi", R, src.mean(axis=1), precision=_HI)
        + src_corr.mean(axis=1)
    )
    return R, t


# Scoped bf16 for the transformer pointer (LayerNorm-based, no BatchNorm).
# LN stats stay f32; sublayer activations bf16.
TRANSFORMER_BF16 = True
# bf16 RESIDUAL stream too: halves the 14-LayerNorm + 6-residual stream
# traffic on (32, 2048, 512). The stream is only 2-3 adds deep
# (n_blocks=1), so bf16 accumulation drift is one rounding per sublayer;
# rotation accuracy is decided in the f32-HIGHEST svd head covariance.
TRANSFORMER_RESID_BF16 = True


def build(args=None) -> "Model":
    """Factory used by the model registry (emb_dims fixed at 512 like the
    reference Model.__init__, dcp.py:384-391)."""
    return Model()


class Model(nn.Module):
    """DCP-v2. forward(src, tgt, T_gt, prefix) like the reference Model."""

    args: Optional[dict] = None
    emb_dims: int = 512

    @nn.compact
    def __call__(self, src, tgt, T_gt=None, prefix: str = "train"):
        train = prefix == "train"

        emb_nn = DGCNN(self.emb_dims)
        src_embedding = emb_nn(src, train)
        tgt_embedding = emb_nn(tgt, train)

        src_p, tgt_p = Transformer(
            self.emb_dims,
            dtype=jnp.bfloat16 if TRANSFORMER_BF16 else None,
            rdt=jnp.bfloat16 if (TRANSFORMER_BF16
                                 and TRANSFORMER_RESID_BF16) else None,
        )(src_embedding, tgt_embedding)
        src_embedding = src_embedding + src_p
        tgt_embedding = tgt_embedding + tgt_p

        R_ab, t_ab = svd_head(src_embedding, tgt_embedding, src, tgt)
        T_12 = metrics.rt_to_transformation(R_ab, t_ab[..., None])

        if T_gt is None:
            return T_12

        r_err = metrics.rotation_error(T_12[:, :3, :3], T_gt[:, :3, :3])
        t_err = metrics.translation_error(T_12[:, :3, 3], T_gt[:, :3, 3])
        rmse = metrics.rmse_loss(src, T_12, T_gt)
        eye = jnp.broadcast_to(jnp.eye(4), T_gt.shape)
        mse = jnp.mean((jnp.matmul(T_12, jnp.linalg.inv(T_gt), precision=_HI) - eye) ** 2)
        loss = mse
        rt_mse = (
            metrics.rotation_geodesic_error(T_12[:, :3, :3], T_gt[:, :3, :3])
            + metrics.translation_error(T_12[:, :3, 3], T_gt[:, :3, 3])
        )
        return loss, r_err, t_err, rmse, rt_mse
