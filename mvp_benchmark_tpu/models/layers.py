"""Shared building blocks for the benchmark models (``models.nn`` modules).

Layout convention: all point features are channels-LAST — (B, N, C) or
(B, N, K, C) — so 1x1 "convolutions" are plain Dense layers, i.e. GEMMs
over the feature dim. The reference's channels-first Conv1d/Conv2d(k=1)
stacks translate 1:1.

Initializers match PyTorch defaults (kaiming-uniform with a=sqrt(5), i.e.
U(+-1/sqrt(fan_in)) for both weight and bias) so training dynamics track the
reference.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
from mvp_benchmark_tpu.models import nn
from jax import lax


def torch_linear_init(key, shape, dtype=jnp.float32):
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) — torch nn.Linear/Conv default."""
    fan_in = shape[0] if len(shape) == 2 else math.prod(shape[:-1])
    bound = 1.0 / math.sqrt(fan_in)
    return jax.random.uniform(key, shape, dtype, -bound, bound)


def torch_bias_init(fan_in: int):
    """torch Linear/Conv bias default: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in)

    def init(key, shape, dtype=jnp.float32):
        return jax.random.uniform(key, shape, dtype, -bound, bound)

    return init


# ---------------------------------------------------------------------------
# Activation-dtype policy (bf16 mixed-precision mode)
# ---------------------------------------------------------------------------
#
# Parameters and optimizer state always stay fp32. When the policy is
# bfloat16, the Dense-family layers cast inputs/kernels to bf16 and RETURN
# bf16 activations (fp32 accumulation): the memory traffic of everything
# between matmuls halves. Coordinate-producing heads pass
# ``dtype=jnp.float32`` so predicted point sets (and hence CD/EMD metrics)
# keep fp32 resolution.
#
# The policy is read at TRACE time: set it before building jitted steps.

_COMPUTE_DTYPE = jnp.float32


def set_compute_dtype(dtype) -> None:
    global _COMPUTE_DTYPE
    _COMPUTE_DTYPE = jnp.dtype(dtype)


def compute_dtype():
    return _COMPUTE_DTYPE


class TorchDense(nn.Module):
    """nn.Dense with torch-default init; == Conv1d/Conv2d(kernel=1).

    ``dtype=None`` follows the global activation policy (see
    ``set_compute_dtype``); coordinate heads pass ``jnp.float32``.
    """

    features: int
    use_bias: bool = True
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, x):
        dt = self.dtype or compute_dtype()
        kernel = self.param(
            "kernel", torch_linear_init, (x.shape[-1], self.features)
        )
        # Flatten leading dims: one large (B*N..., C) @ (C, D) matmul.
        #
        # Output directly at the storage dtype: the product accumulates in
        # f32 and rounds ONCE on write either way, but an f32 output
        # buffer costs a full (rows, D) f32 write + re-read before the
        # cast/bias pass. NOTE (bf16 policy): the bias add below happens
        # AFTER that rounding, at the storage dtype — one extra rounding on
        # bias-carrying layers vs f32-accumulate + f32 bias + single final
        # round.
        lead = x.shape[:-1]
        y = jnp.dot(
            x.reshape(-1, x.shape[-1]).astype(dt), kernel.astype(dt),
            preferred_element_type=dt,
        ).reshape(lead + (self.features,))
        if self.use_bias:
            fan_in = x.shape[-1]
            bound = 1.0 / math.sqrt(fan_in)
            bias = self.param(
                "bias",
                lambda k, s: jax.random.uniform(k, s, jnp.float32, -bound, bound),
                (self.features,),
            )
            # Cast BEFORE the add: under the bf16 policy the output is cast
            # anyway, and adding at the storage dtype halves the traffic of
            # the (rows, D) bias pass when XLA doesn't fuse it into the GEMM
            # epilogue (f32 policy: y is already f32 — no change).
            y = y.astype(dt) + bias.astype(dt)
        return y.astype(dt)


class MultiDense(nn.Module):
    """Several torch-init Dense heads applied to ONE input as a single
    concatenated GEMM; returns the concatenated (…, sum(features)) output
    for the caller to slice.

    Equivalent to separate TorchDense calls up to reduction-order rounding
    (XLA may tile the shared reduction differently per output width; bias
    init/add matches TorchDense exactly) while paying ONE pass over the
    input and one GEMM instead of N narrow ones — VRCNet's SA modules run
    three such heads per module and DCP's attention four per block.
    """

    features: Sequence[int]
    use_bias: bool = True
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, x):
        dt = self.dtype or compute_dtype()
        C = x.shape[-1]
        kernel = jnp.concatenate(
            [
                self.param(f"kernel{i}", torch_linear_init, (C, f))
                for i, f in enumerate(self.features)
            ],
            axis=1,
        )
        lead = x.shape[:-1]
        y = jnp.dot(
            x.reshape(-1, C).astype(dt), kernel.astype(dt),
            preferred_element_type=dt,  # f32 accum, one rounding (see
        ).reshape(lead + (sum(self.features),))  # TorchDense note)
        if self.use_bias:
            bound = 1.0 / math.sqrt(C)
            bias = jnp.concatenate(
                [
                    self.param(
                        f"bias{i}",
                        lambda k, s: jax.random.uniform(
                            k, s, jnp.float32, -bound, bound
                        ),
                        (f,),
                    )
                    for i, f in enumerate(self.features)
                ]
            )
            y = y.astype(dt) + bias.astype(dt)
        return y.astype(dt)


class DenseCat(nn.Module):
    """Dense over a virtual concat: ``cat(xs, -1) @ W == sum_i xs[i] @ W_i``.

    Mathematically identical to ``TorchDense(features)(concat(xs, -1))`` with
    the same single kernel (sliced per input), but never materializes the
    concatenation: broadcast global features ((B, 1, C) tiles) stay tiny
    instead of being replicated N-fold before the matmul. Inputs may have
    broadcastable leading shapes.
    """

    features: int
    use_bias: bool = True
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, *xs):
        dt = self.dtype or compute_dtype()
        cs = [x.shape[-1] for x in xs]
        total = sum(cs)
        kernel = self.param(
            "kernel", torch_linear_init, (total, self.features)
        )
        y = None
        off = 0
        for x, c in zip(xs, cs):
            w = kernel[off:off + c]
            off += c
            lead = x.shape[:-1]
            part = jnp.dot(
                x.reshape(-1, c).astype(dt), w.astype(dt),
                preferred_element_type=jnp.float32,
            ).reshape(lead + (self.features,))
            y = part if y is None else y + part
        if self.use_bias:
            bound = 1.0 / math.sqrt(total)
            bias = self.param(
                "bias",
                lambda k, s: jax.random.uniform(k, s, jnp.float32, -bound, bound),
                (self.features,),
            )
            y = y + bias
        return y.astype(dt)


class DenseEdge(nn.Module):
    """Dense over virtual DGCNN edge features without materializing them.

    Computes ``cat(parts, -1) @ W`` for the edge-feature layouts
    (``[x_i, x_j]``, ``[x_j, x_i]``, ``[x_i, x_j - x_i]``) using the identity
    Dense(gather(x)) == gather(Dense(x)): the center/neighbour halves of the
    kernel are applied to the N points first and only the D-dim projections
    are gathered — the (B, N, k, 2C) tensor never exists and the
    gather/scatter traffic drops from k*2C to k*D per point. Parameters
    are identical to TorchDense(D) on the concatenated edge features.

    mode: 'center_neighbor' | 'neighbor_center' | 'center_minus'.
    """

    features: int
    mode: str = "center_minus"
    use_bias: bool = True
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, x, idx):
        from mvp_benchmark_tpu import ops

        dt = self.dtype or compute_dtype()
        C = x.shape[-1]
        kernel = self.param(
            "kernel", torch_linear_init, (2 * C, self.features)
        )
        Wa, Wb = kernel[:C], kernel[C:]
        if self.mode == "center_neighbor":      # cat([x_i, x_j])
            w_center, w_neigh = Wa, Wb
        elif self.mode == "neighbor_center":    # cat([x_j, x_i])
            w_center, w_neigh = Wb, Wa
        elif self.mode == "center_minus":       # cat([x_i, x_j - x_i])
            w_center, w_neigh = Wa - Wb, Wb
        else:
            raise ValueError(f"unknown mode {self.mode!r}")

        lead = x.shape[:-1]
        x2 = x.reshape(-1, C).astype(dt)
        center = jnp.dot(x2, w_center.astype(dt),
                         preferred_element_type=jnp.float32)
        neigh = jnp.dot(x2, w_neigh.astype(dt),
                        preferred_element_type=jnp.float32)
        center = center.reshape(lead + (self.features,)).astype(dt)
        neigh = neigh.reshape(lead + (self.features,)).astype(dt)
        y = center[:, :, None, :] + ops.grouping_operation(neigh, idx)
        if self.use_bias:
            bound = 1.0 / math.sqrt(2 * C)
            bias = self.param(
                "bias",
                lambda k, s: jax.random.uniform(k, s, jnp.float32, -bound, bound),
                (self.features,),
            )
            y = y + bias
        return y.astype(dt)


class BatchNorm(nn.Module):
    """torch-compatible BatchNorm over the last (channel) axis.

    torch momentum 0.1 == momentum 0.9 here; eps 1e-5. Under a sharded jit
    batch axis the batch statistics are computed globally by XLA — this is
    the NaiveSyncBatchNorm equivalent (reference utils/mm3d_pn2/ops/norm.py)
    for free.
    """

    momentum: float = 0.9
    epsilon: float = 1e-5
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, x, train: bool):
        return nn.BatchNorm(
            use_running_average=not train,
            momentum=self.momentum,
            epsilon=self.epsilon,
            # Activations follow the global policy (or an explicit local
            # override, e.g. IDAM's bf16 similarity stack); running stats
            # and scale/bias params stay fp32.
            dtype=self.dtype or compute_dtype(),
        )(x)


class MLP(nn.Module):
    """Dense [+BN] [+ReLU] stack on the last axis.

    channels: output sizes per layer. If bn, BatchNorm after each Dense.
    Activation after every layer except (optionally) the last.
    """

    channels: Sequence[int]
    bn: bool = False
    last_act: bool = True
    act: Callable = nn.relu
    use_bias: bool = True

    @nn.compact
    def __call__(self, x, train: bool = True):
        n = len(self.channels)
        for i, ch in enumerate(self.channels):
            x = TorchDense(ch, use_bias=self.use_bias and not self.bn)(x)
            if self.bn:
                x = BatchNorm()(x, train)
            if i < n - 1 or self.last_act:
                x = self.act(x)
        return x


def attention(query, key, value, mask=None):
    """Scaled dot-product attention (reference dcp.py:26-32).

    query/key/value: (..., N, d). Returns (out, attn weights).
    """
    d_k = query.shape[-1]
    # bf16 inputs keep bf16 score/weight tensors (halves the (N, M)
    # intermediates' memory traffic); f32 inputs keep f32 accumulation.
    pt = jnp.float32 if query.dtype == jnp.float32 else None
    scores = jnp.einsum(
        "...nd,...md->...nm", query, key, preferred_element_type=pt
    ) / jnp.asarray(math.sqrt(d_k), query.dtype)
    if mask is not None:
        scores = jnp.where(mask == 0, -1e9, scores)
    p_attn = jax.nn.softmax(scores, axis=-1)
    out = jnp.einsum(
        "...nm,...md->...nd", p_attn, value, preferred_element_type=pt
    )
    return out, p_attn


def mha_attention_bnhd(query, key, value, mask=None):
    """Multi-head attention core over the projection-native (B, N, H, dk)
    layout; returns out only (the transformer discards the weights).

    Dense formulation: the (B, H, N, M) scores are materialized, like the
    reference DCP pointer (dcp.py:26-32)."""
    out, _ = attention(
        jnp.swapaxes(query, 1, 2), jnp.swapaxes(key, 1, 2),
        jnp.swapaxes(value, 1, 2), mask,
    )
    return jnp.swapaxes(out, 1, 2)


class UnbiasedLayerNorm(nn.Module):
    """LayerNorm with torch-std semantics: (x - mean) / (std_unbiased + eps).

    Matches the reference's hand-rolled LayerNorm (dcp.py:144-154), which
    divides by the UNBIASED std plus eps (not sqrt(var + eps)).

    ``dtype``: output storage dtype (params and the mean/std math are
    always f32 — a bf16 input is upcast for the statistics). None emits
    f32.
    """

    epsilon: float = 1e-6
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, x):
        d = x.shape[-1]
        a = self.param("scale", nn.initializers.ones, (d,))
        b = self.param("bias", nn.initializers.zeros, (d,))
        x = x.astype(jnp.float32)
        # One-pass statistics: E[x^2] - E[x]^2 lets XLA fuse both
        # reductions into a single sweep over x (the two-pass
        # sum((x - mean)^2) form re-reads x after the mean reduce).
        # LN inputs here are centered O(1) activations, so the
        # cancellation risk of the textbook identity is negligible; the
        # max(., 0) guards the fp32 rounding case.
        mean = jnp.mean(x, axis=-1, keepdims=True)
        msq = jnp.mean(x * x, axis=-1, keepdims=True)
        var = jnp.maximum(msq - mean * mean, 0.0) * (d / (d - 1))
        std = jnp.sqrt(var)
        y = a * (x - mean) / (std + self.epsilon) + b
        return y.astype(self.dtype) if self.dtype is not None else y


def get_graph_feature(x, k: int = 20, minus_center: bool = True,
                      include_center_first: bool = False):
    """DGCNN edge features from dense kNN.

    x: (B, N, C) channels-last. Returns (B, N, k, 2C).

    minus_center=True  -> concat [x_i, x_j - x_i]   (completion model_utils:156-178)
    minus_center=False -> concat [x_i, x_j]
    include_center_first=False matches the registration variant's concat order
    [x_j, x_i] (dcp.py:44-66).
    """
    from mvp_benchmark_tpu import ops

    idx = ops.knn_indices(x, k)  # kNN in the feature space of x
    neigh = ops.grouping_operation(x, idx)                  # (B, N, k, C)
    center = jnp.broadcast_to(x[:, :, None, :], neigh.shape)
    if minus_center:
        return jnp.concatenate([center, neigh - center], axis=-1)
    if include_center_first:
        return jnp.concatenate([center, neigh], axis=-1)
    return jnp.concatenate([neigh, center], axis=-1)


def gen_grid_up(up_ratio: int, grid_size: float = 0.2) -> jnp.ndarray:
    """2D folding grid, (up_ratio, 2) — reference model_utils.py:140-153."""
    sqrted = int(math.sqrt(up_ratio)) + 1
    num_x, num_y = 1, up_ratio
    for i in reversed(range(1, sqrted + 1)):
        if up_ratio % i == 0:
            num_x = i
            num_y = up_ratio // i
            break
    grid_x = jnp.linspace(-grid_size, grid_size, num_x)
    grid_y = jnp.linspace(-grid_size, grid_size, num_y)
    x, y = jnp.meshgrid(grid_x, grid_y, indexing="ij")
    return jnp.stack([x, y], axis=-1).reshape(-1, 2)  # (up_ratio, 2)


def symmetric_svd_rotation(H: jnp.ndarray) -> jnp.ndarray:
    """Batched Kabsch rotation from covariance H (B, 3, 3) with reflection fix.

    Vectorizes the per-sample torch.svd loop of the reference SVD heads
    (dcp.py:331-381, idam.py:152-188): R = V diag(1,1,det) U^T via the
    sign-corrected last column of V.
    """
    U, _, Vt = jnp.linalg.svd(H.astype(jnp.float32))
    V = jnp.swapaxes(Vt, -1, -2)
    R = jnp.matmul(V, jnp.swapaxes(U, -1, -2), precision=lax.Precision.HIGHEST)
    det = jnp.linalg.det(R)
    # Flip the sign of V's last column where det < 0 (reflection fix).
    sign = jnp.where(det < 0, -1.0, 1.0)[:, None]
    V = V.at[:, :, 2].multiply(sign)
    R = jnp.matmul(V, jnp.swapaxes(U, -1, -2), precision=lax.Precision.HIGHEST)
    return R
