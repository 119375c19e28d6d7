"""Plain jnp implementations of the geometry op library.

XLA compiles these for every op that has no hand-written kernel, and they
are the numerical contract for the kernels in ``gpu_kernels`` (the same
strategy the reference repo uses in ``utils/metrics/CD/unit_test.py``,
which checks its CUDA chamfer against a dense pure-python implementation).

Semantics mirror the reference CUDA ops exactly:

- chamfer:        reference ``utils/metrics/CD/chamfer3D/chamfer3D.cu`` (squared
                  L2 dists + argmin indices both directions).
- emd_auction:    reference ``utils/metrics/EMD/emd_cuda.cu`` (auction algorithm
                  with price updates; gradient w.r.t. xyz1 only).
- furthest_point_sample: reference
                  ``utils/mm3d_pn2/ops/furthest_point_sample/src/furthest_point_sample_cuda.cu``
                  (greedy max-min starting at index 0, running min-dist buffer).
- ball_query:     reference ``utils/mm3d_pn2/ops/ball_query/src/ball_query_cuda.cu``
                  (first-hit-fill: empty slots repeat the first in-ball point;
                  all-zero row when no point is in the ball; annulus via
                  min_radius, with ``d2 == 0`` always accepted).
- knn/three_nn/gather/group/three_interpolate: reference
                  ``utils/mm3d_pn2/ops/{knn,interpolate,gather_points,group_points}``.

All point clouds are channels-last ``(B, N, 3)`` and features channels-last
``(B, N, C)``, so 1x1 convolutions are plain GEMMs over the feature dim. The
reference's channels-first wrappers live in ``compat`` shims where needed.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from mvp_benchmark_tpu.parallel.mesh import per_shard


def top_k(x: jnp.ndarray, k: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """``lax.top_k`` over the last axis, run per shard of the leading axis
    under a data-parallel mesh (``parallel.mesh.per_shard``): XLA's
    partitioner has no rule for top-k and would gather the operand whole
    onto every device."""
    if x.ndim < 2:
        return lax.top_k(x, k)
    return per_shard(lambda v: lax.top_k(v, k), x)


# ---------------------------------------------------------------------------
# Pairwise distances
# ---------------------------------------------------------------------------


def square_distance(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Pairwise squared L2 distances.

    a: (..., N, D), b: (..., M, D) -> (..., N, M).

    Uses the |a|^2 + |b|^2 - 2 a.b expansion (one matmul) and clamps at 0
    so downstream ``sqrt`` never sees negative round-off (the CUDA kernels
    compute exact difference-of-coordinates sums, which are non-negative).
    """
    a2 = jnp.sum(a * a, axis=-1, keepdims=True)          # (..., N, 1)
    b2 = jnp.sum(b * b, axis=-1, keepdims=True)          # (..., M, 1)
    # precision=HIGHEST: at default precision an f32 matmul may run as TF32
    # (about three decimal digits), which would break the 1e-4
    # distance-parity bar.
    inner = jnp.einsum(
        "...nd,...md->...nm",
        a,
        b,
        preferred_element_type=jnp.float32,
        precision=lax.Precision.HIGHEST,
    )
    d = a2 + jnp.swapaxes(b2, -1, -2) - 2.0 * inner
    return jnp.maximum(d, 0.0)


# ---------------------------------------------------------------------------
# Chamfer distance
# ---------------------------------------------------------------------------


def chamfer_distance(
    a: jnp.ndarray, b: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Bidirectional squared chamfer distance.

    a: (B, N, 3), b: (B, M, 3) ->
      dist1 (B, N): min_j |a_i - b_j|^2, dist2 (B, M): min_i |b_j - a_i|^2,
      idx1 (B, N) int32 argmin over b, idx2 (B, M) int32 argmin over a.

    Matches ``chamfer_3DFunction`` (reference
    ``utils/metrics/CD/chamfer3D/dist_chamfer_3D.py:26-74``). Differentiable
    w.r.t. both inputs (gradients route through the argmin like the CUDA
    backward's +-2g(p-q) scatter).
    """
    d = square_distance(a, b)
    idx1 = jnp.argmin(d, axis=-1).astype(jnp.int32)
    idx2 = jnp.argmin(d, axis=-2).astype(jnp.int32)
    # Recompute the min distances from the gathered points so gradients match
    # the CUDA backward exactly (flow only through the argmin pair).
    b_sel = jnp.take_along_axis(b, idx1[..., None].astype(jnp.int32), axis=1)
    a_sel = jnp.take_along_axis(a, idx2[..., None].astype(jnp.int32), axis=1)
    dist1 = jnp.sum((a - b_sel) ** 2, axis=-1)
    dist2 = jnp.sum((b - a_sel) ** 2, axis=-1)
    return dist1, dist2, idx1, idx2


# ---------------------------------------------------------------------------
# kNN family
# ---------------------------------------------------------------------------


def knn_indices(points: jnp.ndarray, k: int) -> jnp.ndarray:
    """k nearest neighbours of every point within the same cloud (self included).

    points: (B, N, 3) -> idx (B, N, k) int32, nearest first.

    Matches the dense ``knn(x, k)`` helper used across the reference models
    (``completion/model_utils.py:242-247``): top-k of the negative squared
    distance matrix.
    """
    d = square_distance(points, points)
    _, idx = top_k(-d, min(k, points.shape[-2]))
    return idx.astype(jnp.int32)


def knn_points(
    query: jnp.ndarray, points: jnp.ndarray, k: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """k nearest neighbours of `query` in `points`.

    query: (B, M, 3), points: (B, N, 3) ->
      neg_dist (B, M, k): NEGATIVE squared distances (descending, i.e. nearest
      first), idx (B, M, k) int32.

    Matches ``knn_point(pk, point_input, point_output)`` (reference
    ``completion/model_utils.py:250-259``) including the sign convention:
    the returned distances are negative squared L2 (the reference returns the
    topk values of ``-dist``). The distance output is differentiable.
    """
    d = square_distance(query, points)
    neg_d, idx = top_k(-d, min(k, points.shape[-2]))
    return neg_d, idx.astype(jnp.int32)


def knn_query(k: int, xyz: jnp.ndarray, center_xyz: jnp.ndarray) -> jnp.ndarray:
    """CUDA-op-compatible kNN: idx of k nearest points of `xyz` per center.

    xyz: (B, N, 3) database, center_xyz: (B, M, 3) queries -> idx (B, k, M).

    Matches the mm3d_pn2 ``knn`` extension (reference
    ``utils/mm3d_pn2/ops/knn/knn.py:7-72``): note the transposed (B, k, M)
    output layout.
    """
    _, idx = knn_points(center_xyz, xyz, k)
    return jnp.swapaxes(idx, -1, -2)


def three_nn(
    target: jnp.ndarray, source: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Three nearest source points for every target point.

    target: (B, N, 3), source: (B, M, 3) ->
      dist (B, N, 3): EUCLIDEAN (sqrt) distances ascending, idx (B, N, 3) int32.

    Matches mm3d_pn2 ``three_nn`` (reference
    ``utils/mm3d_pn2/ops/interpolate/three_nn.py:8-45`` — the CUDA kernel
    returns sqrt distances). Both outputs are non-differentiable exactly like
    the CUDA op (its autograd Function registers no backward); this also
    avoids inf gradients from sqrt at 0 when ``source`` is an FPS subset of
    ``target`` (upsampling always hits exact-zero distances).
    """
    d = square_distance(target, source)
    neg_d, idx = top_k(-d, 3)
    dist = jnp.sqrt(jnp.maximum(-neg_d, 0.0))
    return lax.stop_gradient(dist), idx.astype(jnp.int32)


def three_nn_upsampling(
    target_points: jnp.ndarray, source_points: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Indices + inverse-distance weights for 3-NN feature upsampling.

    Matches ``three_nn_upsampling`` (reference
    ``completion/model_utils.py:286-293``): dist clamped at 1e-10, weights
    normalized inverse distances.
    """
    dist, idx = three_nn(target_points, source_points)
    dist = jnp.maximum(dist, 1e-10)
    inv = 1.0 / dist
    weight = inv / jnp.sum(inv, axis=2, keepdims=True)
    return idx, weight


def three_interpolate(
    features: jnp.ndarray, idx: jnp.ndarray, weight: jnp.ndarray
) -> jnp.ndarray:
    """Weighted 3-point feature interpolation.

    features: (B, M, C), idx: (B, N, 3) int32, weight: (B, N, 3) ->
      (B, N, C).

    Matches mm3d_pn2 ``three_interpolate`` (reference
    ``utils/mm3d_pn2/ops/interpolate/three_interpolate.py:8-63``; the
    reference uses channels-first (B, C, M) — this is the channels-last
    equivalent). Differentiable w.r.t. features (scatter-add backward via XLA).
    """
    B, N, _ = idx.shape
    gathered = jax.vmap(lambda f, i: f[i])(features, idx)  # (B, N, 3, C)
    return jnp.sum(gathered * weight[..., None], axis=2)


# ---------------------------------------------------------------------------
# Gather / group
# ---------------------------------------------------------------------------


def gather_points(features: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Gather feature columns by index.

    features: (B, N, C), idx: (B, M) int -> (B, M, C).

    Channels-last equivalent of mm3d_pn2 ``gather_points`` (reference
    ``utils/mm3d_pn2/ops/gather_points/gather_points.py:7-52``); backward is
    the scatter-add XLA derives for take_along_axis.
    """
    return jnp.take_along_axis(features, idx[..., None].astype(jnp.int32), axis=1)


def grouping_operation(features: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Group feature vectors by a (B, M, K) index tensor.

    features: (B, N, C), idx: (B, M, K) int -> (B, M, K, C).

    Channels-last equivalent of mm3d_pn2 ``grouping_operation`` (reference
    ``utils/mm3d_pn2/ops/group_points/group_points.py:166-221``).
    """
    return jax.vmap(lambda f, i: f[i])(features, idx.astype(jnp.int32))


def group_max(features: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Max-pool of grouped features: (B, N, C), (B, M, K) -> (B, M, C)."""
    return jnp.max(grouping_operation(features, idx), axis=2)


# ---------------------------------------------------------------------------
# Furthest point sampling
# ---------------------------------------------------------------------------


def furthest_point_sample(xyz: jnp.ndarray, num_samples: int) -> jnp.ndarray:
    """Greedy furthest point sampling.

    xyz: (B, N, 3) -> idx (B, num_samples) int32.

    Matches the CUDA kernel exactly (reference
    ``utils/mm3d_pn2/ops/furthest_point_sample/src/furthest_point_sample_cuda.cu:26-135``):
    the first selected index is always 0; a running min-distance buffer
    (init 1e10) is updated against the last selected point and the argmax is
    taken each step. Non-differentiable (index output).
    """
    B, N, _ = xyz.shape

    def body(i, state):
        dists, last, idxs = state
        ref = jnp.take_along_axis(xyz, last[:, None, None], axis=1)  # (B,1,3)
        d = jnp.sum((xyz - ref) ** 2, axis=-1)                       # (B,N)
        dists = jnp.minimum(dists, d)
        nxt = jnp.argmax(dists, axis=1).astype(jnp.int32)
        idxs = idxs.at[:, i].set(nxt)
        return dists, nxt, idxs

    idxs0 = jnp.zeros((B, num_samples), jnp.int32)
    dists0 = jnp.full((B, N), 1e10, jnp.float32)
    last0 = jnp.zeros((B,), jnp.int32)
    _, _, idxs = lax.fori_loop(1, num_samples, body, (dists0, last0, idxs0))
    return lax.stop_gradient(idxs)


def furthest_point_sample_with_dist(
    dist_matrix: jnp.ndarray, num_samples: int
) -> jnp.ndarray:
    """FPS on a precomputed (B, N, N) distance matrix.

    Matches mm3d_pn2 ``furthest_point_sample_with_dist`` (reference
    ``utils/mm3d_pn2/ops/furthest_point_sample/furthest_point_sample.py:42-74``).
    """
    B, N, _ = dist_matrix.shape

    def body(i, state):
        dists, last, idxs = state
        d = jnp.take_along_axis(
            dist_matrix, last[:, None, None], axis=1
        ).squeeze(1)
        dists = jnp.minimum(dists, d)
        nxt = jnp.argmax(dists, axis=1).astype(jnp.int32)
        idxs = idxs.at[:, i].set(nxt)
        return dists, nxt, idxs

    idxs0 = jnp.zeros((B, num_samples), jnp.int32)
    dists0 = jnp.full((B, N), 1e10, jnp.float32)
    last0 = jnp.zeros((B,), jnp.int32)
    _, _, idxs = lax.fori_loop(1, num_samples, body, (dists0, last0, idxs0))
    return lax.stop_gradient(idxs)


# ---------------------------------------------------------------------------
# Ball query
# ---------------------------------------------------------------------------


def ball_query(
    min_radius: float,
    max_radius: float,
    nsample: int,
    xyz: jnp.ndarray,
    centers: jnp.ndarray,
) -> jnp.ndarray:
    """Fixed-size radius neighbourhood query with first-hit-fill semantics.

    xyz: (B, N, 3) database, centers: (B, M, 3) -> idx (B, M, nsample) int32.

    Matches the CUDA kernel (reference
    ``utils/mm3d_pn2/ops/ball_query/src/ball_query_cuda.cu:12-54``):
    a point k is in the neighbourhood iff ``d2 == 0`` or
    ``min_r^2 <= d2 < max_r^2``; hits fill slots in ascending index order;
    unfilled slots repeat the FIRST hit; a center with zero hits keeps the
    zero-initialised row.
    """
    B, N, _ = xyz.shape
    d2 = square_distance(centers, xyz)  # (B, M, N)
    # The CUDA kernel's ``d2 == 0`` test sees exact coordinate differences;
    # the matmul expansion rounds, so test coordinate equality directly.
    same = (
        (centers[:, :, None, 0] == xyz[:, None, :, 0])
        & (centers[:, :, None, 1] == xyz[:, None, :, 1])
        & (centers[:, :, None, 2] == xyz[:, None, :, 2])
    )
    valid = same | ((d2 >= min_radius**2) & (d2 < max_radius**2))
    n_iota = lax.broadcasted_iota(jnp.int32, d2.shape, 2)
    # Key: valid points keep their index; invalid points get index + N (so all
    # valid keys sort first, both groups in ascending index order).
    key = jnp.where(valid, n_iota, n_iota + N)
    neg_topk, _ = top_k(-key, nsample)          # smallest keys first
    slots = -neg_topk                                # (B, M, nsample)
    hit = slots < N
    first = jnp.where(hit[..., :1], slots[..., :1], 0)
    idx = jnp.where(hit, slots, first)
    return lax.stop_gradient(idx.astype(jnp.int32))


# ---------------------------------------------------------------------------
# Auction EMD
# ---------------------------------------------------------------------------


def _emd_body(carry, D, eps, n, m, last):
    """One auction round. D: (n, m) sqrt distance matrix (per batch element)."""
    assignment, assignment_inv, price = carry
    unass = assignment < 0

    benefit = 3.0 - D - price[None, :]                     # (n, m)
    # Best + second-best via two max sweeps keep each round one O(nm)
    # streaming pass instead of a top-k.
    best_i = jnp.argmax(benefit, axis=1).astype(jnp.int32)
    best = jnp.max(benefit, axis=1)
    col = lax.broadcasted_iota(jnp.int32, benefit.shape, 1)
    better = jnp.max(
        jnp.where(col == best_i[:, None], -jnp.inf, benefit), axis=1
    )
    bid_inc = best - better + eps                          # (n,)

    if last:
        # Final round force-assigns every remaining bidder to its best target
        # (reference emd_cuda.cu Assign kernel with last=true; may break
        # bijectivity, exactly like the CUDA version).
        assignment = jnp.where(unass, best_i.astype(jnp.int32), assignment)
        return (assignment, assignment_inv, price)

    neg_inf = jnp.float32(-jnp.inf)
    masked_inc = jnp.where(unass, bid_inc, neg_inf)
    # Per-target max bid (segment max over bidders).
    max_inc = jnp.full((m,), neg_inf).at[best_i].max(masked_inc)
    tie = unass & (masked_inc == max_inc[best_i])
    # Resolve ties deterministically: highest bidder index wins.
    winner_of = jnp.full((m,), -1, jnp.int32).at[best_i].max(
        jnp.where(tie, lax.iota(jnp.int32, n), -1)
    )
    i_iota = lax.iota(jnp.int32, n)
    is_winner = tie & (winner_of[best_i] == i_iota)

    # Evict previous owners of won targets.
    old_owner = assignment_inv[best_i]                     # (n,)
    evict_at = jnp.where(is_winner & (old_owner >= 0), old_owner, n)
    assignment = assignment.at[evict_at].set(-1, mode="drop")
    # Assign winners.
    assignment = jnp.where(is_winner, best_i.astype(jnp.int32), assignment)
    set_at = jnp.where(is_winner, best_i, m)
    assignment_inv = assignment_inv.at[set_at].set(i_iota, mode="drop")
    price = price.at[best_i].add(jnp.where(is_winner, bid_inc, 0.0))
    return (assignment, assignment_inv, price)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3))
def emd_auction(
    xyz1: jnp.ndarray, xyz2: jnp.ndarray, eps: float = 0.005, iters: int = 50
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Auction-algorithm approximation of the Earth Mover's Distance.

    xyz1 (predictions), xyz2 (ground truth): (B, n, 3), coords expected in
    [0, 1], n == m. Returns (dist (B, n) squared L2 to the assigned gt point,
    assignment (B, n) int32). Gradient w.r.t. xyz1 only, exactly like the
    reference (``utils/metrics/EMD/emd_module.py:72-81``).

    Re-derivation of the CUDA auction (reference
    ``utils/metrics/EMD/emd_cuda.cu:95-269``) as deterministic masked rounds:
    bid (top-2 benefit over targets) -> per-target segment-max of bid
    increments -> assign/evict -> price update, under ``lax.while_loop`` with
    early exit once every point is assigned; a final forced round assigns any
    leftovers (the CUDA ``last=true`` iteration).
    """
    return _emd_forward(xyz1, xyz2, eps, iters)


def emd_validate(xyz1: jnp.ndarray, xyz2: jnp.ndarray) -> None:
    """Static input validation mirroring the CUDA launcher's asserts
    (reference ``utils/metrics/EMD/emd_cuda.cu:236-249``): n == m,
    n % 1024 == 0, batch <= 512. The CUDA kernel additionally requires
    coordinates in [0, 1] (the benefit offset 3.0 assumes bounded
    distances); that is a runtime property — callers outside jit can check
    ``(x >= 0) & (x <= 1)`` themselves. This implementation stays correct
    for any n (the constraint is the CUDA kernel's block math, kept here as
    protocol documentation), so only hard shape errors raise.
    """
    B, n, _ = xyz1.shape
    m = xyz2.shape[1]
    if n != m:
        raise ValueError(f"EMD requires n == m, got {n} vs {m} "
                         "(emd_cuda.cu:239)")
    import warnings

    if B > 512:
        # The CUDA launcher's block-math limit (emd_cuda.cu:247). This
        # implementation has no such limit — warn like the n % 1024 case
        # instead of refusing a previously-working large-batch eval.
        warnings.warn(
            f"EMD protocol expects batch <= 512 (emd_cuda.cu:247); got "
            f"B={B}. The auction still runs correctly.", stacklevel=2,
        )
    if n % 1024 != 0:
        warnings.warn(
            f"EMD protocol expects n % 1024 == 0 (emd_cuda.cu:243); got "
            f"n={n}. The auction still runs correctly.", stacklevel=2,
        )


def _emd_forward(xyz1, xyz2, eps, iters):
    emd_validate(xyz1, xyz2)
    B, n, _ = xyz1.shape
    m = xyz2.shape[1]
    D = jnp.sqrt(square_distance(xyz1, xyz2))              # (B, n, m)

    def per_batch(Db):
        def cond(state):
            it, (assignment, _, _) = state
            return (it < iters - 1) & jnp.any(assignment < 0)

        def step(state):
            it, carry = state
            return it + 1, _emd_body(carry, Db, eps, n, m, last=False)

        carry0 = (
            jnp.full((n,), -1, jnp.int32),
            jnp.full((m,), -1, jnp.int32),
            jnp.zeros((m,), jnp.float32),
        )
        _, carry = lax.while_loop(cond, step, (0, carry0))
        assignment, _, _ = _emd_body(carry, Db, eps, n, m, last=True)
        return assignment

    assignment = jax.vmap(per_batch)(D)
    matched = jnp.take_along_axis(xyz2, assignment[..., None], axis=1)
    dist = jnp.sum((xyz1 - matched) ** 2, axis=-1)
    return dist, assignment


def _emd_fwd(xyz1, xyz2, eps, iters):
    dist, assignment = _emd_forward(xyz1, xyz2, eps, iters)
    return (dist, assignment), (xyz1, xyz2, assignment)


def _emd_bwd(eps, iters, res, g):
    xyz1, xyz2, assignment = res
    g_dist, _ = g
    matched = jnp.take_along_axis(xyz2, assignment[..., None], axis=1)
    # d dist / d xyz1 = 2 (xyz1 - xyz2[assignment]); xyz2 gets zero grads,
    # matching emd_module.py backward (gradxyz2 is returned as zeros).
    dx1 = 2.0 * g_dist[..., None] * (xyz1 - matched)
    return dx1, jnp.zeros_like(xyz2)


emd_auction.defvjp(_emd_fwd, _emd_bwd)


# ---------------------------------------------------------------------------
# Per-edge MLP blocks (DCP DGCNN, IDAM similarity stack and GNN)
# ---------------------------------------------------------------------------
#
# Matmul operands are bf16 with f32 accumulation; BatchNorm statistics and
# the normalisation are f32. In train mode the statistics are batch
# statistics over every axis but the channel axis, returned as (2, C)
# [mean, biased var] for the caller's running averages; in eval mode the
# given running statistics are used and None is returned in their place.

_BN_EPS = 1e-5


def _bf16_dot(x, w):
    return jnp.dot(
        x.reshape(-1, x.shape[-1]).astype(jnp.bfloat16),
        w.astype(jnp.bfloat16), preferred_element_type=jnp.float32,
    ).reshape(x.shape[:-1] + (w.shape[-1],))


def _bn_relu(h, gamma, beta, mean, var, train: bool):
    """BatchNorm over all but the last axis, then relu. Returns
    (out, stats) with stats = [mean, biased var] (2, C)."""
    f32 = jnp.float32
    if train:
        axes = tuple(range(h.ndim - 1))
        mean = jnp.mean(h, axis=axes)
        var = jnp.maximum(jnp.mean(h * h, axis=axes) - mean * mean, 0.0)
    else:
        mean, var = mean.astype(f32), var.astype(f32)
    hhat = (h - mean) * lax.rsqrt(var + _BN_EPS)
    out = jnp.maximum(hhat * gamma.astype(f32) + beta.astype(f32), 0.0)
    return out, lax.stop_gradient(jnp.stack([mean, var]))


def edge_mlp(a1, Ws, gammas, betas, means, variances, train: bool):
    """DCP's DGCNN chain on edge features a1 (B, k, N, C): per layer
    Dense (no bias) -> BN -> relu, each layer max-pooled over k
    (reference dcp.py:269-301). Returns (xs, stats): xs one (B, N, ch)
    per layer, stats a tuple of (2, ch) in train mode, else None."""
    a = a1.astype(jnp.float32)
    xs, stats = [], []
    for l, W in enumerate(Ws):
        h = _bf16_dot(a, W)
        a, st = _bn_relu(h, gammas[l], betas[l], means[l], variances[l],
                         train)
        stats.append(st)
        xs.append(jnp.max(a, axis=1))
    return tuple(xs), (tuple(stats) if train else None)


def sim_mlp(src, tgt, semb, temb, Wcat, W2, b2, W3, W4, b4,
            g1, be1, g2, be2, mean1, var1, mean2, var2, train: bool):
    """IDAM's similarity-matrix stack (reference idam.py:267-279) over all
    (src_i, tgt_j) pairs: concat([emb_i, emb_j, dist_ij, dir_ij]) ->
    Dense -> BN -> relu -> Dense (-> max over j: weights head) -> Dense ->
    BN -> relu -> Dense(1) (similarity logits, clipped to +-20).

    The first Dense is applied to each part of the virtual concat
    separately, so the (B, M, M, 2 emb + 4) input is never built.
    Positions are not differentiated. Returns (sim (B, M, M), wmax
    (B, M, C), stats) with stats = (st1, st2) in train mode, else None.
    """
    f32 = jnp.float32
    emb = semb.shape[-1]
    src = lax.stop_gradient(src.astype(f32))
    tgt = lax.stop_gradient(tgt.astype(f32))
    sp = _bf16_dot(semb, Wcat[:emb])
    tp = _bf16_dot(temb, Wcat[emb:2 * emb])
    w0 = Wcat[2 * emb].astype(f32)
    wxyz = Wcat[2 * emb + 1:2 * emb + 4]

    diff = src[:, :, None, :] - tgt[:, None, :, :]
    dist = jnp.sqrt(jnp.sum(diff * diff, axis=-1, keepdims=True))
    dproj = dist * w0 + _bf16_dot(diff / (dist + 1e-8), wxyz)
    h0 = sp[:, :, None, :] + tp[:, None, :, :] + dproj

    x1, st1 = _bn_relu(h0, g1, be1, mean1, var1, train)
    h1 = _bf16_dot(x1, W2) + b2.astype(f32)
    wmax = jnp.max(h1, axis=2)
    x2, st2 = _bn_relu(_bf16_dot(h1, W3), g2, be2, mean2, var2, train)
    simr = jnp.sum(x2 * W4.reshape(-1).astype(f32), axis=-1)
    sim = jnp.clip(simr + b4.reshape(()), -20.0, 20.0)
    return sim, wmax, ((st1, st2) if train else None)


def gnn_edge(a1, W, b, gamma, beta, mean, var, train: bool):
    """IDAM Propagate edge block (reference idam.py:115-128) on edge
    features a1 (B, k, N, C): BN -> relu -> Dense(+bias) -> max over k.
    Returns (x (B, N, C), stats (2, C) in train mode, else None)."""
    x1, st = _bn_relu(a1.astype(jnp.float32), gamma, beta, mean, var, train)
    h = _bf16_dot(x1, W) + b.astype(jnp.float32)
    return jnp.max(h, axis=1), (st if train else None)


def gnn_propagate(p, idx, W, b, gamma, beta, mean, var, train: bool):
    """One IDAM Propagate layer from projected features p (B, N, C) and the
    neighbour graph idx (B, N, k): edges gather(p, idx) - p_center, stored
    bf16 in the (B, k, N, C) layout, then ``gnn_edge``."""
    g = grouping_operation(p.astype(jnp.float32), idx)
    a1 = (g - p.astype(jnp.float32)[:, :, None, :]).astype(jnp.bfloat16)
    return gnn_edge(jnp.swapaxes(a1, 1, 2), W, b, gamma, beta, mean, var,
                    train)
