"""Hand-written GPU kernels (Pallas, Triton route) for the geometry ops whose
CUDA originals beat what XLA makes of the plain ``jnp_ref`` formulation.

- ``chamfer_distance``: one launch per direction, as in the reference
  ``utils/metrics/CD/chamfer3D/chamfer3D.cu``. A block owns a tile of query
  points and streams the other cloud through a loop, keeping the running
  min and argmin in registers, so the (B, N, M) distance plane never
  reaches device memory. Distances are exact coordinate differences (no
  |a|^2 + |b|^2 - 2ab expansion). The backward is plain jnp: gather by
  index, then a scatter-add, like the CUDA backward's atomic scatter.
- ``furthest_point_sample``: one block per cloud, as in the reference
  ``furthest_point_sample_cuda.cu``. The cloud and its running
  min-distance buffer stay in registers for all greedy steps; each step is
  one block-wide argmax instead of an XLA while-loop iteration.

Every kernel names the Triton route explicitly. ``interpret=True`` runs
the same kernel bodies in the Pallas interpreter (CPU tests); nothing
switches interpret mode on by backend.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Chamfer tiles: query points per block and other-cloud points per loop step.
_CD_TN = 32
_CD_TM = 128
_CD_WARPS = 4
_FPS_WARPS = 4


def _next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def _planar(x, n_pad, fill):
    """(B, N, 3) -> three (B, n_pad) coordinate rows, padded with ``fill``."""
    x = jnp.pad(x.astype(jnp.float32), ((0, 0), (0, n_pad - x.shape[1]), (0, 0)),
                constant_values=fill)
    return x[..., 0], x[..., 1], x[..., 2]


# ---------------------------------------------------------------------------
# Chamfer distance
# ---------------------------------------------------------------------------


def _nn_kernel(ax_ref, ay_ref, az_ref, bx_ref, by_ref, bz_ref, d_ref, i_ref,
               *, tn, tm, m_tiles):
    """Nearest neighbour in b of every point of one (tn,) tile of a.

    Each (row, lane) slot keeps its own running min and the tile it came
    from, so the loop body is elementwise; the one cross-lane reduction
    happens after the loop.
    """
    b = pl.program_id(0)
    rows = pl.ds(pl.program_id(1) * tn, tn)
    ax = ax_ref[b, rows][:, None]
    ay = ay_ref[b, rows][:, None]
    az = az_ref[b, rows][:, None]

    def body(t, carry):
        best, tile = carry
        cols = pl.ds(t * tm, tm)
        dx = ax - bx_ref[b, cols][None, :]
        dy = ay - by_ref[b, cols][None, :]
        dz = az - bz_ref[b, cols][None, :]
        d = dx * dx + dy * dy + dz * dz                       # (tn, tm)
        # Strictly smaller: an earlier tile keeps a tie.
        better = d < best
        return jnp.where(better, d, best), jnp.where(better, t, tile)

    init = (jnp.full((tn, tm), jnp.inf, jnp.float32),
            jnp.zeros((tn, tm), jnp.int32))
    best, tile = lax.fori_loop(0, m_tiles, body, init)
    dmin = jnp.min(best, axis=1)
    idx = tile * tm + lax.broadcasted_iota(jnp.int32, (tn, tm), 1)
    # Lowest index among the slots that hold the minimum, like jnp.argmin.
    big = jnp.int32(jnp.iinfo(jnp.int32).max)
    d_ref[b, rows] = dmin
    i_ref[b, rows] = jnp.min(jnp.where(best == dmin[:, None], idx, big), axis=1)


def _nearest(a, b, interpret):
    """For every point of a (B, N, 3): squared distance to and index of its
    nearest point in b (B, M, 3)."""
    B, N, _ = a.shape
    M = b.shape[1]
    tn = min(_CD_TN, _next_pow2(N))
    tm = min(_CD_TM, _next_pow2(M))
    n_pad = pl.cdiv(N, tn) * tn
    m_pad = pl.cdiv(M, tm) * tm
    d, i = pl.pallas_call(
        functools.partial(_nn_kernel, tn=tn, tm=tm, m_tiles=m_pad // tm),
        grid=(B, n_pad // tn),
        out_shape=(jax.ShapeDtypeStruct((B, n_pad), jnp.float32),
                   jax.ShapeDtypeStruct((B, n_pad), jnp.int32)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_CD_WARPS,
                                             num_stages=2),
        interpret=interpret,
        name="chamfer_nn",
    )(*_planar(a, n_pad, 0.0), *_planar(b, m_pad, jnp.inf))
    return d[:, :N], i[:, :N]


def _chamfer(a, b, interpret):
    d1, i1 = _nearest(a, b, interpret)
    d2, i2 = _nearest(b, a, interpret)
    return d1, d2, i1, i2


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def chamfer_distance(a, b, interpret: bool = False):
    """Bidirectional squared chamfer distance; same contract as
    ``jnp_ref.chamfer_distance``: (dist1 (B, N), dist2 (B, M), idx1, idx2)."""
    return _chamfer(a, b, interpret)


def _chamfer_fwd(a, b, interpret):
    out = _chamfer(a, b, interpret)
    return out, (a, b, out[2], out[3])


def _chamfer_bwd(interpret, res, g):
    a, b, i1, i2 = res
    g1, g2 = g[0], g[1]
    bidx = jnp.arange(a.shape[0])[:, None]
    # d dist1_i = 2 (a_i - b_idx1[i]) g1_i on a_i, the negative on b_idx1[i]
    # (reference chamfer3D.cu backward, which scatters with atomics).
    ga1 = 2.0 * g1[..., None] * (a - b[bidx, i1])
    gb2 = 2.0 * g2[..., None] * (b - a[bidx, i2])
    da = ga1.at[bidx, i2].add(-gb2)
    db = gb2.at[bidx, i1].add(-ga1)
    return da.astype(a.dtype), db.astype(b.dtype)


chamfer_distance.defvjp(_chamfer_fwd, _chamfer_bwd)


# ---------------------------------------------------------------------------
# Furthest point sampling
# ---------------------------------------------------------------------------


def _fps_kernel(x_ref, y_ref, z_ref, o_ref, *, n, num_samples, n_pad, s_pad):
    b = pl.program_id(0)
    x = x_ref[b, :]
    y = y_ref[b, :]
    z = z_ref[b, :]
    iota = lax.broadcasted_iota(jnp.int32, (n_pad,), 0)
    s_iota = lax.broadcasted_iota(jnp.int32, (s_pad,), 0)

    def point(i):
        hit = iota == i
        return (jnp.sum(jnp.where(hit, x, 0.0)), jnp.sum(jnp.where(hit, y, 0.0)),
                jnp.sum(jnp.where(hit, z, 0.0)))

    def body(i, carry):
        dist, sel, px, py, pz = carry
        dx = x - px
        dy = y - py
        dz = z - pz
        dist = jnp.minimum(dist, dx * dx + dy * dy + dz * dz)
        nxt = jnp.argmax(dist).astype(jnp.int32)   # lowest index wins a tie
        sel = jnp.where(s_iota == i, nxt, sel)
        return (dist, sel) + point(nxt)

    # Padded points start at -inf, so they can never be the furthest.
    dist = jnp.where(iota < n, jnp.float32(1e10), -jnp.inf)
    sel = jnp.zeros((s_pad,), jnp.int32)
    _, sel, *_ = lax.fori_loop(1, num_samples, body, (dist, sel) + point(0))
    o_ref[b, :] = sel


@functools.partial(jax.jit, static_argnums=(1, 2))
def furthest_point_sample(xyz, num_samples: int, interpret: bool = False):
    """Greedy FPS; same contract and arithmetic as
    ``jnp_ref.furthest_point_sample`` (first index 0, running min buffer
    initialised to 1e10, lowest index wins a tie)."""
    B, N, _ = xyz.shape
    n_pad = _next_pow2(N)
    s_pad = _next_pow2(num_samples)
    idx = pl.pallas_call(
        functools.partial(_fps_kernel, n=N, num_samples=num_samples,
                          n_pad=n_pad, s_pad=s_pad),
        grid=(B,),
        out_shape=jax.ShapeDtypeStruct((B, s_pad), jnp.int32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_FPS_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="furthest_point_sample",
    )(*_planar(lax.stop_gradient(xyz), n_pad, 0.0))
    return idx[:, :num_samples]
