"""Triton kernels (ops/gpu_kernels.py) against the jnp references.

On the CPU the kernel bodies run in the Pallas interpreter
(``interpret=True``); the ``gpu`` tests compile them for the card at the
widths the models use."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mvp_benchmark_tpu.ops import dispatch, gpu_kernels, jnp_ref


def _cloud(rng, *shape):
    return jnp.asarray(rng.random(shape).astype(np.float32))


def _exact(x, y, idx):
    """|x_i - y_idx[i]|^2 by coordinate differences."""
    return jnp.sum((x - jnp.take_along_axis(y, idx[..., None], axis=1)) ** 2,
                   axis=-1)


def _assert_chamfer_close(a, b, out, ref, tol=1e-6):
    d1, d2, i1, i2 = out
    r1, r2, ri1, ri2 = ref
    assert d1.shape == r1.shape and d2.shape == r2.shape
    assert i1.dtype == jnp.int32 and i2.dtype == jnp.int32
    np.testing.assert_allclose(np.asarray(d1), np.asarray(r1), atol=tol)
    np.testing.assert_allclose(np.asarray(d2), np.asarray(r2), atol=tol)
    # Indices agree except where both candidates are equally near.
    for x, y, ik, ir in ((a, b, i1, ri1), (b, a, i2, ri2)):
        gap = np.abs(np.asarray(_exact(x, y, ik) - _exact(x, y, ir)))
        assert np.all((np.asarray(ik) == np.asarray(ir)) | (gap <= tol))
        # The kernel's distance is the exact distance at its own index.
        np.testing.assert_allclose(np.asarray(_exact(x, y, ik)),
                                   np.asarray(d1 if x is a else d2),
                                   atol=1e-7)


# ---------------------------------------------------------------------------
# Chamfer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,N,M", [
    (1, 1, 1), (2, 5, 7), (2, 7, 5), (1, 64, 64), (2, 100, 130),
    (1, 130, 33), (3, 1, 9), (2, 200, 129), (1, 33, 257),
])
def test_chamfer_matches_reference(rng, B, N, M):
    a, b = _cloud(rng, B, N, 3), _cloud(rng, B, M, 3)
    out = gpu_kernels.chamfer_distance(a, b, True)
    with jax.default_matmul_precision("highest"):
        ref = jnp_ref.chamfer_distance(a, b)
    _assert_chamfer_close(a, b, out, ref)


@pytest.mark.parametrize("B,N,M", [(2, 5, 7), (1, 64, 64), (2, 100, 130),
                                   (1, 130, 33)])
def test_chamfer_gradient_matches_reference(rng, B, N, M):
    """The custom backward (gather + scatter-add) equals autodiff of jnp_ref
    (which differentiates through the gathered nearest points)."""
    a, b = _cloud(rng, B, N, 3), _cloud(rng, B, M, 3)
    g1, g2 = _cloud(rng, B, N), _cloud(rng, B, M)

    def loss(cd):
        return lambda a, b: (jnp.sum(cd(a, b)[0] * g1)
                             + jnp.sum(jnp.sqrt(cd(a, b)[1] + 1.0) * g2))

    gk = jax.grad(loss(lambda a, b: gpu_kernels.chamfer_distance(a, b, True)),
                  argnums=(0, 1))(a, b)
    with jax.default_matmul_precision("highest"):
        gr = jax.grad(loss(jnp_ref.chamfer_distance), argnums=(0, 1))(a, b)
    for k, r in zip(gk, gr):
        np.testing.assert_allclose(np.asarray(k), np.asarray(r), atol=1e-5)


@pytest.mark.parametrize("tiles", [(4, 8), (8, 4), (16, 16)])
def test_chamfer_multi_tile_loop(rng, monkeypatch, tiles):
    """Small tiles: several query blocks and several loop steps over the
    other cloud, with a ragged last tile on both sides."""
    monkeypatch.setattr(gpu_kernels, "_CD_TN", tiles[0])
    monkeypatch.setattr(gpu_kernels, "_CD_TM", tiles[1])
    a, b = _cloud(rng, 2, 37, 3), _cloud(rng, 2, 29, 3)
    out = gpu_kernels.chamfer_distance(a, b, True)
    with jax.default_matmul_precision("highest"):
        ref = jnp_ref.chamfer_distance(a, b)
    _assert_chamfer_close(a, b, out, ref)


@pytest.mark.parametrize("tm", [4, 128])
def test_chamfer_ties_take_lowest_index(tm, monkeypatch):
    """Duplicated points are exact ties; the lowest index wins, like
    jnp.argmin, within a tile and across tiles."""
    monkeypatch.setattr(gpu_kernels, "_CD_TM", tm)
    base = np.random.default_rng(0).random((1, 6, 3)).astype(np.float32)
    b = jnp.asarray(np.concatenate([base, base, base], axis=1))  # 18 points
    a = jnp.asarray(base + 1e-3)
    _, _, i1, _ = gpu_kernels.chamfer_distance(a, b, True)
    np.testing.assert_array_equal(np.asarray(i1)[0], np.arange(6))


def test_chamfer_padding_never_wins():
    """Far-away queries still pick a real point, never a padded column."""
    a = jnp.full((1, 3, 3), 1e3, jnp.float32)
    b = jnp.asarray(np.random.default_rng(1).random((1, 5, 3)), jnp.float32)
    d1, _, i1, _ = gpu_kernels.chamfer_distance(a, b, True)
    assert np.all(np.asarray(i1) < 5)
    assert np.all(np.isfinite(np.asarray(d1)))


def test_chamfer_under_jit(rng):
    a, b = _cloud(rng, 2, 40, 3), _cloud(rng, 2, 24, 3)
    f = jax.jit(lambda a, b: gpu_kernels.chamfer_distance(a, b, True))
    for x, y in zip(f(a, b), gpu_kernels.chamfer_distance(a, b, True)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# ---------------------------------------------------------------------------
# Furthest point sampling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("N,S", [(1, 1), (7, 1), (64, 64), (100, 30),
                                 (300, 120), (257, 16), (33, 33), (5, 8)])
def test_fps_matches_reference(rng, N, S):
    x = _cloud(rng, 2, N, 3)
    got = gpu_kernels.furthest_point_sample(x, S, True)
    assert got.shape == (2, S) and got.dtype == jnp.int32
    np.testing.assert_array_equal(np.asarray(got),
                                  np.asarray(jnp_ref.furthest_point_sample(x, S)))


def _grid_cloud():
    g = np.stack(np.meshgrid(np.arange(4), np.arange(4), np.arange(4),
                             indexing="ij"), -1).reshape(1, 64, 3)
    return jnp.asarray(g.astype(np.float32))


@pytest.mark.parametrize("cloud,S", [
    (_grid_cloud(), 20),                       # integer grid: exact ties
    (jnp.tile(_grid_cloud()[:, :10], (1, 2, 1)), 15),   # every point twice
    (jnp.zeros((1, 9, 3), jnp.float32), 4),    # all points identical
])
def test_fps_ties_match_reference(cloud, S):
    np.testing.assert_array_equal(
        np.asarray(gpu_kernels.furthest_point_sample(cloud, S, True)),
        np.asarray(jnp_ref.furthest_point_sample(cloud, S)))


def test_fps_first_index_zero_and_no_gradient(rng):
    x = _cloud(rng, 3, 50, 3)
    idx = gpu_kernels.furthest_point_sample(x, 10, True)
    assert np.all(np.asarray(idx)[:, 0] == 0)
    g = jax.grad(lambda x: jnp.sum(
        gpu_kernels.furthest_point_sample(x, 10, True).astype(jnp.float32)))(x)
    assert not np.any(np.asarray(g))


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def _boom(*a, **k):
    raise AssertionError("kernel called")


def test_dispatch_uses_reference_on_cpu(rng, monkeypatch):
    assert jax.default_backend() == "cpu"
    assert not dispatch.use_gpu_kernels()
    monkeypatch.setattr(gpu_kernels, "chamfer_distance", _boom)
    monkeypatch.setattr(gpu_kernels, "furthest_point_sample", _boom)
    a, b = _cloud(rng, 1, 9, 3), _cloud(rng, 1, 11, 3)
    for x, y in zip(dispatch.chamfer_distance(a, b),
                    jnp_ref.chamfer_distance(a, b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    np.testing.assert_array_equal(
        np.asarray(dispatch.furthest_point_sample(a, 4)),
        np.asarray(jnp_ref.furthest_point_sample(a, 4)))


def test_dispatch_uses_kernels_on_gpu(rng, monkeypatch):
    """On the GPU both ops go to the kernel at every shape (no shape gate,
    no fallback)."""
    monkeypatch.setattr(dispatch, "use_gpu_kernels", lambda: True)
    calls = []
    monkeypatch.setattr(gpu_kernels, "chamfer_distance",
                        lambda a, b: calls.append("cd") or "cd")
    monkeypatch.setattr(gpu_kernels, "furthest_point_sample",
                        lambda x, s: calls.append("fps") or "fps")
    for n in (3, 2048, 3001):
        a = _cloud(rng, 1, n, 3)
        assert dispatch.chamfer_distance(a, a) == "cd"
        assert dispatch.furthest_point_sample(a, 2) == "fps"
    assert calls == ["cd", "fps"] * 3


# ---------------------------------------------------------------------------
# On the card: compiled kernels at model widths
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,M", [(32, 2048, 2048), (32, 3072, 2048),
                                   (64, 1024, 2048)])
def test_chamfer_on_gpu(gpu, B, N, M):
    rng = np.random.default_rng(0)
    a, b = _cloud(rng, B, N, 3), _cloud(rng, B, M, 3)
    out = jax.jit(gpu_kernels.chamfer_distance)(a, b)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(jnp_ref.chamfer_distance)(a, b)
    _assert_chamfer_close(a, b, out, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,S", [(32, 2048, 1024), (32, 3072, 2048),
                                   (64, 2048, 2048)])
def test_fps_on_gpu(gpu, B, N, S):
    x = _cloud(np.random.default_rng(0), B, N, 3)
    np.testing.assert_array_equal(
        np.asarray(gpu_kernels.furthest_point_sample(x, S)),
        np.asarray(jax.jit(jnp_ref.furthest_point_sample,
                           static_argnums=1)(x, S)))
