"""The per-edge MLP blocks and the gathers of ops/jnp_ref.py against
independent compositions: unfused module stacks, numpy statistics, and
numpy scatter-add oracles for the gather gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mvp_benchmark_tpu.models import nn
from mvp_benchmark_tpu.ops import jnp_ref


def _f(rng, *shape, scale=1.0):
    return jnp.asarray((scale * rng.standard_normal(shape)).astype(np.float32))


def _bf16_dot(x, w):
    return jnp.einsum("...c,cd->...d", x.astype(jnp.bfloat16),
                      w.astype(jnp.bfloat16),
                      preferred_element_type=jnp.float32)


def _batchnorm(h, gamma, beta, mean, var, train):
    """models.nn.BatchNorm with the block's parameters and statistics."""
    bn = nn.BatchNorm(use_running_average=not train, momentum=0.9,
                      epsilon=1e-5)
    variables = {"params": {"scale": gamma, "bias": beta},
                 "batch_stats": {"mean": mean, "var": var}}
    if train:
        return bn.apply(variables, h, mutable=["batch_stats"])[0]
    return bn.apply(variables, h)


def _np_stats(h):
    h = np.asarray(h, np.float64).reshape(-1, h.shape[-1])
    return np.stack([h.mean(0), h.var(0)])


def _bn_params(rng, C):
    return (jnp.ones(C) + _f(rng, C, scale=0.1), _f(rng, C, scale=0.1),
            _f(rng, C, scale=0.1), 1.0 + jnp.abs(_f(rng, C, scale=0.2)))


# ---------------------------------------------------------------------------
# Per-edge MLP blocks
# ---------------------------------------------------------------------------


class TestEdgeMlp:
    @pytest.mark.parametrize("train", [True, False])
    @pytest.mark.parametrize("chs", [(16,), (16, 8, 32)])
    def test_matches_unfused_stack(self, rng, train, chs):
        B, k, N, C = 2, 5, 12, 8
        a1 = _f(rng, B, k, N, C).astype(jnp.bfloat16)
        cins = (C,) + chs[:-1]
        Ws = tuple(_f(rng, ci, co, scale=0.3) for ci, co in zip(cins, chs))
        bn = [_bn_params(rng, c) for c in chs]
        xs, stats = jnp_ref.edge_mlp(
            a1, Ws, *[tuple(p[i] for p in bn) for i in range(4)], train)

        a = a1.astype(jnp.float32)
        for layer, W in enumerate(Ws):
            h = _bf16_dot(a, W)
            if train:
                np.testing.assert_allclose(np.asarray(stats[layer]),
                                           _np_stats(h), rtol=1e-4,
                                           atol=1e-5)
            a = jax.nn.relu(_batchnorm(h, *bn[layer], train))
            np.testing.assert_allclose(np.asarray(xs[layer]),
                                       np.asarray(jnp.max(a, axis=1)),
                                       rtol=1e-4, atol=1e-5)
        assert (stats is None) == (not train)


class TestGnnEdge:
    @pytest.mark.parametrize("train", [True, False])
    def test_matches_unfused_stack(self, rng, train):
        B, k, N, C = 2, 4, 10, 8
        a1 = _f(rng, B, k, N, C).astype(jnp.bfloat16)
        W, b = _f(rng, C, C, scale=0.3), _f(rng, C, scale=0.1)
        gamma, beta, mean, var = _bn_params(rng, C)
        x, st = jnp_ref.gnn_edge(a1, W, b, gamma, beta, mean, var, train)
        a = a1.astype(jnp.float32)
        h = _bf16_dot(jax.nn.relu(_batchnorm(a, gamma, beta, mean, var,
                                             train)), W) + b
        np.testing.assert_allclose(np.asarray(x),
                                   np.asarray(jnp.max(h, axis=1)),
                                   rtol=1e-4, atol=1e-5)
        if train:
            np.testing.assert_allclose(np.asarray(st), _np_stats(a),
                                       rtol=1e-4, atol=1e-5)
        else:
            assert st is None


class TestGnnPropagate:
    def _setup(self, rng, B=2, k=5, N=48, C=16):
        p = _f(rng, B, N, C)
        idx = jnp.asarray(np.argsort(
            rng.random((B, N, N)), axis=-1)[:, :, :k].astype(np.int32))
        W, b = _f(rng, C, C, scale=0.3), _f(rng, C, scale=0.1)
        return (p, idx, W, b) + _bn_params(rng, C)

    @pytest.mark.parametrize("train", [True, False])
    def test_matches_unfused_gnn_edge(self, rng, train):
        """Edge build (numpy gather - center, stored bf16, (B, k, N, C))
        followed by gnn_edge."""
        p, idx, W, b, gamma, beta, mean, var = self._setup(rng)
        x, st = jnp_ref.gnn_propagate(p, idx, W, b, gamma, beta, mean, var,
                                      train)
        pn, ix = np.asarray(p), np.asarray(idx)
        edges = np.stack([pn[i][ix[i]] - pn[i][:, None, :]
                          for i in range(pn.shape[0])])
        a1 = jnp.swapaxes(jnp.asarray(edges).astype(jnp.bfloat16), 1, 2)
        xu, stu = jnp_ref.gnn_edge(a1, W, b, gamma, beta, mean, var, train)
        np.testing.assert_allclose(np.asarray(x), np.asarray(xu),
                                   rtol=1e-5, atol=1e-5)
        if train:
            np.testing.assert_allclose(np.asarray(st), np.asarray(stu),
                                       rtol=1e-6, atol=1e-7)


class TestSimMlp:
    @pytest.mark.parametrize("train", [True, False])
    def test_matches_materialized_concat(self, rng, train):
        """Against the reference formulation: Dense over the materialized
        (B, M, M, 2 emb + 4) concat [emb_i, emb_j, dist_ij, dir_ij], in f32
        at HIGHEST. The block rounds matmul operands to bf16 (relative
        2^-9 per operand) through four layers and two BatchNorms, hence the
        2e-2 tolerance on O(1) outputs."""
        B, M, emb, C = 2, 9, 12, 8
        src, tgt = _f(rng, B, M, 3), _f(rng, B, M, 3)
        semb, temb = _f(rng, B, M, emb), _f(rng, B, M, emb)
        Wcat = _f(rng, 2 * emb + 4, C, scale=0.3)
        W2, W3 = _f(rng, C, C, scale=0.3), _f(rng, C, C, scale=0.3)
        W4 = _f(rng, C, 1, scale=0.3)
        b2, b4 = _f(rng, C, scale=0.1), _f(rng, 1, scale=0.1)
        g1, be1, m1, v1 = _bn_params(rng, C)
        g2, be2, m2, v2 = _bn_params(rng, C)
        sim, wmax, stats = jnp_ref.sim_mlp(
            src, tgt, semb, temb, Wcat, W2, b2, W3, W4, b4, g1, be1, g2, be2,
            m1, v1, m2, v2, train)

        with jax.default_matmul_precision("highest"):
            diff = src[:, :, None, :] - tgt[:, None, :, :]
            dist = jnp.sqrt(jnp.sum(diff ** 2, -1, keepdims=True))
            cat = jnp.concatenate([
                jnp.broadcast_to(semb[:, :, None], (B, M, M, emb)),
                jnp.broadcast_to(temb[:, None], (B, M, M, emb)),
                dist, diff / (dist + 1e-8)], axis=-1)
            h0 = cat @ Wcat
            x1 = jax.nn.relu(_batchnorm(h0, g1, be1, m1, v1, train))
            h1 = x1 @ W2 + b2
            x2 = jax.nn.relu(_batchnorm(h1 @ W3, g2, be2, m2, v2, train))
            want = jnp.clip((x2 @ W4)[..., 0] + b4[0], -20.0, 20.0)
        np.testing.assert_allclose(np.asarray(sim), np.asarray(want),
                                   atol=2e-2)
        np.testing.assert_allclose(np.asarray(wmax),
                                   np.asarray(jnp.max(h1, axis=2)), atol=2e-2)
        if train:
            np.testing.assert_allclose(np.asarray(stats[0]), _np_stats(h0),
                                       rtol=2e-2, atol=2e-2)
        else:
            assert stats is None


# ---------------------------------------------------------------------------
# Gathers: forward and scatter-add backward against numpy
# ---------------------------------------------------------------------------


def _scatter_rows(n_rows, idx, rows):
    """numpy oracle: out[idx[j]] += rows[j] for every j (per batch)."""
    out = np.zeros((idx.shape[0], n_rows, rows.shape[-1]), np.float64)
    for b in range(idx.shape[0]):
        np.add.at(out[b], idx[b].reshape(-1),
                  rows[b].reshape(-1, rows.shape[-1]))
    return out


@pytest.mark.parametrize("N,M,K,C", [(20, 7, 4, 3), (33, 16, 9, 16)])
def test_grouping_operation_grad_is_scatter_add(rng, N, M, K, C):
    feats = _f(rng, 2, N, C)
    idx = rng.integers(0, N, (2, M, K)).astype(np.int32)
    ct = _f(rng, 2, M, K, C)
    out = jnp_ref.grouping_operation(feats, jnp.asarray(idx))
    np.testing.assert_array_equal(
        np.asarray(out), np.stack([np.asarray(feats)[b][idx[b]]
                                   for b in range(2)]))
    g = jax.grad(lambda f: jnp.sum(
        jnp_ref.grouping_operation(f, jnp.asarray(idx)) * ct))(feats)
    np.testing.assert_allclose(np.asarray(g),
                               _scatter_rows(N, idx, np.asarray(ct)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("N,M,C", [(20, 7, 3), (33, 40, 16)])
def test_gather_points_grad_is_scatter_add(rng, N, M, C):
    feats = _f(rng, 2, N, C)
    idx = rng.integers(0, N, (2, M)).astype(np.int32)
    ct = _f(rng, 2, M, C)
    g = jax.grad(lambda f: jnp.sum(
        jnp_ref.gather_points(f, jnp.asarray(idx)) * ct))(feats)
    np.testing.assert_allclose(np.asarray(g),
                               _scatter_rows(N, idx, np.asarray(ct)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("N,M,C", [(12, 30, 3), (40, 25, 16)])
def test_three_interpolate_grads(rng, N, M, C):
    feats = _f(rng, 2, N, C)
    idx = rng.integers(0, N, (2, M, 3)).astype(np.int32)
    w = jnp.asarray(rng.random((2, M, 3)).astype(np.float32))
    ct = _f(rng, 2, M, C)
    gf, gw = jax.grad(lambda f, w: jnp.sum(
        jnp_ref.three_interpolate(f, jnp.asarray(idx), w) * ct),
        argnums=(0, 1))(feats, w)
    rows = np.asarray(w)[..., None] * np.asarray(ct)[:, :, None, :]
    np.testing.assert_allclose(np.asarray(gf), _scatter_rows(N, idx, rows),
                               rtol=1e-5, atol=1e-5)
    fn = np.asarray(feats)
    want_w = np.stack([np.einsum("mkc,mc->mk", fn[b][idx[b]],
                                 np.asarray(ct)[b]) for b in range(2)])
    np.testing.assert_allclose(np.asarray(gw), want_w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("N,M,K,C", [(20, 7, 4, 3), (33, 16, 9, 16)])
def test_group_max_grad_routes_to_argmax(rng, N, M, K, C):
    feats = _f(rng, 2, N, C)
    # distinct neighbours per row: no exact ties in the max
    idx = np.argsort(rng.random((2, M, N)), axis=-1)[:, :, :K].astype(np.int32)
    ct = _f(rng, 2, M, C)
    out = jnp_ref.group_max(feats, jnp.asarray(idx))
    fn = np.asarray(feats)
    grouped = np.stack([fn[b][idx[b]] for b in range(2)])     # (2, M, K, C)
    np.testing.assert_array_equal(np.asarray(out), grouped.max(axis=2))
    g = jax.grad(lambda f: jnp.sum(
        jnp_ref.group_max(f, jnp.asarray(idx)) * ct))(feats)
    want = np.zeros((2, N, C))
    arg = grouped.argmax(axis=2)                               # (2, M, C)
    for b in range(2):
        for m in range(M):
            for c in range(C):
                want[b, idx[b, m, arg[b, m, c]], c] += float(ct[b, m, c])
    np.testing.assert_allclose(np.asarray(g), want, rtol=1e-5, atol=1e-5)
