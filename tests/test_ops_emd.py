"""Auction EMD tests — ports the reference's own self-check
(utils/metrics/EMD/emd_module.py:90-104): assignment-consistency of the
returned distances, near-bijectivity, plus gradient formula checks and an
optimality sanity bound vs scipy's exact solver.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mvp_benchmark_tpu import ops
from mvp_benchmark_tpu.ops import jnp_ref


def clouds(rng, B=2, N=128):
    # EMD contract: coords normalized to [0, 1].
    x1 = rng.random((B, N, 3), dtype=np.float64).astype(np.float32)
    x2 = rng.random((B, N, 3), dtype=np.float64).astype(np.float32)
    return x1, x2


def test_dist_matches_assignment(rng):
    """dist[i] must equal |x1_i - x2_assignment[i]|^2 (emd self-check)."""
    x1, x2 = clouds(rng)
    dist, assign = jax.jit(
        lambda a, b: ops.emd_auction(a, b, 0.02, 100)
    )(x1, x2)
    assign = np.asarray(assign)
    assert np.all(assign >= 0)
    for b in range(x1.shape[0]):
        matched = x2[b][assign[b]]
        exp = np.sum((x1[b] - matched) ** 2, -1)
        np.testing.assert_allclose(np.asarray(dist[b]), exp, rtol=1e-4, atol=1e-6)


def test_near_bijection(rng):
    """With enough iterations the assignment must be (near-)bijective."""
    x1, x2 = clouds(rng, B=2, N=128)
    _, assign = ops.emd_auction(x1, x2, 0.005, 3000)
    for b in range(2):
        uniq = len(np.unique(np.asarray(assign[b])))
        assert uniq >= 127, f"batch {b}: only {uniq}/128 unique targets"


def test_identity_on_equal_clouds(rng):
    """Matching a cloud against itself must find the zero-cost bijection."""
    x1, _ = clouds(rng, B=1, N=64)
    dist, assign = ops.emd_auction(x1, x1, 0.002, 2000)
    mean = float(jnp.sqrt(dist).mean())
    assert mean < 0.05, mean


def test_close_to_exact_emd(rng):
    """Auction result within a modest factor of scipy's exact assignment."""
    from scipy.optimize import linear_sum_assignment

    x1, x2 = clouds(rng, B=1, N=64)
    dist, _ = ops.emd_auction(x1, x2, 0.002, 3000)
    approx = float(jnp.sqrt(dist).mean())

    P = np.sqrt(
        np.sum((x1[0][:, None] - x2[0][None]) ** 2, -1)
    )
    r, c = linear_sum_assignment(P)
    exact = P[r, c].mean()
    assert approx <= exact * 1.05 + 0.01, (approx, exact)
    assert approx >= exact * 0.999, (approx, exact)


def test_gradient_formula(rng):
    """grad wrt xyz1 = 2 g (x1 - x2[assign]); grad wrt xyz2 = 0."""
    x1, x2 = clouds(rng, B=1, N=32)

    def loss(a, b):
        d, _ = ops.emd_auction(a, b, 0.02, 200)
        return jnp.sum(d)

    g1, g2 = jax.grad(loss, argnums=(0, 1))(x1, x2)
    _, assign = ops.emd_auction(x1, x2, 0.02, 200)
    matched = x2[0][np.asarray(assign[0])]
    np.testing.assert_allclose(
        np.asarray(g1[0]), 2.0 * (x1[0] - matched), rtol=1e-4, atol=1e-6
    )
    assert float(jnp.max(jnp.abs(g2))) == 0.0


def test_emd_eval_protocol_timed():
    """Eval-protocol EMD (eps 0.004, 3000 iters — reference pcn.py:108) at
    n=1024 (the CUDA kernel's minimum n % 1024 == 0 size): converges to a
    bijection, distances are consistent, and a post-compile run stays within
    a CPU time budget (the old top_k-per-round formulation took >9 min)."""
    import time

    rng = np.random.default_rng(3)
    B, n = 1, 1024
    x1 = jnp.asarray(rng.random((B, n, 3)).astype(np.float32))
    x2 = jnp.asarray(rng.random((B, n, 3)).astype(np.float32))

    f = jax.jit(lambda a, b: jnp_ref.emd_auction(a, b, 0.004, 3000))
    d, assign = f(x1, x2)
    jax.block_until_ready(d)
    t0 = time.perf_counter()
    d, assign = f(x1, x2)
    jax.block_until_ready(d)
    elapsed = time.perf_counter() - t0
    assert elapsed < 180.0, f"eval-protocol EMD too slow: {elapsed:.1f}s"

    a = np.asarray(assign[0])
    # The final forced round may assign a leftover bidder to an owned target,
    # exactly like the CUDA last=true iteration (emd_cuda.cu Assign kernel):
    # require near-bijectivity (the reference's own self-check measures
    # |set(assignment)| the same way, emd_module.py:90-104).
    assert len(set(a.tolist())) >= n - 2, len(set(a.tolist()))
    matched = np.asarray(x2[0])[a]
    expect = np.sum((np.asarray(x1[0]) - matched) ** 2, -1)
    np.testing.assert_allclose(np.asarray(d[0]), expect, rtol=1e-5, atol=1e-6)


def test_emd_validate_shapes():
    """Shape validation mirrors emd_cuda.cu:236-249."""
    import pytest as _pytest

    x1 = jnp.zeros((2, 64, 3))
    with _pytest.raises(ValueError):
        jnp_ref.emd_validate(x1, jnp.zeros((2, 32, 3)))
    # B > 512 is a CUDA launcher block-math limit with no analogue here —
    # it warns (like n % 1024) instead of refusing a working computation.
    with _pytest.warns(UserWarning):
        jnp_ref.emd_validate(jnp.zeros((513, 1024, 3)),
                             jnp.zeros((513, 1024, 3)))
    with _pytest.warns(UserWarning):
        jnp_ref.emd_validate(x1, x1)
