"""The module system (models/nn.py) and the shared layers."""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mvp_benchmark_tpu.models import get_model, layers as L, nn


class Pair(nn.Module):
    """Two Dense-like children, one of them called twice."""

    @nn.compact
    def __call__(self, x):
        a = L.TorchDense(4)
        b = L.TorchDense(4)
        return a(x) + b(a(x))


def test_autonaming_and_reuse():
    v = Pair().init(jax.random.PRNGKey(0), jnp.ones((2, 4)))
    assert set(v) == {"params"}
    assert set(v["params"]) == {"TorchDense_0", "TorchDense_1"}
    assert set(v["params"]["TorchDense_0"]) == {"kernel", "bias"}


def test_init_is_deterministic_per_path():
    x = jnp.ones((2, 4))
    v1 = Pair().init(jax.random.PRNGKey(0), x)
    v2 = Pair().init(jax.random.PRNGKey(0), x)
    for a, b in zip(jax.tree.leaves(v1), jax.tree.leaves(v2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    k0 = v1["params"]["TorchDense_0"]["kernel"]
    k1 = v1["params"]["TorchDense_1"]["kernel"]
    assert not np.allclose(np.asarray(k0), np.asarray(k1))


class BNNet(nn.Module):
    @nn.compact
    def __call__(self, x, train: bool = True):
        return L.BatchNorm()(x, train)


def test_apply_mutable_and_missing_variables():
    x = jnp.asarray(np.random.default_rng(0).normal(size=(8, 3)), jnp.float32)
    v = BNNet().init(jax.random.PRNGKey(0), x)
    # init does not update running averages
    np.testing.assert_array_equal(
        np.asarray(v["batch_stats"]["BatchNorm_0"]["BatchNorm_0"]["mean"]), 0)
    y, new = BNNet().apply(v, x, mutable=["batch_stats"])
    assert set(new) == {"batch_stats"}
    np.testing.assert_allclose(
        np.asarray(new["batch_stats"]["BatchNorm_0"]["BatchNorm_0"]["mean"]),
        0.1 * np.asarray(x).mean(0), rtol=1e-5, atol=1e-6)
    # train mode without a mutable batch_stats collection is an error
    with pytest.raises(ValueError, match="not mutable"):
        BNNet().apply(v, x)
    # eval mode needs no mutability and leaves the input untouched
    y_eval = BNNet().apply(v, x, train=False)
    assert y_eval.shape == x.shape
    with pytest.raises(ValueError, match="not found"):
        BNNet().apply({"params": v["params"]}, x, train=False)


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_matches_flax(train):
    """Same variables and same outputs as flax.linen.BatchNorm."""
    fnn = pytest.importorskip("flax.linen")
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(2.0, 3.0, (4, 5, 6)), jnp.float32)

    class Flax(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return fnn.BatchNorm(use_running_average=not train, momentum=0.9,
                                 epsilon=1e-5)(x)

    ours = nn.BatchNorm(use_running_average=not train, momentum=0.9,
                        epsilon=1e-5)
    vf = Flax().init(jax.random.PRNGKey(0), x)["batch_stats"]
    variables = {
        "params": {"scale": jnp.asarray(rng.random(6), jnp.float32),
                   "bias": jnp.asarray(rng.random(6), jnp.float32)},
        "batch_stats": {"mean": jnp.asarray(rng.random(6), jnp.float32),
                        "var": jnp.asarray(1 + rng.random(6), jnp.float32)},
    }
    flax_vars = {"params": {"BatchNorm_0": variables["params"]},
                 "batch_stats": {"BatchNorm_0": variables["batch_stats"]}}
    assert set(vf["BatchNorm_0"]) == set(variables["batch_stats"])
    yf, sf = Flax().apply(flax_vars, x, mutable=["batch_stats"])
    yo, so = ours.apply(variables, x, mutable=["batch_stats"])
    np.testing.assert_allclose(np.asarray(yo), np.asarray(yf), rtol=1e-5,
                               atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(
            np.asarray(so["batch_stats"][k]),
            np.asarray(sf["batch_stats"]["BatchNorm_0"][k]), rtol=1e-5)


def test_batchnorm_axis_name_averages_over_mapped_axis():
    x = jnp.asarray(np.random.default_rng(1).normal(size=(4, 8, 3)),
                    jnp.float32)
    bn = nn.BatchNorm(axis_name="data", momentum=0.9)
    v = bn.init(jax.random.PRNGKey(0), x[0])
    y = jax.vmap(lambda xi: bn.apply(v, xi, mutable=["batch_stats"])[0],
                 axis_name="data")(x)
    full = (x - x.mean((0, 1))) / jnp.sqrt(x.var((0, 1)) + 1e-5)
    np.testing.assert_allclose(np.asarray(y), np.asarray(full), rtol=1e-4,
                               atol=1e-4)


class Drop(nn.Module):
    rate: float
    deterministic: bool

    @nn.compact
    def __call__(self, x):
        d = nn.Dropout(self.rate, deterministic=self.deterministic)
        return d(x), d(x)


def test_dropout():
    x = jnp.ones((64, 64))
    v = Drop(0.5, True).init(jax.random.PRNGKey(0), x)
    a, b = Drop(0.5, True).apply(v, x)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(x))
    a, b = Drop(0.5, False).apply(
        v, x, rngs={"dropout": jax.random.PRNGKey(3)})
    assert set(np.unique(np.asarray(a))) <= {0.0, 2.0}
    assert 0.4 < float((a == 0).mean()) < 0.6
    assert not np.array_equal(np.asarray(a), np.asarray(b))   # fresh key
    with pytest.raises(ValueError, match="dropout"):
        Drop(0.5, False).apply(v, x)


def test_unbound_module_call_raises():
    with pytest.raises(RuntimeError, match="not bound"):
        L.TorchDense(3)(jnp.ones((2, 2)))


def test_multi_dense_matches_separate_torch_dense(rng):
    """MultiDense must match separate TorchDense heads with the same
    kernels/biases to reduction-order rounding (XLA may tile the reduction
    differently for different output widths)."""
    x = jnp.asarray(rng.standard_normal((2, 64, 48)).astype(np.float32))
    md = L.MultiDense((8, 8, 32))
    vs = md.init(jax.random.PRNGKey(0), x)
    y = md.apply(vs, x)
    assert y.shape == (2, 64, 48)

    # Rebuild the three separate heads from MultiDense's own params.
    p = vs["params"]
    for i, (lo, hi) in enumerate([(0, 8), (8, 16), (16, 48)]):
        td = L.TorchDense(hi - lo)
        out = td.apply(
            {"params": {"kernel": p[f"kernel{i}"], "bias": p[f"bias{i}"]}}, x
        )
        np.testing.assert_allclose(np.asarray(y[..., lo:hi]),
                                   np.asarray(out), rtol=1e-5, atol=1e-6)


# Digest of every model's variable tree (collection/path: shape, for the
# configs of tests/test_models_all.py), as flax.linen built it: checkpoints
# written by earlier versions keep loading.
TREE_DIGESTS = {
    "pcn": (20, "94567f68fe317da9"),
    "ecg": (64, "eba4bdbebc68dd49"),
    "vrcnet": (142, "1599ea29f06b7d44"),
    "dcp": (71, "7dd423a6a77d6cf9"),
    "deepgmr": (37, "ef1d5ecab29e55ea"),
    "idam": (99, "0ccef6a47b445dc4"),
}


@pytest.mark.parametrize("name", list(TREE_DIGESTS))
def test_variable_tree_keeps_its_keys(name):
    from tests.test_models_all import (COMPLETION_CFGS, REGISTRATION_CFGS,
                                       _clouds)

    cfg = {**COMPLETION_CFGS, **REGISTRATION_CFGS}[name]
    model = get_model(name, cfg)
    x, g = jnp.asarray(_clouds(1)), jnp.asarray(_clouds(2))
    args = (x, g) if name in COMPLETION_CFGS else (
        x, g, jnp.broadcast_to(jnp.eye(4), (2, 4, 4)))
    rngs = {k: jax.random.PRNGKey(i)
            for i, k in enumerate(("params", "dropout", "sample"))}
    v = jax.eval_shape(lambda: model.init(rngs, *args))
    leaves = sorted(f"{jax.tree_util.keystr(p)}:{tuple(leaf.shape)}"
                    for p, leaf in jax.tree_util.tree_leaves_with_path(v))
    digest = hashlib.sha256("\n".join(leaves).encode()).hexdigest()[:16]
    assert (len(leaves), digest) == TREE_DIGESTS[name], "\n".join(leaves)
