"""Per-shard execution under a data-parallel mesh (``parallel.mesh.per_shard``)
on virtual CPU devices: the ops XLA's partitioner cannot split (the Triton
kernels, top-k) run on each device's shard of the batch, never on the
global batch gathered onto every device."""

import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from mvp_benchmark_tpu.models import get_model
from mvp_benchmark_tpu.ops import dispatch, gpu_kernels, jnp_ref
from mvp_benchmark_tpu.parallel.mesh import (
    make_mesh,
    per_shard,
    shard_batch,
    trace_under,
)
from mvp_benchmark_tpu.train import engine

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from tests.test_models_all import COMPLETION_CFGS, REGISTRATION_CFGS  # noqa: E402


@pytest.fixture(scope="module")
def mesh4():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    return make_mesh(jax.devices()[:4])


def _rows_seen(x, mesh):
    seen = []

    def fn(v):
        seen.append(v.shape[0])
        return v * 2

    def traced(v):
        with trace_under(mesh):
            return per_shard(fn, v)

    out = jax.jit(traced)(x)
    np.testing.assert_array_equal(np.asarray(out), 2 * np.asarray(x))
    return seen


@pytest.mark.parametrize("rows,expect", [(8, 2), (12, 3), (6, 6), (1, 1)])
def test_per_shard_splits_only_a_divisible_batch(mesh4, rows, expect):
    assert _rows_seen(jnp.ones((rows, 5)), mesh4) == [expect]


def test_per_shard_without_mesh_runs_whole(mesh4):
    assert _rows_seen(jnp.ones((8, 5)), None) == [8]
    assert _rows_seen(jnp.ones((8, 5)), make_mesh(jax.devices()[:1])) == [8]


def test_per_shard_inside_shard_map_runs_directly(mesh4):
    seen = []

    def inner(v):
        return per_shard(lambda u: seen.append(u.shape[0]) or u + 1, v)

    def traced(v):
        with trace_under(mesh4):
            return jax.shard_map(inner, mesh=mesh4, in_specs=P("data"),
                                 out_specs=P("data"))(v)

    out = jax.jit(traced)(jnp.zeros((8, 3)))
    assert seen == [2]
    np.testing.assert_array_equal(np.asarray(out), np.ones((8, 3)))


def test_top_k_per_shard_matches_whole_and_gathers_nothing(mesh4, rng):
    x = rng.random((8, 40, 3)).astype(np.float32)
    xs = jax.device_put(x, NamedSharding(mesh4, P("data")))

    def knn(v):
        with trace_under(mesh4):
            return jnp_ref.knn_indices(v, 5), jnp_ref.three_nn(v, v[:, :9])[1]

    fn = jax.jit(knn)
    assert "all-gather" not in fn.lower(xs).compile().as_text()
    for got, want in zip(fn(xs), (jnp_ref.knn_indices(x, 5),
                                  jnp_ref.three_nn(x, x[:, :9])[1])):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _step_args(name, mesh, B=8, N=96):
    comp = name in COMPLETION_CFGS
    cfg = (COMPLETION_CFGS if comp else REGISTRATION_CFGS)[name]
    model = get_model(name, cfg)
    rng = np.random.default_rng(0)
    x, y = (rng.random((B, N, 3)).astype(np.float32) for _ in range(2))
    T = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    example = ((jnp.asarray(x), jnp.asarray(y)) if comp
               else (jnp.asarray(x), jnp.asarray(y), jnp.asarray(T)))
    batch = ({"inputs": x, "gt": y} if comp
             else {"src": x, "tgt": y, "transform": T})
    ctx = engine.create_context(cfg, model, example)
    kind = "completion" if comp else "registration"
    step = engine.make_train_step(model, ctx.tx, kind, mesh)
    return step, (ctx.params, ctx.batch_stats, ctx.opt_state,
                  shard_batch(mesh, batch), jnp.asarray(1.0),
                  jax.random.PRNGKey(0))


@pytest.mark.parametrize("name", ["pcn", "ecg", "vrcnet", "dcp", "deepgmr",
                                  "idam"])
def test_sharded_train_step_gathers_nothing(mesh4, name):
    """Each model's train step, batch sharded over 4 devices, compiles to a
    program with no all-gather: every op runs on its device's shard."""
    step, args = _step_args(name, mesh4)
    compiled, report = engine.compile_step(step, *args)
    gathers = [line for line in compiled.as_text().splitlines()
               if re.search(r"all-gather(-start)?\(", line)]
    assert not gathers, gathers[:3]
    assert report["compile_s"] > 0
    assert report["memory_analysis"]["temp_size_in_bytes"] is not None


def test_sharded_step_lowers_each_triton_kernel_per_card(mesh4, monkeypatch):
    """Lowered for the GPU, the 4-way sharded VRCNet step calls every Triton
    kernel on a quarter of the clouds the one-device step gives it."""
    monkeypatch.setattr(dispatch, "use_gpu_kernels", lambda: True)

    def kernels(mesh):
        step, args = _step_args("vrcnet", mesh)
        lowered = step.trace(*args).lower(lowering_platforms=("cuda",))
        return chip_smoke.kernel_batches(lowered.as_text())

    whole = kernels(make_mesh(jax.devices()[:1]))
    assert len(whole) == 12         # 4 FPS calls, 4 chamfer x 2 directions
    assert kernels(mesh4) == [k // 4 for k in whole]


def test_sharded_interpret_kernels_match_one_device(mesh4, monkeypatch):
    """The VRCNet train step with the kernels (interpret mode) run per
    shard on 4 devices gives the parameters of the one-device step."""
    monkeypatch.setattr(dispatch, "use_gpu_kernels", lambda: True)
    cd, fps = gpu_kernels.chamfer_distance, gpu_kernels.furthest_point_sample
    monkeypatch.setattr(gpu_kernels, "chamfer_distance",
                        lambda a, b: cd(a, b, True))
    monkeypatch.setattr(gpu_kernels, "furthest_point_sample",
                        lambda x, s: fps(x, s, True))

    def params_after_step(mesh):
        step, args = _step_args("vrcnet", mesh)
        params, _, _, aux = step(*args)
        return jax.tree.map(np.asarray, params), float(aux["total_loss"])

    p4, loss4 = params_after_step(mesh4)
    p1, loss1 = params_after_step(make_mesh(jax.devices()[:1]))
    np.testing.assert_allclose(loss4, loss1, rtol=1e-5)
    for a, b in zip(jax.tree.leaves(p4), jax.tree.leaves(p1)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def test_engine_runs_compiled_step_across_epochs(tmp_path):
    """train_completion on a batch sharded over every device runs the step
    it compiled ahead of time for two epochs (the LR is re-set between
    them) and reports that step's compile time and memory."""
    from tests.test_engine_integration import completion_cfg

    n = len(jax.devices())
    out = engine.train_completion(
        completion_cfg(batch_size=n, nepoch=2), str(tmp_path),
        data_dir=str(tmp_path / "none"), max_steps_per_epoch=2)
    assert len(out["history"]["train_loss"]) == 2
    assert all(np.isfinite(out["history"]["train_loss"]))
    assert out["train_step"]["compile_s"] > 0
    assert set(out["train_step"]["memory_analysis"]) >= {
        "argument_size_in_bytes", "temp_size_in_bytes"}
