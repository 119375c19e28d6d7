"""Data-parallel sharding tests on the 8-device CPU mesh: sharded train step
== single-device train step; BN stats are global; prefetcher correctness."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from mvp_benchmark_tpu.data.mvp import BatchSpec, MVPRegistrationDataset
from mvp_benchmark_tpu.data.prefetch import prefetch_to_device
from mvp_benchmark_tpu.models import get_model
from mvp_benchmark_tpu.parallel.mesh import make_mesh, shard_batch
from mvp_benchmark_tpu.train import engine
from mvp_benchmark_tpu.train.config import Config


@pytest.fixture(scope="module")
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jax.devices()[:8]


def test_sharded_step_matches_single_device(eight_devices):
    """The global-batch jit step must produce identical numbers whether the
    batch is sharded over 8 devices or resident on one (same program, only
    layout differs). Uses PCN: its gradient path (MLPs + chamfer) is well
    conditioned — SVD-head models amplify float-reassociation noise through
    the 1/(s_i^2-s_j^2) terms of the SVD derivative at random init."""
    cfg = Config(model_name="pcn", num_points=48, num_coarse=24, loss="cd",
                 eval_emd=False, lr=1e-4, optimizer="Adam",
                 betas="0.9, 0.999", weight_decay=0)
    model = get_model("pcn", cfg)
    rng = np.random.default_rng(0)
    B, N = 8, 48
    x = rng.random((B, N, 3)).astype(np.float32)
    gt = rng.random((B, N, 3)).astype(np.float32)

    ctx = engine.create_context(cfg, model, (jnp.asarray(x), jnp.asarray(gt)))

    @jax.jit
    def loss_and_grads(params, batch):
        def f(p):
            _, _, total = model.apply(
                {"params": p}, batch["inputs"], batch["gt"],
                prefix="train", alpha=0.5,
            )
            return total

        return jax.value_and_grad(f)(params)

    batch1 = {"inputs": jnp.asarray(x), "gt": jnp.asarray(gt)}
    loss1, g1 = loss_and_grads(ctx.params, batch1)

    mesh = make_mesh(eight_devices)
    batch8 = shard_batch(mesh, {"inputs": x, "gt": gt})
    assert batch8["inputs"].sharding.is_equivalent_to(
        NamedSharding(mesh, P("data")), 3
    )
    loss8, g8 = loss_and_grads(ctx.params, batch8)

    np.testing.assert_allclose(float(loss1), float(loss8), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(g1), jax.tree.leaves(g8)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        # layouts reassociate float reductions; compare in relative L2 norm
        denom = np.linalg.norm(a) + 1e-12
        rel = np.linalg.norm(a - b) / denom
        assert rel < 1e-3, (a.shape, rel)


def test_batchnorm_stats_are_global(eight_devices):
    """BN batch statistics must be computed over the GLOBAL batch (the
    NaiveSyncBatchNorm contract), not per-shard."""
    from mvp_benchmark_tpu.models import layers as L

    from mvp_benchmark_tpu.models import nn

    class BNNet(nn.Module):
        @nn.compact
        def __call__(self, x, train: bool = True):
            return L.BatchNorm()(x, train)

    net = BNNet()
    rng = np.random.default_rng(0)
    # Deliberately different distribution per shard-block.
    x = np.concatenate(
        [rng.normal(loc=i, size=(1, 4, 3)) for i in range(8)]
    ).astype(np.float32)
    variables = net.init(jax.random.PRNGKey(0), jnp.asarray(x))
    mesh = make_mesh(eight_devices)
    xs = jax.device_put(x, NamedSharding(mesh, P("data")))

    @jax.jit
    def run(v, x):
        y, new = net.apply(v, x, mutable=["batch_stats"])
        return y, new["batch_stats"]

    y, stats = run(variables, xs)
    # global mean over all shards ~ (0+..+7)/8 = 3.5 (per channel, noisy);
    # flax momentum 0.9 -> first update stores 0.1 * batch mean.
    expected = x.mean((0, 1))
    got_mean = np.asarray(
        [s for p, s in jax.tree_util.tree_leaves_with_path(stats)
         if "mean" in jax.tree_util.keystr(p)][0]
    )
    np.testing.assert_allclose(got_mean, expected * 0.1, rtol=0.05, atol=0.05)
    # normalized output is standardized globally
    np.testing.assert_allclose(np.asarray(y).mean(), 0.0, atol=1e-4)


def test_prefetcher_roundtrip(eight_devices):
    ds = MVPRegistrationDataset("train", max_angle=45.0, max_trans=0.5,
                                num_points=16, synthetic_size=32)
    mesh = make_mesh(eight_devices)
    got = list(prefetch_to_device(ds.batches(BatchSpec(8)), mesh=mesh))
    assert len(got) == 4
    for b in got:
        assert b["src"].shape == (8, 16, 3)
        assert isinstance(b["src"], jax.Array)
    # order and content preserved vs the raw iterator
    raw = list(ds.batches(BatchSpec(8)))
    for b, r in zip(got, raw):
        assert b["src"].shape == r["src"].shape


def test_multihost_shards_partition_dataset():
    """BatchSpec(num_shards, shard_id): shards are disjoint, their union is
    the dataset, and shuffled order is consistent across shards (multi-host
    dataset sharding — the reference has no equivalent; parallel/launch.py)."""
    from mvp_benchmark_tpu.data.mvp import BatchSpec, MVPCompletionDataset

    ds = MVPCompletionDataset("train", data_dir="/nonexistent",
                              num_points=64, synthetic_size=52)
    n_shards = 2
    seen = []
    steps = []
    for sid in range(n_shards):
        spec = BatchSpec(4, shuffle=True, seed=7, num_shards=n_shards,
                         shard_id=sid)
        ids = []
        count = 0
        for batch in ds.batches(spec, epoch=3):
            c = int(batch["count"])
            # identify samples by their content hash
            for row in np.asarray(batch["inputs"])[:c]:
                ids.append(row.tobytes())
            count += 1
        assert count == ds.steps_per_epoch(spec)
        steps.append(count)
        seen.append(set(ids))
    assert seen[0].isdisjoint(seen[1])
    assert len(seen[0] | seen[1]) == 52
    assert abs(steps[0] - steps[1]) <= 1


def test_engine_uses_host_shards(monkeypatch, tmp_path):
    """train_completion picks up (process_count, process_index) for its
    BatchSpec and gates checkpoints on the primary process."""
    from mvp_benchmark_tpu.data import mvp as mvp_mod
    from mvp_benchmark_tpu.parallel import launch
    from mvp_benchmark_tpu.train import engine
    from mvp_benchmark_tpu.train.config import Config

    monkeypatch.setattr(launch, "host_shard", lambda: (2, 1))
    monkeypatch.setattr(launch, "is_primary", lambda: False)

    captured = {}
    orig = mvp_mod._BatchedDataset.batches

    def spy(self, spec, epoch=0):
        captured["spec"] = spec
        return orig(self, spec, epoch)

    monkeypatch.setattr(mvp_mod._BatchedDataset, "batches", spy)

    cfg = Config(model_name="pcn", num_points=64, loss="cd", eval_emd=False,
                 lr=1e-4, optimizer="Adam", betas="0.9, 0.999",
                 weight_decay=0, num_coarse=32, batch_size=4, nepoch=1,
                 manual_seed=1, step_interval_to_print=2,
                 epoch_interval_to_save=1, epoch_interval_to_val=5)
    engine.train_completion(cfg, str(tmp_path), data_dir="/nonexistent",
                            max_steps_per_epoch=2)
    assert captured["spec"].num_shards == 2
    assert captured["spec"].shard_id == 1
    # non-primary process must not write epoch checkpoints
    assert not (tmp_path / "network.pkl").exists()


def test_prefetcher_sentinel_not_dropped_when_queue_full():
    """End-of-stream must be delivered even when the consumer lags (the
    sentinel used to be dropped if the queue was full at iterator
    exhaustion, deadlocking the consumer)."""
    import time

    from mvp_benchmark_tpu.data.prefetch import DevicePrefetcher

    def gen():
        for i in range(3):
            yield {"x": np.full((2,), i, np.float32)}

    with DevicePrefetcher(gen(), place=lambda b: b, depth=1) as pf:
        time.sleep(0.5)      # let the worker fill the queue and finish
        items = list(pf)     # must terminate
    assert len(items) == 3


def test_two_process_data_parallel(tmp_path):
    """GENUINE multi-process data parallelism: two jax.distributed CPU
    processes on localhost drive train_completion for 2 steps on disjoint
    host shards (no monkeypatching). Both processes must end with identical
    params, and those params must match a single-process run over the same
    global batches (shard interleave order[shard::2] makes the union of the
    two hosts' step-i batches exactly the 2*bs-sized step-i batch of a
    single-process run with the same shuffle seed)."""
    import pickle
    import socket
    import subprocess
    import sys as _sys

    import jax as _jax

    # Free localhost port for the coordination service.
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    coord = f"127.0.0.1:{port}"

    driver = os.path.join(os.path.dirname(__file__), "_distributed_driver.py")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(__file__)),
         env.get("PYTHONPATH", "")]
    )
    # conftest forces an 8-device virtual CPU in the pytest process; the
    # subprocesses model one single-device host each.
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    bs = 4
    procs = [
        subprocess.Popen(
            [_sys.executable, driver, coord, "2", str(pid), str(tmp_path),
             str(bs)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=600)[0].decode() for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"driver failed:\n{out[-3000:]}"

    with open(tmp_path / "params_0.pkl", "rb") as f:
        p0 = pickle.load(f)
    with open(tmp_path / "params_1.pkl", "rb") as f:
        p1 = pickle.load(f)

    # Identical across processes (same global computation on both).
    flat_p0 = {jax.tree_util.keystr(k): v
               for k, v in jax.tree_util.tree_leaves_with_path(p0)}
    flat_p1 = {jax.tree_util.keystr(k): v
               for k, v in jax.tree_util.tree_leaves_with_path(p1)}
    assert flat_p0.keys() == flat_p1.keys()
    for k in flat_p0:
        np.testing.assert_array_equal(flat_p0[k], flat_p1[k], err_msg=k)

    # Equal to the single-process run over the same global batches
    # (2*bs per step; fp summation order differs -> tolerance).
    from mvp_benchmark_tpu.train import engine
    from mvp_benchmark_tpu.train.config import Config

    cfg = Config(
        model_name="pcn", num_points=64, loss="cd", eval_emd=False,
        lr=1e-2, optimizer="Adam", betas="0.9, 0.999", weight_decay=0,
        num_coarse=32, batch_size=2 * bs, nepoch=1, manual_seed=1,
        step_interval_to_print=1, epoch_interval_to_save=1,
        epoch_interval_to_val=1,
    )
    (tmp_path / "single").mkdir()
    res = engine.train_completion(cfg, str(tmp_path / "single"),
                                  data_dir="/nonexistent",
                                  max_steps_per_epoch=2)
    ps = jax.tree.map(np.asarray, res["context"].params)
    flat0 = {jax.tree_util.keystr(k): v
             for k, v in jax.tree_util.tree_leaves_with_path(p0)}
    flats = {jax.tree_util.keystr(k): v
             for k, v in jax.tree_util.tree_leaves_with_path(ps)}
    assert flat0.keys() == flats.keys()
    for k in flats:
        # The global batch is the same SET of samples but a different row
        # order, so fp32 reduction order differs; Adam's grad/sqrt(v)
        # normalization amplifies that on near-zero-gradient params
        # (observed: ~20/527K elements off by <=3e-4 after 2 lr=1e-2 steps,
        # i.e. ~1% of one optimizer step). A real data/collective bug moves
        # params by O(one step) everywhere, far outside these bounds.
        diff = np.abs(flat0[k] - flats[k])
        assert diff.max() < 2e-3, (k, diff.max())
        assert (diff > 1e-4).mean() < 1e-3, (k, (diff > 1e-4).mean())
