"""Codalab-style submission writers (reference ``completion/test.py:54-64``,
``registration/test.py:55-66``): results.h5 with a ``results`` key + a
``submission.zip`` containing it."""

from __future__ import annotations

import os
import zipfile

import numpy as np


def write_submission(log_dir: str, results: np.ndarray) -> str:
    """Write results.h5 (+ submission.zip) into log_dir; returns zip path."""
    import h5py  # only the test jobs write HDF5; training never needs it

    h5_path = os.path.join(log_dir, "results.h5")
    with h5py.File(h5_path, "w") as f:
        f.create_dataset("results", data=results)
    zip_path = os.path.join(log_dir, "submission.zip")
    cur = os.getcwd()
    os.chdir(log_dir)
    try:
        with zipfile.ZipFile("submission.zip", "w") as z:
            z.write("results.h5")
    finally:
        os.chdir(cur)
    return zip_path


def run_completion_test(cfg, log_dir: str, data_dir: str = "./data"):
    """Inference over the extra-test split (reference completion/test.py:23-64)."""
    import jax.numpy as jnp

    from mvp_benchmark_tpu.data.mvp import BatchSpec, MVPCompletionDataset
    from mvp_benchmark_tpu.models import get_model
    from mvp_benchmark_tpu.train import checkpoint as ckpt
    from mvp_benchmark_tpu.train import engine

    dataset = MVPCompletionDataset("test", data_dir, int(cfg.num_points))
    spec = BatchSpec(int(cfg.batch_size))
    model = get_model(cfg.model_name, cfg)
    b0 = next(dataset.batches(spec))
    x0 = jnp.asarray(b0["inputs"])
    ctx = engine.create_context(cfg, model, (x0, None, "test"))
    if cfg.load_model:
        ctx.load_state_dict(ckpt.load_model(cfg.load_model)["net_state_dict"])
    eval_step = engine.make_eval_step(model, "completion")

    outs = []
    for batch in dataset.batches(spec):
        count = int(batch["count"])
        res = eval_step(
            ctx.params, ctx.batch_stats,
            {"inputs": jnp.asarray(batch["inputs"])}, prefix="test",
        )
        outs.append(np.asarray(res["result"])[:count])
    results = np.concatenate(outs, axis=0)
    return write_submission(log_dir, results), results


def run_registration_test(cfg, log_dir: str, data_dir: str = "./data"):
    """Pose prediction over extra-test (reference registration/test.py:27-66)."""
    import jax.numpy as jnp

    from mvp_benchmark_tpu.data.mvp import BatchSpec, MVPRegistrationDataset
    from mvp_benchmark_tpu.models import get_model
    from mvp_benchmark_tpu.train import checkpoint as ckpt
    from mvp_benchmark_tpu.train import engine

    dataset = MVPRegistrationDataset(
        "test", max_angle=float(cfg.max_angle), max_trans=float(cfg.max_trans),
        category=cfg.category, data_dir=data_dir,
        num_points=int(cfg.num_points or 2048),
    )
    spec = BatchSpec(int(cfg.batch_size))
    model = get_model(cfg.model_name, cfg)
    b0 = next(dataset.batches(spec))
    ctx = engine.create_context(
        cfg, model,
        (jnp.asarray(b0["src"]), jnp.asarray(b0["tgt"]), None, "test"),
    )
    if cfg.load_model:
        ctx.load_state_dict(ckpt.load_model(cfg.load_model)["net_state_dict"])
    eval_step = engine.make_eval_step(model, "registration")

    outs = []
    for batch in dataset.batches(spec):
        count = int(batch["count"])
        T = eval_step(
            ctx.params, ctx.batch_stats,
            {"src": jnp.asarray(batch["src"]),
             "tgt": jnp.asarray(batch["tgt"])},
            prefix="test",
        )
        outs.append(np.asarray(T)[:count])
    results = np.concatenate(outs, axis=0)
    return write_submission(log_dir, results), results
