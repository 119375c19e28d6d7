#!/usr/bin/env python
"""Compile and time one train step of each model on the GPU.

Builds each model from its shipped config (``completion/cfgs`` and
``registration/cfgs``: bs 32 x 2048 points at the published widths) on
random clouds, compiles the jitted train step ahead of time, and times
``steps`` steps that each end in ``block_until_ready``. This shows that
every model compiles and fits on the card; it is not a benchmark.

Usage: python tools/step_check.py [model ...]

Prints one ``RESULT {json}`` line per model: compile seconds, median and
spread of ms/step, peak device memory, and the compiled step's
``memory_analysis()``. Run one model per process to get each model's own
peak memory.
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mvp_benchmark_tpu.models import COMPLETION_MODELS, get_model  # noqa: E402
from mvp_benchmark_tpu.train import engine  # noqa: E402
from mvp_benchmark_tpu.train.config import load_config  # noqa: E402
from mvp_benchmark_tpu.train.profiling import card_name_and_power  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ("pcn", "ecg", "vrcnet", "dcp", "deepgmr", "idam")


def model_config(name: str):
    track = "completion" if name in COMPLETION_MODELS else "registration"
    return load_config(os.path.join(ROOT, track, "cfgs", f"{name}.yaml"))


def build_step(name: str, batch_size: int = 32, seed: int = 0):
    """(compiled train step, its argument tuple) for one model."""
    cfg = model_config(name)
    engine.apply_compute_dtype(cfg)
    kind = "completion" if name in COMPLETION_MODELS else "registration"
    model = get_model(name, cfg)
    n = int(cfg.num_points or 2048)
    rng = np.random.default_rng(seed)
    a = jnp.asarray(rng.random((batch_size, n, 3), np.float32))
    b = jnp.asarray(rng.random((batch_size, n, 3), np.float32))
    if kind == "completion":
        args, batch = (a, b), {"inputs": a, "gt": b}
    else:
        T = jnp.tile(jnp.eye(4), (batch_size, 1, 1))
        args, batch = (a, b, T), {"src": a, "tgt": b, "transform": T}
    ctx = engine.create_context(cfg, model, args, seed=seed)
    step = engine.make_train_step(model, ctx.tx, kind)
    step_args = (ctx.params, ctx.batch_stats, ctx.opt_state, batch,
                 jnp.asarray(0.5, jnp.float32), jax.random.PRNGKey(seed))
    return step, step_args


def check(name: str, batch_size: int = 32, steps: int = 10) -> dict:
    t0 = time.perf_counter()
    step, (params, bs, opt, batch, alpha, key) = build_step(name, batch_size)
    compiled = step.lower(params, bs, opt, batch, alpha, key).compile()
    params, bs, opt, aux = compiled(params, bs, opt, batch, alpha, key)
    loss = float(jax.block_until_ready(aux["total_loss"]))
    compile_s = time.perf_counter() - t0

    times = []
    for _ in range(steps):
        key, k = jax.random.split(key)
        t = time.perf_counter()
        params, bs, opt, aux = compiled(params, bs, opt, batch, alpha, k)
        jax.block_until_ready(aux)
        times.append(1e3 * (time.perf_counter() - t))
    mem = compiled.memory_analysis()
    stats = jax.devices()[0].memory_stats() or {}
    return {
        "model": name,
        "batch_size": batch_size,
        "loss": loss,
        "compile_s": compile_s,
        "ms_per_step_median": float(np.median(times)),
        "ms_per_step_min": float(np.min(times)),
        "ms_per_step_max": float(np.max(times)),
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        "temp_bytes": getattr(mem, "temp_size_in_bytes", None),
        "argument_bytes": getattr(mem, "argument_size_in_bytes", None),
        "output_bytes": getattr(mem, "output_size_in_bytes", None),
    }


if __name__ == "__main__":
    if jax.default_backend() != "gpu":
        sys.exit(f"step_check needs a GPU; JAX found {jax.devices()}")
    print(f"device: {jax.devices()[0].device_kind} | "
          f"{card_name_and_power()}", flush=True)
    for name in sys.argv[1:] or MODELS:
        print("RESULT " + json.dumps(check(name)), flush=True)
