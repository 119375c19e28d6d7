#!/usr/bin/env python
"""EMD at the TRAIN protocol, on the GPU.

Two demonstrations:

1. Time the auction EMD at the reference's training operating point —
   eps=0.005, 50 iterations, n=m=2048, bs=32 (reference
   completion/models/pcn.py:104-111 / model_utils.py:80-85), each call
   ended with ``block_until_ready``.

2. Smoke-train PCN with ``loss: emd`` for one epoch at n=1024 and check the
   losses are finite and descending. n=1024 because EMD requires n == m
   (reference emd_module.py:47 ``assert(n == m)``): the reference's own
   shipped PCN config (num_coarse=1024, num_points=2048) would fail that
   assert on ``loss1 = calc_emd(out1, gt)`` — coarse-vs-gt EMD is only
   legal when the coarse and full sizes coincide. Same constraint here,
   mirrored; n=1024 satisfies n % 1024 == 0 and n == m for both loss terms.

Usage: python tools/emd_train_protocol.py [reps]
"""

import json
import sys
import tempfile
import time

sys.path.insert(0, ".")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mvp_benchmark_tpu.metrics import calc_emd  # noqa: E402
from mvp_benchmark_tpu.train import engine  # noqa: E402
from mvp_benchmark_tpu.train.config import Config  # noqa: E402

REPS = int(sys.argv[1]) if len(sys.argv) > 1 else 5


def time_train_protocol():
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.random((32, 2048, 3), np.float32))
    b = jnp.asarray(rng.random((32, 2048, 3), np.float32))
    # One jitted scalar: nothing compiles inside the timed region.
    f = jax.jit(
        lambda a, b: calc_emd(a, b, eps=0.005, iterations=50).mean())
    out = f(a, b)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(REPS):
        out = jax.block_until_ready(f(a, b))
    dt = (time.perf_counter() - t0) / REPS
    val = float(out)
    print(json.dumps({
        "what": "emd train protocol (eps=0.005, iters=50, n=2048, bs=32)",
        "ms_per_call": round(dt * 1e3, 1),
        "mean_emd": round(val, 5),
    }), flush=True)


def smoke_train_pcn_emd():
    cfg = Config(
        model_name="pcn", num_points=1024, num_coarse=1024, loss="emd",
        eval_emd=False, lr=1e-4, optimizer="Adam", betas="0.9, 0.999",
        weight_decay=0, batch_size=32, manual_seed=1, nepoch=1,
        epoch_interval_to_save=1000, epoch_interval_to_val=1,
        step_interval_to_print=2,
    )
    log_dir = tempfile.mkdtemp(prefix="pcn_emd_smoke_")
    t0 = time.time()
    res = engine.train_completion(
        cfg, log_dir, data_dir="/nonexistent-use-synthetic",
        max_steps_per_epoch=6,
    )
    losses = res["history"]["train_loss"]
    print(json.dumps({
        "what": "pcn loss=emd smoke train (n=1024, bs=32, 6 steps)",
        "epoch_avg_loss": [round(v, 5) for v in losses],
        "finite": all(np.isfinite(v) for v in losses),
        "wall_s": round(time.time() - t0, 1),
        "val": res["history"]["val"],
    }), flush=True)


if __name__ == "__main__":
    time_train_protocol()
    smoke_train_pcn_emd()
