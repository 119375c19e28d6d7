#!/usr/bin/env python
"""Truncated `eval_emd: True` val epoch on the GPU.

Runs a REAL 3-batch completion val pass with eval_emd enabled — PCN at
n=2048, bs=32, the reference eval protocol (eps=0.004, 3000 auction rounds,
reference completion/models/pcn.py:108) — through the production
``engine.val_completion`` loop, which now batches its device->host metric
pulls into ONE sync per pass. Proves the wiring end-to-end and records the
per-batch cost so the full-epoch estimate (1300 batches) is grounded.

Usage: python tools/eval_emd_val_pass.py
"""

import json
import math
import sys
import tempfile
import time

sys.path.insert(0, ".")

import jax.numpy as jnp  # noqa: E402

from mvp_benchmark_tpu.data.mvp import BatchSpec, MVPCompletionDataset  # noqa: E402
from mvp_benchmark_tpu.models import get_model  # noqa: E402
from mvp_benchmark_tpu.train import engine  # noqa: E402
from mvp_benchmark_tpu.train.config import Config  # noqa: E402
from mvp_benchmark_tpu.train.meters import AverageValueMeter  # noqa: E402


def main():
    cfg = Config(
        model_name="pcn", num_points=2048, num_coarse=1024, loss="cd",
        eval_emd=True, lr=1e-4, optimizer="Adam", betas="0.9, 0.999",
        weight_decay=0, batch_size=32, manual_seed=1,
    )
    engine.apply_compute_dtype(cfg)
    # Default: 3 val batches (78 synthetic samples = 32 + 32 + 14-padded).
    # Pass a sample count to run more — e.g. 41600 (= the reference val
    # split, 1300 batches) for a FULL measured eval_emd epoch.
    n_samples = int(sys.argv[1]) if len(sys.argv) > 1 else 78
    ds = MVPCompletionDataset("val", "/nonexistent-use-synthetic",
                              num_points=2048, synthetic_size=n_samples)
    spec = BatchSpec(int(cfg.batch_size), shuffle=False)
    model = get_model("pcn", cfg)
    b0 = next(ds.batches(spec))
    ctx = engine.create_context(
        cfg, model, (jnp.asarray(b0["inputs"]), jnp.asarray(b0["gt"])))
    eval_step = engine.make_eval_step(model, "completion")

    metrics = ["cd_p", "cd_t", "emd", "f1"]
    best = {m: (0, 0.0) if m == "f1" else (0, math.inf) for m in metrics}
    meters = {m: AverageValueMeter() for m in metrics}
    log_dir = tempfile.mkdtemp(prefix="eval_emd_val_")

    t0 = time.time()
    res = engine.val_completion(
        ctx, eval_step, ds, spec, meters, best, epoch=0, log_dir=log_dir)
    wall = time.time() - t0
    n_batches = ds.steps_per_epoch(spec)
    print(json.dumps({
        "what": f"eval_emd val pass (PCN, n=2048, bs=32, eps=0.004, "
                f"iters=3000, {n_batches} batches)",
        "metrics": {m: round(v, 5) for m, v in res.items()},
        "wall_s": round(wall, 1),
        "s_per_batch": round(wall / n_batches, 2),
        "est_full_epoch_h_1300_batches": round(wall / n_batches * 1300 / 3600,
                                               2),
    }), flush=True)
    assert res["emd"] > 0.0, "eval_emd wiring produced zero EMD"


if __name__ == "__main__":
    main()
