#!/usr/bin/env python
"""Full-scale bf16-vs-fp32 convergence evidence.

Trains VRCNet at the HEADLINE shapes — n=2048, bs=32, the bench layer config —
for a few hundred optimizer steps per dtype on the GPU, same seed and data
sequence, validating every few epochs through the production engine loop.

Synthetic blob data (the loaders' dataset-free fallback) — the reference's
own operational validation is training-loss descent + val CD trajectories
(completion/train.py:95-192), which is what this records.

Usage: python tools/convergence_full.py [nepoch] [dtype ...]
Writes one JSON line per dtype to stdout and a combined summary.
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, ".")

from mvp_benchmark_tpu.train.config import Config  # noqa: E402
from mvp_benchmark_tpu.train import engine  # noqa: E402


def run(dtype: str, nepoch: int):
    cfg = Config(
        model_name="vrcnet", num_points=2048, loss="cd", eval_emd=False,
        lr=1e-4, optimizer="Adam", betas="0.9, 0.999", weight_decay=0,
        layers="1, 1, 1, 1", knn_list="16", distribution_loss="KLD",
        pk=10, local_folding=True, points_label=True, num_coarse_raw=1024,
        num_fps=2048, num_coarse=2048, batch_size=32, manual_seed=1,
        nepoch=nepoch, epoch_interval_to_save=1000,
        epoch_interval_to_val=4, step_interval_to_print=20,
        varying_constant="0.01, 0.1, 0.5, 1", varying_constant_epochs="1, 2, 3",
        compute_dtype=dtype,
    )
    log_dir = tempfile.mkdtemp(prefix=f"conv_full_{dtype}_")
    t0 = time.time()
    res = engine.train_completion(
        cfg, log_dir, data_dir="/nonexistent-use-synthetic"
    )
    out = {
        "dtype": dtype,
        "nepoch": nepoch,
        "steps_per_epoch": 9,  # 260 synthetic samples // bs32 (padded final)
        "wall_s": round(time.time() - t0, 1),
        "train_loss": [round(v, 5) for v in res["history"]["train_loss"]],
        "val": [
            {m: round(v, 5) for m, v in r.items()}
            for r in res["history"]["val"]
        ],
        "best": {m: (e, round(v, 5)) for m, (e, v) in res["best"].items()},
    }
    print(json.dumps(out), flush=True)
    return out


def main():
    nepoch = int(sys.argv[1]) if len(sys.argv) > 1 else 36
    dtypes = sys.argv[2:] or ["float32", "bfloat16"]
    results = [run(d, nepoch) for d in dtypes]
    if len(results) == 2:
        a, b = results
        print(json.dumps({
            "summary": f"{a['dtype']} vs {b['dtype']} @ n=2048 bs=32",
            f"best_cd_t_{a['dtype']}": a["best"]["cd_t"],
            f"best_cd_t_{b['dtype']}": b["best"]["cd_t"],
            f"best_cd_p_{a['dtype']}": a["best"]["cd_p"],
            f"best_cd_p_{b['dtype']}": b["best"]["cd_p"],
        }), flush=True)


if __name__ == "__main__":
    main()
