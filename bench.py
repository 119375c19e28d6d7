#!/usr/bin/env python
"""Benchmark: VRCNet completion training throughput on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "ms_per_step", ...}.

Protocol: the reference trains VRCNet on MVP with batch_size 32 x 2048-point
clouds (completion/cfgs/vrcnet.yaml); one train step = forward (dual-path,
batch internally doubles), 4-term chamfer loss, backward, Adam update. The
step is built from the shipped config on random clouds (the dataset is
RAM-resident in the reference too, so input cost is negligible) and timed
step by step, each step ending in ``block_until_ready``; the result is
points/sec/card = steps/sec * batch * 2048 / cards.

The output names the device JAX ran on and the card's name and power limit
(``nvidia-smi``), with the card's published peaks from ``PEAKS``. A device
missing from ``PEAKS`` is an error, and so is a run without a GPU.
"""

import json
import os
import sys
import time

import jax
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tools"))

import step_check  # noqa: E402

from mvp_benchmark_tpu.train.profiling import card_name_and_power  # noqa: E402

WARMUP = 3
STEPS = 30

# Published dense peaks by jax device_kind. Source: NVIDIA H100 Tensor Core
# GPU data sheet, SXM5 part, without sparsity; the rates assume the 700 W
# power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_tflops": 989.0, "tf32_tflops": 495.0, "fp32_tflops": 67.0,
        "hbm_tbps": 3.35,
    },
}


def device_peaks(kind: str) -> dict:
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {kind!r}; "
                       "add them to bench.PEAKS with their source")
    return PEAKS[kind]


def run(batch_size: int = 32):
    step, (params, bs, opt, batch, alpha, key) = step_check.build_step(
        "vrcnet", batch_size)
    times = []
    for i in range(WARMUP + STEPS):
        key, k = jax.random.split(key)
        t0 = time.perf_counter()
        params, bs, opt, aux = step(params, bs, opt, batch, alpha, k)
        jax.block_until_ready(aux)
        if i >= WARMUP:
            times.append(time.perf_counter() - t0)
    return np.asarray(times), float(aux["total_loss"])


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {jax.devices()}")
    peaks = device_peaks(dev.device_kind)
    card = card_name_and_power()
    batch_size, n_cards = 32, 1
    times, loss = run(batch_size)
    ms = 1e3 * float(np.median(times))
    num_points = int(step_check.model_config("vrcnet").num_points)
    print(json.dumps({
        "metric": "vrcnet_train_points_per_sec_per_card",
        "value": batch_size * num_points / n_cards / (ms / 1e3),
        "unit": f"points/sec/card (bs={batch_size}, n={num_points})",
        "ms_per_step": ms,
        "ms_per_step_min": 1e3 * float(times.min()),
        "ms_per_step_max": 1e3 * float(times.max()),
        "steps": int(times.size),
        "loss": loss,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": n_cards},
        "card": card,
        "peaks": peaks,
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
    }))


if __name__ == "__main__":
    main()
