#!/usr/bin/env python
"""Smoke run of the system on one NVIDIA GPU.

    python chip_smoke.py                # one card: every phase below
    python chip_smoke.py --four-cards   # data-parallel path on four cards

Phases (one line each before the last):

1. device: JAX platform, device kind and count; the card's name and power
   limit as ``nvidia-smi`` reports them.
2. kernels: each Triton kernel compiled for the card against its plain
   ``jnp_ref`` version in float32 at ``precision=HIGHEST`` at real widths
   (chamfer: distances, argmin indices up to near-ties, gradients; FPS:
   identical indices).
3. completion: ``engine.train_completion`` with
   ``completion/cfgs/vrcnet.yaml`` at full width (bs 32 x 2048, synthetic
   data, 3 steps) and a val pass; losses and metrics must be finite.
4. registration: the same with ``engine.train_registration`` and
   ``registration/cfgs/dcp.yaml``.

With ``--four-cards`` only the data-parallel path runs: VRCNet for 2 steps
on a global batch of 4 x 16 clouds sharded over a 4-card mesh, against the
same 64 clouds for 2 steps on card 0. Parameters must agree within the
bounds of the CPU data-parallel test.

The last line of standard output is one JSON object
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``,
printed only when every phase passed. Without a GPU the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

# Tolerances of phase 2 (float32, reference at precision=HIGHEST).
DIST_TOL = 1e-6      # chamfer distances, and the near-tie bound for indices
GRAD_TOL = 1e-6      # chamfer gradients
# Data-parallel parameter agreement (tests/test_parallel.py bounds).
DP_MAX_DIFF = 2e-3
DP_FRAC_ABOVE = 1e-3  # share of elements differing by more than 1e-4


def _line(phase: str, **fields) -> None:
    print(f"{phase}: " + json.dumps(fields, default=str), flush=True)


# ---------------------------------------------------------------------------
# Phase 2: kernel parity
# ---------------------------------------------------------------------------


def _near_tie_rows(x, y, ik, ir):
    """Index mismatches between kernel (``ik``) and reference (``ir``) nearest
    neighbours of every point of ``x`` in ``y``: (mismatch mask, mismatches
    whose two candidates' exact distances differ by more than DIST_TOL)."""
    import jax.numpy as jnp

    bi = jnp.arange(x.shape[0])[:, None]

    def exact(idx):
        return jnp.sum((x - y[bi, idx]) ** 2, -1)

    diff = ik != ir
    return diff, diff & (jnp.abs(exact(ik) - exact(ir)) > DIST_TOL)


def check_chamfer(B, N, M, seed=0, interpret=False) -> dict:
    """The Triton chamfer kernel against ``jnp_ref`` on random clouds."""
    import jax.numpy as jnp
    import numpy as np

    from mvp_benchmark_tpu.ops import gpu_kernels

    rng = np.random.default_rng(seed)
    a, b = (jnp.asarray(rng.random((B, n, 3), np.float32)) for n in (N, M))
    return compare_chamfer(
        lambda a, b: gpu_kernels.chamfer_distance(a, b, interpret), a, b)


def compare_chamfer(kern, a, b, seed=0) -> dict:
    """``kern`` against ``jnp_ref.chamfer_distance`` on clouds (a, b):
    distances, indices up to near-ties, and gradients of a randomly
    weighted sum of the distances against ``jax.grad`` of the reference.

    At a near-tie the two sides pick different nearest points, and the
    gradient rule moves a whole point-to-point difference onto the point
    each picked. Such gradient rows (the query point and both candidates)
    are left out of the gradient comparison and counted.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mvp_benchmark_tpu.ops import jnp_ref

    (B, N, _), M = a.shape, b.shape[1]
    rng = np.random.default_rng(seed)
    g1 = jnp.asarray(rng.random((B, N), np.float32))
    g2 = jnp.asarray(rng.random((B, M), np.float32))

    def weighted(cd):
        def f(a, b):
            d1, d2, _, _ = cd(a, b)
            return jnp.sum(d1 * g1) + jnp.sum(d2 * g2)
        return jax.jit(jax.grad(f, argnums=(0, 1)))

    d1, d2, i1, i2 = jax.jit(kern)(a, b)
    ga, gb = weighted(kern)(a, b)
    with jax.default_matmul_precision("highest"):
        r1, r2, ri1, ri2 = jax.jit(jnp_ref.chamfer_distance)(a, b)
        ra, rb = weighted(jnp_ref.chamfer_distance)(a, b)

    diff1, beyond1 = _near_tie_rows(a, b, i1, ri1)
    diff2, beyond2 = _near_tie_rows(b, a, i2, ri2)
    bi = jnp.arange(B)[:, None]

    def touched(own, other, ik, ir):
        # Rows at a mismatch of their own, or picked by one at the other side.
        hits = jnp.zeros(own.shape, jnp.int32)
        hits = hits.at[bi, ik].add(other).at[bi, ir].add(other)
        return own | (hits > 0)

    skip_a = touched(diff1, diff2.astype(jnp.int32), i2, ri2)
    skip_b = touched(diff2, diff1.astype(jnp.int32), i1, ri1)

    def worst(x, y, skip):
        return float(jnp.max(jnp.where(skip[..., None], 0.0, jnp.abs(x - y))))

    mismatch = int(diff1.sum()) + int(diff2.sum())
    beyond = int(beyond1.sum()) + int(beyond2.sum())
    dist_err = max(float(jnp.max(jnp.abs(d1 - r1))),
                   float(jnp.max(jnp.abs(d2 - r2))))
    grad_err = max(worst(ga, ra, skip_a), worst(gb, rb, skip_b))
    ok = dist_err <= DIST_TOL and grad_err <= GRAD_TOL and beyond == 0
    return {"op": "chamfer", "shape": [B, N, M], "ok": ok,
            "dist_max_abs_err": dist_err, "grad_max_abs_err": grad_err,
            "grad_rows_masked": int(skip_a.sum()) + int(skip_b.sum()),
            "idx_near_tie_mismatches": mismatch,
            "idx_mismatches_beyond_tol": beyond}


def check_fps(B, N, S, seed=0, interpret=False) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mvp_benchmark_tpu.ops import gpu_kernels, jnp_ref

    x = jnp.asarray(np.random.default_rng(seed).random((B, N, 3), np.float32))
    got = gpu_kernels.furthest_point_sample(x, S, interpret)
    want = jax.jit(jnp_ref.furthest_point_sample, static_argnums=1)(x, S)
    rows = int(jnp.any(got != want, axis=1).sum())
    return {"op": "fps", "shape": [B, N, S], "ok": rows == 0,
            "rows_differing": rows}


def phase_kernels(chamfer_shapes, fps_shapes, interpret=False) -> bool:
    ok = True
    for shape in chamfer_shapes:
        r = check_chamfer(*shape, interpret=interpret)
        ok &= r["ok"]
        _line("kernels", **r, tolerance={"dist": DIST_TOL, "grad": GRAD_TOL},
              precision="float32, reference at HIGHEST")
    for shape in fps_shapes:
        r = check_fps(*shape, interpret=interpret)
        ok &= r["ok"]
        _line("kernels", **r, tolerance="indices identical",
              precision="float32")
    return ok


# ---------------------------------------------------------------------------
# Phases 3-4: the training entry points
# ---------------------------------------------------------------------------


def _finite(values) -> bool:
    import math

    return all(isinstance(v, (int, float)) and math.isfinite(v)
               for v in values)


def phase_train(kind: str, cfg_path: str, steps: int, **overrides) -> bool:
    from mvp_benchmark_tpu.train import engine
    from mvp_benchmark_tpu.train.config import load_config

    cfg = load_config(cfg_path, nepoch=1, epoch_interval_to_val=1,
                      **overrides)
    run = (engine.train_completion if kind == "completion"
           else engine.train_registration)
    with tempfile.TemporaryDirectory() as log_dir:
        t0 = time.perf_counter()
        res = run(cfg, log_dir, data_dir=os.path.join(log_dir, "no_data"),
                  max_steps_per_epoch=steps)
        wall = time.perf_counter() - t0
    val = res["history"]["val"][-1]
    losses = res["history"]["train_loss"]
    ok = bool(val) and bool(losses) and _finite(list(val.values()) + losses)
    # compile_s and memory_analysis of the executable the loop ran.
    _line(kind, ok=ok, model=cfg.model_name, batch_size=int(cfg.batch_size),
          num_points=int(cfg.num_points), steps=steps,
          train_loss=losses, val=val, wall_s=round(wall, 3),
          **res["train_step"])
    return ok


# ---------------------------------------------------------------------------
# --four-cards: data-parallel path
# ---------------------------------------------------------------------------


def kernel_batches(lowered_text: str) -> list:
    """Leading (batch) dimension of the first result of every Triton kernel
    call in a lowered program's StableHLO text."""
    import re

    return [int(re.search(r"tensor<(\d+)x", line.rsplit(" -> ", 1)[1])[1])
            for line in lowered_text.splitlines()
            if "@__gpu$xla.gpu.triton" in line]


def phase_data_parallel(devices, per_card: int = 16, steps: int = 2,
                        num_points: int = 2048, lr: float = 1e-2,
                        cfg_path=None, seed: int = 0) -> bool:
    """VRCNet on a global batch sharded over ``devices`` vs the same batch
    on ``devices[0]``, compared parameter by parameter after ``steps``.

    The sharded step must run every Triton kernel on its card's shard: each
    kernel call in its lowered program sees 1/len(devices) of the clouds the
    same call sees on one card. The compiled program's all-gathers are
    listed by op.

    Both runs use Adagrad (an optimizer the engine supports) instead of the
    config's Adam: Adam divides each gradient by its own magnitude, so an
    element whose gradient is zero up to rounding takes a full step in a
    direction set by that rounding, and the two runs round differently.
    Adagrad's update is linear in small gradients, so a parameter
    difference measures a gradient difference.
    """
    import re
    from concurrent.futures import ThreadPoolExecutor

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mvp_benchmark_tpu.models import get_model
    from mvp_benchmark_tpu.parallel.mesh import make_mesh, shard_batch
    from mvp_benchmark_tpu.train import engine
    from mvp_benchmark_tpu.train.config import load_config

    cfg = load_config(cfg_path or os.path.join(
        ROOT, "completion", "cfgs", "vrcnet.yaml"), lr=lr,
        optimizer="Adagrad", num_points=num_points)
    engine.apply_compute_dtype(cfg)
    B = per_card * len(devices)
    rng = np.random.default_rng(seed)
    x = rng.random((B, num_points, 3), np.float32)
    gt = rng.random((B, num_points, 3), np.float32)
    model = get_model("vrcnet", cfg)
    alpha = jnp.asarray(1.0, jnp.float32)

    def lower(mesh):
        ctx = engine.create_context(cfg, model, (jnp.asarray(x),
                                                 jnp.asarray(gt)), seed=seed)
        step = engine.make_train_step(model, ctx.tx, "completion", mesh)
        batch = shard_batch(mesh, {"inputs": x, "gt": gt})
        state = tuple(jax.device_put(t, NamedSharding(mesh, P()))
                      for t in (ctx.params, ctx.batch_stats, ctx.opt_state))
        lowered = step.lower(*state, batch, alpha, jax.random.PRNGKey(seed))
        return lowered, state, batch

    def compile_(lowered):
        t0 = time.perf_counter()
        return lowered.compile(), time.perf_counter() - t0

    def run(exe, state, batch):
        p, bs, opt = state
        key, losses = jax.random.PRNGKey(seed), []
        for _ in range(steps):
            key, k = jax.random.split(key)
            p, bs, opt, aux = exe(p, bs, opt, batch, alpha, k)
            losses.append(float(aux["total_loss"]))
        return jax.tree.map(np.asarray, p), losses

    sharded, one = lower(make_mesh(devices)), lower(make_mesh(devices[:1]))
    kernels = kernel_batches(sharded[0].as_text())
    whole = kernel_batches(one[0].as_text())
    # The two cold compiles run side by side.
    with ThreadPoolExecutor(2) as pool:
        (exe_dp, compile_dp), (exe_one, compile_one) = pool.map(
            compile_, (sharded[0], one[0]))
    gathers = [(re.search(r'op_name="([^"]*)"', line) or (None, "?"))[1]
               for line in exe_dp.as_text().splitlines()
               if re.search(r"all-gather(-start)?\(", line)]
    p_dp, loss_dp = run(exe_dp, *sharded[1:])
    shards = sorted(d.id for d in sharded[2]["inputs"].sharding.device_set)
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
             for d in devices]
    p_one, loss_one = run(exe_one, *one[1:])
    worst_max, worst_frac = 0.0, 0.0
    for a, b in zip(jax.tree.leaves(p_dp), jax.tree.leaves(p_one)):
        diff = np.abs(a - b)
        worst_max = max(worst_max, float(diff.max()))
        worst_frac = max(worst_frac, float((diff > 1e-4).mean()))
    n = len(devices)
    spread = (all(pk for pk in peaks)
              and shards == sorted(d.id for d in devices)
              and bool(kernels) and kernels == [k // n for k in whole]
              and all(k % n == 0 for k in whole))
    ok = (worst_max < DP_MAX_DIFF and worst_frac < DP_FRAC_ABOVE and spread
          and _finite(loss_dp + loss_one))
    _line("data_parallel", ok=ok, cards=len(devices), global_batch=B,
          num_points=num_points, steps=steps, optimizer="Adagrad", lr=lr,
          loss_sharded=loss_dp, loss_one_card=loss_one,
          param_max_abs_diff=worst_max, share_above_1e_4=worst_frac,
          bounds={"max": DP_MAX_DIFF, "share_above_1e_4": DP_FRAC_ABOVE},
          batch_on_devices=shards, peak_bytes_per_card=peaks,
          kernel_call_batches={"sharded": kernels, "one_card": whole},
          all_gathers=gathers,
          compile_s={"sharded": compile_dp, "one_card": compile_one})
    return ok


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the data-parallel path on four cards")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(ROOT, "mvp_benchmark_tpu")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX found {devices}", file=sys.stderr)
        return 1
    want = 4 if args.four_cards else 1
    if len(devices) < want:
        print(f"needs {want} GPUs, found {len(devices)}", file=sys.stderr)
        return 1
    devices = devices[:want]
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)

    dev = {"platform": devices[0].platform,
           "kind": devices[0].device_kind, "count": len(devices)}
    phases = []
    try:
        from mvp_benchmark_tpu.train.profiling import card_name_and_power

        card = card_name_and_power()
        _line("device", **dev)
        print(card, flush=True)
        phases.append(True)
    except Exception:
        traceback.print_exc()
        phases.append(False)

    def run(fn, *a, **kw):
        try:
            phases.append(bool(fn(*a, **kw)))
        except Exception:
            traceback.print_exc()
            _line(getattr(fn, "__name__", "phase"), ok=False)
            phases.append(False)

    if args.four_cards:
        run(phase_data_parallel, devices)
    else:
        run(phase_kernels,
            chamfer_shapes=((32, 2048, 2048), (32, 3072, 2048)),
            fps_shapes=((32, 2048, 1024), (32, 3072, 2048)))
        run(phase_train, "completion",
            os.path.join(ROOT, "completion", "cfgs", "vrcnet.yaml"),
            steps=3, batch_size=32, num_points=2048)
        run(phase_train, "registration",
            os.path.join(ROOT, "registration", "cfgs", "dcp.yaml"),
            steps=3, batch_size=32, num_points=2048)

    if not all(phases):
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
