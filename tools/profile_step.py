#!/usr/bin/env python
"""Device-time attribution for one model's train step on the GPU.

Runs ``steps`` compiled train steps (built as in ``step_check``) under
``jax.profiler.trace``, then reads the trace's GPU device planes: device
busy time (union of kernel intervals) and idle share over the traced
window, and device time per kernel name, in ms/step.

Usage: python tools/profile_step.py [model] [steps] [trace_dir]
"""

import collections
import glob
import os
import re
import sys
import tempfile

import jax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import step_check  # noqa: E402


def device_kernel_events(xplane_path: str):
    """[(name, start_ns, dur_ns)] of every kernel on the GPU planes' stream
    lines (one stream line per CUDA stream; XLA's op-level lines are
    skipped so nothing is counted twice)."""
    from jax.profiler import ProfileData

    events = []
    for plane in ProfileData.from_file(xplane_path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for e in line.events:
                events.append((e.name, e.start_ns, e.duration_ns))
    return events


def summarize(events, steps: int, top: int = 30) -> dict:
    """Busy time (interval union), idle share over the first-to-last kernel
    window, and per-kernel ms/step (numeric suffixes collapsed)."""
    if not events:
        return {"busy_ms_per_step": 0.0, "idle_share": None, "kernels": []}
    spans = sorted((s, s + d) for _, s, d in events)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    per = collections.Counter()
    for name, _, d in events:
        per[re.sub(r"[._]\d+$", "", name)] += d
    return {
        "busy_ms_per_step": busy / 1e6 / steps,
        "window_ms_per_step": window / 1e6 / steps,
        "idle_share": 1.0 - busy / window if window else None,
        "kernels": [(k, v / 1e6 / steps) for k, v in per.most_common(top)],
    }


def profile(name: str, steps: int = 5, trace_dir: str = None) -> dict:
    step, (params, bs, opt, batch, alpha, key) = step_check.build_step(name)
    for _ in range(2):    # compile + warm up outside the window
        key, k = jax.random.split(key)
        params, bs, opt, aux = step(params, bs, opt, batch, alpha, k)
    jax.block_until_ready(aux)
    trace_dir = trace_dir or tempfile.mkdtemp(prefix=f"trace_{name}_")
    with jax.profiler.trace(trace_dir):
        for i in range(steps):
            with jax.profiler.StepTraceAnnotation("train", step_num=i):
                key, k = jax.random.split(key)
                params, bs, opt, aux = step(params, bs, opt, batch, alpha, k)
                jax.block_until_ready(aux)
    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    return summarize(device_kernel_events(path), steps)


if __name__ == "__main__":
    if jax.default_backend() != "gpu":
        sys.exit(f"profile_step needs a GPU; JAX found {jax.devices()}")
    model = sys.argv[1] if len(sys.argv) > 1 else "vrcnet"
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    out = sys.argv[3] if len(sys.argv) > 3 else None
    res = profile(model, n, out)
    print(f"# {model}: device busy {res['busy_ms_per_step']:.3f} ms/step, "
          f"idle share {res['idle_share']:.3f}")
    for k, ms in res["kernels"]:
        print(f"{ms:9.3f} ms  {k}")
