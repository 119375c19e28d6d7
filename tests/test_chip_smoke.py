"""chip_smoke.py and bench.py refuse to run without a GPU; bench.py knows
no peaks for an unknown device."""

import os
import shutil
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, cwd, *args):
    return subprocess.run([sys.executable, script, *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))


@pytest.mark.parametrize("args", [(), ("--four-cards",)])
def test_chip_smoke_fails_without_gpu(args):
    out = _run(os.path.join(_REPO, "chip_smoke.py"), _REPO, *args)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no GPU" in out.stderr


def test_chip_smoke_fails_outside_checkout(tmp_path):
    shutil.copy(os.path.join(_REPO, "chip_smoke.py"), tmp_path)
    out = _run("chip_smoke.py", tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_bench_fails_without_gpu():
    out = _run(os.path.join(_REPO, "bench.py"), _REPO)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_bench_unknown_device_is_an_error():
    sys.path.insert(0, _REPO)
    import bench

    assert bench.device_peaks("NVIDIA H100 80GB HBM3")["bf16_tflops"] == 989.0
    with pytest.raises(KeyError, match="no published peaks"):
        bench.device_peaks("NVIDIA Future GPU")


def _other_tie_break(a, b):
    """jnp_ref's chamfer on reversed clouds: at an exact tie it picks the
    highest index instead of the lowest."""
    from mvp_benchmark_tpu.ops import jnp_ref

    d1, d2, i1, i2 = jnp_ref.chamfer_distance(a[:, ::-1], b[:, ::-1])
    n, m = a.shape[1], b.shape[1]
    return (d1[:, ::-1], d2[:, ::-1], (m - 1 - i1)[:, ::-1],
            (n - 1 - i2)[:, ::-1])


def test_chamfer_check_masks_tie_rows_of_the_gradient():
    """Where kernel and reference break a tie differently, the check counts
    the mismatches, leaves those gradient rows out and still passes."""
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, _REPO)
    import chip_smoke

    rng = np.random.default_rng(0)
    a = rng.random((2, 20, 3)).astype(np.float32)
    b = rng.random((2, 30, 3)).astype(np.float32)
    b[:, 7] = b[:, 3]                  # two equal candidates ...
    a[:, 0] = b[:, 3] + 1e-3           # ... nearest to a[:, 0]
    r = chip_smoke.compare_chamfer(_other_tie_break, jnp.asarray(a),
                                   jnp.asarray(b))
    assert r["ok"], r
    assert r["idx_near_tie_mismatches"] >= 2
    assert r["grad_rows_masked"] >= 2 and r["idx_mismatches_beyond_tol"] == 0


def test_chamfer_check_fails_a_wrong_kernel():
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, _REPO)
    import chip_smoke
    from mvp_benchmark_tpu.ops import jnp_ref

    rng = np.random.default_rng(1)
    a, b = (jnp.asarray(rng.random((2, n, 3)).astype(np.float32))
            for n in (20, 30))
    r = chip_smoke.compare_chamfer(
        lambda a, b: jnp_ref.chamfer_distance(a * 1.001, b), a, b)
    assert not r["ok"]
    assert r["grad_max_abs_err"] > chip_smoke.GRAD_TOL
