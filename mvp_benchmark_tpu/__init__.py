"""MVP-Benchmark-TPU: a JAX framework for the MVP point-cloud benchmark.

Re-implements the capabilities of paul007pl/MVP_Benchmark (PyTorch + CUDA)
as a JAX/XLA/Pallas stack for NVIDIA GPUs:

- ``mvp_benchmark_tpu.ops``      — geometry op library (chamfer, EMD, FPS, kNN,
  ball query, gather/group, three_nn/interpolate): plain jnp for XLA plus
  Triton kernels for chamfer and FPS (replaces the CUDA extensions under
  reference ``utils/metrics`` and ``utils/mm3d_pn2/ops``).
- ``mvp_benchmark_tpu.metrics``  — CD/EMD/F1 and rotation/translation/RMSE
  eval numerics matching the reference to 1e-4.
- ``mvp_benchmark_tpu.models``   — the six benchmark models (PCN, ECG, VRCNet;
  DCP, DeepGMR, IDAM) in a small flax-style module system (``models.nn``).
- ``mvp_benchmark_tpu.data``     — MVP HDF5 loaders + host-side augmentation.
- ``mvp_benchmark_tpu.parallel`` — device-mesh data parallelism.
- ``mvp_benchmark_tpu.train``    — config, loops, meters, checkpointing,
  submission writers.
"""

import os

__version__ = "0.1.0"

# Persistent compilation cache used when JAX_COMPILATION_CACHE_DIR is unset
# (gitignored). The path is part of the cache key, so it is fixed.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def _enable_compilation_cache():
    """Keep compiled programs across runs: in $JAX_COMPILATION_CACHE_DIR
    when it is set (JAX reads it itself), else in DEFAULT_CACHE_DIR."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


_enable_compilation_cache()
