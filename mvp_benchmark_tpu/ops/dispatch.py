"""Which implementation of a geometry op runs, and on which shard.

On the GPU, the ops with a hand-written kernel (``gpu_kernels``: chamfer
and furthest point sampling) run that kernel at every shape; its wrapper
pads and masks. Every other op, and every op on the CPU, is the plain
``jnp_ref`` formulation compiled by XLA.

Under a mesh in context (``parallel.mesh.trace_under``, which the
engine's train step sets) whose data axis splits the batch, both ops run
per shard (``parallel.mesh.per_shard``). A ``pallas_call`` has no sharding
rule, so without it XLA would gather the whole batch onto every device and
run the kernel on all of it there. Each cloud is independent, so the
shards need no communication.
"""

from __future__ import annotations

import jax

from mvp_benchmark_tpu.ops import gpu_kernels, jnp_ref
from mvp_benchmark_tpu.parallel.mesh import per_shard


def use_gpu_kernels() -> bool:
    """True when traced for the GPU (read at trace time)."""
    return jax.default_backend() == "gpu"


def chamfer_distance(a, b):
    """Bidirectional squared chamfer distance (see jnp_ref.chamfer_distance)."""
    impl = (gpu_kernels.chamfer_distance if use_gpu_kernels()
            else jnp_ref.chamfer_distance)
    return per_shard(lambda a, b: impl(a, b), a, b)


def furthest_point_sample(xyz, num_samples: int):
    """Greedy FPS (see jnp_ref.furthest_point_sample)."""
    impl = (gpu_kernels.furthest_point_sample if use_gpu_kernels()
            else jnp_ref.furthest_point_sample)
    return per_shard(lambda x: impl(x, num_samples), xyz)
