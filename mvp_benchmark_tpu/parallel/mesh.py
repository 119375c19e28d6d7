"""Device mesh + sharding helpers for data-parallel training.

The reference's only parallelism is single-node ``torch.nn.DataParallel``
(replicate module, scatter batch — ``completion/train.py:49``). The JAX
equivalent: a 1-axis ``jax.sharding.Mesh`` over all local devices, the
global batch sharded along ``data``, parameters/optimizer state replicated.
Under ``jax.jit`` XLA inserts the gradient all-reduce (NCCL) and
computes BatchNorm batch statistics globally — i.e. the NaiveSyncBatchNorm
behavior of ``utils/mm3d_pn2/ops/norm.py`` for free.

Multi-host: ``jax.distributed.initialize`` + per-host dataset sharding via
``BatchSpec(num_shards=jax.process_count(), shard_id=jax.process_index())``;
the same mesh spans all hosts.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Dict, Iterable, Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def make_mesh(devices=None, axis_name: str = DATA_AXIS) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


@functools.lru_cache(maxsize=None)
def _cached_default_mesh() -> Mesh:
    return make_mesh()


def get_mesh(mesh: Optional[Mesh] = None) -> Mesh:
    return mesh if mesh is not None else _cached_default_mesh()


_TRACE_MESH: contextvars.ContextVar[Optional[Mesh]] = contextvars.ContextVar(
    "trace_mesh", default=None)


@contextlib.contextmanager
def trace_under(mesh: Optional[Mesh]):
    """Within this context ``per_shard`` splits over ``mesh``'s data axis.

    Enter it inside the function that ``jax.jit`` traces (as the engine's
    train step does): jit does not key its cache on this context. No-op
    for None.
    """
    token = _TRACE_MESH.set(mesh)
    try:
        yield
    finally:
        _TRACE_MESH.reset(token)


def per_shard(fn, *args):
    """``fn(*args)``, run on each shard of the leading axis when the mesh of
    ``trace_under`` splits the data axis over several devices; otherwise on
    the whole arrays.

    ``fn`` must treat the rows of the leading axis independently; every
    output is split along it too. For ops XLA's partitioner has no rule for
    (a ``pallas_call``, ``lax.top_k``), which it would otherwise gather
    whole onto every device and run there on the global batch.
    """
    mesh = _TRACE_MESH.get()
    if (mesh is None or DATA_AXIS not in mesh.axis_names
            # already inside a shard_map over the data axis
            or DATA_AXIS in jax.sharding.get_abstract_mesh().manual_axes):
        return fn(*args)
    n = mesh.shape[DATA_AXIS]
    if n == 1 or any(x.shape[0] % n for x in args):
        return fn(*args)
    spec = P(DATA_AXIS)
    # check_vma=False: a pallas_call's outputs carry no varying-axes type.
    return jax.shard_map(fn, mesh=mesh, in_specs=spec, out_specs=spec,
                         check_vma=False)(*args)


def _multiprocess() -> bool:
    try:
        return jax.process_count() > 1
    except Exception:
        return False


def shard_batch(mesh: Mesh, batch: Dict[str, np.ndarray],
                exclude: Iterable[str] = ("count",),
                replicated: bool = False) -> Dict[str, jax.Array]:
    """Place batch arrays with the leading axis sharded over the data axis.

    Works single-device too (sharding degenerates to full placement). The
    batch size must be divisible by the LOCAL mesh size for sharded keys.

    Multi-process: each process passes its HOST-LOCAL batch; the returned
    arrays are global, with the global batch the concatenation of all hosts'
    shards along the data axis (``jax.device_put`` cannot address other
    hosts' devices — ``make_array_from_process_local_data`` assembles the
    global array from per-process locals).
    """
    multi = _multiprocess()
    n_dev = mesh.devices.size
    n_local = max(1, n_dev // (jax.process_count() if multi else 1))
    out = {}
    for k, v in batch.items():
        if k in exclude:
            out[k] = v
            continue
        arr = np.asarray(v)
        if (not replicated and arr.ndim >= 1
                and arr.shape[0] % n_local == 0 and n_dev > 1):
            sharding = NamedSharding(mesh, P(DATA_AXIS))
        else:
            sharding = NamedSharding(mesh, P())
        if multi:
            out[k] = jax.make_array_from_process_local_data(sharding, arr)
        else:
            out[k] = jax.device_put(arr, sharding)
    return out


def replicate(mesh: Mesh, tree):
    """Replicate a pytree (params/opt state) across the mesh.

    Multi-process: every process must hold identical values (same-seed init
    or a loaded checkpoint); the global array is assembled from the local
    copies."""
    sharding = NamedSharding(mesh, P())
    if _multiprocess():
        return jax.tree.map(
            lambda x: jax.make_array_from_process_local_data(
                sharding, np.asarray(x)
            ),
            tree,
        )
    return jax.tree.map(lambda x: jax.device_put(x, sharding), tree)
