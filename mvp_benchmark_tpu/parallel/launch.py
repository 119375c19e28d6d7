"""Multi-host launch helper.

The reference launches single-node SLURM tasks (``completion/run_train.sh``);
here one process drives all of a host's GPUs, and several hosts rendezvous
through ``jax.distributed.initialize`` with per-host dataset shards. This
module centralizes that so the CLIs work unchanged on one GPU, one host with
N GPUs, or several hosts.
"""

from __future__ import annotations

import logging
import os

import jax

logger = logging.getLogger(__name__)


def maybe_initialize_distributed() -> None:
    """Initialize multi-host JAX when a coordinator is configured.

    Set ``JAX_COORDINATOR_ADDRESS`` (``host:port``), ``JAX_NUM_PROCESSES``
    and ``JAX_PROCESS_ID`` in each process's environment. No-op when the
    address is unset (single-host).
    """
    if os.environ.get("JAX_COORDINATOR_ADDRESS"):
        jax.distributed.initialize(
            coordinator_address=os.environ["JAX_COORDINATOR_ADDRESS"],
            num_processes=int(os.environ["JAX_NUM_PROCESSES"]),
            process_id=int(os.environ["JAX_PROCESS_ID"]),
        )
        logger.info(
            "distributed: process %d/%d, %d local / %d global devices",
            jax.process_index(), jax.process_count(),
            jax.local_device_count(), jax.device_count(),
        )


def host_shard() -> tuple:
    """(num_shards, shard_id) for per-host dataset sharding."""
    return jax.process_count(), jax.process_index()


def is_primary() -> bool:
    """True on the process that should log/checkpoint."""
    return jax.process_index() == 0
