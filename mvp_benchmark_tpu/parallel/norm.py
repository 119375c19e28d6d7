"""Cross-replica synchronized BatchNorm.

The reference's only distributed-communication component is
``NaiveSyncBatchNorm1d/2d`` (``utils/mm3d_pn2/ops/norm.py:9-133``): an
all_gather + sum of per-worker (mean, meansqr) over ``torch.distributed``.

Under ``jax.jit`` with the batch sharded over the mesh, plain
``models.nn.BatchNorm`` reductions ARE global (XLA inserts the psums), so
``models.layers.BatchNorm`` is already sync-BN — strictly better than the
reference's DataParallel per-GPU statistics. This module provides the
explicit ``axis_name`` variant for code running under ``shard_map``/``vmap``
where the batch axis is a named mapped axis rather than a sharded one.
"""

from __future__ import annotations

from mvp_benchmark_tpu.models import nn


class SyncBatchNorm(nn.Module):
    """BatchNorm with explicit cross-device stat reduction via axis_name.

    Use inside shard_map/pmap-style code: pmean of (mean, mean-square) over
    ``axis_name``, exactly the NaiveSyncBatchNorm reduction. torch-default
    hyperparameters (torch momentum 0.1 -> 0.9 here, eps 1e-5).
    """

    axis_name: str = "data"
    momentum: float = 0.9
    epsilon: float = 1e-5

    @nn.compact
    def __call__(self, x, train: bool):
        return nn.BatchNorm(
            use_running_average=not train,
            momentum=self.momentum,
            epsilon=self.epsilon,
            axis_name=self.axis_name,
        )(x)
