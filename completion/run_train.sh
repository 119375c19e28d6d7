#!/usr/bin/env bash
# Launch completion training: ./run_train.sh <config-name>
# (the reference wraps this in SLURM `srun`; here one process drives all of a
# host's GPUs, and for several hosts jax.distributed.initialize handles
# rendezvous -- set JAX_COORDINATOR_*)
set -e
cd "$(dirname "$0")"
exec python train.py --config "cfgs/$1.yaml"
