"""Subprocess driver for the REAL 2-process data-parallel test.

Each process: jax.distributed.initialize on a localhost coordinator, CPU
backend, then drives engine.train_completion for 2 steps on its host shard
of the (synthetic, deterministic) dataset and dumps its final params.
Invoked by tests/test_parallel.py::test_two_process_data_parallel — not a
test module itself.
"""

import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    coord = sys.argv[1]
    nproc = int(sys.argv[2])
    pid = int(sys.argv[3])
    outdir = sys.argv[4]
    bs = int(sys.argv[5])

    import jax

    # One CPU device per process, whatever else the machine has.
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=coord, num_processes=nproc, process_id=pid
    )
    assert jax.process_count() == nproc
    assert jax.device_count() == nproc  # 1 CPU device per process

    import numpy as np

    from mvp_benchmark_tpu.train import engine
    from mvp_benchmark_tpu.train.config import Config

    cfg = Config(
        model_name="pcn", num_points=64, loss="cd", eval_emd=False,
        lr=1e-2, optimizer="Adam", betas="0.9, 0.999", weight_decay=0,
        num_coarse=32, batch_size=bs, nepoch=1, manual_seed=1,
        step_interval_to_print=1, epoch_interval_to_save=1,
        epoch_interval_to_val=1,
    )
    os.makedirs(os.path.join(outdir, f"log{pid}"), exist_ok=True)
    res = engine.train_completion(
        cfg, os.path.join(outdir, f"log{pid}"), data_dir="/nonexistent",
        max_steps_per_epoch=2,
    )
    params = jax.tree.map(np.asarray, res["context"].params)
    with open(os.path.join(outdir, f"params_{pid}.pkl"), "wb") as f:
        pickle.dump(params, f)
    print(f"driver {pid}: ok", flush=True)


if __name__ == "__main__":
    main()
