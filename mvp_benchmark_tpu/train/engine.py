"""Training/val engine for both benchmark tracks.

Reproduces the reference loops:
- completion: ``completion/train.py:21-192`` (alpha schedule, manual LR decay,
  cd_p/cd_t/f1[/emd] val meters, best-per-metric checkpoints).
- registration: ``registration/train.py:28-181`` (RotE/transE/MSE/RMSE/recall
  meters plus the 2x2 (rot_level, match_level) split).

Execution model: one jitted train step per config; the batch is
sharded over the data axis of a device mesh (see ``parallel.mesh``), model
state is replicated, loss/grads are averaged globally by XLA. BatchNorm
batch statistics are computed over the GLOBAL batch (a strict upgrade over
the reference's per-GPU DataParallel stats; equivalent to NaiveSyncBatchNorm).
"""

from __future__ import annotations

import functools
import logging
import math
import os
import time
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from mvp_benchmark_tpu.data.mvp import (
    BatchSpec,
    MVPCompletionDataset,
    MVPRegistrationDataset,
)
from mvp_benchmark_tpu.data.prefetch import DevicePrefetcher
from mvp_benchmark_tpu.models import get_model
from mvp_benchmark_tpu.parallel import launch
from mvp_benchmark_tpu.parallel.mesh import (
    get_mesh,
    replicate,
    shard_batch,
    trace_under,
)
from mvp_benchmark_tpu.train import checkpoint as ckpt
from mvp_benchmark_tpu.train import optim as optim_util
from mvp_benchmark_tpu.train import profiling
from mvp_benchmark_tpu.train.config import Config
from mvp_benchmark_tpu.train.meters import AverageValueMeter

logger = logging.getLogger(__name__)


class NanGuard:
    """Failure detection for the train loop (the reference has none —
    SURVEY.md §5): logs non-finite losses and aborts after `limit`
    consecutive occurrences with an actionable error instead of silently
    training on garbage."""

    def __init__(self, limit: int = 5):
        self.limit = limit
        self.consecutive = 0
        self.total = 0

    def check(self, loss: float, where: str) -> None:
        if math.isfinite(loss):
            self.consecutive = 0
            return
        self.consecutive += 1
        self.total += 1
        logger.warning("non-finite loss (%s) at %s [%d consecutive]",
                       loss, where, self.consecutive)
        if self.consecutive >= self.limit:
            raise FloatingPointError(
                f"{self.consecutive} consecutive non-finite losses at {where}"
                " — check LR / input normalization (EMD expects coords in"
                " [0,1]) / distribution-loss stability."
            )


def apply_compute_dtype(cfg: Config) -> None:
    """Set the global activation dtype policy from ``cfg.compute_dtype``
    ('bf16'/'bfloat16' or 'f32'/'float32'; default f32). Must run before
    model init / step tracing (the policy is read at trace time)."""
    from mvp_benchmark_tpu.models import layers as _layers

    want = str(cfg.compute_dtype or "float32").lower()
    bf16 = want in ("bf16", "bfloat16")
    _layers.set_compute_dtype(jnp.bfloat16 if bf16 else jnp.float32)


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------


class TrainContext:
    """Bundles model, variables, optimizer and jitted steps for one config."""

    def __init__(self, cfg: Config, model, variables, tx, opt_state):
        self.cfg = cfg
        self.model = model
        self.params = variables["params"]
        self.batch_stats = variables.get("batch_stats", {})
        self.tx = tx
        self.opt_state = opt_state

    @property
    def variables(self):
        v = {"params": self.params}
        if self.batch_stats:
            v["batch_stats"] = self.batch_stats
        return v

    def load_state_dict(self, state: Dict[str, Any]):
        self.params = state["params"]
        self.batch_stats = state.get("batch_stats", {})


def _init_model(cfg: Config, model, example_args, rng_seed: int = 0):
    rngs = {
        "params": jax.random.PRNGKey(rng_seed),
        "dropout": jax.random.PRNGKey(rng_seed + 1),
        "sample": jax.random.PRNGKey(rng_seed + 2),
    }

    # Jit the init: eager init dispatches (and compiles) every op
    # separately. Non-array example args (None / prefix strings) are closed
    # over as statics.
    is_array = lambda a: isinstance(a, (jnp.ndarray, np.ndarray))
    array_args = [a for a in example_args if is_array(a)]

    @jax.jit
    def do_init(rngs, arrays):
        it = iter(arrays)
        args = [next(it) if is_array(a) else a for a in example_args]
        return model.init(rngs, *args)

    variables = dict(do_init(rngs, array_args))
    return variables


def _is_multiprocess() -> bool:
    try:
        return jax.process_count() > 1
    except Exception:
        return False


def _replicate_context(context, mesh) -> None:
    """Multi-process: promote the per-process (identically seeded/loaded)
    params, BN state and optimizer state to global replicated arrays so the
    jitted step can consume them alongside the globally sharded batch."""
    if not _is_multiprocess():
        return
    context.params = replicate(mesh, context.params)
    if context.batch_stats:
        context.batch_stats = replicate(mesh, context.batch_stats)
    context.opt_state = replicate(mesh, context.opt_state)


def _place_val(batch, keys):
    """Device placement for a val batch. Multi-process: every host runs the
    SAME full val pass (num_shards=1) on fully replicated arrays — metric
    arrays come back replicated, so the host-side meters see the global
    values without cross-host metric plumbing."""
    if _is_multiprocess():
        placed = shard_batch(get_mesh(), {k: batch[k] for k in keys},
                             exclude=(), replicated=True)
        return placed
    return {k: jnp.asarray(batch[k]) for k in keys}


def create_context(cfg: Config, model, example_args, seed: int = 0) -> TrainContext:
    variables = _init_model(cfg, model, example_args, seed)
    tx = optim_util.build_optimizer(cfg)
    opt_state = tx.init(variables["params"])
    return TrainContext(cfg, model, variables, tx, opt_state)


# ---------------------------------------------------------------------------
# Jitted steps (shared by both tracks)
# ---------------------------------------------------------------------------


def make_train_step(model, tx, kind: str, mesh=None):
    """kind: 'completion' (x, gt, alpha) or 'registration' (src, tgt, T_gt).

    ``mesh``: the mesh the batch is sharded over. The model traces under
    it, so the ops XLA cannot partition (the Triton kernels, top-k) run per
    shard (``parallel.mesh.per_shard``) instead of on the whole batch on
    every device.
    """

    @functools.partial(jax.jit, donate_argnums=(0, 1, 2))
    def step(params, batch_stats, opt_state, batch, alpha, rng):
        drop_rng, sample_rng = jax.random.split(rng)

        def loss_fn(p):
            variables = {"params": p}
            mutable = False
            if batch_stats:
                variables["batch_stats"] = batch_stats
                mutable = ["batch_stats"]
            rngs = {"dropout": drop_rng, "sample": sample_rng}
            if kind == "completion":
                outs = model.apply(
                    variables, batch["inputs"], batch["gt"],
                    prefix="train", alpha=alpha,
                    mutable=mutable, rngs=rngs,
                )
            else:
                outs = model.apply(
                    variables, batch["src"], batch["tgt"], batch["transform"],
                    prefix="train", mutable=mutable, rngs=rngs,
                )
            if mutable:
                result, new_state = outs
                new_bs = new_state["batch_stats"]
            else:
                result, new_bs = outs, batch_stats
            # result: completion (out2, loss2, total) / registration
            # (loss, r_err, t_err, rmse, mse)
            if kind == "completion":
                _, loss2, total = result
                aux = {"fine_loss": jnp.mean(loss2)}
            else:
                loss, r_err, t_err, rmse, mse = result
                total = loss
                aux = {
                    "r_err": jnp.mean(r_err),
                    "t_err": jnp.mean(t_err),
                    "rmse": jnp.mean(rmse),
                    "mse": jnp.mean(mse),
                }
            return jnp.mean(total), (new_bs, aux)

        with trace_under(mesh):
            (loss, (new_bs, aux)), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        aux["total_loss"] = loss
        return params, new_bs, opt_state, aux

    return step


def compile_step(step, *args):
    """Compile the jitted ``step`` for ``args`` ahead of time.

    Returns the executable, which the caller then runs, and a report of its
    compile seconds and ``memory_analysis()`` byte counts.
    """
    t0 = time.perf_counter()
    compiled = step.lower(*args).compile()
    seconds = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    report = {"compile_s": seconds, "memory_analysis": {
        k: getattr(mem, k, None) for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")}}
    return compiled, report


def make_eval_step(model, kind: str):
    @functools.partial(jax.jit, static_argnames=("prefix",))
    def step(params, batch_stats, batch, prefix="val"):
        variables = {"params": params}
        if batch_stats:
            variables["batch_stats"] = batch_stats
        rngs = {
            "dropout": jax.random.PRNGKey(0),
            "sample": jax.random.PRNGKey(0),
        }
        if kind == "completion":
            if prefix == "test":
                return model.apply(
                    variables, batch["inputs"], None, prefix="test", rngs=rngs
                )
            return model.apply(
                variables, batch["inputs"], batch["gt"], prefix=prefix, rngs=rngs
            )
        else:
            if prefix == "test":
                return model.apply(
                    variables, batch["src"], batch["tgt"], None,
                    prefix="test", rngs=rngs,
                )
            return model.apply(
                variables, batch["src"], batch["tgt"], batch["transform"],
                prefix=prefix, rngs=rngs,
            )

    return step


# ---------------------------------------------------------------------------
# Completion track
# ---------------------------------------------------------------------------


def train_completion(cfg: Config, log_dir: str, data_dir: str = "./data",
                     max_steps_per_epoch: Optional[int] = None) -> Dict[str, Any]:
    """Completion training loop (reference completion/train.py:21-153)."""
    apply_compute_dtype(cfg)
    metrics_list = (
        ["cd_p", "cd_t", "emd", "f1"] if cfg.eval_emd else ["cd_p", "cd_t", "f1"]
    )
    best = {m: (0, 0.0) if m == "f1" else (0, math.inf) for m in metrics_list}
    train_meter = AverageValueMeter()
    val_meters = {m: AverageValueMeter() for m in metrics_list}

    launch.maybe_initialize_distributed()
    num_shards, shard_id = launch.host_shard()
    num_points = int(cfg.num_points or 2048)
    dataset = MVPCompletionDataset("train", data_dir, num_points)
    dataset_val = MVPCompletionDataset("val", data_dir, num_points)
    mesh = get_mesh()
    # Per-host dataset shards (the multi-host analogue of DataLoader
    # sharding); single-process runs get the identity shard.
    spec = BatchSpec(int(cfg.batch_size), shuffle=True,
                     seed=int(cfg.manual_seed or 1),
                     num_shards=num_shards, shard_id=shard_id)
    if _is_multiprocess():
        # Replicated val (see _place_val): every host runs the full pass.
        val_spec = BatchSpec(int(cfg.batch_size), shuffle=False)
    else:
        val_spec = BatchSpec(int(cfg.batch_size), shuffle=False,
                             num_shards=num_shards, shard_id=shard_id)

    model = get_model(cfg.model_name, cfg)
    b0 = next(dataset.batches(spec))
    context = create_context(
        cfg, model,
        (jnp.asarray(b0["inputs"]), jnp.asarray(b0["gt"])),
        seed=int(cfg.manual_seed or 1),
    )
    if cfg.load_model:
        context.load_state_dict(ckpt.load_model(cfg.load_model)["net_state_dict"])
        logger.info("%s's previous weights loaded.", cfg.model_name)

    _replicate_context(context, mesh)
    train_step = make_train_step(model, context.tx, "completion", mesh)
    compiled, step_report = None, None
    eval_step = make_eval_step(model, "completion")
    rng = jax.random.PRNGKey(int(cfg.manual_seed or 1))
    guard = NanGuard()

    print_every = int(cfg.step_interval_to_print or 100)
    # NanGuard safety bound: flush the device-side loss queue at least every
    # 20 steps regardless of the print cadence, so a NaN aborts within ~20
    # optimizer updates instead of `step_interval_to_print` (ADVICE r2).
    guard_every = min(print_every, 20)
    timer = profiling.StepTimer()

    history = {"train_loss": [], "val": []}
    for epoch in range(int(cfg.start_epoch or 0), int(cfg.nepoch)):
        train_meter.reset()
        alpha = optim_util.alpha_for_epoch(cfg, epoch)
        lr = optim_util.epoch_lr(cfg, epoch)
        context.opt_state = optim_util.set_learning_rate(context.opt_state, lr)
        a = jnp.asarray(alpha if alpha is not None else 1.0, jnp.float32)

        # Device-side loss accumulation: aux scalars stay on device and the
        # host syncs once per `guard_every` steps instead of every step (a
        # per-step float() stalls the async dispatch pipeline). NanGuard
        # therefore fires up to `guard_every` (<=20) steps late.
        pending = []
        t_flush = time.perf_counter()

        def flush():
            nonlocal t_flush
            if not pending:
                return
            dt = time.perf_counter() - t_flush
            sps = len(pending) / dt if dt > 0 else 0.0
            for j, dev in pending:
                loss = float(dev["total_loss"])
                guard.check(loss, f"completion epoch {epoch} step {j}")
                train_meter.update(loss)
                if j % print_every == 0:
                    logger.info(
                        "train [%d: %d] loss_type: %s fine_loss: %f "
                        "total_loss: %f lr: %f alpha: %s steps/s: %.2f",
                        epoch, j, cfg.loss, float(dev["fine_loss"]), loss,
                        lr, alpha, sps,
                    )
            pending.clear()
            t_flush = time.perf_counter()

        # Host->device prefetch overlaps batch assembly + transfer with the
        # running step (the reference's DataLoader-worker role).
        place = functools.partial(shard_batch, mesh, exclude=("count",))
        with DevicePrefetcher(dataset.batches(spec, epoch), place) as pf, \
                profiling.trace(cfg.profile_dir if epoch == int(cfg.start_epoch or 0) else None):
            for i, sharded in enumerate(pf):
                if max_steps_per_epoch and i >= max_steps_per_epoch:
                    break
                rng, step_rng = jax.random.split(rng)
                args = (context.params, context.batch_stats,
                        context.opt_state, sharded, a, step_rng)
                if compiled is None:
                    compiled, step_report = compile_step(train_step, *args)
                with timer:
                    (context.params, context.batch_stats, context.opt_state,
                     aux) = compiled(*args)
                pending.append((i, aux))
                if len(pending) >= guard_every:
                    flush()
        flush()

        history["train_loss"].append(train_meter.avg)

        if (epoch % int(cfg.epoch_interval_to_save or 1) == 0
                and launch.is_primary()):
            ckpt.save_model(os.path.join(log_dir, "network.pkl"),
                            context.variables, context.opt_state)

        if (epoch % int(cfg.epoch_interval_to_val or 1) == 0
                or epoch == int(cfg.nepoch) - 1):
            res = val_completion(
                context, eval_step, dataset_val, val_spec, val_meters,
                best, epoch, log_dir,
            )
            history["val"].append(res)
    return {"best": best, "history": history, "context": context,
            "train_step": step_report}


def val_completion(context, eval_step, dataset_val, spec, val_meters, best,
                   epoch, log_dir) -> Dict[str, float]:
    for v in val_meters.values():
        v.reset()
    # Metric arrays stay on device for the whole pass; one device->host pull
    # at the end instead of len(metrics) pulls per batch, so a 1300-batch
    # `eval_emd` epoch does not serialize thousands of syncs.
    pending = []
    for batch in dataset_val.batches(spec):
        count = int(batch["count"])
        result = eval_step(
            context.params, context.batch_stats,
            _place_val(batch, [k for k in batch if k != "count"]),
            prefix="val",
        )
        pending.append((count, {m: result[m] for m in val_meters}))
    for count, result in jax.device_get(pending):
        for name, meter in val_meters.items():
            vals = np.asarray(result[name])
            if vals.ndim == 0:
                meter.update(float(vals), count)
            else:
                meter.update(float(vals[:count].mean()), count)

    log, best_log = "", ""
    for m, meter in val_meters.items():
        curr_best_epoch, curr_best = best[m]
        improved = meter.avg > curr_best if m == "f1" else meter.avg < curr_best
        if improved:
            best[m] = (epoch, meter.avg)
            # Primary-only, like the epoch checkpoints (multi-process: every
            # process computes identical metrics on the replicated val pass,
            # but only one should write).
            if launch.is_primary():
                ckpt.save_model(
                    os.path.join(log_dir, f"best_{m}_network.pkl"),
                    context.variables,
                )
                logger.info("Best %s net saved!", m)
        log += f"curr_{m}: {meter.avg:f}; "
        best_log += f"best_{m}: {best[m][1]:f} [epoch {best[m][0]}]; "
    logger.info(log)
    logger.info(best_log)
    return {m: meter.avg for m, meter in val_meters.items()}


# ---------------------------------------------------------------------------
# Registration track
# ---------------------------------------------------------------------------

REG_METRICS = ["RotE", "transE", "MSE", "RMSE", "recall"]


def train_registration(cfg: Config, log_dir: str, data_dir: str = "./data",
                       max_steps_per_epoch: Optional[int] = None) -> Dict[str, Any]:
    """Registration training loop (reference registration/train.py:28-111)."""
    apply_compute_dtype(cfg)
    best = {m: (0, 0.0) if m == "recall" else (0, math.inf) for m in REG_METRICS}
    val_meters = {m: AverageValueMeter() for m in REG_METRICS}
    n_rot = int(cfg.num_rot_levels or 2)
    n_corr = int(cfg.num_corr_levels or 2)
    split_meters = [
        [{m: AverageValueMeter() for m in REG_METRICS} for _ in range(n_corr)]
        for _ in range(n_rot)
    ]

    dataset = MVPRegistrationDataset(
        "train", max_angle=float(cfg.max_angle), max_trans=float(cfg.max_trans),
        category=cfg.category, data_dir=data_dir,
        num_points=int(cfg.num_points or 2048), seed=int(cfg.manual_seed or 1),
    )
    dataset_val = MVPRegistrationDataset(
        "val", max_angle=float(cfg.max_angle), max_trans=float(cfg.max_trans),
        category=cfg.category, data_dir=data_dir,
        num_points=int(cfg.num_points or 2048),
    )
    launch.maybe_initialize_distributed()
    num_shards, shard_id = launch.host_shard()
    mesh = get_mesh()
    spec = BatchSpec(int(cfg.batch_size), shuffle=True,
                     seed=int(cfg.manual_seed or 1),
                     num_shards=num_shards, shard_id=shard_id)
    if _is_multiprocess():
        # Replicated val (see _place_val): every host runs the full pass.
        val_spec = BatchSpec(int(cfg.batch_size), shuffle=False)
    else:
        val_spec = BatchSpec(int(cfg.batch_size), shuffle=False,
                             num_shards=num_shards, shard_id=shard_id)

    model = get_model(cfg.model_name, cfg)
    b0 = next(dataset.batches(spec))
    context = create_context(
        cfg, model,
        (jnp.asarray(b0["src"]), jnp.asarray(b0["tgt"]),
         jnp.asarray(b0["transform"])),
        seed=int(cfg.manual_seed or 1),
    )
    if cfg.load_model:
        context.load_state_dict(ckpt.load_model(cfg.load_model)["net_state_dict"])
        logger.info("%s's previous weights loaded.", cfg.model_name)

    _replicate_context(context, mesh)
    train_step = make_train_step(model, context.tx, "registration", mesh)
    compiled, step_report = None, None
    eval_step = make_eval_step(model, "registration")
    rng = jax.random.PRNGKey(int(cfg.manual_seed or 1))
    guard = NanGuard()
    lr = float(cfg.lr)
    plateau = optim_util.PlateauScheduler(
        lr, float(cfg.lr_decay_rate or 0.5), float(cfg.lr_clip or 0.0)
    )

    print_every = int(cfg.step_interval_to_print or 100)
    # NanGuard safety bound: flush the device-side loss queue at least every
    # 20 steps regardless of the print cadence, so a NaN aborts within ~20
    # optimizer updates instead of `step_interval_to_print` (ADVICE r2).
    guard_every = min(print_every, 20)
    timer = profiling.StepTimer()
    alpha1 = jnp.asarray(1.0)

    train_meter = AverageValueMeter()
    history = {"train_loss": [], "val": []}
    for epoch in range(int(cfg.start_epoch or 0), int(cfg.nepoch)):
        train_meter.reset()
        context.opt_state = optim_util.set_learning_rate(context.opt_state, lr)

        # Interval-synced metering: see train_completion for rationale.
        pending = []
        t_flush = time.perf_counter()

        def flush():
            nonlocal t_flush
            if not pending:
                return
            dt = time.perf_counter() - t_flush
            sps = len(pending) / dt if dt > 0 else 0.0
            for j, dev in pending:
                loss = float(dev["total_loss"])
                guard.check(loss, f"registration epoch {epoch} step {j}")
                train_meter.update(loss)
                if j % print_every == 0:
                    logger.info(
                        "train [%d: %d] total_loss: %.4f rot: %.4f "
                        "trans: %.4f rmse: %.4f mse: %.4f lr: %f steps/s: %.2f",
                        epoch, j, loss, float(dev["r_err"]),
                        float(dev["t_err"]), float(dev["rmse"]),
                        float(dev["mse"]), lr, sps,
                    )
            pending.clear()
            t_flush = time.perf_counter()

        place = functools.partial(
            shard_batch, mesh, exclude=("count", "match_level", "rot_level")
        )
        with DevicePrefetcher(dataset.batches(spec, epoch), place) as pf, \
                profiling.trace(cfg.profile_dir if epoch == int(cfg.start_epoch or 0) else None):
            for i, sharded in enumerate(pf):
                if max_steps_per_epoch and i >= max_steps_per_epoch:
                    break
                rng, step_rng = jax.random.split(rng)
                args = (context.params, context.batch_stats,
                        context.opt_state,
                        {k: sharded[k] for k in ("src", "tgt", "transform")},
                        alpha1, step_rng)
                if compiled is None:
                    compiled, step_report = compile_step(train_step, *args)
                with timer:
                    (context.params, context.batch_stats, context.opt_state,
                     aux) = compiled(*args)
                pending.append((i, aux))
                if len(pending) >= guard_every:
                    flush()
        flush()
        history["train_loss"].append(train_meter.avg)

        if (epoch % int(cfg.epoch_interval_to_save or 1) == 0
                and launch.is_primary()):
            ckpt.save_model(os.path.join(log_dir, "network.pkl"),
                            context.variables, context.opt_state)

        if (epoch % int(cfg.epoch_interval_to_val or 1) == 0
                or epoch == int(cfg.nepoch) - 1):
            res = val_registration(
                context, eval_step, dataset_val, val_spec, val_meters,
                split_meters, best, epoch, log_dir,
            )
            history["val"].append(res)
            # The reference instantiates ReduceLROnPlateau but never calls
            # scheduler.step() (registration/train.py:75-76) -> constant LR.
            # Opt-in with cfg.lr_plateau_step to actually reduce on plateau.
            if cfg.lr_plateau_step:
                lr = plateau.step(res["RMSE"])
    return {"best": best, "history": history, "context": context,
            "train_step": step_report}


def val_registration(context, eval_step, dataset_val, spec, val_meters,
                     split_meters, best, epoch, log_dir,
                     rmse_thresh: float = 0.1) -> Dict[str, float]:
    for v in val_meters.values():
        v.reset()
    for row in split_meters:
        for cell in row:
            for v in cell.values():
                v.reset()

    # Single device->host sync per val pass (see val_completion).
    pending = []
    for batch in dataset_val.batches(spec):
        count = int(batch["count"])
        _, r_err, t_err, rmse, mse = eval_step(
            context.params, context.batch_stats,
            _place_val(batch, ("src", "tgt", "transform")),
            prefix="val",
        )
        pending.append(
            ((r_err, t_err, rmse, mse),
             (count, batch["rot_level"], batch["match_level"]))
        )
    for (r_err, t_err, rmse, mse), (count, rot_level, match_level) in (
            jax.device_get(pending)):
        recall = (rmse < rmse_thresh).astype(np.float32)
        vals = {"RotE": r_err, "transE": t_err, "MSE": mse, "RMSE": rmse,
                "recall": recall}
        for m, arr in vals.items():
            val_meters[m].update(float(arr[:count].mean()), count)
        for i in range(count):
            rl = int(rot_level[i])
            ml = int(match_level[i])
            for m, arr in vals.items():
                split_meters[rl][ml][m].update(float(arr[i]))

    log, best_log = "", ""
    for m, meter in val_meters.items():
        curr_best_epoch, curr_best = best[m]
        improved = (
            meter.avg > curr_best if m == "recall" else meter.avg < curr_best
        )
        if improved:
            best[m] = (epoch, meter.avg)
            # Primary-only, like the epoch checkpoints (multi-process: every
            # process computes identical metrics on the replicated val pass,
            # but only one should write).
            if launch.is_primary():
                ckpt.save_model(
                    os.path.join(log_dir, f"best_{m}_network.pkl"),
                    context.variables,
                )
                logger.info("Best %s net saved!", m)
        log += f"curr_{m}: {meter.avg:f}; "
        best_log += f"best_{m}: {best[m][1]:f} [epoch {best[m][0]}]; "
    logger.info(log)
    logger.info(best_log)
    for rl in range(len(split_meters)):
        for ml in range(len(split_meters[0])):
            cell = split_meters[rl][ml]
            logger.info(
                "[rot_level %d, match_level %d] %s", rl, ml,
                "; ".join(f"curr_{m}: {v.avg:f}" for m, v in cell.items()),
            )
    return {m: meter.avg for m, meter in val_meters.items()}
