"""Optimizers + LR schedules matching the reference semantics.

- Adam/Adagrad selection via config (``completion/train.py:71-77``).
- Manual epoch-level LR decay: every ``lr_decay_interval`` epochs multiply by
  ``lr_decay_rate``; or explicit step lists; clipped at ``lr_clip``
  (``completion/train.py:110-120``).
- ReduceLROnPlateau for registration (``registration/train.py:75-76``) —
  NOTE: the reference creates it but never steps it, so its effective LR is
  constant; we reproduce that default and expose ``lr_plateau_step: true`` to
  actually enable it.

The learning rate is injected as an optax hyperparameter so LR changes never
retrace the jitted train step.
"""

from __future__ import annotations

from typing import Tuple

import optax

from mvp_benchmark_tpu.train.config import Config, parse_float_list, parse_int_list


def build_optimizer(cfg: Config) -> optax.GradientTransformation:
    name = (cfg.optimizer or "Adam").lower()
    if name == "adam":
        betas = parse_float_list(cfg.betas or "0.9, 0.999")
        wd = float(cfg.weight_decay or 0.0)

        def make(learning_rate):
            # Per-leaf moments (not optax.flatten): the flattened opt_state
            # would break checkpoint-shape compatibility.
            if wd:
                return optax.adamw(
                    learning_rate, b1=betas[0], b2=betas[1], weight_decay=wd
                )
            return optax.adam(learning_rate, b1=betas[0], b2=betas[1])

    elif name == "adagrad":

        def make(learning_rate):
            return optax.adagrad(
                learning_rate,
                initial_accumulator_value=float(cfg.initial_accum_val or 0.1),
            )

    else:
        raise ValueError(f"unsupported optimizer {cfg.optimizer!r}")

    return optax.inject_hyperparams(make)(learning_rate=float(cfg.lr))


def epoch_lr(cfg: Config, epoch: int) -> float:
    """Reference completion LR schedule (train.py:110-120), pure function."""
    lr = float(cfg.lr)
    if not cfg.lr_decay:
        return lr
    if cfg.lr_decay_interval and cfg.lr_step_decay_epochs:
        raise ValueError(
            "lr_decay_interval and lr_step_decay_epochs are mutually exclusive!"
        )
    if cfg.lr_decay_interval:
        steps = epoch // int(cfg.lr_decay_interval)
        lr = lr * float(cfg.lr_decay_rate) ** steps
    elif cfg.lr_step_decay_epochs:
        decay_epochs = parse_int_list(cfg.lr_step_decay_epochs)
        decay_rates = parse_float_list(cfg.lr_step_decay_rates)
        for e, r in zip(decay_epochs, decay_rates):
            if epoch >= e:
                lr = lr * r
    if cfg.lr_clip:
        lr = max(lr, float(cfg.lr_clip))
    return lr


def set_learning_rate(opt_state, lr: float):
    """Return a new opt_state with the injected LR hyperparameter replaced.

    Rebuilds the InjectHyperparamsState instead of mutating ``hyperparams``
    in place — in-place mutation aliases device buffers and breaks silently
    once the state is donated to the jitted step.
    """
    import jax.numpy as jnp

    hp = dict(opt_state.hyperparams)
    hp["learning_rate"] = jnp.asarray(lr, jnp.float32)
    return opt_state._replace(hyperparams=hp)


def alpha_for_epoch(cfg: Config, epoch: int):
    """Loss-weight alpha schedule (``completion/train.py:101-108``)."""
    if not cfg.varying_constant:
        return None
    epochs = parse_int_list(cfg.varying_constant_epochs)
    consts = parse_float_list(cfg.varying_constant)
    assert len(consts) == len(epochs) + 1
    for ind, ep in enumerate(epochs):
        if epoch < ep:
            return consts[ind]
    return consts[-1]


class PlateauScheduler:
    """torch ReduceLROnPlateau equivalent (mode=min, patience=10, factor)."""

    def __init__(self, lr: float, factor: float, min_lr: float,
                 patience: int = 10):
        self.lr = lr
        self.factor = factor
        self.min_lr = min_lr
        self.patience = patience
        self.best = float("inf")
        self.bad_epochs = 0

    def step(self, metric: float) -> float:
        if metric < self.best:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_epochs = 0
        return self.lr
