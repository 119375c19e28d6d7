"""The small module system the benchmark models are written in.

It implements the part of ``flax.linen`` the models use, with the same
variable layout, so parameter trees and checkpoints keep their keys:

- ``Module`` subclasses are dataclasses. A module built inside another
  module's ``__call__`` is named ``ClassName_i`` (a counter per class and
  per parent call), and calling the same instance again reuses its
  variables.
- ``param``, ``variable``, ``make_rng``, ``is_mutable_collection`` and
  ``is_initializing`` inside a module; ``init(rngs, ...)`` and
  ``apply(variables, ..., mutable=..., rngs=...)`` on the top-level module.
- ``BatchNorm`` (params ``scale``/``bias``, ``batch_stats`` ``mean``/``var``),
  ``Dropout``, and the activations and initializers of ``jax.nn``.

Random keys for parameters and ``make_rng`` are derived from the given
root keys and each variable's path, so every process that starts from the
same seed builds the same parameters.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import zlib
from collections.abc import Mapping
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.nn import initializers, relu, sigmoid, softmax, softplus  # noqa: F401

# Modules whose __call__ is running, innermost last: a module built while
# one runs becomes its child.
_RUNNING: list = []


def compact(fn: Callable) -> Callable:
    """Marks a ``__call__`` that builds its submodules inline (the only
    style this module system has)."""
    return fn


def _path_hash(path) -> int:
    return zlib.crc32("/".join(path).encode()) & 0x7FFFFFFF


def _copy_tree(tree):
    if isinstance(tree, Mapping):
        return {k: _copy_tree(v) for k, v in tree.items()}
    return tree


class _Frame:
    """State of one ``init`` or ``apply`` call."""

    def __init__(self, variables, rngs, mutable, initializing: bool):
        self.variables = _copy_tree(variables)
        self.rngs = rngs
        self.mutable = mutable            # True (every collection) or a set
        self.initializing = initializing
        self.rng_counts: dict = {}

    def is_mutable(self, col: str) -> bool:
        return self.mutable is True or col in self.mutable


class Variable:
    """Handle on one entry of a variable collection (``.value``)."""

    def __init__(self, module: "Module", col: str, name: str):
        self._module, self._col, self._name = module, col, name

    @property
    def value(self):
        return self._module._scope(self._col, create=False)[self._name]

    @value.setter
    def value(self, v):
        if not self._module._frame.is_mutable(self._col):
            raise ValueError(f"collection {self._col!r} is not mutable "
                             f"(pass mutable=[{self._col!r}] to apply)")
        self._module._scope(self._col, create=True)[self._name] = v


def _bound_call(fn: Callable) -> Callable:
    @functools.wraps(fn)
    def call(self, *args, **kwargs):
        if self._frame is None:
            raise RuntimeError(
                f"{type(self).__name__} is not bound: call it through "
                "init/apply or from another module's __call__")
        self._autoname = {}
        _RUNNING.append(self)
        try:
            return fn(self, *args, **kwargs)
        finally:
            _RUNNING.pop()

    return call


class Module:
    """Base class: subclasses declare dataclass fields and a ``__call__``."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(cls, eq=False)
        if "__call__" in cls.__dict__:
            cls.__call__ = _bound_call(cls.__dict__["__call__"])

    def __post_init__(self):
        self._frame = None
        self._path = ()
        self._autoname = {}
        if _RUNNING:
            parent = _RUNNING[-1]
            prefix = type(self).__name__
            i = parent._autoname.get(prefix, 0)
            parent._autoname[prefix] = i + 1
            self._frame = parent._frame
            self._path = parent._path + (f"{prefix}_{i}",)

    # -- top level -----------------------------------------------------

    def _run(self, frame: _Frame, args, kwargs):
        bound = copy.copy(self)
        bound._frame, bound._path, bound._autoname = frame, (), {}
        return bound(*args, **kwargs)

    def init(self, rngs, *args, **kwargs):
        """Build every variable; returns ``{collection: tree}``. ``rngs`` is
        one key (for ``params``) or a dict of named keys."""
        if not isinstance(rngs, Mapping):
            rngs = {"params": rngs}
        frame = _Frame({}, dict(rngs), True, initializing=True)
        self._run(frame, args, kwargs)
        return frame.variables

    def apply(self, variables, *args, rngs=None, mutable=False, **kwargs):
        """Run ``__call__`` with the given variables. With ``mutable`` (a
        collection name, a list of them, or True) returns
        ``(out, {collection: updated tree})``."""
        if isinstance(mutable, str):
            mutable = [mutable]
        cols = True if mutable is True else frozenset(mutable or ())
        frame = _Frame(variables, dict(rngs or {}), cols, initializing=False)
        out = self._run(frame, args, kwargs)
        if not cols:
            return out
        names = frame.variables if cols is True else sorted(cols)
        return out, {c: frame.variables.get(c, {}) for c in names}

    # -- inside __call__ -----------------------------------------------

    def _scope(self, col: str, create: bool):
        d = self._frame.variables
        for key in (col,) + self._path:
            if key not in d:
                if not create:
                    return None
                d[key] = {}
            d = d[key]
        return d

    def param(self, name: str, init_fn: Callable, *args):
        scope = self._scope("params", create=False)
        if scope is not None and name in scope:
            return scope[name]
        path = self._path + (name,)
        if not self._frame.initializing:
            raise ValueError(f"parameter {'/'.join(path)} not found")
        key = jax.random.fold_in(self._frame.rngs["params"], _path_hash(path))
        value = init_fn(key, *args)
        self._scope("params", create=True)[name] = value
        return value

    def variable(self, col: str, name: str, init_fn: Callable, *args):
        scope = self._scope(col, create=False)
        if scope is None or name not in scope:
            if not self._frame.is_mutable(col):
                raise ValueError(
                    f"variable {col}/{'/'.join(self._path + (name,))} not found")
            self._scope(col, create=True)[name] = init_fn(*args)
        return Variable(self, col, name)

    def make_rng(self, name: str):
        if name not in self._frame.rngs:
            raise ValueError(f"no {name!r} key passed in rngs")
        count_key = (self._path, name)
        n = self._frame.rng_counts.get(count_key, 0)
        self._frame.rng_counts[count_key] = n + 1
        key = jax.random.fold_in(self._frame.rngs[name], _path_hash(self._path))
        return jax.random.fold_in(key, n)

    def is_mutable_collection(self, col: str) -> bool:
        return self._frame.is_mutable(col)

    def is_initializing(self) -> bool:
        return self._frame.initializing


class BatchNorm(Module):
    """Batch normalisation over every axis but the last (flax semantics:
    ``ra = momentum * ra + (1 - momentum) * batch``, biased variance,
    statistics in float32, no running-average update during ``init``).
    ``axis_name`` averages the statistics over a mapped axis (outside
    ``init``, like flax)."""

    use_running_average: bool = False
    momentum: float = 0.99
    epsilon: float = 1e-5
    dtype: Optional[Any] = None
    axis_name: Optional[str] = None

    def __call__(self, x):
        feat = x.shape[-1]
        ra_mean = self.variable("batch_stats", "mean", jnp.zeros, (feat,),
                                jnp.float32)
        ra_var = self.variable("batch_stats", "var", jnp.ones, (feat,),
                               jnp.float32)
        scale = self.param("scale", initializers.ones, (feat,))
        bias = self.param("bias", initializers.zeros, (feat,))
        if self.use_running_average:
            mean, var = ra_mean.value, ra_var.value
        else:
            xf = x.astype(jnp.float32)
            axes = tuple(range(x.ndim - 1))
            mean = jnp.mean(xf, axes)
            mean2 = jnp.mean(xf * xf, axes)
            if self.axis_name is not None and not self.is_initializing():
                mean, mean2 = lax.pmean((mean, mean2), self.axis_name)
            var = jnp.maximum(0.0, mean2 - mean * mean)
            if not self.is_initializing():
                m = self.momentum
                ra_mean.value = m * ra_mean.value + (1.0 - m) * mean
                ra_var.value = m * ra_var.value + (1.0 - m) * var
        y = (x - mean) * (lax.rsqrt(var + self.epsilon) * scale) + bias
        return y.astype(self.dtype or jnp.result_type(x, scale))


class Dropout(Module):
    """Inverted dropout; draws from the ``dropout`` rng stream."""

    rate: float
    deterministic: bool = False

    def __call__(self, x):
        if self.deterministic or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = jax.random.bernoulli(self.make_rng("dropout"), keep, x.shape)
        return jnp.where(mask, x / keep, jnp.zeros_like(x))
