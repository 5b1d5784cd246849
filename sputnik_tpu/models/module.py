"""A minimal functional module system for the model layer.

Modules are frozen dataclasses holding their configuration. Parameters
live outside them, in a nested dict, exactly as a flax ``linen`` model
would lay them out (``{"params": {"layer_0": {"mlp": {"to_4h":
{"kernel", "bias"}}}}}``), so checkpoints, name-keyed sharding rules and
the serving runtime's direct reads (``x @ p["kernel"] + p["bias"]``) work
unchanged:

  * ``module.init(key, *args)`` traces the forward once, creating every
    parameter it asks for, and returns ``{"params": tree}``;
  * ``module.apply(variables, *args)`` runs the forward on given
    parameters; ``mutable=["intermediates"]`` also returns the values the
    forward sowed (``{"intermediates": {...: {name: (value,)}}}``).

Inside a forward, ``scope.param(name, init_fn, *args)`` creates or reads a
parameter, ``scope.child(name)`` is a sub-module's scope and
``scope.sow(name, value)`` records an intermediate. A sub-module runs as
``Child(...)(scope.child("name"), x)``.

The initialisers are flax's defaults: LeCun-normal (truncated) kernels,
zero biases, unit LayerNorm scales, ``1/sqrt(features)``-normal
embeddings. Parameter keys derive from the init key and the parameter's
path, so a tree is reproducible from its seed.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["Module", "Scope", "Dense", "LayerNorm", "Embed", "layernorm",
           "lecun_normal", "remat_call"]


def _fold(key, name: str):
    return jax.random.fold_in(key, zlib.crc32(name.encode()))


class Scope:
    """The parameters (and sown intermediates) of one module instance."""

    def __init__(self, params: dict, key=None, sown: Optional[dict] = None):
        self.params = params
        self.key = key                    # set while initialising
        self.sown = sown                  # set while collecting

    @property
    def initializing(self) -> bool:
        return self.key is not None

    def param(self, name: str, init_fn, *args):
        if name not in self.params:
            if not self.initializing:
                raise KeyError(f"missing parameter {name!r}")
            self.params[name] = init_fn(_fold(self.key, name), *args)
        return self.params[name]

    def child(self, name: str) -> "Scope":
        if name not in self.params:
            if not self.initializing:
                raise KeyError(f"missing parameters for {name!r}")
            self.params[name] = {}
        sown = None
        if self.sown is not None:
            sown = self.sown.setdefault(name, {})
        return Scope(self.params[name],
                     None if self.key is None else _fold(self.key, name),
                     sown)

    def sow(self, name: str, value) -> None:
        if self.sown is not None:
            self.sown[name] = self.sown.get(name, ()) + (value,)


def _prune(tree: dict) -> dict:
    """Drop empty sub-dicts (scopes that sowed nothing)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            v = _prune(v)
            if not v:
                continue
        out[k] = v
    return out


@dataclasses.dataclass(frozen=True)
class Module:
    """Base class: subclasses define ``forward(self, scope, *args)``."""

    def forward(self, scope: Scope, *args):
        raise NotImplementedError

    def __call__(self, scope: Scope, *args):
        return self.forward(scope, *args)

    def init(self, key, *args) -> dict:
        scope = Scope({}, key)
        self.forward(scope, *args)
        return {"params": scope.params}

    def apply(self, variables: dict, *args, mutable=()):
        collect = "intermediates" in mutable
        scope = Scope(variables.get("params", {}), None,
                      {} if collect else None)
        out = self.forward(scope, *args)
        if collect:
            return out, {"intermediates": _prune(scope.sown)}
        return out

    def clone(self, **changes) -> "Module":
        return dataclasses.replace(self, **changes)


def remat_call(module: Module, scope: Scope, x):
    """Run ``module`` under ``jax.checkpoint``: activations are
    recomputed in the backward pass instead of stored. The parameter tree
    is unchanged (initialisation runs the plain forward)."""
    if scope.initializing:
        return module(scope, x)

    def run(params, x):
        sub = Scope(params, None, {} if scope.sown is not None else None)
        return module(sub, x), sub.sown

    y, sown = jax.checkpoint(run)(scope.params, x)
    if sown:
        for k, v in sown.items():
            scope.sown[k] = v
    return y


def lecun_normal(key, shape, dtype=jnp.float32):
    """flax's default kernel init: truncated normal, variance 1/fan_in."""
    fan_in = int(np.prod(shape[:-1]))
    # stddev of a standard normal truncated to [-2, 2]
    std = np.sqrt(1.0 / max(fan_in, 1)) / 0.87962566103423978
    return (jax.random.truncated_normal(key, -2.0, 2.0, shape, jnp.float32)
            * std).astype(dtype)


def _zeros(key, shape, dtype=jnp.float32):
    del key
    return jnp.zeros(shape, dtype)


def _ones(key, shape, dtype=jnp.float32):
    del key
    return jnp.ones(shape, dtype)


def layernorm(p, x, eps: float = 1e-6):
    """LayerNorm apply on ``{"scale", "bias"}`` parameters."""
    mu = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.var(x, axis=-1, keepdims=True)
    return (x - mu) / jnp.sqrt(var + eps) * p["scale"] + p["bias"]


@dataclasses.dataclass(frozen=True)
class Dense(Module):
    """``x @ kernel (+ bias)`` with a ``[in, features]`` kernel."""

    features: int
    use_bias: bool = True
    param_dtype: Any = jnp.float32

    def forward(self, scope, x):
        kernel = scope.param("kernel", lecun_normal,
                             (x.shape[-1], self.features), self.param_dtype)
        y = jnp.matmul(x, kernel.astype(jnp.promote_types(x.dtype,
                                                          kernel.dtype)))
        if self.use_bias:
            y = y + scope.param("bias", _zeros, (self.features,),
                                self.param_dtype)
        return y


@dataclasses.dataclass(frozen=True)
class LayerNorm(Module):
    epsilon: float = 1e-6

    def forward(self, scope, x):
        p = {"scale": scope.param("scale", _ones, (x.shape[-1],)),
             "bias": scope.param("bias", _zeros, (x.shape[-1],))}
        return layernorm(p, x, self.epsilon)


@dataclasses.dataclass(frozen=True)
class Embed(Module):
    """Token embedding ``[num_embeddings, features]``; ``attend`` is the
    tied LM head ``x @ embedding^T``."""

    num_embeddings: int
    features: int

    def _table(self, scope):
        def init(key, shape, dtype=jnp.float32):
            return (jax.random.normal(key, shape, jnp.float32)
                    / np.sqrt(shape[1])).astype(dtype)

        return scope.param("embedding", init,
                           (self.num_embeddings, self.features))

    def forward(self, scope, tokens):
        return jnp.take(self._table(scope), tokens, axis=0)

    def attend(self, scope, x):
        return x @ self._table(scope).T.astype(x.dtype)
