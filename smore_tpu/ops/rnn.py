"""Standalone RNN cell: the batched equivalent of the reference's
pkg/rnn (/root/reference/pkg/rnn/rnn.go).

The reference ships a tiny reusable package -- a simple tanh RNN cell
with (a) Forward h' = tanh(Wh h + Wx x + b) (rnn.go:58-81), (b) a
one-step pseudo-BPTT Update toward a target hidden state (rnn.go:85-119:
error * (1 - h'^2) outer-producted into Wh/Wx/b, plain SGD ascent), and
(c) a time-delta Project (rnn.go:123-132: forward with input = [dt,
0...]). JODIE is its only consumer there (jodie.go), as here
(smore_tpu/models/jodie.py) -- but the module is reusable on its own.

Design: parameters are a pytree dict; every op is batched over a
leading axis and jit-safe (pure functions returning new params instead
of in-place mutation).
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp


def init_rnn_cell(
    key: jax.Array, in_dim: int, hidden_dim: int, scale: float = None
) -> Dict[str, jnp.ndarray]:
    """Uniform(-scale, scale) weights, zero bias; the reference's
    default scale is 1/sqrt(hidden_dim) (rnn.go:27)."""
    if scale is None:
        scale = 1.0 / jnp.sqrt(float(hidden_dim))
    k1, k2 = jax.random.split(key)
    return {
        "Wh": jax.random.uniform(
            k1, (hidden_dim, hidden_dim), minval=-scale, maxval=scale
        ),
        "Wx": jax.random.uniform(
            k2, (hidden_dim, in_dim), minval=-scale, maxval=scale
        ),
        "b": jnp.zeros((hidden_dim,)),
    }


def rnn_forward(params, h: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """h' = tanh(Wh h + Wx x + b); batched over any leading axes."""
    return jnp.tanh(
        h @ params["Wh"].T + x @ params["Wx"].T + params["b"]
    )


def rnn_update(
    params, h: jnp.ndarray, x: jnp.ndarray, target: jnp.ndarray,
    lr: float,
) -> Dict[str, jnp.ndarray]:
    """One-step pseudo-BPTT toward ``target`` (rnn.go:85-119): the
    gradient is (target - h') * (1 - h'^2), outer-producted into the
    weights. Batched inputs sum their gradients (the batched analog of
    the reference's sequential per-sample updates)."""
    h = jnp.atleast_2d(h)
    x = jnp.atleast_2d(x)
    target = jnp.atleast_2d(target)
    pred = rnn_forward(params, h, x)
    g = (target - pred) * (1.0 - pred * pred)  # (B, H)
    return {
        "Wh": params["Wh"] + lr * g.T @ h,
        "Wx": params["Wx"] + lr * g.T @ x,
        "b": params["b"] + lr * g.sum(axis=0),
    }


def rnn_project(params, emb: jnp.ndarray, dt) -> jnp.ndarray:
    """Project an embedding forward in time: forward pass with input
    [dt, 0, ...] (rnn.go:123-132)."""
    emb = jnp.asarray(emb)
    in_dim = params["Wx"].shape[1]
    batch_shape = emb.shape[:-1]
    x = jnp.zeros(batch_shape + (in_dim,), emb.dtype)
    if in_dim > 0:
        x = x.at[..., 0].set(dt)
    return rnn_forward(params, emb, x)
