"""Walk -> training-pair mappers (fixed-shape, on-device).

Reference mappers materialize variable-length (vertex, context, label)
lists per walk (/root/reference/src/proNet.cpp:726-987). On the device every
shape is static: a walk matrix (B, L) maps to a dense (B, L, C) candidate
grid plus a float mask selecting the valid slots; downstream kernels take
the mask (padded slots contribute zero gradient).

Only POSITIVE pairs are emitted -- like the reference's model loops, which
call SkipGrams(negative_samples=0) and let UpdatePairs draw negatives
(src/model/DeepWalk.cpp:137-139).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _offsets(window_min: int, window_max: int) -> np.ndarray:
    """[-wmax..-wmin, wmin..wmax] context offsets (excluding 0)."""
    left = -np.arange(window_min, window_max + 1)[::-1]
    right = np.arange(window_min, window_max + 1)
    return np.concatenate([left, right])


def skipgram_pairs(
    walk: jnp.ndarray,  # (B, L) int32
    key: jax.Array,
    window: int,
    row_mask: jnp.ndarray = None,  # (B,) float32
    valid: jnp.ndarray = None,  # (B, L) per-position validity (truncated
    # walks, e.g. temporal ones) -- a pair needs BOTH endpoints valid
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """proNet::SkipGrams (proNet.cpp:769-809): per-center shrunken window
    reduce ~ U{1..window}; pairs (walk[i], walk[i+o]) for 0 < |o| <=
    reduce, clipped to the walk. Returns flat (src (M,), ctx (M,),
    mask (M,)) with M = B * L * 2*window."""
    B, L = walk.shape
    offs = jnp.asarray(_offsets(1, window), dtype=jnp.int32)  # (2W,)
    reduce = jax.random.randint(key, (B, L), 1, window + 1)  # U{1..W}

    pos = jnp.arange(L, dtype=jnp.int32)
    j = pos[None, :, None] + offs[None, None, :]  # (1, L, 2W)
    in_bounds = (j >= 0) & (j < L)
    within = jnp.abs(offs)[None, None, :] <= reduce[:, :, None]
    mask = (in_bounds & within).astype(jnp.float32)
    if row_mask is not None:
        mask = mask * row_mask[:, None, None]
    if valid is not None:
        jv = jnp.broadcast_to(jnp.clip(j, 0, L - 1), (B, L, offs.shape[0]))
        ctx_valid = jnp.take_along_axis(
            valid, jv.reshape(B, -1), axis=1
        ).reshape(B, L, -1)
        mask = mask * valid[:, :, None] * ctx_valid

    jc = jnp.broadcast_to(jnp.clip(j, 0, L - 1), (B, L, offs.shape[0]))
    ctx = jnp.take_along_axis(walk, jc.reshape(B, -1).astype(jnp.int32), axis=1)
    src = jnp.broadcast_to(walk[:, :, None], (B, L, offs.shape[0]))
    return src.reshape(-1), ctx.reshape(-1), mask.reshape(-1)


def scale_skipgram_pairs(
    walk: jnp.ndarray,  # (B, L)
    window_min: int,
    window_max: int,
    row_mask: jnp.ndarray = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """proNet::ScaleSkipGrams (proNet.cpp:926-987): fixed offset band
    window_min <= |o| <= window_max, NO window shrink. (Walklets'
    scale-k band. The reference clamps out-of-range j to the walk edge,
    which duplicates boundary pairs; we mask them instead.)"""
    B, L = walk.shape
    offs = jnp.asarray(_offsets(window_min, window_max), dtype=jnp.int32)
    pos = jnp.arange(L, dtype=jnp.int32)
    j = pos[None, :, None] + offs[None, None, :]
    mask = ((j >= 0) & (j < L)).astype(jnp.float32)
    mask = mask * jnp.ones((B, 1, 1))
    if row_mask is not None:
        mask = mask * row_mask[:, None, None]
    jc = jnp.broadcast_to(jnp.clip(j, 0, L - 1), (B, L, offs.shape[0]))
    ctx = jnp.take_along_axis(walk, jc.reshape(B, -1).astype(jnp.int32), axis=1)
    src = jnp.broadcast_to(walk[:, :, None], (B, L, offs.shape[0]))
    return src.reshape(-1), ctx.reshape(-1), mask.reshape(-1)


def ordinal_pairs(
    walk: jnp.ndarray,  # (B, L)
    row_mask: jnp.ndarray = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """proNet::OrdinalSkipGrams (proNet.cpp:811-924, live branch only):
    (walk[0], walk[i]) for i in 1..L-1, each to be ranked against one
    negative by the caller's BPR-style kernel. Returns (src, ctx_i, mask)
    flat with M = B * (L-1)."""
    B, L = walk.shape
    src = jnp.broadcast_to(walk[:, :1], (B, L - 1))
    ctx = walk[:, 1:]
    mask = jnp.ones((B, L - 1), dtype=jnp.float32)
    if row_mask is not None:
        mask = mask * row_mask[:, None]
    return src.reshape(-1), ctx.reshape(-1), mask.reshape(-1)


def cbow_groups(
    walk: jnp.ndarray,  # (B, L)
    key: jax.Array,
    window: int,
    row_mask: jnp.ndarray = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """proNet::CBOWs (proNet.cpp:726-767) grouped form: for each center,
    the masked context set (to be averaged by the CBOW kernel). Returns
    (centers (B*L,), ctx (B*L, 2W), ctx_mask (B*L, 2W))."""
    B, L = walk.shape
    offs = jnp.asarray(_offsets(1, window), dtype=jnp.int32)
    reduce = jax.random.randint(key, (B, L), 1, window + 1)
    pos = jnp.arange(L, dtype=jnp.int32)
    j = pos[None, :, None] + offs[None, None, :]
    mask = (
        (j >= 0)
        & (j < L)
        & (jnp.abs(offs)[None, None, :] <= reduce[:, :, None])
    ).astype(jnp.float32)
    if row_mask is not None:
        mask = mask * row_mask[:, None, None]
    jc = jnp.broadcast_to(jnp.clip(j, 0, L - 1), (B, L, offs.shape[0]))
    ctx = jnp.take_along_axis(walk, jc.reshape(B, -1).astype(jnp.int32), axis=1)
    W2 = offs.shape[0]
    return (
        walk.reshape(-1),
        ctx.reshape(B * L, W2),
        mask.reshape(B * L, W2),
    )
