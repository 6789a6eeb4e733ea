"""Decompose the hoisted banded DRAW cost: RNG vs edge-row gather.

The hoisted draw is a large share of the banded step. This experiment
separates its two candidate costs on the GPU:

  full        the production hoisted draw (baseline)
  rng         ONLY the threefry uniforms the draw consumes
  rng_rbg     the same uniforms from the rbg (hardware) generator
  gather      ONLY the edge_pa 32-B row gathers (slots from a cheap
              integer hash so XLA can't constant-fold the addresses)
  gather_neg  gather + the negative-table 8-B row gathers
  full_rbg    the production draw with an rbg key

Run: python experiments/draw_decomp.py  (GPU)
"""

from __future__ import annotations

import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, "/root/repo")
sys.path.insert(0, "/root/repo/experiments")

from bench import make_youtube_graph  # noqa: E402
from yt_scale_bench import YT  # noqa: E402

BATCH = 32768
HOIST = 8
KS = 128
STEPS_PER_CALL = 100
CALLS = 3


def build():
    from smore_tpu.graph.graph import Graph
    from smore_tpu.sampling.banded import FUSED_BAND_SIZE, BandedTables

    g = Graph.load_edge_list(YT, undirected=True)
    bt = BandedTables.build(g, band_size=FUSED_BAND_SIZE, two_d=True)
    return bt


def make_run(bt, variant):
    E = bt.edge_pa.shape[0]
    Nn = bt.neg_pa.shape[0]

    def body(carry, key):
        if variant in ("full", "full_rbg"):
            sb, db, src, pos, negs = bt.draw_banded_batches_hoisted(
                key, BATCH, 1, KS, HOIST
            )
            probe = (
                jnp.sum(src[:, :64]) + jnp.sum(pos[:, :64])
                + jnp.sum(negs[:, :16]) + jnp.sum(sb) + jnp.sum(db)
            )
        elif variant in ("rng", "rng_rbg"):
            kb, ku, kn = jax.random.split(key, 3)
            ub = jax.random.uniform(kb, (HOIST, 2))
            u = jax.random.uniform(ku, (HOIST, BATCH, 2))
            un = jax.random.uniform(kn, (HOIST, KS, 2))
            probe = (jnp.sum(ub) + jnp.sum(u[:, :64]) + jnp.sum(un)) \
                .astype(jnp.int32)
        elif variant in ("gather", "gather_neg"):
            # slot addresses from a cheap integer hash of the carry --
            # data-dependent, so XLA must issue real gathers
            base = carry.astype(jnp.uint32)
            i = jax.lax.broadcasted_iota(
                jnp.uint32, (HOIST, BATCH), 1
            ) + base
            slot = ((i * jnp.uint32(2654435761)) >> jnp.uint32(8)
                    ).astype(jnp.int32) % E
            row = bt.edge_pa.at[slot.reshape(-1)].get(
                mode="promise_in_bounds"
            ).reshape(HOIST, BATCH, -1)
            probe = jnp.sum(row[:, :64]).astype(jnp.int32)
            if variant == "gather_neg":
                j = ((i[:, :KS] * jnp.uint32(40503)) >> jnp.uint32(4)
                     ).astype(jnp.int32) % Nn
                nrow = bt.neg_pa.at[j.reshape(-1)].get(
                    mode="promise_in_bounds"
                ).reshape(HOIST, KS, -1)
                probe = probe + jnp.sum(nrow).astype(jnp.int32)
        else:
            raise ValueError(variant)
        return carry + probe.astype(jnp.int32) % 7, None

    @jax.jit
    def run(carry, key):
        keys = jax.random.split(key, STEPS_PER_CALL)
        carry, _ = jax.lax.scan(body, carry, keys)
        return carry

    return run


def main():
    make_youtube_graph(YT)
    bt = build()
    micro_per_call = STEPS_PER_CALL * HOIST
    results = {}
    for variant in ["full", "rng", "rng_rbg", "gather", "gather_neg",
                    "full_rbg"]:
        impl = "rbg" if variant.endswith("rbg") else "threefry"
        key = jax.random.PRNGKey(0) if impl == "threefry" else \
            jax.random.key(0, impl="rbg")
        run = make_run(bt, variant)
        carry = jnp.int32(1)
        carry = run(carry, key)
        carry.block_until_ready()
        t0 = time.time()
        for c in range(CALLS):
            key2 = (jax.random.PRNGKey(c + 1) if impl == "threefry"
                    else jax.random.key(c + 1, impl="rbg"))
            carry = run(carry, key2)
        carry.block_until_ready()
        dt = (time.time() - t0) / (CALLS * micro_per_call)
        results[variant] = dt
        print(f"{variant:12s} {dt * 1e6:8.1f} us/micro-step "
              f"({BATCH / dt / 1e6:7.1f} M draws/s)", flush=True)
    print({k: round(v * 1e6, 1) for k, v in results.items()})


if __name__ == "__main__":
    main()
