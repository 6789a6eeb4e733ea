"""Multi-host (DCN) bring-up smoke: run under N processes.

Each process calls smore_tpu.parallel.mesh.init_distributed against a
localhost coordinator, builds the GLOBAL device mesh, and executes one
data-parallel SGNS training step with psum-merged deltas — the across-
hosts design of SURVEY.md 5.8 (per-host independent sampler streams via
fold_in(process_index), only delta traffic crossing DCN).

Launched by tests/test_multihost.py as 2 subprocesses; also runnable by
hand:

    for i in 0 1; do
      JAX_PLATFORMS=cpu python experiments/multihost_smoke.py \
          --coord localhost:12355 --nprocs 2 --pid $i &
    done; wait
"""

import argparse
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coord", required=True)
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--local_devices", type=int, default=2)
    args = ap.parse_args()

    flags = os.environ.get("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] = (
        flags + f" --xla_force_host_platform_device_count={args.local_devices}"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")

    from smore_tpu.parallel.mesh import init_distributed, make_mesh

    init_distributed(
        coordinator=args.coord,
        num_processes=args.nprocs,
        process_id=args.pid,
    )
    assert jax.process_count() == args.nprocs, jax.process_count()
    n_global = len(jax.devices())
    n_local = len(jax.local_devices())
    assert n_global == args.nprocs * args.local_devices, n_global

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P

    try:
        from jax import shard_map
    except ImportError:  # pragma: no cover
        from jax.experimental.shard_map import shard_map

    from smore_tpu.models.base import init_embedding, zeros_embedding
    from smore_tpu.ops.update import sgns_shared_negs_step

    mesh = make_mesh()  # ALL global devices
    n, dim, batch, ks = 64, 8, 16, 8
    key = jax.random.PRNGKey(0)
    state = {
        "vertex": np.asarray(init_embedding(key, n, dim)),
        "context": np.asarray(zeros_embedding(n, dim)),
    }

    def shard_fn(state, key, alpha):
        # per-DEVICE stream: fold in the device's mesh position (the
        # multi-host analog of per-thread RNG, random.cpp:5-13)
        key = jax.random.fold_in(key, jax.lax.axis_index("d"))
        k1, k2, k3 = jax.random.split(key, 3)
        src = jax.random.randint(k1, (batch,), 0, n, dtype=jnp.int32)
        pos = jax.random.randint(k2, (batch,), 0, n, dtype=jnp.int32)
        negs = jax.random.randint(k3, (ks,), 0, n, dtype=jnp.int32)
        wv, wc, loss = sgns_shared_negs_step(
            state["vertex"], state["context"], src, pos, negs,
            jnp.float32(alpha), k_equiv=2,
        )
        delta = jax.tree.map(
            lambda a, b: a - b, {"vertex": wv, "context": wc}, state
        )
        delta = jax.lax.psum(delta, "d")
        new_state = jax.tree.map(lambda o, d: o + d, state, delta)
        return new_state, jax.lax.pmean(loss, "d")

    step = jax.jit(
        shard_map(
            shard_fn, mesh=mesh,
            in_specs=(P(), P(), P()), out_specs=(P(), P()),
            check_vma=False,
        )
    )
    new_state, loss = step(state, key, np.float32(0.025))
    loss = float(loss)
    assert np.isfinite(loss), loss
    # context starts at zero, so the FIRST step's vertex delta is exactly
    # zero (d_src = g_pos * context_row); the context table must move.
    moved = float(
        np.abs(np.asarray(new_state["context"]) - state["context"]).max()
    )
    assert moved > 0.0, "DP step did not update the tables"
    print(
        f"MULTIHOST_OK pid={args.pid} procs={jax.process_count()} "
        f"global_devices={n_global} local_devices={n_local} "
        f"loss={loss:.4f} moved={moved:.2e}",
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
