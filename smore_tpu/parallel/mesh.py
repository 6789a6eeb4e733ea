"""Device-mesh helpers for multi-chip training.

The reference's only parallelism is single-node hogwild threads
(SURVEY.md section 2.5). The mesh replacement:

  - data axis "d": each device draws an independent batch shard (the
    analog of the reference's per-thread RNG streams,
    /root/reference/src/random.cpp:5-13) and applies updates; embedding
    tables are either replicated (small graphs) or row-sharded.
  - row-sharded tables: vertex rows striped over "d"
    (``NamedSharding(mesh, P("d", None))``); gathers/scatters against a
    sharded table are partitioned by GSPMD, which inserts the all-to-all /
    all-gather collectives automatically.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None, axis: str = "d") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def row_sharded(mesh: Mesh, axis: str = "d") -> NamedSharding:
    """Embedding table sharding: rows striped across the mesh axis."""
    return NamedSharding(mesh, P(axis, None))


def batch_sharded(mesh: Mesh, axis: str = "d") -> NamedSharding:
    """Index-batch sharding: leading dim split across devices."""
    return NamedSharding(mesh, P(axis))


def shard_state(state, mesh: Mesh, axis: str = "d"):
    """Large-graph mode: place every embedding table row-sharded over the
    mesh. A TrainDriver jit over such state keeps the shardings; GSPMD
    partitions the gathers/scatter-adds and inserts the all-gather /
    all-to-all collectives (SURVEY.md 5.8). Use when the tables
    do not fit one card's memory; for smaller graphs prefer
    TrainDriver(mesh=...) data parallelism (replicated tables)."""
    rows = row_sharded(mesh, axis)
    return jax.tree.map(
        lambda x: jax.device_put(x, rows) if getattr(x, "ndim", 0) == 2 else x,
        state,
    )


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Multi-host (DCN) bring-up: wraps jax.distributed.initialize. Each
    host then builds the same global Mesh over jax.devices(); per-host
    sampler streams differ via fold_in(key, process_index) -- the
    multi-host analog of the reference's per-thread RNG
    (/root/reference/src/random.cpp:5-13)."""
    kwargs = {}
    if coordinator is not None:
        kwargs = dict(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    jax.distributed.initialize(**kwargs)
