"""DeepWalk: truncated random walks + skip-gram with negative sampling.

Reference: /root/reference/src/model/DeepWalk.{h,cpp} (walk loop
DeepWalk.cpp:98-155) and /root/reference/internal/models/deepwalk.
Flags match the C++ CLI (cli/deepwalk.cpp): walk_times=10, walk_steps=40,
window_size=5, negative_samples=5, alpha=0.025.
"""

from __future__ import annotations

import jax

from smore_tpu.models.walk_base import WalkSGNSBase
from smore_tpu.sampling.mappers import skipgram_pairs
from smore_tpu.sampling.walks import random_walk


class DeepWalk(WalkSGNSBase):
    def __init__(self, graph, seed: int = 0):
        super().__init__(graph, seed)
        self.walk_steps = 40
        self.window_size = 5

    def _emit_pairs(self, tables, key, starts):
        k1, k2 = jax.random.split(key)
        walk, row_mask = random_walk(tables, k1, starts, self.walk_steps)
        return skipgram_pairs(walk, k2, self.window_size, row_mask)

    def train(
        self,
        walk_times: int = 10,
        walk_steps: int = 40,
        window_size: int = 5,
        negative_samples: int = 5,
        alpha: float = 0.025,
        # batch_walks=128-256 -> 52-105k pair slots/step on a 40-step walk:
        # large enough for the matrix units, small enough that stale-snapshot
        # collisions don't hurt (measured link-AUC 0.9956-0.9966 with
        # collision="sum", matching the C++ reference's 0.9958).
        batch_walks: int = 128,
        steps_per_call: int = 64,
        shared_negatives: int = 256,
        collision: str = "sum",
        hoist: int = 1,  # walk-generation mega-draw for N batches before
        # an inner update scan (identical law; models/walk_base.py). Off
        # by default until measured on hardware; single-stream only.
        mesh=None,
        sharding: str = "dp",
        verbose: bool = True,
    ) -> None:
        self.walk_steps = walk_steps
        self.window_size = window_size
        self._run(
            hoist=hoist,
            total_walks=walk_times * self.graph.n_vertices,
            batch_walks=batch_walks,
            negatives=negative_samples,
            alpha=alpha,
            steps_per_call=steps_per_call,
            shared_negatives=shared_negatives,
            collision=collision,
            verbose=verbose,
            mesh=mesh,
            sharding=sharding,
        )
