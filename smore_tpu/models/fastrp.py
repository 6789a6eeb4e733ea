"""FastRP: training-free embeddings by iterated sparse random projection.

Reference: /root/reference/internal/models/fastrp/fastrp.go --
  1. very sparse random init: per entry +1 w.p. 2.5%, -1 w.p. 2.5%,
     else 0 (:129-151)
  2. ``iterations`` rounds of neighbor aggregation: for each vertex,
     sum_j w_ij * x_j * deg_i^(-ns) / sum_j w_ij (:154-223)
  3. blocks [U_0 | U_1 | ... | U_L] concatenated, dim_per_iteration =
     dim // (iterations + 1) (:77-117); final rows L2-normalized (:225)

Batched form: the aggregation is one edge-gather + segment-sum (a sparse
matmul) per iteration -- all on device, no SGD anywhere.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from smore_tpu.graph.graph import Graph
from smore_tpu.io.embeddings import save_embeddings


class FastRP:
    def __init__(
        self,
        graph: Graph,
        seed: int = 42,
        iterations: int = 3,
        normalization_strength: float = 0.0,
    ):
        self.graph = graph
        self.seed = seed
        self.iterations = iterations
        self.normalization_strength = normalization_strength
        self.state = {}
        self.dim = 0

    @classmethod
    def load_edge_list(cls, path: str, undirected: bool = True, **kw):
        return cls(Graph.load_edge_list(path, undirected=undirected), **kw)

    def generate(self, dim: int) -> None:
        g = self.graph
        n = g.n_vertices
        self.dim = dim
        L = self.iterations
        d_iter = max(1, dim // (L + 1))

        key = jax.random.PRNGKey(self.seed)
        u = jax.random.uniform(key, (n, d_iter))
        x = jnp.where(u < 0.025, 1.0, jnp.where(u < 0.05, -1.0, 0.0))

        src = jnp.asarray(
            np.repeat(np.arange(n, dtype=np.int64), np.diff(g.indptr))
        )
        dst = jnp.asarray(g.indices)
        w = jnp.asarray(g.weights, dtype=jnp.float32)
        deg = jnp.asarray(np.diff(g.indptr), dtype=jnp.float32)
        tot_w = jax.ops.segment_sum(w, src, num_segments=n)
        ns = self.normalization_strength
        norm = jnp.where(deg > 0, deg, 1.0) ** (-ns) if ns > 0 else 1.0
        scale = jnp.where(tot_w > 0, norm / jnp.maximum(tot_w, 1e-12), 0.0)

        @jax.jit
        def aggregate(x):
            msg = x.at[dst].get(mode="promise_in_bounds") * w[:, None]
            agg = jax.ops.segment_sum(msg, src, num_segments=n)
            return agg * scale[:, None]

        blocks = [x]
        for _ in range(L):
            x = aggregate(x)
            blocks.append(x)
        emb = jnp.concatenate(blocks, axis=1)
        if emb.shape[1] < dim:  # pad like the reference's fixed-size rows
            emb = jnp.pad(emb, ((0, 0), (0, dim - emb.shape[1])))
        nrm = jnp.linalg.norm(emb, axis=1, keepdims=True)
        self.state = {"vertex": emb / jnp.maximum(nrm, 1e-12)}

    def save_weights(self, path: str) -> None:
        save_embeddings(path, self.graph.names, np.asarray(self.state["vertex"]))
