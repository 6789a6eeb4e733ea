"""Field-constrained sampling tables.

The reference's field system (proNet::LoadFieldMeta + NegativeFieldSample,
/root/reference/src/proNet.cpp:330-408,635-645) tags each vertex with a
field id and lets models draw negatives restricted to a given field by
REJECTION (resample until the field matches, e.g. HBPR.cpp:111-113).

Design: one alias table per field, concatenated into flat arrays (the
same layout trick as the per-vertex context tables) so a single gather
serves every field:

    field_indptr : (F+1,) slot range of field f
    field_pa     : (S, 2) float32 [prob, alias_slot] per slot
    field_vid    : (S,)   vid at each slot
    field_of     : (N,)   field id per vertex

A field-constrained draw is then O(1): pick a slot uniformly inside the
field's range, walk the alias redirect, read the vid.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from smore_tpu.sampling.alias import build_alias


@jax.tree_util.register_pytree_node_class
@dataclass
class FieldTables:
    field_indptr: jnp.ndarray  # (F+1,) int32
    field_pa: jnp.ndarray  # (S, 2) float32 [prob, alias_slot]
    field_vid: jnp.ndarray  # (S,) int32
    field_of: jnp.ndarray  # (N,) int32

    def tree_flatten(self):
        return (
            self.field_indptr,
            self.field_pa,
            self.field_vid,
            self.field_of,
        ), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @staticmethod
    def build(graph, weights: np.ndarray = None) -> "FieldTables":
        """weights: per-vertex sampling mass (default: the reference's
        degree^0.75 negative distribution over in+out degree)."""
        n = graph.n_vertices
        fields = (
            graph.fields
            if graph.fields is not None
            else np.zeros(n, dtype=np.int32)
        )
        n_fields = max(1, int(fields.max()) + 1 if len(fields) else 1)
        if weights is None:
            weights = graph.out_degree + graph.in_degree

        order = np.argsort(fields, kind="stable")
        sorted_fields = fields[order]
        indptr = np.searchsorted(
            sorted_fields, np.arange(n_fields + 1)
        ).astype(np.int64)

        prob = np.ones(n, dtype=np.float64)
        alias_slot = np.arange(n, dtype=np.int64)
        for f in range(n_fields):
            lo, hi = indptr[f], indptr[f + 1]
            if hi <= lo:
                continue
            w = weights[order[lo:hi]].astype(np.float64)
            p, a = build_alias(w)  # power transform handled inside
            prob[lo:hi] = p
            local = np.arange(hi - lo)
            alias_slot[lo:hi] = lo + np.where(a < 0, local, a)

        return FieldTables(
            field_indptr=jnp.asarray(indptr, dtype=jnp.int32),
            field_pa=jnp.asarray(
                np.stack([prob, alias_slot], axis=1), dtype=jnp.float32
            ),
            field_vid=jnp.asarray(order, dtype=jnp.int32),
            field_of=jnp.asarray(fields, dtype=jnp.int32),
        )

    def negative_field_sample(
        self, key: jax.Array, fids: jnp.ndarray, u2=None
    ) -> jnp.ndarray:
        """Draw one vertex per row whose field == fids[row]
        (proNet::NegativeFieldSample / the HBPR rejection loop, exactly)."""
        if u2 is None:
            u2 = jax.random.uniform(key, tuple(fids.shape) + (2,))
        lo = self.field_indptr.at[fids].get(mode="promise_in_bounds")
        hi = self.field_indptr.at[fids + 1].get(mode="promise_in_bounds")
        size = jnp.maximum(hi - lo, 1)
        slot = lo + jnp.minimum((u2[..., 0] * size).astype(jnp.int32), size - 1)
        row = self.field_pa.at[slot].get(mode="promise_in_bounds")
        slot = jnp.where(
            u2[..., 1] < row[..., 0], slot, row[..., 1].astype(jnp.int32)
        )
        return self.field_vid.at[slot].get(mode="promise_in_bounds")

    def field_of_v(self, vids: jnp.ndarray) -> jnp.ndarray:
        return self.field_of.at[vids].get(mode="promise_in_bounds")
