"""Knowledge-graph store: (head, relation, tail, weight) triples.

Reference: /root/reference/pkg/knowledge/knowledge_graph.go -- entity and
relation interning (:145-183), head/tail/relation indices (:37-39), and
per-relation entity sets for corrupt-head/corrupt-tail negative sampling
(:185-212). File format: ``head relation tail [weight]`` whitespace-split,
weight defaults to 1.0.

Device layout: triples as parallel numpy arrays; the per-relation entity
pools flattened into (rel_indptr, rel_entities) segments so a corrupted
entity is one uniform draw inside the relation's segment on device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np


@dataclass
class KnowledgeGraph:
    heads: np.ndarray  # (T,) int32
    relations: np.ndarray  # (T,) int32
    tails: np.ndarray  # (T,) int32
    weights: np.ndarray  # (T,) float32
    entities: List[str]
    relations_names: List[str]
    entity2id: Dict[str, int]
    relation2id: Dict[str, int]
    # per-relation entity pools, flattened
    rel_indptr: np.ndarray  # (R+1,) int64
    rel_entities: np.ndarray  # (S,) int32

    @property
    def n_entities(self) -> int:
        return len(self.entities)

    @property
    def n_relations(self) -> int:
        return len(self.relations_names)

    @property
    def n_triples(self) -> int:
        return len(self.heads)

    @staticmethod
    def load_triples(path: str) -> "KnowledgeGraph":
        e2i: Dict[str, int] = {}
        r2i: Dict[str, int] = {}
        ents: List[str] = []
        rels: List[str] = []
        h_l, r_l, t_l, w_l = [], [], [], []

        def intern(table, names, s):
            i = table.get(s)
            if i is None:
                i = len(names)
                table[s] = i
                names.append(s)
            return i

        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 3:
                    continue
                h = intern(e2i, ents, parts[0])
                r = intern(r2i, rels, parts[1])
                t = intern(e2i, ents, parts[2])
                w = 1.0
                if len(parts) >= 4:
                    try:
                        w = float(parts[3])
                    except ValueError:
                        pass
                h_l.append(h)
                r_l.append(r)
                t_l.append(t)
                w_l.append(w)

        heads = np.asarray(h_l, dtype=np.int32)
        relations = np.asarray(r_l, dtype=np.int32)
        tails = np.asarray(t_l, dtype=np.int32)

        # per-relation entity pools: unique entities seen with relation r
        pairs = np.unique(
            np.concatenate(
                [
                    np.stack([relations, heads], axis=1),
                    np.stack([relations, tails], axis=1),
                ]
            ),
            axis=0,
        )
        n_rel = len(rels)
        rel_indptr = np.searchsorted(
            pairs[:, 0], np.arange(n_rel + 1)
        ).astype(np.int64)

        return KnowledgeGraph(
            heads=heads,
            relations=relations,
            tails=tails,
            weights=np.asarray(w_l, dtype=np.float32),
            entities=ents,
            relations_names=rels,
            entity2id=e2i,
            relation2id=r2i,
            rel_indptr=rel_indptr,
            rel_entities=pairs[:, 1].astype(np.int32),
        )
