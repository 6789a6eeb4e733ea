"""Bipartite interaction store: timestamped user-item events.

Reference: /root/reference/pkg/bipartite/interaction_graph.go -- ``user
item timestamp [features...]`` lines (:64-140); users and items interned
SEPARATELY; interactions kept globally time-sorted plus per-user/item
time-sorted lists (:187-206); time-window queries (:225-272).

Device layout: parallel arrays sorted by timestamp; per-user/item indices
as (indptr, order) permutations for window queries.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class InteractionGraph:
    users: List[str]
    items: List[str]
    user2id: Dict[str, int]
    item2id: Dict[str, int]
    user_ids: np.ndarray  # (T,) int32, time-sorted
    item_ids: np.ndarray  # (T,)
    timestamps: np.ndarray  # (T,) float32
    features: Optional[np.ndarray]  # (T, F) or None
    user_indptr: np.ndarray  # (U+1,)
    user_order: np.ndarray  # (T,) interaction idx grouped by user, by time
    item_indptr: np.ndarray  # (I+1,)
    item_order: np.ndarray

    @property
    def n_users(self) -> int:
        return len(self.users)

    @property
    def n_items(self) -> int:
        return len(self.items)

    @property
    def n_interactions(self) -> int:
        return len(self.timestamps)

    @property
    def feature_dim(self) -> int:
        return 0 if self.features is None else self.features.shape[1]

    @property
    def min_time(self) -> float:
        return float(self.timestamps[0]) if len(self.timestamps) else 0.0

    @property
    def max_time(self) -> float:
        return float(self.timestamps[-1]) if len(self.timestamps) else 0.0

    def user_interactions(self, uid: int) -> np.ndarray:
        return self.user_order[self.user_indptr[uid]:self.user_indptr[uid + 1]]

    def item_interactions(self, iid: int) -> np.ndarray:
        return self.item_order[self.item_indptr[iid]:self.item_indptr[iid + 1]]

    def user_interactions_before(self, uid: int, t: float) -> np.ndarray:
        """Interaction indices for ``uid`` with timestamp < t, time order
        (interaction_graph.go GetUserInteractionsBefore :225-238)."""
        idx = self.user_interactions(uid)
        k = int(np.searchsorted(self.timestamps[idx], np.float32(t), side="left"))
        return idx[:k]

    def item_interactions_before(self, iid: int, t: float) -> np.ndarray:
        """Interaction indices for ``iid`` with timestamp < t
        (interaction_graph.go GetItemInteractionsBefore :241-254)."""
        idx = self.item_interactions(iid)
        k = int(np.searchsorted(self.timestamps[idx], np.float32(t), side="left"))
        return idx[:k]

    def last_user_interaction(self, uid: int, t: float) -> int:
        """Most recent interaction index before t, or -1
        (interaction_graph.go GetLastUserInteraction :257-263)."""
        idx = self.user_interactions_before(uid, t)
        return int(idx[-1]) if len(idx) else -1

    def last_item_interaction(self, iid: int, t: float) -> int:
        """Most recent interaction index before t, or -1
        (interaction_graph.go GetLastItemInteraction :266-272)."""
        idx = self.item_interactions_before(iid, t)
        return int(idx[-1]) if len(idx) else -1

    def window(self, t0: float, t1: float) -> Tuple[int, int]:
        """Global interaction index range with t0 <= ts < t1."""
        lo = int(np.searchsorted(self.timestamps, t0, side="left"))
        hi = int(np.searchsorted(self.timestamps, t1, side="left"))
        return lo, hi

    @staticmethod
    def load_interactions(path: str) -> "InteractionGraph":
        user2id: Dict[str, int] = {}
        item2id: Dict[str, int] = {}
        users: List[str] = []
        items: List[str] = []
        u_l, i_l, t_l, f_l = [], [], [], []
        feat_dim = None

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
                try:
                    ts = float(parts[2])
                except ValueError:
                    continue
                feats = []
                for p in parts[3:]:
                    try:
                        feats.append(float(p))
                    except ValueError:
                        pass
                if feat_dim is None:
                    feat_dim = len(feats)
                u_l.append(intern(user2id, users, parts[0]))
                i_l.append(intern(item2id, items, parts[1]))
                t_l.append(ts)
                f_l.append(feats[:feat_dim] + [0.0] * (feat_dim - len(feats)))

        ts = np.asarray(t_l, dtype=np.float64)
        order = np.argsort(ts, kind="stable")
        uid = np.asarray(u_l, dtype=np.int32)[order]
        iid = np.asarray(i_l, dtype=np.int32)[order]
        ts = ts[order].astype(np.float32)
        feats = (
            np.asarray(f_l, dtype=np.float32)[order]
            if feat_dim
            else None
        )

        def group(ids, n):
            o = np.argsort(ids, kind="stable")  # stable keeps time order
            indptr = np.searchsorted(ids[o], np.arange(n + 1)).astype(np.int64)
            return indptr, o.astype(np.int64)

        u_indptr, u_order = group(uid, len(users))
        i_indptr, i_order = group(iid, len(items))

        return InteractionGraph(
            users=users,
            items=items,
            user2id=user2id,
            item2id=item2id,
            user_ids=uid,
            item_ids=iid,
            timestamps=ts,
            features=feats,
            user_indptr=u_indptr,
            user_order=u_order,
            item_indptr=i_indptr,
            item_order=i_order,
        )
