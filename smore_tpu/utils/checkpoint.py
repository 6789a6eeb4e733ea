"""Checkpoint / resume.

The reference's only persistence is the final text dump + warm start
(SURVEY.md 5.4; proNet::LoadPreTrain, /root/reference/src/proNet.cpp:
238-286 -- covered by smore_tpu/io/embeddings.py). For production
training this module adds native checkpoints of the FULL training state
(embedding tables, optimizer state, PRNG key, progress counter), so a run
can resume mid-train after preemption.

A checkpoint is one NumPy ``.npz`` file inside the checkpoint directory.
The payload is a nest of dicts whose leaves are arrays or numbers; a
leaf's key is its path joined by ``/``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np

_FILE = "checkpoint.npz"


def _flatten(tree: dict, prefix: str, out: dict) -> dict:
    for k, v in tree.items():
        if "/" in str(k):
            raise ValueError(f"checkpoint key {k!r} contains '/'")
        if isinstance(v, dict):
            _flatten(v, f"{prefix}{k}/", out)
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _unflatten(flat) -> dict:
    tree: dict = {}
    for key in flat.files:
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = flat[key]
    return tree


def save_checkpoint(path: str, state: Dict[str, Any],
                    step: int = 0, extra: Optional[dict] = None) -> None:
    """Write a native checkpoint. ``state`` is a nest of dicts of arrays.
    The file is written beside the old one and renamed over it, so a run
    killed mid-save leaves the previous checkpoint intact."""
    payload = {"state": state, "step": np.int64(step)}
    if extra:
        payload["extra"] = extra
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, _FILE + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **_flatten(payload, "", {}))
    os.replace(tmp, os.path.join(path, _FILE))


def load_checkpoint(path: str):
    """Returns (state, step, extra)."""
    with np.load(os.path.join(path, _FILE)) as flat:
        payload = _unflatten(flat)
    return payload["state"], int(payload["step"]), payload.get("extra")


def checkpoint_exists(path: str) -> bool:
    """True when ``path`` holds a restorable checkpoint."""
    return os.path.isfile(os.path.join(path, _FILE))
