"""Embedding text IO in the reference interchange format.

Format (reference SaveWeights, e.g. /root/reference/src/model/LINE.cpp:13-47):

    N dim
    name v1 v2 ... vdim
    ...

Values are written with 6 significant digits (C++ default ostream
precision). ``load_embeddings`` is the warm-start path (reference
proNet::LoadPreTrain, /root/reference/src/proNet.cpp:238-286): rows are
matched by name and overwrite the given table when dims match.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def save_embeddings(path: str, names: Sequence[str], table: np.ndarray) -> None:
    table = np.asarray(table)
    # rows past the names are padding (a row-sharded table is padded to a
    # multiple of the device count, models/base.py TrainDriver.train)
    table = table[: len(names)]
    n, dim = table.shape
    assert n == len(names), f"{n} rows vs {len(names)} names"
    from smore_tpu.native import fastgraph

    # Native writer only for float32: it formats float32 values, so routing
    # float64 tables through it would silently change the saved digits vs
    # the full-precision Python fallback below.
    if fastgraph.available() and table.dtype == np.float32:
        fastgraph.save_embeddings(path, names, table)
        return
    with open(path, "w") as f:
        f.write(f"{n} {dim}\n")
        for name, row in zip(names, table):
            f.write(name)
            f.write(" ")
            f.write(" ".join(f"{v:.6g}" for v in row))
            f.write("\n")


def load_embeddings(path: str) -> Dict[str, np.ndarray]:
    """Parse a saved embedding file into name -> vector."""
    out: Dict[str, np.ndarray] = {}
    with open(path, "r") as f:
        header = f.readline().split()
        dim = int(header[1]) if len(header) >= 2 else -1
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            name = parts[0]
            vec = np.array([float(x) for x in parts[1:]], dtype=np.float32)
            if dim > 0 and len(vec) != dim:
                continue
            out[name] = vec
    return out


def warm_start(
    table: np.ndarray, names: Sequence[str], pretrain_path: str
) -> np.ndarray:
    """Overwrite rows of ``table`` by name from a saved model file
    (dims must match; mismatches are skipped, like LoadPreTrain)."""
    from smore_tpu.native import fastgraph

    if fastgraph.available() and np.asarray(table).dtype == np.float32:
        return fastgraph.warm_start(table, names, pretrain_path)
    loaded = load_embeddings(pretrain_path)
    table = np.array(table, copy=True)
    dim = table.shape[1]
    for i, name in enumerate(names):
        vec = loaded.get(name)
        if vec is not None and len(vec) == dim:
            table[i] = vec
    return table
