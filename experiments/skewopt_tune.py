"""Root-cause SkewOPT's recall@10 deficit (VERDICT r3 item 6).

Round-3 record: per-sample default (batch 8192) reads recall ~0.01
under the reference across seeds (0.9134 vs 0.9229); the
shared-negs arm read 0.9106 and was demoted. BPR at the same batch
matches -- so the suspect is SkewOPT-specific interaction between the
(xi, omega, eta) odd-power gradient and batched staleness at a batch
that nearly covers the 9k-vertex table.

Arms (same bpr_parity dataset/eval, 20M samples):
  ours per-sample batch in {1024, 2048, 8192}
  ours shared-pool Ks=256 at the best batch
  reference (compiled, all cores) x N seeds

Run: python experiments/skewopt_tune.py [seeds=3]
(CPU jax works -- the model is small; re-confirm winners on the GPU.)
"""

from __future__ import annotations

import sys
import time

import numpy as np

sys.path.insert(0, "/root/repo")
sys.path.insert(0, "/root/repo/experiments")

from bpr_parity import (  # noqa: E402
    DIM,
    SAMPLE_TIMES,
    TRAIN,
    evaluate,
    load_ref_embeddings,
    make_dataset,
    run_reference,
)


def run_ours(batch, shared, seed):
    from smore_tpu.graph.graph import Graph
    from smore_tpu.models import rec

    g = Graph.load_edge_list(TRAIN, undirected=True)
    m = rec.SkewOPT(g, seed=seed)
    m.init(dim=DIM)
    t0 = time.time()
    m.train(sample_times=SAMPLE_TIMES, batch=batch,
            shared_negatives=shared, verbose=False)
    dt = time.time() - t0
    emb = np.asarray(m.state["vertex"])
    ue = np.zeros((6000, DIM), dtype=np.float32)
    ie = np.zeros((3000, DIM), dtype=np.float32)
    for name, vid in g.name2id.items():
        (ue if name[0] == "u" else ie)[int(name[1:])] = emb[vid]
    auc, r10 = evaluate(ue, ie)
    print(f"ours b={batch} Ks={shared} seed={seed}: "
          f"AUC={auc:.4f} r@10={r10:.4f} ({SAMPLE_TIMES/dt:.1f} M/s)",
          flush=True)
    return auc, r10


def main():
    make_dataset()
    n_seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 3

    for batch in (1024, 2048, 8192):
        run_ours(batch, 0, seed=0)

    refs = []
    for s in range(n_seeds):
        ue, ie = run_reference("skewopt")
        auc, r10 = evaluate(ue, ie)
        refs.append((auc, r10))
        print(f"ref seed={s}: AUC={auc:.4f} r@10={r10:.4f}", flush=True)
    ra = np.array(refs)
    print(f"ref mean AUC={ra[:,0].mean():.4f}+-{ra[:,0].std():.4f} "
          f"r@10={ra[:,1].mean():.4f}+-{ra[:,1].std():.4f}", flush=True)


if __name__ == "__main__":
    main()
