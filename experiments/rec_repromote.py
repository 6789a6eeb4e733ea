"""Re-promote SkewOPT's shared-negatives arm + close WARP's residual
(VERDICT r4 item 6).

Round-3 demoted SkewOPT's shared-pool arm on a recall deficit
(0.9106 vs 0.9225) that round 4 root-caused to UNDIRECTED loading (the
reference rec CLIs hardcode directed, cli/skewopt.cpp:69). This
retests both SkewOPT arms and WARP under DIRECTED loading at >=3
seeds per side on the bpr_parity dataset/eval.

Run: python experiments/rec_repromote.py [seeds=3]
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
    make_dataset,
    run_reference,
)


def run_ours(model, batch, shared, seed):
    from smore_tpu.graph.graph import Graph
    from smore_tpu.models import rec

    g = Graph.load_edge_list(TRAIN, undirected=False)  # directed: the
    # reference rec CLIs hardcode LoadEdgeList(file, 0)
    m = getattr(rec, model)(g, seed=seed)
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
    rate = SAMPLE_TIMES / dt
    print(f"ours {model} b={batch} Ks={shared} seed={seed}: "
          f"AUC={auc:.4f} r@10={r10:.4f} ({rate:.1f} M/s)", flush=True)
    return auc, r10, rate


def stats(tag, vals):
    a = np.asarray(vals)
    sd = a.std(ddof=1) if len(a) > 1 else 0.0
    print(f"{tag}: mean {a.mean():.4f} +- {sd:.4f} "
          f"({' '.join(f'{v:.4f}' for v in a)})", flush=True)
    return a.mean()


def main():
    make_dataset()
    n_seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 3

    arms = {
        ("SkewOPT", 8192, 0): [],
        ("SkewOPT", 8192, 256): [],
        ("WARP", 8192, -1): [],
    }
    for (model, batch, shared), out in arms.items():
        for s in range(n_seeds):
            out.append(run_ours(model, batch, shared, s))

    refs = {"skewopt": [], "warp": []}
    for cli in refs:
        for s in range(n_seeds):
            ue, ie = run_reference(cli)
            refs[cli].append(evaluate(ue, ie))
            print(f"ref {cli} seed={s}: AUC={refs[cli][-1][0]:.4f} "
                  f"r@10={refs[cli][-1][1]:.4f}", flush=True)

    print("\n=== summary (directed, mean +- sample sd) ===")
    for (model, batch, shared), out in arms.items():
        stats(f"ours {model} Ks={shared} r@10", [o[1] for o in out])
        stats(f"ours {model} Ks={shared} M/s ", [o[2] for o in out])
    for cli, out in refs.items():
        stats(f"ref {cli} r@10", [o[1] for o in out])


if __name__ == "__main__":
    main()
