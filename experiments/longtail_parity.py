"""Long-tail quality parity vs the compiled C++ reference (VERDICT #6).

Extends experiments/bpr_parity.py's head-to-head protocol (same seeded
implicit-feedback dataset through both implementations at a matched
sample budget, identical scoring) to the models it didn't cover:

  hoprec   HBPR.cpp       (field-matched 2-hop chains, -field required)
  skewopt  SkewOPT.cpp    (xi/omega/eta sign-power BPR)
  hpe      HPE.cpp        (UpdateCommunity + reverse pair)
  nemf     NEMF.cpp       (CSE, -field required)
  nerank   NERANK.cpp     (CSE ranking head, -field required)
  gcn      GCN.cpp        (neighbor-average CBOW; binary built on demand
                           -- cli/Makefile:3 omits it from the default
                           target list)

Go-only models (sne, transe/rotate/complex, metapath2vec, SASRec family)
have NO compiled reference in this image (no Go toolchain); their quality
gates live elsewhere: absolute-threshold eval-hook tests
(tests/test_eval_hooks.py, tests/test_kg_models.py) and the
reference-semantics head-to-head in experiments/sasrec_eval.py.

Run: python experiments/longtail_parity.py [model...]   (GPU)
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, "/root/repo")

from bpr_parity import (  # noqa: E402
    DIM,
    REF_DIR,
    SAMPLE_TIMES,
    TRAIN,
    evaluate,
    load_ref_embeddings,
    make_dataset,
)

FIELD = "/tmp/bpr_field.txt"


def make_field_file() -> None:
    """users -> field u, items -> field i (LoadFieldMeta format:
    'vertex meta' lines, proNet.cpp:330-408)."""
    if os.path.exists(FIELD):
        return
    seen = set()
    with open(TRAIN) as f, open(FIELD, "w") as out:
        for line in f:
            for name in line.split()[:2]:
                if name not in seen:
                    seen.add(name)
                    out.write(f"{name} {name[0]}\n")


def ensure_build_tree() -> None:
    """Bootstrap the reference build in REF_DIR (same as bench.py's
    measure_reference; /tmp is ephemeral so this must be self-contained)."""
    if os.path.exists(os.path.join(REF_DIR, "bin", "libproNet.a")):
        return
    os.makedirs(REF_DIR, exist_ok=True)
    for d in ("src", "cli", "Makefile"):
        subprocess.run(["cp", "-r", f"/root/reference/{d}", REF_DIR],
                       check=True)
    subprocess.run(["make", "-C", REF_DIR], check=True,
                   capture_output=True)


def ensure_binary(model: str) -> str:
    """gcn/textgcn/eco are not in the reference's default CLI target list
    (cli/Makefile:3); compile them the same way the Makefile would."""
    ensure_build_tree()
    path = os.path.join(REF_DIR, "cli", model)
    if not os.path.exists(path):
        subprocess.run(
            ["g++", "-std=c++11", "-fopenmp", "-Ofast",
             f"{REF_DIR}/cli/{model}.cpp", "-o", path,
             f"-I{REF_DIR}/src", f"-L{REF_DIR}/bin", "-lproNet", "-lm"],
            check=True,
        )
    return path


def ensure_fine_binary() -> str:
    """FINE/msFINE ship with NO reference CLI (absent from
    cli/Makefile:3); compile the minimal positional-arg driver
    experiments/ref_fine_main.cpp against the reference's libproNet."""
    ensure_build_tree()
    path = os.path.join(REF_DIR, "cli", "ref_fine")
    if not os.path.exists(path):
        here = os.path.dirname(os.path.abspath(__file__))
        subprocess.run(
            ["g++", "-std=c++11", "-fopenmp", "-Ofast",
             os.path.join(here, "ref_fine_main.cpp"),
             # FINE/msFINE .o's are not in libproNet.a (src/Makefile
             # archives only the CLI-built models) -- compile them in.
             f"{REF_DIR}/src/model/FINE.cpp",
             f"{REF_DIR}/src/model/msFINE.cpp",
             "-o", path,
             f"-I{REF_DIR}/src", f"-I{REF_DIR}/src/model",
             f"-L{REF_DIR}/bin", "-lproNet", "-lm"],
            check=True,
        )
    return path


def load_wide_embeddings(path):
    """Like bpr_parity.load_ref_embeddings but width-agnostic (FINE rows
    concatenate the field-0 and field-1 projections -> 2*DIM columns;
    the reference header still says DIM, FINE.cpp:17-27, so the width
    must be inferred from the rows)."""
    import numpy as np

    from bpr_parity import N_ITEMS, N_USERS

    with open(path) as f:
        f.readline()
        lines = f.readlines()
    width = len(lines[0].split()) - 1
    ue = np.zeros((N_USERS, width), dtype=np.float32)
    ie = np.zeros((N_ITEMS, width), dtype=np.float32)
    for line in lines:
        p = line.split()
        if p[0][0] == "u":
            ue[int(p[0][1:])] = np.array(p[1:], dtype=np.float32)
        else:
            ie[int(p[0][1:])] = np.array(p[1:], dtype=np.float32)
    return ue, ie


NEEDS_FIELD = {"hoprec", "nemf", "nerank", "gcn", "eco", "textgcn",
               "fine", "msfine", "textgcndev"}
EXTRA_REF_FLAGS = {
    "hoprec": ["-walk_steps", "2"],
    "nemf": ["-walk_steps", "2"],
    "nerank": ["-walk_steps", "2"],
    "textgcn": ["-walk_steps", "2"],
}


def run_reference(model: str):
    out = f"/tmp/{model}_ref_out.txt"
    if model in ("fine", "msfine"):
        cmd = [ensure_fine_binary(), model, TRAIN, FIELD, out,
               str(SAMPLE_TIMES), "2", "5", "0.025",
               str(os.cpu_count() or 1)]
        subprocess.run(cmd, check=True, stdout=subprocess.DEVNULL,
                       stderr=subprocess.DEVNULL)
        return load_wide_embeddings(out)
    cmd = [ensure_binary(model), "-train", TRAIN, "-save", out,
           "-dimensions", str(DIM), "-sample_times", str(SAMPLE_TIMES),
           "-alpha", "0.025", "-threads", str(os.cpu_count() or 1)]
    if model in NEEDS_FIELD:
        cmd += ["-field", FIELD]
    cmd += EXTRA_REF_FLAGS.get(model, [])
    subprocess.run(cmd, check=True, stdout=subprocess.DEVNULL,
                   stderr=subprocess.DEVNULL)
    return load_ref_embeddings(out)


def run_ours(model: str):
    import smore_tpu.models as M
    from smore_tpu.graph.graph import Graph

    cls = {"hoprec": M.HOPREC, "skewopt": M.SkewOPT, "hpe": M.HPE,
           "nemf": M.NEMF, "nerank": M.NERANK, "gcn": M.GCN,
           "eco": M.ECO, "textgcn": M.TEXTGCN,
           "fine": M.FINE, "msfine": M.MSFINE,
           "textgcndev": M.TEXTGCNdev}[model]
    # skewopt's reference CLI hardcodes DIRECTED loading
    # (cli/skewopt.cpp:69); the others here load undirected (their CLIs
    # pass 1 or a default-1 flag)
    g = Graph.load_edge_list(TRAIN, undirected=model != "skewopt")
    m = cls(g, seed=0)
    if model in NEEDS_FIELD:
        m.graph.load_field_meta(FIELD)
    m.init(dim=DIM)
    kw = {}
    if model in ("hoprec", "nemf", "nerank", "textgcn", "fine", "msfine"):
        kw["walk_steps"] = 2
    if model == "textgcndev":
        kw.update(num_events=1, num_words=5)  # reference CLI defaults
        # (cli/textgcndev.cpp:54)
    m.train(sample_times=1, verbose=False, **kw)  # warm/compile
    t0 = time.time()
    m.train(sample_times=SAMPLE_TIMES, verbose=False, **kw)
    dt = time.time() - t0
    print(f"{model} ours: {SAMPLE_TIMES/dt:.1f} M samples/s wall",
          flush=True)
    # read back by name -> label-order user/item matrices
    import tempfile

    from smore_tpu.io.embeddings import save_embeddings  # noqa: F401

    with tempfile.NamedTemporaryFile(suffix=".txt", delete=False) as tf:
        m.save_weights(tf.name)
        if model in ("fine", "msfine"):
            return load_wide_embeddings(tf.name)
        return load_ref_embeddings(tf.name)


def main():
    make_dataset()
    make_field_file()
    models = sys.argv[1:] or ["hoprec", "skewopt", "hpe", "nemf", "nerank",
                              "gcn"]
    rows = []
    for model in models:
        t0 = time.time()
        ue, ie = run_ours(model)
        t_ours = time.time() - t0
        auc, rec = evaluate(ue, ie)
        t0 = time.time()
        ue_r, ie_r = run_reference(model)
        t_ref = time.time() - t0
        auc_r, rec_r = evaluate(ue_r, ie_r)
        # ours wall includes a warm/compile train(sample_times=1) call;
        # the per-model "ours M/s" print from run_ours is the steady rate
        rows.append((model, auc, rec, auc_r, rec_r,
                     SAMPLE_TIMES / t_ours, SAMPLE_TIMES / t_ref))
        print(f"{model:8s} ours: AUC={auc:.4f} r@10={rec:.4f} "
              f"({SAMPLE_TIMES/t_ours:.1f} M/s wall)  "
              f"ref: AUC={auc_r:.4f} r@10={rec_r:.4f} "
              f"({SAMPLE_TIMES/t_ref:.2f} M/s all-core)", flush=True)
    print("\n| model | ours AUC | ours r@10 | ref AUC | ref r@10 "
          "| ours M/s | ref M/s | multiple |")
    print("|---|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r[0]} | {r[1]:.4f} | {r[2]:.4f} | {r[3]:.4f} "
              f"| {r[4]:.4f} | {r[5]:.1f} | {r[6]:.2f} "
              f"| {r[5]/max(r[6],1e-9):.0f}x |")


if __name__ == "__main__":
    main()
