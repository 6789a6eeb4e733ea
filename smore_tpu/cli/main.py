"""``smore`` CLI: one entry point, one subcommand per reference binary.

Mirrors the flag conventions of the reference CLIs (single-dash long
flags, e.g. ``-train net.txt -save rep.txt -dimensions 64``; C++ side
cli/*.cpp, Go side cmd/*/main.go). Run with no arguments for the list;
``smore <model>`` with no flags prints that model's options.

Usage examples (matching /root/reference/README.md:83-106):
    python -m smore_tpu line -train net.txt -save rep.txt -order 2
    python -m smore_tpu deepwalk -train net.txt -save rep.txt
    python -m smore_tpu hoprec -train net.txt -field meta.txt -save rep.txt
    python -m smore_tpu transe -train triples.txt -save_entity e.txt \
        -save_relation r.txt
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}


def _cmd(name):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def _base_parser(name: str, walk: bool = False) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=f"smore {name}", allow_abbrev=False, prefix_chars="-"
    )
    p.add_argument("-train", required=True, help="input edge list")
    p.add_argument("-save", required=True, help="output embedding file")
    p.add_argument("-dimensions", type=int, default=64)
    p.add_argument("-undirected", type=int, default=1)
    p.add_argument("-alpha", type=float, default=0.025)
    p.add_argument("-threads", type=int, default=1,
                   help="accepted for compatibility; the device path ignores it")
    p.add_argument("-batch", type=int, default=None,
                   help="batch size override")
    p.add_argument("-checkpoint", default=None,
                   help="checkpoint dir: save the full training "
                        "state periodically and resume from it if present")
    p.add_argument("-checkpoint_every", type=int, default=1,
                   help="checkpoint interval: jit calls for TrainDriver "
                        "models; epochs for han/kg/seq/jodie")
    p.add_argument("-no_resume", action="store_true",
                   help="with -checkpoint: overwrite instead of resuming")
    if walk:
        p.add_argument("-walk_times", type=int, default=10)
        p.add_argument("-walk_steps", type=int, default=40)
        p.add_argument("-window_size", type=int, default=5)
        p.add_argument("-negative_samples", type=int, default=5)
    else:
        p.add_argument("-sample_times", type=float, default=10)
        p.add_argument("-negative_samples", type=int, default=5)
    return p


def _bt(args, default):
    return {"batch" + ("_walks" if "walk" in default else ""): args.batch} \
        if args.batch else {}


def _set_ckpt(m, a) -> None:
    """Apply -checkpoint/-checkpoint_every/-no_resume to a model."""
    if getattr(a, "checkpoint", None):
        m.set_checkpoint(a.checkpoint, every=a.checkpoint_every,
                         resume=not a.no_resume)


def _warm_start(m, a) -> None:
    """Apply -load_v/-load_c pretrain warm starts after init (reference
    Init(dim, load_vertex, load_context), e.g. src/model/DeepWalk.cpp:
    60-94; flags cli/deepwalk.cpp:61-62, cli/hpe.cpp)."""
    if getattr(a, "load_v", None):
        m.load_pretrain(a.load_v, table="vertex")
    if getattr(a, "load_c", None) and "context" in m.state:
        m.load_pretrain(a.load_c, table="context")


# --------------------------- edge-pair models --------------------------- #
@_cmd("line")
def _line(argv):
    p = _base_parser("line")
    p.add_argument("-order", type=int, default=2)
    p.add_argument("-group", type=int, default=0,
                   help="contexts drawn per source per step (0 = auto: "
                        "1 on the banded large-graph path, 8 elsewhere; "
                        "1 = strict per-sample sources; >1 is walk-style "
                        "reuse, AUC-parity verified)")
    p.add_argument("-load_v", default=None, help="pretrained vertex warm start")
    p.add_argument("-load_c", default=None, help="pretrained context warm start")
    a = p.parse_args(argv)
    from smore_tpu.models import LINE

    m = LINE.load_edge_list(a.train, undirected=bool(a.undirected))
    m.init(dim=a.dimensions, order=a.order)
    _warm_start(m, a)
    _set_ckpt(m, a)
    kw = {"batch": a.batch} if a.batch else {}
    m.train(sample_times=a.sample_times, negative_samples=a.negative_samples,
            alpha=a.alpha, group=a.group, **kw)
    m.save_weights(a.save)


@_cmd("pe")
def _pe(argv):
    p = _base_parser("pe")
    p.add_argument("-walk_meta", default=None,
                   help="per-vertex walk-steps file (reference "
                        "PE::LoadWalkMeta, ProximityEmbedding.cpp:6-7)")
    a = p.parse_args(argv)
    from smore_tpu.models import PE

    m = PE.load_edge_list(a.train, undirected=bool(a.undirected))
    if a.walk_meta:
        m.load_walk_meta(a.walk_meta)
    m.init(dim=a.dimensions)
    _set_ckpt(m, a)
    m.train(sample_times=a.sample_times, negative_samples=a.negative_samples,
            alpha=a.alpha)
    m.save_weights(a.save)


@_cmd("hpe")
def _hpe(argv):
    p = _base_parser("hpe")
    p.add_argument("-walk_steps", type=int, default=5)
    p.add_argument("-reg", type=float, default=0.01)
    p.add_argument("-load_v", default=None, help="pretrained vertex warm start")
    p.add_argument("-load_c", default=None, help="pretrained context warm start")
    a = p.parse_args(argv)
    from smore_tpu.models import HPE

    m = HPE.load_edge_list(a.train, undirected=bool(a.undirected))
    m.init(dim=a.dimensions)
    _warm_start(m, a)
    _set_ckpt(m, a)
    m.train(sample_times=a.sample_times, walk_steps=a.walk_steps,
            negative_samples=a.negative_samples, reg=a.reg, alpha=a.alpha)
    m.save_weights(a.save)


def _simple_rec(cls_name, extra=None):
    def run(argv):
        p = _base_parser(cls_name)
        # the reference's mf/bpr/warp/skewopt CLIs HARDCODE directed
        # loading (LoadEdgeList(file, 0) -- cli/{mf,bpr,warp}.cpp:57-63,
        # cli/skewopt.cpp:69; there is no -undirected flag there). An
        # undirected default silently doubles the edges and mixes
        # item->user pairs into the ranking law -- measured recall@10
        # cost 0.88 vs 0.92 at a 2M budget (experiments/skewopt_tune.py,
        # round 4). Default 0 for fidelity; -undirected 1 still works.
        p.set_defaults(undirected=0)
        for flag, typ, dv in (extra or []):
            p.add_argument(flag, type=typ, default=dv)
        a = p.parse_args(argv)
        import smore_tpu.models as M

        cls = getattr(M, cls_name.upper() if cls_name != "skewopt" else "SkewOPT")
        ctor_kw = {}
        if cls_name == "skewopt":
            ctor_kw = {"xi": a.xi, "omega": a.omega, "eta": a.eta}
        elif cls_name == "mf":
            ctor_kw = {"reg": a.reg,
                       "negative_samples": a.negative_samples}
        m = cls.load_edge_list(a.train, undirected=bool(a.undirected),
                               **ctor_kw)
        m.init(dim=a.dimensions)
        _set_ckpt(m, a)
        kw = {"batch": a.batch} if a.batch else {}
        m.train(sample_times=a.sample_times, alpha=a.alpha, **kw)
        m.save_weights(a.save)

    return run


_REGISTRY["mf"] = _simple_rec("mf", [("-reg", float, 0.01)])
_REGISTRY["bpr"] = _simple_rec("bpr", [("-reg", float, 0.01)])
_REGISTRY["warp"] = _simple_rec("warp", [("-reg", float, 0.01)])
_REGISTRY["skewopt"] = _simple_rec(
    "skewopt",
    [("-reg", float, 0.01), ("-xi", float, 10.0), ("-omega", float, 3.0),
     ("-eta", int, 3)],
)


@_cmd("hoprec")
def _hoprec(argv):
    p = _base_parser("hoprec")
    p.add_argument("-field", required=True)
    p.add_argument("-walk_steps", type=int, default=5)
    p.add_argument("-margin", type=float, default=1.0)
    a = p.parse_args(argv)
    from smore_tpu.models import HOPREC

    m = HOPREC.load_edge_list(a.train, undirected=bool(a.undirected))
    m.graph.load_field_meta(a.field)
    m.init(dim=a.dimensions)
    _set_ckpt(m, a)
    m.train(sample_times=a.sample_times, walk_steps=a.walk_steps,
            margin=a.margin, alpha=a.alpha)
    m.save_weights(a.save)


# ---------------------------- walk models ------------------------------ #
@_cmd("deepwalk")
def _deepwalk(argv):
    p = _base_parser("deepwalk", walk=True)
    p.add_argument("-load_v", default=None, help="pretrained vertex warm start")
    p.add_argument("-load_c", default=None, help="pretrained context warm start")
    a = p.parse_args(argv)
    from smore_tpu.models import DeepWalk

    m = DeepWalk.load_edge_list(a.train, undirected=bool(a.undirected))
    m.init(dim=a.dimensions)
    _warm_start(m, a)
    _set_ckpt(m, a)
    m.train(walk_times=a.walk_times, walk_steps=a.walk_steps,
            window_size=a.window_size,
            negative_samples=a.negative_samples, alpha=a.alpha)
    m.save_weights(a.save)


@_cmd("walklets")
def _walklets(argv):
    p = _base_parser("walklets", walk=True)
    p.add_argument("-window_min", type=int, default=2)
    p.add_argument("-window_max", type=int, default=5)
    a = p.parse_args(argv)
    from smore_tpu.models import Walklets

    m = Walklets.load_edge_list(a.train, undirected=bool(a.undirected))
    m.init(dim=a.dimensions)
    _set_ckpt(m, a)
    m.train(walk_times=a.walk_times, walk_steps=a.walk_steps,
            window_min=a.window_min, window_max=a.window_max,
            negative_samples=a.negative_samples, alpha=a.alpha)
    m.save_weights(a.save)


@_cmd("node2vec")
def _node2vec(argv):
    p = _base_parser("node2vec", walk=True)
    p.add_argument("-p", type=float, default=1.0)
    p.add_argument("-q", type=float, default=1.0)
    a = p.parse_args(argv)
    from smore_tpu.models import Node2Vec

    m = Node2Vec.load_edge_list(a.train, undirected=bool(a.undirected))
    m.init(dim=a.dimensions)
    _set_ckpt(m, a)
    m.train(walk_times=a.walk_times, walk_steps=a.walk_steps,
            window_size=a.window_size, p=a.p, q=a.q,
            negative_samples=a.negative_samples, alpha=a.alpha)
    m.save_weights(a.save)


@_cmd("app")
def _app(argv):
    p = _base_parser("app")
    p.add_argument("-walk_times", type=int, default=100)
    p.add_argument("-jump", type=float, default=0.15)
    a = p.parse_args(argv)
    from smore_tpu.models import APP

    m = APP.load_edge_list(a.train, undirected=bool(a.undirected))
    m.init(dim=a.dimensions)
    _set_ckpt(m, a)
    m.train(walk_times=a.walk_times, sample_times=int(a.sample_times),
            jump=a.jump, negative_samples=a.negative_samples, alpha=a.alpha)
    m.save_weights(a.save)


@_cmd("fastrp")
def _fastrp(argv):
    p = _base_parser("fastrp")
    p.add_argument("-iterations", type=int, default=3)
    p.add_argument("-normalization", type=float, default=0.0)
    a = p.parse_args(argv)
    from smore_tpu.models import FastRP

    m = FastRP.load_edge_list(
        a.train, undirected=bool(a.undirected), iterations=a.iterations,
        normalization_strength=a.normalization,
    )
    m.generate(dim=a.dimensions)
    m.save_weights(a.save)


# ---------------------------- field models ----------------------------- #
def _field_model(name, cls_name, needs_field=True):
    def run(argv):
        p = _base_parser(name)
        p.add_argument("-field", required=needs_field)
        p.add_argument("-walk_steps", type=int, default=5)
        p.add_argument("-reg", type=float, default=0.01)
        a = p.parse_args(argv)
        import smore_tpu.models as M

        cls = getattr(M, cls_name)
        m = cls.load_edge_list(a.train, undirected=bool(a.undirected))
        if a.field:
            m.graph.load_field_meta(a.field)
        m.init(dim=a.dimensions)
        _set_ckpt(m, a)
        kw = {}
        if cls_name in ("GCN", "TEXTGCN"):
            kw["reg"] = a.reg
        m.train(sample_times=a.sample_times, walk_steps=a.walk_steps,
                negative_samples=a.negative_samples, alpha=a.alpha, **kw)
        m.save_weights(a.save)

    return run


_REGISTRY["gcn"] = _field_model("gcn", "GCN")
_REGISTRY["textgcn"] = _field_model("textgcn", "TEXTGCN")


@_cmd("textgcndev")
def _textgcndev(argv):
    p = _base_parser("textgcndev")
    p.add_argument("-field", required=True)
    p.add_argument("-num_events", type=int, default=5)
    p.add_argument("-num_words", type=int, default=5)
    p.add_argument("-reg", type=float, default=0.01)
    a = p.parse_args(argv)
    from smore_tpu.models import TEXTGCNdev

    m = TEXTGCNdev.load_edge_list(a.train, undirected=bool(a.undirected))
    m.graph.load_field_meta(a.field)
    m.init(dim=a.dimensions)
    m.train(sample_times=a.sample_times, num_events=a.num_events,
            num_words=a.num_words, negative_samples=a.negative_samples,
            reg=a.reg, alpha=a.alpha)
    m.save_weights(a.save)
_REGISTRY["fine"] = _field_model("fine", "FINE")
_REGISTRY["msfine"] = _field_model("msfine", "MSFINE")
_REGISTRY["nemf"] = _field_model("nemf", "NEMF")
_REGISTRY["nerank"] = _field_model("nerank", "NERANK")


@_cmd("eco")
def _eco(argv):
    p = _base_parser("eco")
    p.add_argument("-field", default=None)
    p.add_argument("-reg", type=float, default=0.01)
    p.add_argument("-head", default="dchoice",
                   choices=("dchoice", "hop_choice", "recall_rank"),
                   help="dchoice = the reference's live branch "
                        "(ECO.cpp:107); the others are its commented-out "
                        "alternates (ECO.cpp:103-110), selectable here")
    a = p.parse_args(argv)
    from smore_tpu.models import ECO

    m = ECO.load_edge_list(a.train, undirected=bool(a.undirected),
                           head=a.head)
    if a.field:
        m.graph.load_field_meta(a.field)
    m.init(dim=a.dimensions)
    _set_ckpt(m, a)
    m.train(sample_times=a.sample_times, reg=a.reg,
            negative_samples=a.negative_samples, alpha=a.alpha)
    m.save_weights(a.save)


# ------------------------- typed-graph models -------------------------- #
@_cmd("metapath2vec")
def _m2v(argv):
    p = _base_parser("metapath2vec", walk=True)
    p.add_argument("-meta_path", action="append", required=True,
                   help="comma-separated type sequence; repeatable")
    a = p.parse_args(argv)
    from smore_tpu.models import Metapath2Vec

    m = Metapath2Vec.load_edge_list(a.train, undirected=bool(a.undirected))
    for mp in a.meta_path:
        m.add_meta_path(mp.split(","))
    m.init(dim=a.dimensions)
    m.train(walk_times=a.walk_times, walk_steps=a.walk_steps,
            window_size=a.window_size,
            negative_samples=a.negative_samples, alpha=a.alpha,
            checkpoint=a.checkpoint, checkpoint_every=a.checkpoint_every,
            resume=not a.no_resume)
    m.save_weights(a.save)


@_cmd("han")
def _han(argv):
    p = _base_parser("han", walk=True)
    p.add_argument("-meta_path", action="append", required=True)
    p.add_argument("-epochs", type=int, default=5)
    a = p.parse_args(argv)
    from smore_tpu.models import HAN

    m = HAN.load_edge_list(a.train, undirected=bool(a.undirected))
    for mp in a.meta_path:
        m.add_meta_path(mp.split(","))
    m.init(dim=a.dimensions, learning_rate=a.alpha)
    m.train(walk_times=a.walk_times, walk_steps=a.walk_steps,
            epochs=a.epochs, checkpoint=a.checkpoint,
            checkpoint_every=a.checkpoint_every, resume=not a.no_resume)
    m.save_weights(a.save)


@_cmd("ctdne")
def _ctdne(argv):
    p = _base_parser("ctdne", walk=True)
    p.add_argument("-time_window", type=float, default=None)
    a = p.parse_args(argv)
    from smore_tpu.models import CTDNE

    m = CTDNE.load_edge_list(a.train, time_window=a.time_window)
    m.init(dim=a.dimensions)
    m.train(walk_times=a.walk_times, walk_steps=a.walk_steps,
            window_size=a.window_size,
            negative_samples=a.negative_samples, alpha=a.alpha,
            checkpoint=a.checkpoint, checkpoint_every=a.checkpoint_every,
            resume=not a.no_resume)
    m.save_weights(a.save)


@_cmd("sne")
def _sne(argv):
    p = _base_parser("sne")
    p.add_argument("-epochs", type=int, default=10)
    p.add_argument("-beta", type=float, default=1.0)
    p.add_argument("-samples_per_edge", type=int, default=5,
                   help="samples per edge per epoch (cmd/sne/main.go:21)")
    a = p.parse_args(argv)
    from smore_tpu.models import SNE

    m = SNE.load_edge_list(a.train, undirected=bool(a.undirected),
                           beta=a.beta,
                           negative_samples=a.negative_samples)
    m.init(dim=a.dimensions)
    m.train(epochs=a.epochs, samples_per_edge=a.samples_per_edge,
            alpha=a.alpha, checkpoint=a.checkpoint,
            checkpoint_every=a.checkpoint_every, resume=not a.no_resume)
    m.save_weights(a.save)


def _kg_model(name, cls_name, extra=None):
    def run(argv):
        p = argparse.ArgumentParser(prog=f"smore {name}", allow_abbrev=False)
        p.add_argument("-train", required=True)
        p.add_argument("-save_entity", required=True)
        p.add_argument("-save_relation", required=True)
        p.add_argument("-dimensions", type=int, default=64)
        p.add_argument("-epochs", type=int, default=100)
        p.add_argument("-batch_size", type=int, default=1024)
        p.add_argument("-alpha", type=float, default=0.01)
        p.add_argument("-margin", type=float, default=1.0)
        p.add_argument("-threads", type=int, default=1,
                       help="accepted for compatibility; the device path ignores it")
        p.add_argument("-checkpoint", default=None,
                       help="checkpoint dir: save tables + PRNG "
                            "chain every -checkpoint_every epochs and "
                            "resume from it if present")
        p.add_argument("-checkpoint_every", type=int, default=1)
        p.add_argument("-no_resume", action="store_true")
        for flag, typ, dv in (extra or []):
            p.add_argument(flag, type=typ, default=dv)
        a = p.parse_args(argv)
        import smore_tpu.models as M

        cls = getattr(M, cls_name)
        kw = {"margin": a.margin}
        if cls_name == "TransE":
            kw["norm"] = a.norm
        if cls_name == "RotatE":
            kw["adversarial_temp"] = a.adversarial_temp
        m = cls.load_triples(a.train, **kw)
        m.init(dim=a.dimensions)
        m.train(epochs=a.epochs, batch=a.batch_size, alpha=a.alpha,
                checkpoint=a.checkpoint,
                checkpoint_every=a.checkpoint_every,
                resume=not a.no_resume)
        m.save_embeddings(a.save_entity, a.save_relation)

    return run


_REGISTRY["transe"] = _kg_model("transe", "TransE", [("-norm", int, 2)])
_REGISTRY["rotate"] = _kg_model(
    "rotate", "RotatE", [("-adversarial_temp", float, 1.0)]
)
_REGISTRY["complex"] = _kg_model("complex", "ComplEx")


@_cmd("jodie")
def _jodie(argv):
    p = argparse.ArgumentParser(prog="smore jodie", allow_abbrev=False)
    p.add_argument("-train", required=True)
    p.add_argument("-save_user", required=True)
    p.add_argument("-save_item", required=True)
    p.add_argument("-dimensions", type=int, default=64)
    p.add_argument("-epochs", type=int, default=5)
    p.add_argument("-alpha", type=float, default=0.01)
    p.add_argument("-batch-size", type=int, default=128, dest="batch_size",
                   help="accepted for parity; the Go reference prints it "
                        "and trains chronologically (jodie.go:214-224)")
    p.add_argument("-checkpoint", default=None)
    p.add_argument("-checkpoint_every", type=int, default=1)
    p.add_argument("-no_resume", action="store_true")
    a = p.parse_args(argv)
    from smore_tpu.models import JODIE

    m = JODIE.load_interactions(a.train)
    m.init(dim=a.dimensions)
    m.train(epochs=a.epochs, learning_rate=a.alpha,
            checkpoint=a.checkpoint, checkpoint_every=a.checkpoint_every,
            resume=not a.no_resume)
    print(f"\tpairwise accuracy: {m.evaluate_predictions():.4f}")
    m.save_weights(a.save_user, a.save_item)


def _seq_model(name, cls_name, extra=None):
    def run(argv):
        p = argparse.ArgumentParser(prog=f"smore {name}", allow_abbrev=False)
        p.add_argument("-train", required=True)
        p.add_argument("-save", required=True)
        p.add_argument("-dimensions", type=int, default=64)
        p.add_argument("-max_seq_len", type=int, default=50)
        p.add_argument("-num_blocks", type=int, default=2)
        p.add_argument("-num_heads", type=int, default=1)
        p.add_argument("-dropout", type=float, default=0.2)
        p.add_argument("-epochs", type=int, default=10)
        p.add_argument("-batch_size", type=int, default=128)
        p.add_argument("-alpha", type=float, default=0.001)
        p.add_argument("-negative_samples", type=int, default=1,
                       help="negatives per position, summed "
                            "(sasrec.go:576-593)")
        p.add_argument("-threads", type=int, default=1,
                       help="accepted for compatibility; the device path ignores it")
        p.add_argument("-eval_holdout", type=int, default=0,
                       help="1 = withhold each user's last item, train on "
                            "the prefix, and print recall@10 / NDCG@10 "
                            "(leave-one-out next-item ranking)")
        p.add_argument("-forward_only", type=int, default=0,
                       help="1 = train ONLY the item embeddings (the "
                            "reference's semantics, sasrec.go:553-593); "
                            "0 = full autodiff (default)")
        p.add_argument("-checkpoint", default=None,
                       help="checkpoint dir: save params + adam "
                            "state + PRNG chain every -checkpoint_every "
                            "epochs and resume from it if present")
        p.add_argument("-checkpoint_every", type=int, default=1)
        p.add_argument("-no_resume", action="store_true")
        for flag, typ, dv in (extra or []):
            p.add_argument(flag, type=typ, default=dv)
        a = p.parse_args(argv)
        import smore_tpu.models as M

        cls = getattr(M, cls_name)
        kw = {"negative_samples": a.negative_samples}
        if cls_name == "GSASRec":
            kw["beta"] = a.beta
        if cls_name == "RecDenoiser":
            kw["lambda_sparsity"] = a.lambda_sparsity
            kw["sparsity"] = a.sparsity
        m = cls.load_edge_list(a.train, **kw)
        m.init(dim=a.dimensions, max_seq_len=a.max_seq_len,
               num_blocks=a.num_blocks, num_heads=a.num_heads,
               dropout=a.dropout)
        m.train(epochs=a.epochs, batch_size=a.batch_size, alpha=a.alpha,
                holdout=bool(a.eval_holdout),
                forward_only=bool(a.forward_only),
                checkpoint=a.checkpoint, checkpoint_every=a.checkpoint_every,
                resume=not a.no_resume)
        if a.eval_holdout:
            r = m.evaluate_ranking(ks=(10,))
            print(f"\trecall@10: {r['recall@10']:.4f}  "
                  f"NDCG@10: {r['ndcg@10']:.4f}")
        m.save_weights(a.save)

    return run


_REGISTRY["sasrec"] = _seq_model("sasrec", "SASRec")
_REGISTRY["gsasrec"] = _seq_model(
    "gsasrec", "GSASRec", [("-beta", float, 0.5)]
)
_REGISTRY["recdenoiser"] = _seq_model(
    "recdenoiser", "RecDenoiser",
    [("-lambda_sparsity", float, 0.01), ("-sparsity", float, 0.3)],
)


@_cmd("cpr")
def _cpr(argv):
    p = argparse.ArgumentParser(prog="smore cpr", allow_abbrev=False)
    p.add_argument("-train_target", required=True)
    p.add_argument("-train_source", required=True)
    p.add_argument("-save_user", required=True)
    p.add_argument("-save_target", required=True)
    p.add_argument("-save_source", required=True)
    p.add_argument("-dimensions", type=int, default=64)
    p.add_argument("-update_times", type=float, default=10)
    p.add_argument("-alpha", type=float, default=0.025)
    p.add_argument("-margin", type=float, default=1.0)
    p.add_argument("-user_reg", type=float, default=0.01)
    p.add_argument("-item_reg", type=float, default=0.01)
    p.add_argument("-negative_samples", type=int, default=5,
                   help="accepted for parity; print-only in the Go "
                        "reference (cpr.go:181)")
    p.add_argument("-undirected", type=int, default=1)
    p.add_argument("-threads", type=int, default=1,
                   help="accepted for compatibility; the device path ignores it")
    p.add_argument("-checkpoint", default=None)
    p.add_argument("-checkpoint_every", type=int, default=1)
    p.add_argument("-no_resume", action="store_true")
    a = p.parse_args(argv)
    from smore_tpu.models import CPR

    m = CPR.load_domains(a.train_target, a.train_source, margin=a.margin,
                         undirected=bool(a.undirected),
                         user_reg=a.user_reg, item_reg=a.item_reg)
    m.init(dim=a.dimensions)
    m.train(update_times=a.update_times, alpha=a.alpha,
            checkpoint=a.checkpoint, checkpoint_every=a.checkpoint_every,
            resume=not a.no_resume)
    m.save_weights(a.save_user, a.save_target, a.save_source)


@_cmd("tpr")
def _tpr(argv):
    p = argparse.ArgumentParser(prog="smore tpr", allow_abbrev=False)
    p.add_argument("-train_ui", required=True)
    p.add_argument("-train_iw", required=True)
    p.add_argument("-save_user", required=True)
    p.add_argument("-save_item", required=True)
    p.add_argument("-save_word", required=True)
    p.add_argument("-dimensions", type=int, default=64)
    p.add_argument("-sample_times", type=float, default=10)
    p.add_argument("-alpha", type=float, default=0.025)
    p.add_argument("-text_weight", type=float, default=0.3)
    p.add_argument("-lambda", type=float, default=0.025, dest="lam",
                   help="L2 regularization (cmd/tpr/main.go:21)")
    p.add_argument("-undirected", type=int, default=1)
    p.add_argument("-threads", type=int, default=1,
                   help="accepted for compatibility; the device path ignores it")
    p.add_argument("-checkpoint", default=None)
    p.add_argument("-checkpoint_every", type=int, default=1)
    p.add_argument("-no_resume", action="store_true")
    a = p.parse_args(argv)
    from smore_tpu.models import TPR

    m = TPR.load_graphs(a.train_ui, a.train_iw, text_weight=a.text_weight,
                        undirected=bool(a.undirected), lam=a.lam)
    m.init(dim=a.dimensions)
    m.train(sample_times=a.sample_times, alpha=a.alpha,
            checkpoint=a.checkpoint, checkpoint_every=a.checkpoint_every,
            resume=not a.no_resume)
    m.save_weights(a.save_user, a.save_item, a.save_word)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help", "help"):
        names = ", ".join(sorted(_REGISTRY))
        print("smore-tpu: SMORe in JAX. Subcommands:\n  " + names)
        print("\nRun `smore <model>` with no flags for that model's options.")
        return 0
    cmd = argv[0]
    if cmd not in _REGISTRY:
        print(f"unknown model {cmd!r}; run `smore help` for the list")
        return 1
    _REGISTRY[cmd](argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
