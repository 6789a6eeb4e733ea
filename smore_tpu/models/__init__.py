"""Model zoo: the union of the reference's 17 C++ models
(/root/reference/src/model/) and 21 Go models
(/root/reference/internal/models/), re-designed for accelerators.

All edge/walk models follow the reference protocol
``load_edge_list -> init(dim) -> train(...) -> save_weights(path)``.
"""

from smore_tpu.models.app import APP
from smore_tpu.models.cpr import CPR, TPR
from smore_tpu.models.cse import NEMF, NERANK
from smore_tpu.models.ctdne import CTDNE
from smore_tpu.models.deepwalk import DeepWalk
from smore_tpu.models.eco import ECO
from smore_tpu.models.fastrp import FastRP
from smore_tpu.models.fine import FINE, MSFINE
from smore_tpu.models.gcn import GCN, TEXTGCN, TEXTGCNdev
from smore_tpu.models.han import HAN
from smore_tpu.models.hoprec import HOPREC
from smore_tpu.models.hpe import HPE, PE
from smore_tpu.models.jodie import JODIE
from smore_tpu.models.kg import ComplEx, RotatE, TransE
from smore_tpu.models.line import LINE
from smore_tpu.models.metapath2vec import Metapath2Vec
from smore_tpu.models.node2vec import Node2Vec
from smore_tpu.models.rec import BPR, MF, WARP, SkewOPT
from smore_tpu.models.sne import SNE
from smore_tpu.models.walklets import Walklets

# The SASRec family needs flax; import it on first use so every other model
# (and the CLI) works where flax is not installed.
_LAZY = {"GSASRec", "RecDenoiser", "SASRec"}


def __getattr__(name):
    if name in _LAZY:
        from smore_tpu.models import sasrec

        return getattr(sasrec, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "APP", "BPR", "CPR", "CTDNE", "ComplEx", "DeepWalk", "ECO", "FINE",
    "FastRP", "GCN", "GSASRec", "HAN", "HOPREC", "HPE", "JODIE", "LINE",
    "MF", "MSFINE", "Metapath2Vec", "NEMF", "NERANK", "Node2Vec", "PE",
    "RecDenoiser", "RotatE", "SASRec", "SNE", "SkewOPT", "TEXTGCN",
    "TEXTGCNdev", "TPR", "TransE", "WARP", "Walklets",
]
