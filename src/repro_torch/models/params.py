"""Parameter trees: the logical sharding axes of every leaf, and counts.

The JAX package boxes each leaf with its logical axes
(``repro/models/params.py``: ``Boxed``, ``split``) only to drive its
sharder.  The port keeps plain tensor trees; :func:`param_axes` gives the
reference's axes tree for an arch (the same keys, and the same tuples as
``pp.split(bundle.init(key))[1]``), which the optimizer's ``state_axes``
and slice 6's mesh read.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from repro_torch.configs import ArchConfig

Axes = Tuple[Optional[str], ...]

# a leaf's axes by its key; a key whose axes depend on its block is looked
# up as (block, key) first
_AXES: Dict[Any, Axes] = {
    "embedding": ("vocab", "fsdp"), "unembed": ("fsdp", "vocab"),
    "scale": (None,), "q_norm": (None,), "k_norm": (None,),
    "wq": ("fsdp", "heads"), "wk": ("fsdp", "kv"), "wv": ("fsdp", "kv"),
    "wo": ("heads", "fsdp"),
    "w_gate": ("fsdp", "ff"), "w_up": ("fsdp", "ff"), "w_down": ("ff", "fsdp"),
    ("moe", "router"): (None, None),
    ("moe", "w_gate"): ("expert", "fsdp", None),
    ("moe", "w_up"): ("expert", "fsdp", None),
    ("moe", "w_down"): ("expert", None, "fsdp"),
    "in_proj": ("fsdp", "inner"), "conv_w": (None, "inner"),
    "conv_b": ("inner",), "a_log": ("inner",), "dt_bias": ("inner",),
    "d_skip": ("inner",), "norm_scale": ("inner",),
    "out_proj": ("inner", "fsdp"),
    ("mm_proj", "w1"): (None, "fsdp"), ("mm_proj", "w2"): ("fsdp", None),
}


def param_axes(cfg: ArchConfig) -> Dict[str, Any]:
    """The reference's logical-axes tree of ``cfg``'s parameters: a tuple
    of axis names (or None) per leaf, ``"layers"`` first under the stacked
    stages."""
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import STACKED

    def walk(tree, parent: Optional[str], stacked: bool):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, k, stacked or k in STACKED)
                continue
            axes = _AXES[(parent, k)] if (parent, k) in _AXES else _AXES[k]
            if len(axes) + stacked != v.dim():
                raise ValueError(f"{k}: axes {axes} do not fit shape "
                                 f"{tuple(v.shape)}")
            out[k] = (("layers",) if stacked else ()) + axes
        return out

    return walk(build_model(cfg).init(0, "meta"), None, False)


def count_params(tree) -> int:
    """Elements of every tensor leaf of a nested dict."""
    from repro_torch.models.transformer import tree_leaves
    return sum(int(t.numel()) for t in tree_leaves(tree))
