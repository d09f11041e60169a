"""Decoder-only transformer stack (attention or Mamba-2 mixers; dense, routed
or no MLP), and the stacked-stage initialiser both model families share.

The JAX package's ``repro/models/transformer.py`` for the archs the port
serves so far.  Layers are grouped into ``n_stages`` identical stages of
``stage_period`` sublayers; every parameter leaf of ``params["stages"]``
carries the stage axis first (the reference's stacked ``lax.scan`` layout),
and the port walks the stages with a Python loop over views.  A MoE
sublayer (``mlp == "moe"``) runs :func:`repro_torch.models.moe.apply_moe`;
the full-sequence forward sums its aux losses (``moe_aux + moe_z``) into the
``aux`` it returns, as the reference's ``lm_backbone`` does, and the decode
step drops them.  A training forward (``train=True``) recomputes each stage
in the backward as ``cfg.remat`` says (:func:`remat_wrap`); prefill and
decode never do.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs import ATTN, DENSE, MAMBA, MOE, NONE, ArchConfig
from repro_torch.distributed.sharding import Sharder
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (DRAW_PIECE, apply_attention,
                                       apply_attention_decode, apply_mlp,
                                       apply_rmsnorm, dtype_of,
                                       init_attention, init_embedding,
                                       init_kv_cache, init_mlp, init_rmsnorm,
                                       normal)

VIS_WIDTH = 1024  # CLIP ViT-L/14 stub feature width (the reference's)


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a block schedule of anything but
    attention or Mamba-2 mixers with a dense, routed or no MLP, and for an
    encoder-decoder arch whose decoder is not attention with a dense MLP
    (the reference's ``_build_enc_dec`` builds only that).  Sinusoidal
    positions (``use_rope=False``) are admitted."""
    for mixer, mlp in cfg.block_schedule():
        if mixer not in (ATTN, MAMBA) or mlp not in (DENSE, MOE, NONE):
            raise NotImplementedError(
                f"{cfg.name}: {mixer}/{mlp} sublayers are not in the "
                "reference's block schedules")
        if cfg.enc_dec and (mixer, mlp) != (ATTN, DENSE):
            raise NotImplementedError(
                f"{cfg.name}: an encoder-decoder layer is attention with a "
                f"dense MLP, not {mixer}/{mlp}")


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_map2(fn, a, b):
    """``fn`` over the leaves of two trees of the same structure (``b``'s
    leaves may be subtrees: they are handed to ``fn`` whole)."""
    if isinstance(a, dict):
        return {k: tree_map2(fn, v, b[k]) for k, v in a.items()}
    return fn(a, b)


def tree_leaves(tree) -> List[Any]:
    """The leaves of a nested dict, in its order."""
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def stage_view(stages: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Stage ``i``'s parameters (or caches): views, no copy."""
    return tree_map(lambda a: a[i], stages)


# the parameter subtrees whose leaves carry the stage axis first
STACKED = ("stages", "enc_stages", "dec_stages")
# stacked leaf (by id) -> the tensors its stages enter a forward as, while
# a training step's ``stage_leaves`` is open
_STAGE_LEAVES: Dict[int, List[torch.Tensor]] = {}


@contextlib.contextmanager
def stage_leaves(stages_of: Dict[int, List[torch.Tensor]]):
    """Within: :func:`stage_views` hands out ``stages_of[id(leaf)]`` for
    those stacked leaves instead of their views -- a training step's
    per-stage leaves, whose gradients it collects a stage at a time."""
    _STAGE_LEAVES.update(stages_of)
    try:
        yield
    finally:
        for k in stages_of:
            _STAGE_LEAVES.pop(k, None)


def stage_views(stages: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Every stage's parameters as views, from one ``unbind`` of each
    stacked leaf (or a training step's per-stage leaves,
    :func:`stage_leaves`).  Under autograd a leaf's gradient is then the
    stack of its stages' (one allocation); indexed stage by stage, each
    stage's gradient would be written into a zero leaf of its own and added
    up (depth times the leaf's bytes, a step)."""
    per_leaf = tree_map(lambda a: _STAGE_LEAVES.get(id(a)) or a.unbind(0),
                        stages)
    n = len(tree_leaves(per_leaf)[0])
    return [tree_map(lambda u: u[i], per_leaf) for i in range(n)]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_stage(gen, cfg: ArchConfig, device,
               out: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One stage's parameters, drawn from ``gen`` (None on the meta
    device); with ``out`` (a stage's views of the stacked leaves) every
    leaf is written in place there, with the same numbers."""
    sched = cfg.block_schedule()[:cfg.stage_period]
    dt = dtype_of(cfg.param_dtype)
    res: Dict[str, Any] = {}
    for i, (mixer, mlp) in enumerate(sched):
        o = (out or {}).get(f"sub{i}", {})
        sub: Dict[str, Any] = {"norm1": init_rmsnorm(cfg.d_model, dt, device,
                                                     o.get("norm1"))}
        if mixer == ATTN:
            sub["attn"] = init_attention(gen, cfg, device, o.get("attn"))
        else:
            sub["mamba"] = ssm_mod.init_ssm(gen, cfg, device, o.get("mamba"))
        if mlp != NONE:
            sub["norm2"] = init_rmsnorm(cfg.d_model, dt, device,
                                        o.get("norm2"))
            if mlp == MOE:
                sub["moe"] = moe_mod.init_moe(gen, cfg, device, o.get("moe"))
            else:
                sub["mlp"] = init_mlp(gen, cfg, device, out=o.get("mlp"))
        res[f"sub{i}"] = sub
    return res


def init_stacked(gen, n: int, init_one, device) -> Dict[str, Any]:
    """``n`` stages of ``init_one(gen, device, out=None)`` as one tree of
    stacked leaves ``(n, ...)``: each leaf allocated once, each stage drawn
    straight into its views (nothing drawn on the meta device).  The
    numbers are those of drawing the stages one by one and stacking
    them."""
    stages = tree_map(lambda t: torch.empty((n,) + tuple(t.shape),
                                            dtype=t.dtype, device=device),
                      init_one(None, "meta", None))
    if torch.device(device or "cpu").type != "meta":
        for i in range(n):
            init_one(gen, device, stage_view(stages, i))
    return stages


def make_generator(seed: int, device) -> torch.Generator:
    """The parameter draws' generator on ``device`` (the CPU's for the
    meta device)."""
    dev = torch.device(device or "cpu")
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
    gen.manual_seed(int(seed))
    return gen


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_lm(cfg: ArchConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Full decoder-only LM parameter tree, drawn from ``seed`` on
    ``device`` (the port's own initialiser: the reference's scales and
    layout, not its ``jax.random`` draws).  Each stacked leaf is allocated
    once, ``(n_stages, ...)``, and each stage's leaves are drawn straight
    into their slices, a leaf over ``layers.DRAW_PIECE`` elements in
    float32 pieces: beside the tree, at most one piece's float32 draw is
    alive (:func:`init_footprint`).  The numbers are those of drawing the
    stages one by one and stacking them.  A vision arch also gets the
    patch projection ``mm_proj`` (the reference's ``transformer.py:65-72``;
    drawn last)."""
    check_supported(cfg)
    gen = make_generator(seed, device)
    n_stages = cfg.num_layers // cfg.stage_period
    dt = dtype_of(cfg.param_dtype)
    embed = init_embedding(gen, cfg, device)
    stages = init_stacked(gen, n_stages,
                          lambda g, d, o: init_stage(g, cfg, d, out=o),
                          device)
    p = {"embed": embed, "stages": stages,
         "final_norm": init_rmsnorm(cfg.d_model, dt, device)}
    if cfg.num_patches:
        p["mm_proj"] = {
            "w1": normal(gen, (VIS_WIDTH, cfg.d_model), 0.02, dt, device),
            "w2": normal(gen, (cfg.d_model, cfg.d_model), 0.02, dt, device)}
    return p


def init_footprint(cfg: ArchConfig) -> Tuple[int, int]:
    """(bytes of the parameter tree, bytes the initialiser holds at its
    peak): the tree plus the float32 draw of its largest leaf or piece --
    a stage's leaf, as a stacked leaf is drawn stage by stage.  The
    encoder-decoder's tree (embeddings, encoder and decoder stages, norms)
    is reckoned by its own initialiser."""
    from repro_torch.models.model import build_model

    def leaves(tree) -> List[torch.Tensor]:
        out: List[torch.Tensor] = []
        tree_map(out.append, tree)
        return out

    tree = build_model(cfg).init(0, "meta")
    weights = sum(t.numel() * t.element_size() for t in leaves(tree))
    stacked = ("stages", "enc_stages", "dec_stages")
    drawn = leaves({k: v for k, v in tree.items() if k not in stacked})
    drawn += [t[0] for k in stacked if k in tree for t in leaves(tree[k])]
    return weights, weights + 4 * min(max(t.numel() for t in drawn),
                                      DRAW_PIECE)


# ---------------------------------------------------------------------------
# full-sequence forward (prefill)
# ---------------------------------------------------------------------------
def apply_ffn(sub: Dict[str, Any], h: torch.Tensor, cfg: ArchConfig
              ) -> torch.Tensor:
    """A sublayer's MLP on its normed input: the routed experts where the
    sublayer has them (aux losses dropped), else the dense SwiGLU."""
    return apply_ffn_aux(sub, h, cfg)[0]


def apply_ffn_aux(sub: Dict[str, Any], h: torch.Tensor, cfg: ArchConfig,
                  sh: Optional[Sharder] = None
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """:func:`apply_ffn` and the routed experts' aux losses summed
    (``moe_aux + moe_z``, float32), or None for a dense MLP.  ``sh``'s mesh
    reaches the routed experts (expert parallelism where the dispatch asks
    for it)."""
    if "moe" in sub:
        y, losses = moe_mod.apply_moe(sub["moe"], h, cfg, sh)
        return y, losses["moe_aux"] + losses["moe_z"]
    return apply_mlp(sub["mlp"], h, cfg), None


# the products whose outputs the ``dots`` policy keeps (the reference's
# ``checkpoint_dots``): PyTorch's matmul and einsum reach these
_DOT_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                      torch.ops.aten.addmm.default,
                      torch.ops.aten.baddbmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_wrap(fn: Callable, cfg: ArchConfig, train: bool) -> Callable:
    """``fn`` as a training forward runs it under ``cfg.remat``: ``full``
    saves only its inputs and recomputes the rest in the backward
    (``jax.checkpoint``), ``dots`` keeps the matmul outputs and recomputes
    the rest (``checkpoint_dots``), ``none`` (or not training) runs it as it
    is."""
    if not train or cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if cfg.remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_dots))
    raise ValueError(f"remat={cfg.remat!r}: one of none, full, dots")


def _kv_to_cache(k, v, positions, cfg: ArchConfig):
    """Turn full-sequence K/V into a decode cache (window-clipped for SWA)."""
    S = k.shape[1]
    w = cfg.sliding_window
    if w is not None and S > w:
        k, v = k[:, S - w:], v[:, S - w:]
        pos = positions[S - w:][None, :].expand(k.shape[0], w)
    else:
        pos = positions[None, :].expand(k.shape[0], S)
    return {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16),
            "pos": pos.to(torch.int32)}


def _stage_forward(sp, x, cfg: ArchConfig, positions, collect_cache: bool,
                   sh: Optional[Sharder] = None):
    """One stage: (x, the sum of its MoE sublayers' aux losses, float32,
    or None without one, caches)."""
    sched = cfg.block_schedule()[:cfg.stage_period]
    caches = {}
    aux = None
    for i, (mixer, mlp) in enumerate(sched):
        sub = sp[f"sub{i}"]
        h = apply_rmsnorm(sub["norm1"], x)
        if mixer == ATTN and collect_cache:
            h, (k, v) = apply_attention(sub["attn"], h, cfg,
                                        positions=positions, return_kv=True)
            caches[f"sub{i}"] = _kv_to_cache(k, v, positions, cfg)
        elif mixer == ATTN:
            h = apply_attention(sub["attn"], h, cfg, positions=positions)
        elif collect_cache:
            h, caches[f"sub{i}"] = ssm_mod.apply_ssm(sub["mamba"], h, cfg,
                                                     return_state=True)
        else:
            h = ssm_mod.apply_ssm(sub["mamba"], h, cfg)
        x = x + h
        if mlp != NONE:
            h, a = apply_ffn_aux(sub, apply_rmsnorm(sub["norm2"], x), cfg,
                                 sh)
            x = x + h
            if a is not None:
                aux = a if aux is None else aux + a
    return x, aux, caches


def lm_backbone(params, x, cfg: ArchConfig, sh: Optional[Sharder] = None,
                positions: Optional[torch.Tensor] = None,
                collect_cache: bool = False, train: bool = False):
    """x: (B, S, d) embedded inputs -> (hidden, aux, caches|None): aux the
    float32 sum of every MoE sublayer's aux losses (0 without one), caches
    stacked with the stage axis first, like the reference's scan output.
    ``train`` recomputes each stage in the backward as ``cfg.remat``
    says.  ``sh`` (default: no mesh) reaches only the routed experts: the
    rest is computed once, over the whole batch, where the reference merely
    constrains its layout."""
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    per_stage = []
    for sp in stage_views(params["stages"]):
        if collect_cache:
            x, a, c = _stage_forward(sp, x, cfg, positions, True, sh)
            per_stage.append(c)
        else:
            x, a = remat_wrap(functools.partial(
                _stage_train, sp, cfg=cfg, positions=positions, sh=sh),
                cfg, train)(x)
        if a is not None:
            aux = aux + a
    x = apply_rmsnorm(params["final_norm"], x)
    return x, aux, (_stack(per_stage) if collect_cache else None)


def _stage_train(sp, x, *, cfg: ArchConfig, positions,
                 sh: Optional[Sharder] = None):
    """A stage without caches: (x, aux or None) -- what a checkpointed
    stage returns."""
    x, aux, _ = _stage_forward(sp, x, cfg, positions, False, sh)
    return x, aux


# ---------------------------------------------------------------------------
# decode (single token) forward
# ---------------------------------------------------------------------------
def lm_decode_backbone(params, x, caches, cache_index: int, cfg: ArchConfig,
                       sh: Optional[Sharder] = None):
    """x: (B, 1, d) -> (hidden (B, 1, d), caches); the dense ring caches
    and the SSM states are updated in place.  K/V caches split on KV heads
    (``sh``'s mesh) are read and written a shard at a time."""
    sched = cfg.block_schedule()[:cfg.stage_period]
    n_stages = cfg.num_layers // cfg.stage_period
    for s in range(n_stages):
        sp = stage_view(params["stages"], s)
        sc = stage_view(caches, s)
        for i, (mixer, mlp) in enumerate(sched):
            sub = sp[f"sub{i}"]
            hin = apply_rmsnorm(sub["norm1"], x)
            if mixer == ATTN:
                hout, _ = apply_attention_decode(sub["attn"], hin,
                                                 sc[f"sub{i}"], cfg,
                                                 cache_index, sh)
            else:
                hout, new = ssm_mod.apply_ssm_decode(sub["mamba"], hin,
                                                     sc[f"sub{i}"], cfg)
                for k, v in new.items():
                    sc[f"sub{i}"][k].copy_(v)
            x = x + hout
            if mlp != NONE:
                x = x + apply_ffn(sub, apply_rmsnorm(sub["norm2"], x), cfg)
    return apply_rmsnorm(params["final_norm"], x), caches


# the decode caches' logical axes, the reference's: a serving sharder maps
# only "kv" to the mesh, so K/V split on KV heads and the positions and the
# SSM states ("inner" is no serving rule) stay whole
ATTN_CACHE_AXES = {"k": ("layers", "batch", "kvseq", "kv", None),
                   "v": ("layers", "batch", "kvseq", "kv", None),
                   "pos": ("layers", "batch", "kvseq")}
SSM_CACHE_AXES = {"ssm": ("layers", "batch", "inner", None, None),
                  "conv": ("layers", "batch", None, "inner")}


def lm_cache_axes(cfg: ArchConfig):
    """Logical sharding axes matching :func:`init_lm_caches`' structure."""
    sched = cfg.block_schedule()[:cfg.stage_period]
    return {f"sub{i}": (ATTN_CACHE_AXES if mixer == ATTN else SSM_CACHE_AXES)
            for i, (mixer, _) in enumerate(sched)}


def init_lm_caches(cfg: ArchConfig, batch: int, seq_len: int, device=None):
    """Empty decode caches: sub{i} -> stacked (n_stages, ...) tensors."""
    n_stages = cfg.num_layers // cfg.stage_period
    sched = cfg.block_schedule()[:cfg.stage_period]
    return {f"sub{i}": tree_map(
        lambda a: a[None].repeat((n_stages,) + (1,) * a.dim()),
        init_kv_cache(cfg, batch, seq_len, device=device) if mixer == ATTN
        else ssm_mod.init_ssm_state(cfg, batch, device=device))
        for i, (mixer, _) in enumerate(sched)}
