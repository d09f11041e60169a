"""Model factory: ArchConfig -> init / prefill / decode callables.

The decoder-only half of the JAX package's ``repro/models/model.py``
(attention and Mamba-2 mixers, dense and routed MLPs, and a vision arch's
patch embeddings merged into the leading positions)::

    bundle = build_model(cfg)
    params = bundle.init(seed, device)             # tree of tensors
    logits, caches, idx = bundle.prefill_fn(params, batch)
    logits, caches = bundle.decode_fn(params, tokens, caches, idx)

There is no ``loss_fn`` yet (training is slice 5 of the port), and the
encoder-decoder bundle comes with slice 4c.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs import ArchConfig
from repro_torch.models.layers import (apply_embedding, apply_unembed,
                                       dtype_of, unembed_operand)
from repro_torch.models.transformer import (VIS_WIDTH, check_supported,
                                            init_lm, init_lm_caches,
                                            lm_backbone, lm_decode_backbone,
                                            tree_map)

# leaves the reference casts to the compute dtype at every use
# (``p[...].astype(cdt)``; a MoE sublayer's experts w_gate/w_up/w_down too,
# and a vision arch's patch projection w1/w2);
# norm scales, the SSM's a_log, dt_bias, d_skip and norm_scale and the MoE
# router (float32, read as float32) stay as they are, as the reference
# reads them
COMPUTE_LEAVES = ("embedding", "wq", "wk", "wv", "wo", "w_gate", "w_up",
                  "w_down", "in_proj", "conv_w", "conv_b", "out_proj", "w1",
                  "w2")


@dataclasses.dataclass
class ModelBundle:
    cfg: ArchConfig
    init: Callable[..., Any]
    prefill_fn: Callable[..., Tuple[torch.Tensor, Any, int]]
    decode_fn: Callable[..., Tuple[torch.Tensor, Any]]
    init_caches: Callable[..., Any]


def prepare_params(cfg: ArchConfig, params: Dict[str, Any]) -> Dict[str, Any]:
    """The parameter tree the engine computes with: every leaf the
    reference casts at each use is cast to the compute dtype once here, and
    the unembedding is stored as the float32 operand of its
    ``preferred_element_type=f32`` product (``unembed_f32``, contiguous),
    for a tied arch too (the embedding's transpose).  The numbers are those
    of casting at every use; what goes is the cast traffic (at full width,
    float32 parameters are 7.6 GB read per decode step) and, for a tied
    arch, a fresh float32 copy of the embedding per call (0.52 GB for
    mamba2)."""
    cdt = dtype_of(cfg.compute_dtype)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in COMPUTE_LEAVES:
                out[k] = v.to(cdt)
            elif k == "unembed":
                out["unembed_f32"] = unembed_operand({"unembed": v}, cfg)
            else:
                out[k] = v
        return out

    out = walk(params)
    if cfg.tie_embeddings:
        out["embed"]["unembed_f32"] = unembed_operand(params["embed"], cfg)
    return out


def _merge_patches(params, x: torch.Tensor, patch_embeds: torch.Tensor,
                   cfg: ArchConfig) -> torch.Tensor:
    """The reference's ``_merge_patches``: patch embeddings ``(B, P,
    VIS_WIDTH)`` through the two-layer projection (tanh GELU, as
    ``jax.nn.gelu``'s default), written over the first ``P`` positions of
    the embedded tokens ``x`` ``(B, S, d)``."""
    cdt = dtype_of(cfg.compute_dtype)
    n = patch_embeds.shape[1]
    if patch_embeds.shape[-1] != VIS_WIDTH or n > x.shape[1]:
        raise ValueError(f"patch embeds {tuple(patch_embeds.shape)}: width "
                         f"{VIS_WIDTH} and at most {x.shape[1]} patches")
    pe = torch.matmul(patch_embeds.to(cdt), params["mm_proj"]["w1"].to(cdt))
    pe = F.gelu(pe, approximate="tanh")
    pe = torch.matmul(pe, params["mm_proj"]["w2"].to(cdt))
    return torch.cat([pe.to(x.dtype), x[:, n:]], dim=1)


def _embed(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig
           ) -> torch.Tensor:
    """The prefill's input embeddings: the tokens', with a vision arch's
    patch embeddings merged in when the batch carries them."""
    x = apply_embedding(params["embed"], batch["tokens"], cfg)
    if cfg.num_patches and "patch_embeds" in batch:
        x = _merge_patches(params, x, batch["patch_embeds"], cfg)
    return x


def _build_decoder_only(cfg: ArchConfig) -> ModelBundle:
    def init(seed: int = 0, device=None):
        return init_lm(cfg, seed, device)

    def prefill_fn(params, batch: Dict[str, torch.Tensor]):
        x = _embed(params, batch, cfg)
        h, caches = lm_backbone(params, x, cfg, collect_cache=True)
        logits = apply_unembed(params["embed"], h[:, -1:], cfg)
        return logits[:, 0], caches, int(x.shape[1])

    def decode_fn(params, tokens, caches, cache_index: int):
        x = apply_embedding(params["embed"], tokens, cfg)
        h, caches = lm_decode_backbone(params, x, caches, cache_index, cfg)
        return apply_unembed(params["embed"], h, cfg)[:, 0], caches

    def init_caches(batch: int, seq_len: int, device=None):
        return init_lm_caches(cfg, batch, seq_len, device)

    return ModelBundle(cfg, init, prefill_fn, decode_fn, init_caches)


def build_model(cfg: ArchConfig) -> ModelBundle:
    check_supported(cfg)
    return _build_decoder_only(cfg)


def param_count(params: Dict[str, Any]) -> int:
    n = [0]
    tree_map(lambda a: n.__setitem__(0, n[0] + a.numel()), params)
    return n[0]
