"""Model factory: ArchConfig -> init / prefill / decode callables.

The JAX package's ``repro/models/model.py``: the decoder-only family
(attention and Mamba-2 mixers, dense and routed MLPs, and a vision arch's
patch embeddings merged into the leading positions) and the
encoder-decoder family (whisper: an encoder over precomputed frames, a
decoder with self- and cross-attention, sinusoidal positions)::

    bundle = build_model(cfg)
    params = bundle.init(seed, device)             # tree of tensors
    loss, metrics = bundle.loss_fn(params, batch)  # training (sh: a mesh)
    logits, caches, idx = bundle.prefill_fn(params, batch)
    logits, caches = bundle.decode_fn(params, tokens, caches, idx)
    bundle.cache_axes()                            # caches' logical axes

``loss_fn`` computes with the float32 master leaves, cast at each use as the
reference casts them, so its gradients reach every leaf;
:func:`prepare_params` (cast once) is for serving only.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs import ArchConfig, ShapeCell
from repro_torch.distributed.sharding import Sharder
from repro_torch.models.layers import (apply_attention,
                                       apply_attention_decode,
                                       apply_cross_attention, apply_embedding,
                                       apply_mlp, apply_rmsnorm,
                                       apply_unembed, dtype_of,
                                       init_attention, init_embedding,
                                       init_kv_cache, init_mlp, init_rmsnorm,
                                       precompute_cross_kv,
                                       sinusoid_frequencies,
                                       sinusoidal_positions, unembed_operand)
from repro_torch.models.transformer import (ATTN_CACHE_AXES, VIS_WIDTH,
                                            _kv_to_cache, check_supported,
                                            init_lm, init_lm_caches,
                                            init_stacked, lm_backbone,
                                            lm_cache_axes, lm_decode_backbone,
                                            make_generator, remat_wrap,
                                            stage_view, stage_views,
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
    # the encoder-decoder's parts (None for a decoder-only arch):
    # encode(params, frames) -> the encoder's output, cross_kv_all(params,
    # enc_out) -> every decoder layer's cross K and V
    encode: Optional[Callable[..., Any]] = None
    cross_kv_all: Optional[Callable[..., Any]] = None
    # loss_fn(params, batch, sh=None) -> (loss, {"xent", "aux"}): the
    # training objective, the next-token cross-entropy plus the MoE aux
    # losses (``sh``'s mesh reaches the routed experts)
    loss_fn: Optional[Callable[..., Tuple[torch.Tensor, Dict[str, Any]]]] = None
    # cache_axes() -> the logical axes of init_caches' tree (the
    # reference's): a serving sharder lays the prefill's caches out by them
    cache_axes: Optional[Callable[[], Any]] = None


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy of float32 ``logits`` (..., V) against
    integer ``labels`` (...), the reference's ``_xent``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return -torch.mean(ll)


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


def _sinusoid_at(pos: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embeddings at the positions ``pos``, a device tensor whose
    last axis broadcasts against the ``dim // 2`` frequencies: a 0-d
    position gives ``(dim,)``, per-row positions ``(C, 1, 1)`` give ``(C,
    1, dim)``.  Read on the device, so a captured decode round reads each
    row's position where it lies, not a host int."""
    ang = pos.float() * sinusoid_frequencies(dim, pos.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _embed(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig
           ) -> torch.Tensor:
    """The prefill's input embeddings: the tokens', with a vision arch's
    patch embeddings merged in when the batch carries them, plus the
    sinusoidal positions where the arch has no rotary ones."""
    x = apply_embedding(params["embed"], batch["tokens"], cfg)
    if cfg.num_patches and "patch_embeds" in batch:
        x = _merge_patches(params, x, batch["patch_embeds"], cfg)
    if not cfg.use_rope:
        x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                     x.device).to(x.dtype)[None]
    return x


def _build_decoder_only(cfg: ArchConfig) -> ModelBundle:
    def init(seed: int = 0, device=None):
        return init_lm(cfg, seed, device)

    def loss_fn(params, batch: Dict[str, torch.Tensor],
                sh: Optional[Sharder] = None):
        x = _embed(params, batch, cfg)
        h, aux, _ = lm_backbone(params, x, cfg, sh, train=True)
        logits = apply_unembed(params["embed"], h, cfg)
        loss = _xent(logits, batch["labels"])
        return loss + aux, {"xent": loss, "aux": aux}

    def prefill_fn(params, batch: Dict[str, torch.Tensor]):
        x = _embed(params, batch, cfg)
        h, _, caches = lm_backbone(params, x, cfg, collect_cache=True)
        logits = apply_unembed(params["embed"], h[:, -1:], cfg)
        return logits[:, 0], caches, int(x.shape[1])

    def decode_fn(params, tokens, caches, cache_index: int,
                  sh: Optional[Sharder] = None):
        x = apply_embedding(params["embed"], tokens, cfg)
        if not cfg.use_rope:
            x = x + _position_at(cache_index, cfg, x)
        h, caches = lm_decode_backbone(params, x, caches, cache_index, cfg,
                                       sh)
        return apply_unembed(params["embed"], h, cfg)[:, 0], caches

    def init_caches(batch: int, seq_len: int, device=None):
        return init_lm_caches(cfg, batch, seq_len, device)

    return ModelBundle(cfg, init, prefill_fn, decode_fn, init_caches,
                       loss_fn=loss_fn, cache_axes=lambda: lm_cache_axes(cfg))


def _position_at(cache_index: int, cfg: ArchConfig, x: torch.Tensor
                 ) -> torch.Tensor:
    """The dense decode's sinusoidal embedding at ``cache_index``, shaped
    ``(1, 1, d)`` in ``x``'s dtype (a fill, no host-to-device copy)."""
    pos = torch.full((), int(cache_index), dtype=torch.int32,
                     device=x.device)
    return _sinusoid_at(pos, cfg.d_model).to(x.dtype)[None, None]


# ---------------------------------------------------------------------------
# Encoder-decoder family (whisper)
# ---------------------------------------------------------------------------
def _init_enc_stage(gen, cfg: ArchConfig, device,
                    out: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One encoder layer: self-attention and a SwiGLU MLP, each behind an
    RMSNorm (written into ``out``'s views when given)."""
    dt = dtype_of(cfg.param_dtype)
    o = out or {}
    return {"norm1": init_rmsnorm(cfg.d_model, dt, device, o.get("norm1")),
            "attn": init_attention(gen, cfg, device, o.get("attn")),
            "norm2": init_rmsnorm(cfg.d_model, dt, device, o.get("norm2")),
            "mlp": init_mlp(gen, cfg, device, out=o.get("mlp"))}


def _init_dec_stage(gen, cfg: ArchConfig, device,
                    out: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One decoder layer: causal self-attention, cross-attention to the
    encoder's output and a SwiGLU MLP, each behind an RMSNorm."""
    dt = dtype_of(cfg.param_dtype)
    o = out or {}
    return {"norm1": init_rmsnorm(cfg.d_model, dt, device, o.get("norm1")),
            "attn": init_attention(gen, cfg, device, o.get("attn")),
            "norm_c": init_rmsnorm(cfg.d_model, dt, device, o.get("norm_c")),
            "cross": init_attention(gen, cfg, device, o.get("cross"),
                                    cross=True),
            "norm2": init_rmsnorm(cfg.d_model, dt, device, o.get("norm2")),
            "mlp": init_mlp(gen, cfg, device, out=o.get("mlp"))}


def _build_enc_dec(cfg: ArchConfig) -> ModelBundle:
    """The reference's ``_build_enc_dec``.  A prefill encodes the batch's
    ``frames`` ``(B, S_enc, d)`` (non-causal self-attention), projects
    every decoder layer's cross K/V of the encoder's output, and runs the
    decoder over the tokens; its caches are ``{"self": {k, v, pos}
    (n_dec, B, S, Hkv, D), "cross": {k, v} (n_dec, B, S_enc, Hkv, D)}``,
    the cross K/V in the compute dtype.  A decode step updates the self
    cache in place and reads the cross cache."""
    n_enc, n_dec = cfg.num_encoder_layers, cfg.num_layers
    cdt = dtype_of(cfg.compute_dtype)

    def init(seed: int = 0, device=None):
        gen = make_generator(seed, device)
        dt = dtype_of(cfg.param_dtype)
        return {
            "embed": init_embedding(gen, cfg, device),
            "enc_stages": init_stacked(
                gen, n_enc, lambda g, d, o: _init_enc_stage(g, cfg, d, o),
                device),
            "dec_stages": init_stacked(
                gen, n_dec, lambda g, d, o: _init_dec_stage(g, cfg, d, o),
                device),
            "enc_norm": init_rmsnorm(cfg.d_model, dt, device),
            "final_norm": init_rmsnorm(cfg.d_model, dt, device)}

    def encode(params, frames: torch.Tensor) -> torch.Tensor:
        x = frames.to(cdt)
        x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                     x.device).to(x.dtype)[None]
        for sp in stage_views(params["enc_stages"]):
            x = x + apply_attention(sp["attn"], apply_rmsnorm(sp["norm1"], x),
                                    cfg, causal=False)
            x = x + apply_mlp(sp["mlp"], apply_rmsnorm(sp["norm2"], x), cfg)
        return apply_rmsnorm(params["enc_norm"], x)

    def cross_kv_all(params, enc_out: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every decoder layer's cross K and V, stacked ``(n_dec, B, S_enc,
        Hkv, D)``."""
        kv = [precompute_cross_kv(sp["cross"], enc_out, cfg)
              for sp in stage_views(params["dec_stages"])]
        return (torch.stack([k for k, _ in kv]),
                torch.stack([v for _, v in kv]))

    def dec_layer(sp, x, ck, cv, positions):
        """A decoder layer without caches (what a checkpointed layer
        runs)."""
        x = x + apply_attention(sp["attn"], apply_rmsnorm(sp["norm1"], x),
                                cfg, positions=positions)
        x = x + apply_cross_attention(
            sp["cross"], apply_rmsnorm(sp["norm_c"], x), (ck, cv), cfg)
        return x + apply_mlp(sp["mlp"], apply_rmsnorm(sp["norm2"], x), cfg)

    def decode_full(params, tokens, enc_out, collect_cache: bool = False,
                    train: bool = False):
        x = apply_embedding(params["embed"], tokens, cfg)
        x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                     x.device).to(x.dtype)[None]
        ck, cv = cross_kv_all(params, enc_out)
        positions = torch.arange(x.shape[1], device=x.device)
        caches = []
        for i, sp in enumerate(stage_views(params["dec_stages"])):
            if not collect_cache:
                x = remat_wrap(functools.partial(dec_layer, sp), cfg, train)(
                    x, ck[i], cv[i], positions)
                continue
            a, (k, v) = apply_attention(sp["attn"],
                                        apply_rmsnorm(sp["norm1"], x), cfg,
                                        positions=positions, return_kv=True)
            caches.append(_kv_to_cache(k, v, positions, cfg))
            x = x + a
            x = x + apply_cross_attention(
                sp["cross"], apply_rmsnorm(sp["norm_c"], x), (ck[i], cv[i]),
                cfg)
            x = x + apply_mlp(sp["mlp"], apply_rmsnorm(sp["norm2"], x), cfg)
        x = apply_rmsnorm(params["final_norm"], x)
        self_caches = ({k: torch.stack([c[k] for c in caches])
                        for k in caches[0]} if collect_cache else None)
        return x, self_caches, (ck, cv)

    def loss_fn(params, batch: Dict[str, torch.Tensor],
                sh: Optional[Sharder] = None):
        del sh                  # no routed experts: computed once
        enc_out = encode(params, batch["frames"])
        h, _, _ = decode_full(params, batch["tokens"], enc_out, train=True)
        logits = apply_unembed(params["embed"], h, cfg)
        loss = _xent(logits, batch["labels"])
        return loss, {"xent": loss,
                      "aux": torch.zeros((), dtype=torch.float32,
                                         device=loss.device)}

    def prefill_fn(params, batch: Dict[str, torch.Tensor]):
        enc_out = encode(params, batch["frames"])
        h, self_caches, (ck, cv) = decode_full(params, batch["tokens"],
                                               enc_out, collect_cache=True)
        logits = apply_unembed(params["embed"], h[:, -1:], cfg)
        caches = {"self": self_caches, "cross": {"k": ck, "v": cv}}
        return logits[:, 0], caches, int(batch["tokens"].shape[1])

    def decode_fn(params, tokens, caches, cache_index: int,
                  sh: Optional[Sharder] = None):
        x = apply_embedding(params["embed"], tokens, cfg)
        x = x + _position_at(cache_index, cfg, x)
        cross = caches["cross"]
        for i in range(n_dec):
            sp = stage_view(params["dec_stages"], i)
            a, _ = apply_attention_decode(sp["attn"],
                                          apply_rmsnorm(sp["norm1"], x),
                                          stage_view(caches["self"], i), cfg,
                                          cache_index, sh)
            x = x + a
            x = x + apply_cross_attention(
                sp["cross"], apply_rmsnorm(sp["norm_c"], x),
                (cross["k"][i], cross["v"][i]), cfg, decode=True)
            x = x + apply_mlp(sp["mlp"], apply_rmsnorm(sp["norm2"], x), cfg)
        x = apply_rmsnorm(params["final_norm"], x)
        return apply_unembed(params["embed"], x, cfg)[:, 0], caches

    def init_caches(batch: int, seq_len: int, device=None):
        self_c = tree_map(
            lambda a: a[None].repeat((n_dec,) + (1,) * a.dim()),
            init_kv_cache(cfg, batch, seq_len, device=device))
        shape = (n_dec, batch, cfg.encoder_seq_len, cfg.num_kv_heads,
                 cfg.head_dim)
        return {"self": self_c,
                "cross": {k: torch.zeros(shape, dtype=torch.bfloat16,
                                         device=device) for k in "kv"}}

    def cache_axes():
        cross = ("layers", "batch", None, "kv", None)
        return {"self": dict(ATTN_CACHE_AXES),
                "cross": {"k": cross, "v": cross}}

    return ModelBundle(cfg, init, prefill_fn, decode_fn, init_caches,
                       encode, cross_kv_all, loss_fn, cache_axes)


def build_model(cfg: ArchConfig) -> ModelBundle:
    check_supported(cfg)
    if cfg.enc_dec:
        return _build_enc_dec(cfg)
    return _build_decoder_only(cfg)


def param_count(params: Dict[str, Any]) -> int:
    n = [0]
    tree_map(lambda a: n.__setitem__(0, n[0] + a.numel()), params)
    return n[0]


# ---------------------------------------------------------------------------
# Input specs per (arch x shape) cell: meta tensors, no allocation
# ---------------------------------------------------------------------------
def input_specs(cfg: ArchConfig, shape: ShapeCell) -> Dict[str, torch.Tensor]:
    """The batch of one ``shape`` cell as meta tensors of the reference's
    shapes and dtypes (its ``input_specs``): int32 tokens (and labels for
    training), bf16 patch embeddings and frames where the arch takes
    them."""
    B, S = shape.global_batch, shape.seq_len

    def meta(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")

    i32, bf16 = torch.int32, torch.bfloat16
    if shape.kind == "train":
        specs = {"tokens": meta((B, S), i32), "labels": meta((B, S), i32)}
    elif shape.kind == "prefill":
        specs = {"tokens": meta((B, S), i32)}
    else:  # decode: one new token; caches are built separately
        specs = {"tokens": meta((B, 1), i32)}
    if cfg.num_patches and shape.kind != "decode":
        specs["patch_embeds"] = meta((B, cfg.num_patches, VIS_WIDTH), bf16)
    if cfg.enc_dec and shape.kind != "decode":
        specs["frames"] = meta((B, cfg.encoder_seq_len, cfg.d_model), bf16)
    return specs
