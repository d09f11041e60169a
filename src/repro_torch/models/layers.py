"""Layer library: norms, RoPE and sinusoidal positions, embeddings, GQA
self- and cross-attention, SwiGLU MLP.

The JAX package's ``repro/models/layers.py`` as plain functions on tensors.
Parameters are nested dicts with the reference's key names (``wq``,
``w_gate``, ``scale``, ...).  Every ``apply_*`` casts a weight to the compute
dtype where the reference does (``.to`` is free when the engine has already
cast it once, see :func:`repro_torch.models.model.prepare_params`), and every
``einsum(..., preferred_element_type=f32)`` of the reference on a lower
precision becomes a float32 product of operands widened first (exact for
bf16: a bf16 x bf16 product is representable in float32).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import ArchConfig
from repro_torch.distributed.sharding import Sharder, ShardedTensor
from repro_torch.kernels import ops
from repro_torch.models.attention_core import naive_attention

NEG_INF = -1e30
POS_EMPTY = 2 ** 30        # position of an empty cache slot: never valid


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def pad_vocab(vocab: int, multiple: int = 256) -> int:
    return ((vocab + multiple - 1) // multiple) * multiple


# a leaf of more elements than this is drawn in float32 pieces of at most
# this many, each cast into its part of the leaf: a whole float32 draw of a
# large leaf (one stage's experts of llama4, 5.4 G elements) would not fit
# beside the weights.  A leaf of this many or fewer is one draw.
DRAW_PIECE = 1 << 28


def normal(gen: torch.Generator, shape, scale: float, dtype: torch.dtype,
           device, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn in float32 from ``gen``, cast to ``dtype``
    (the reference's ``params.normal``; the draws differ from jax.random),
    written into ``out`` (a contiguous slice of a stacked leaf) when given.
    A leaf over :data:`DRAW_PIECE` elements is drawn piece by piece into
    its flat view; given the generator's state, the numbers do not depend
    on whether ``out`` is given."""
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=device)
    if out.device.type == "meta":
        return out
    n = out.numel()
    if n <= DRAW_PIECE:
        x = torch.randn(tuple(out.shape), generator=gen, dtype=torch.float32,
                        device=out.device)
        out.copy_(x.mul_(scale))
        return out
    flat = out.view(-1)
    for a in range(0, n, DRAW_PIECE):
        b = min(a + DRAW_PIECE, n)
        flat[a:b].copy_(torch.randn((b - a,), generator=gen,
                                    dtype=torch.float32,
                                    device=out.device).mul_(scale))
    return out


def filled(value: float, shape, dtype: torch.dtype, device,
           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A constant leaf (norm scales, biases), or ``out`` set to it."""
    if out is None:
        return torch.full(shape, value, dtype=dtype, device=device)
    return out.fill_(value)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
def init_rmsnorm(dim: int, dtype, device, out: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, torch.Tensor]:
    return {"scale": filled(1.0, (dim,), dtype, device,
                            (out or {}).get("scale"))}


def apply_rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return apply_rmsnorm_heads(p["scale"], x, eps)


def apply_rmsnorm_heads(scale, x: torch.Tensor, eps: float = 1e-6
                        ) -> torch.Tensor:
    """RMSNorm over the last axis (also the per-head qk-norm)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (B, S, H, D); positions: (S,) or (B, S)."""
    D = x.shape[-1]
    inv = rope_frequencies(D, theta, x.device)
    if positions.dim() == 1:
        ang = positions[:, None].float() * inv[None, :]             # (S, half)
        ang = ang[None, :, None, :]
    else:
        ang = positions[..., None].float() * inv                    # (B,S,half)
        ang = ang[:, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoid_frequencies(dim: int, device=None) -> torch.Tensor:
    """The ``dim // 2`` angular frequencies of the sinusoidal positions,
    float32."""
    half = dim // 2
    return torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=device) / half)


def sinusoidal_positions(seq_len: int, dim: int, device=None
                         ) -> torch.Tensor:
    """(seq_len, dim) float32 absolute position embeddings: ``sin`` of each
    position times each frequency, then ``cos`` (the encoder-decoder arch's
    positions, added to frames and to the decoder's tokens)."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    ang = pos * sinusoid_frequencies(dim, device)[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def init_embedding(gen, cfg: ArchConfig, device) -> Dict[str, torch.Tensor]:
    dt = dtype_of(cfg.param_dtype)
    v = pad_vocab(cfg.vocab_size)
    out = {"embedding": normal(gen, (v, cfg.d_model), 0.02, dt, device)}
    if not cfg.tie_embeddings:
        out["unembed"] = normal(gen, (cfg.d_model, v),
                                0.02 / math.sqrt(cfg.d_model), dt, device)
    return out


def apply_embedding(p, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    emb = p["embedding"].to(dtype_of(cfg.compute_dtype))
    return emb[tokens.long()]


def unembed_operand(p, cfg: ArchConfig) -> torch.Tensor:
    """The unembedding as the float32 operand of the reference's
    ``einsum(x, w.astype(compute), preferred_element_type=f32)``: rounded to
    the compute dtype, then widened, contiguous (a tied arch's is the
    embedding's transpose).  :func:`repro_torch.models.model.
    prepare_params` stores it once as ``unembed_f32``."""
    if "unembed_f32" in p:
        return p["unembed_f32"]
    cdt = dtype_of(cfg.compute_dtype)
    w = p["embedding"].t() if cfg.tie_embeddings else p["unembed"]
    return w.to(cdt).float().contiguous()


def apply_unembed(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Returns float32 logits over the padded vocab with pad columns masked
    to -1e30."""
    w = unembed_operand(p, cfg)
    logits = torch.matmul(x.float(), w)
    v_pad = w.shape[-1]
    if v_pad != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = NEG_INF
    return logits


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------
def init_attention(gen, cfg: ArchConfig, device,
                   out: Optional[Dict[str, Any]] = None, cross: bool = False
                   ) -> Dict[str, torch.Tensor]:
    """An attention block's projections (and qk-norm scales).  ``cross``
    names a decoder's cross-attention block, as the reference's flag does;
    it has the same leaves (wk/wv read the encoder's output)."""
    dt = dtype_of(cfg.param_dtype)
    d, H, Hkv, D = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s_in = 0.02
    s_out = 0.02 / math.sqrt(2 * max(cfg.num_layers, 1))
    o = out or {}
    p = {"wq": normal(gen, (d, H * D), s_in, dt, device, o.get("wq")),
         "wk": normal(gen, (d, Hkv * D), s_in, dt, device, o.get("wk")),
         "wv": normal(gen, (d, Hkv * D), s_in, dt, device, o.get("wv")),
         "wo": normal(gen, (H * D, d), s_out, dt, device, o.get("wo"))}
    if cfg.qk_norm:
        p["q_norm"] = filled(1.0, (D,), dt, device, o.get("q_norm"))
        p["k_norm"] = filled(1.0, (D,), dt, device, o.get("k_norm"))
    return p


def _project_qkv(p, x, x_kv, cfg: ArchConfig):
    cdt = dtype_of(cfg.compute_dtype)
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    B, S = x.shape[0], x.shape[1]
    Skv = x_kv.shape[1]
    q = torch.matmul(x, p["wq"].to(cdt)).reshape(B, S, H, D)
    k = torch.matmul(x_kv, p["wk"].to(cdt)).reshape(B, Skv, Hkv, D)
    v = torch.matmul(x_kv, p["wv"].to(cdt)).reshape(B, Skv, Hkv, D)
    if cfg.qk_norm:
        q = apply_rmsnorm_heads(p["q_norm"], q)
        k = apply_rmsnorm_heads(p["k_norm"], k)
    return q, k, v


def apply_attention(p, x, cfg: ArchConfig, *,
                    positions: Optional[torch.Tensor] = None,
                    causal: bool = True, return_kv: bool = False):
    """Full-sequence (prefill) self-attention; the attention itself is
    ``ops.flash_attention`` (the FlashAttention kernel on the card, the
    reference's blockwise attention on the CPU)."""
    q, k, v = _project_qkv(p, x, x, cfg)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    o = ops.flash_attention(q, k, v, causal=causal, window=cfg.sliding_window)
    o = o.reshape(x.shape[0], x.shape[1], -1)
    out = torch.matmul(o, p["wo"].to(dtype_of(cfg.compute_dtype)))
    if return_kv:
        return out, (k, v)
    return out


def apply_cross_attention(p, x, kv: Tuple[torch.Tensor, torch.Tensor],
                          cfg: ArchConfig, *, decode: bool = False
                          ) -> torch.Tensor:
    """Decoder cross-attention against precomputed encoder K/V ``kv`` (each
    ``(B, S_enc, Hkv, D)``; a decode step's may be split on KV heads, each
    shard cast to the query's dtype), no masking.  A prefill's queries go through
    ``ops.flash_attention(causal=False)`` (the FlashAttention kernel on the
    card, Sq the prompt bucket against S_enc keys); a decode step's single
    query (``decode``) through :func:`naive_attention`, as the reference
    computes both."""
    cdt = dtype_of(cfg.compute_dtype)
    H, D = cfg.num_heads, cfg.head_dim
    B, S = x.shape[0], x.shape[1]
    q = torch.matmul(x, p["wq"].to(cdt)).reshape(B, S, H, D)
    if cfg.qk_norm:
        q = apply_rmsnorm_heads(p["q_norm"], q)
    k, v = kv
    if decode:
        # K/V split on KV heads (a slot decode under --mesh) a shard at a
        # time, cast to the query's dtype there
        o = attend_kv_shards(q, k, v, lambda qs, ks, vs: naive_attention(
            qs, ks.to(qs.dtype), vs.to(qs.dtype), causal=False))
    else:
        o = ops.flash_attention(q, k, v, causal=False)
    o = o.reshape(B, S, -1)
    return torch.matmul(o, p["wo"].to(cdt))


def precompute_cross_kv(p, enc_out: torch.Tensor, cfg: ArchConfig
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A decoder layer's cross-attention K and V ``(B, S_enc, Hkv, D)`` of
    the encoder's output, in the compute dtype."""
    cdt = dtype_of(cfg.compute_dtype)
    Hkv, D = cfg.num_kv_heads, cfg.head_dim
    B, S = enc_out.shape[0], enc_out.shape[1]
    k = torch.matmul(enc_out, p["wk"].to(cdt)).reshape(B, S, Hkv, D)
    v = torch.matmul(enc_out, p["wv"].to(cdt)).reshape(B, S, Hkv, D)
    if cfg.qk_norm:
        k = apply_rmsnorm_heads(p["k_norm"], k)
    return k, v


def _decode_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    """One query token's GQA attention: q ``(B, 1, Hq, D)`` against k / v
    ``(B, S_c, Hk, D)`` (``Hq`` a multiple of ``Hk``, query head ``h``
    reading KV head ``h // (Hq / Hk)``) under the additive ``bias``
    ``(S_c,)``; float32 ``(B, 1, Hq, D)``.  Heads are independent, so a
    KV-head shard's call is its heads of the whole call."""
    B, _, Hq, D = q.shape
    Hk = k.shape[2]
    qr = q.reshape(B, 1, Hk, Hq // Hk, D)
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bqhrd,bkhd->bqhrk", qr.float(),
                     k.to(q.dtype).float()) * scale
    s = s + bias
    pattn = torch.softmax(s, dim=-1)
    o = torch.einsum("bqhrk,bkhd->bqhrd", pattn, v.to(q.dtype).float())
    return o.reshape(B, 1, Hq, D)


def attend_kv_shards(q: torch.Tensor, k, v, attend) -> torch.Tensor:
    """``attend(q_heads, k_local, v_local)`` once per distinct KV-head
    shard of ``k`` / ``v`` (:class:`ShardedTensor` split on their head axis
    2, or plain tensors: one call over every head), each shard's query
    heads ``(B, S, Hq/M, D)`` moved to its device; the shards' outputs
    joined on heads on ``q``'s device (data movement, never a sum)."""
    if not isinstance(k, ShardedTensor):
        return attend(q, k, v)
    rep = q.shape[2] // k.shape[2]
    parts = []
    for p, kl, sl in k.distinct():
        h = sl[2]
        parts.append(attend(q[:, :, h.start * rep:h.stop * rep].to(kl.device),
                            kl, v.locals[p]).to(q.device))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=2)


def apply_attention_decode(p, x, cache: Dict[str, Any], cfg: ArchConfig,
                           cache_index: int, sh: Optional[Sharder] = None):
    """Single-token decode with a (possibly ring) KV cache.

    cache: {"k": (B, S_c, Hkv, D), "v": ..., "pos": (B, S_c) absolute
    positions}, updated in place (the reference returns a new cache; here
    the caller's buffers are the state).  ``cache_index`` is the new
    token's absolute position.  K / V may be :class:`ShardedTensor` split on
    KV heads over ``sh``'s mesh (the slot schedules' caches under
    ``--mesh``): each shard takes the new token's K/V of its heads in place,
    its query heads attend to its KV heads on its device, and the shards'
    outputs are joined on heads on the first device before ``wo`` -- bit
    for bit their heads of the unsharded call.  Returns (out, cache)."""
    del sh                    # the placement travels with the cache
    H, D = cfg.num_heads, cfg.head_dim
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(p, x, x, cfg)
    pos = int(cache_index)
    if cfg.use_rope:
        at = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
        q = apply_rope(q, at, cfg.rope_theta)
        k_new = apply_rope(k_new, at, cfg.rope_theta)
    k, v, kpos = cache["k"], cache["v"], cache["pos"]
    slot = pos % k.shape[1]
    for dst, new in ((k, k_new), (v, v_new)):
        if isinstance(dst, ShardedTensor):
            for _, t, sl in dst.unique():
                t[:, slot] = new[:, 0, sl[2]].to(t.device, t.dtype)
        else:
            dst[:, slot] = new[:, 0].to(dst.dtype)
    kpos[:, slot] = pos
    valid = kpos[0] <= pos
    if cfg.sliding_window is not None:
        valid &= kpos[0] > pos - cfg.sliding_window
    bias = torch.where(valid, 0.0, NEG_INF).float()
    o = attend_kv_shards(
        q, k, v, lambda qs, ks, vs: _decode_heads(qs, ks, vs,
                                                  bias.to(ks.device)))
    o = o.reshape(B, 1, H * D).to(x.dtype)
    out = torch.matmul(o, p["wo"].to(dtype_of(cfg.compute_dtype)))
    return out, cache


def init_kv_cache(cfg: ArchConfig, batch: int, seq_len: int,
                  dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    s_c = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    shape = (batch, s_c, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            # empty slots get a far-future position so `kpos <= pos` masks
            # them out
            "pos": torch.full((batch, s_c), POS_EMPTY, dtype=torch.int32,
                              device=device)}


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------
def init_mlp(gen, cfg: ArchConfig, device, d_ff: Optional[int] = None,
             out: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    dt = dtype_of(cfg.param_dtype)
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    s_in = 0.02
    s_out = 0.02 / math.sqrt(2 * max(cfg.num_layers, 1))
    o = out or {}
    return {"w_gate": normal(gen, (d, ff), s_in, dt, device, o.get("w_gate")),
            "w_up": normal(gen, (d, ff), s_in, dt, device, o.get("w_up")),
            "w_down": normal(gen, (ff, d), s_out, dt, device,
                             o.get("w_down"))}


def apply_mlp(p, x, cfg: ArchConfig) -> torch.Tensor:
    cdt = dtype_of(cfg.compute_dtype)
    g = torch.matmul(x, p["w_gate"].to(cdt))
    u = torch.matmul(x, p["w_up"].to(cdt))
    h = torch.nn.functional.silu(g) * u
    return torch.matmul(h, p["w_down"].to(cdt))
