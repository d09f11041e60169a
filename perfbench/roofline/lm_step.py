"""Model FLOPs of a dense GQA decoder: the products a token's forward pass
needs, from the configuration's shapes (no embedding lookup; the
unembedding where logits are made)."""
from __future__ import annotations

from typing import Dict


def dense_flops(m: Dict[str, int]) -> float:
    """2 x the multiply-adds of one token's projections and MLP, all
    layers."""
    d, H, Hkv, D, F = (m["d_model"], m["num_heads"], m["num_kv_heads"],
                       m["head_dim"], m["d_ff"])
    per_layer = d * H * D + 2 * d * Hkv * D + H * D * d + 3 * d * F
    return 2.0 * m["num_layers"] * per_layer


def attn_flops(m: Dict[str, int], keys: float) -> float:
    """A query's scores and weighted values against ``keys`` keys, all
    layers and heads."""
    return 4.0 * m["num_layers"] * m["num_heads"] * m["head_dim"] * keys


def unembed_flops(m: Dict[str, int]) -> float:
    return 2.0 * m["d_model"] * m["vocab_size"]


def prefill_flops(m: Dict[str, int], S: int, width: int = 1) -> float:
    """A prefill of ``width`` rows of ``S`` tokens, causal, logits at the
    last position."""
    return width * (S * dense_flops(m) + attn_flops(m, S * (S + 1) / 2)
                    + unembed_flops(m))


def decode_flops(m: Dict[str, int], keys: float) -> float:
    """One decoded token reading ``keys`` keys."""
    return dense_flops(m) + attn_flops(m, keys) + unembed_flops(m)
