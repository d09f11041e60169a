"""Plain reference of a dense GQA decoder (InternLM2's published block).

Per layer: RMSNorm, grouped-query attention with rotary positions (the
"rotate half" form: the first and second halves of each head's vector as
the two coordinates, frequencies ``theta ** (-i / (D/2))``), a residual
add, RMSNorm, a SwiGLU MLP ``(silu(x W_gate) * (x W_up)) W_down``, a
residual add; a final RMSNorm and the unembedding.  No biases.

Attention here is over a window: query position ``i`` reads key positions
``i - window < j <= i``.  The serving port keeps a request's keys in a ring
as long as its prompt bucket, so a decoded token reads the last ``bucket``
positions; ``window`` is that bucket.  The prompt's left padding is token 0
at the leading positions, read like any token.

Everything runs in float32 (TF32 off), a layer at a time from the weights
handed in, which are never changed.  It imports nothing of the program.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch

Weights = Dict[str, torch.Tensor]
QUERY_BLOCK = 1024


@contextlib.contextmanager
def exact_float32():
    """Float32 products in float32: TF32 off for matmuls and cuDNN."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, heads, D) at positions ``pos`` (S,)."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64,
                                  device=x.device) / half)
    ang = (pos.double()[:, None] * inv[None, :]).float()[:, None, :]
    c, s = torch.cos(ang), torch.sin(ang)
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * c - b * s, b * c + a * s], dim=-1)


def logits(W: Weights, cfg: Dict, tokens: torch.Tensor, first: int,
           window: int,
           weight: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
           ) -> torch.Tensor:
    """Float32 logits ``(S - first, vocab)`` of positions ``first ..
    S - 1`` of ``tokens`` (S,), each position predicting the next token.
    ``weight`` maps each weight matrix before use (the control's lower
    precision); None uses it as given."""
    w = weight or (lambda t: t)
    L, H, Hkv = cfg["num_layers"], cfg["num_heads"], cfg["num_kv_heads"]
    D, eps, theta = cfg["head_dim"], cfg["rms_norm_eps"], cfg["rope_theta"]
    V = cfg["vocab_size"]
    dev = W["embedding"].device
    f32 = lambda t: t.to(dev, torch.float32)  # noqa: E731
    with exact_float32(), torch.no_grad():
        tok = tokens.to(dev).long()
        S = tok.shape[0]
        pos = torch.arange(S, device=dev)
        x = f32(W["embedding"][tok])
        for layer in range(L):
            h = rmsnorm(x, f32(W["norm1"][layer]), eps)
            q = (h @ w(f32(W["wq"][layer]))).reshape(S, H, D)
            k = (h @ w(f32(W["wk"][layer]))).reshape(S, Hkv, D)
            v = (h @ w(f32(W["wv"][layer]))).reshape(S, Hkv, D)
            q, k = rope(q, pos, theta), rope(k, pos, theta)
            k = k.repeat_interleave(H // Hkv, dim=1)
            v = v.repeat_interleave(H // Hkv, dim=1)
            o = torch.empty_like(q)
            for a in range(0, S, QUERY_BLOCK):
                b = min(S, a + QUERY_BLOCK)
                lo = max(0, a - window + 1)
                s = torch.einsum("qhd,khd->hqk", q[a:b], k[lo:b]) / D ** 0.5
                qi = pos[a:b, None]
                kj = pos[None, lo:b]
                ok = (kj <= qi) & (kj > qi - window)
                s = s.masked_fill(~ok[None], float("-inf"))
                o[a:b] = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1),
                                      v[lo:b])
            x = x + o.reshape(S, H * D) @ w(f32(W["wo"][layer]))
            h = rmsnorm(x, f32(W["norm2"][layer]), eps)
            g = h @ w(f32(W["w_gate"][layer]))
            u = h @ w(f32(W["w_up"][layer]))
            x = x + (torch.nn.functional.silu(g) * u) @ \
                w(f32(W["w_down"][layer]))
        h = rmsnorm(x[first:], f32(W["final_norm"]), eps)
        return h @ w(f32(W["unembed"][:, :V]))


def fp8_weight(t: torch.Tensor) -> torch.Tensor:
    """The control's weights: each matrix rounded to float8 e4m3 with one
    scale per output column (its largest magnitude to 448), then widened."""
    scale = t.abs().amax(dim=0, keepdim=True).clamp(min=1e-12) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def token_gaps(ref: torch.Tensor, tokens: torch.Tensor,
               k: int = 1) -> torch.Tensor:
    """Per position, how far the lowest logit of ``ref`` among ``tokens``
    (S, m) lies below the ``k``-th best logit of ``ref``: nought where each
    lies in its top ``k``."""
    t = tokens.to(ref.device).long()
    kth = ref.topk(k, dim=-1).values[:, -1]
    return (kth - ref.gather(1, t).min(dim=1).values).clamp(min=0)
