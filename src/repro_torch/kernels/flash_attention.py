"""FlashAttention forward kernel of the prefill path for NVIDIA Hopper.

Replaces the Pallas kernel of the JAX package's
``repro/kernels/flash_attention.py`` (``_kernel``, entry
``flash_attention_pallas``) with :func:`flash_attention`, CUDA C++ in
``csrc/flash_attention.cu``, built by :mod:`.build` at first use.  The
reference's layers reach the same function through ``blockwise_attention``,
its jnp stand-in for the kernel; the port's layers reach this kernel for
every prefill on the card (``models.layers.apply_attention`` ->
``kernels.ops.flash_attention``).

What bounds it on the card: operations.  The causal half of ``Q K^T`` and
``P V`` is ``~2 B Hq Sq Skv D`` flops (~34 GFLOP at an olmoe prefill of 8 x
1024 tokens) against tens of megabytes of q, k, v and o.  The inputs' type
picks one of two kernels (``variant_counts`` says which ran):

* ``bf16_mma`` (every full-width path): FlashAttention-2 on the tensor
  cores, ``mma.sync.m16n8k16`` bf16 -> f32.  A block of 4 warps takes 64
  rows of (query position, query head of one kv head's group), so one K/V
  tile serves the whole group; each warp keeps its 16 rows' Q fragments in
  registers; K/V tiles of 64 keys stream through a 2-stage ``cp.async``
  ring; the online softmax runs on the accumulator fragments.  P is split
  into two bf16 halves (``P = P_hi + P_lo``) and both products are summed
  in f32, so P carries ~2^-17 relative error, not a bf16 rounding.
* ``f32_simt`` (the reduced configs, the float32 holds): plain float32 FMAs
  on 64 x 64 tiles staged as float32 rows in shared memory.

Both skip key tiles that the causal or window mask hides whole (exactly),
mask ragged edges in the kernel and read q, k and v through their strides.
Asked for it (``return_lse=True``, the training forward of
:class:`repro_torch.kernels.ops.FlashAttentionFn`), both also write each
row's log-sum-exp of its scores, the residual the reference's backward
reads (``attn_fwd`` in ``repro/models/attention_core.py``).

Beside the kernels stands their plain PyTorch version
(:func:`flash_attention_plain`): the port's
:func:`repro_torch.kernels.ref.blockwise_attention` at the
reference's blocks (512 queries x 1024 keys), which is what the
reference's ``models/layers.py`` computes.  The wrapper takes the plain
version only for tensors that lie on the CPU; for CUDA tensors it launches
the kernel of their type or raises.  ``launch_counts`` and ``plain_counts``
record which way each call went.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import blockwise_attention

#: kernel launches per wrapper, bumped where the kernel is launched
launch_counts: Dict[str, int] = {"flash_attention": 0}
#: plain-version calls (any caller, any device)
plain_counts: Dict[str, int] = {"flash_attention_plain": 0}
#: launches of each kernel variant: the tensor-core kernel (bfloat16
#: inputs) and the SIMT kernel (float32 inputs); they sum to
#: ``launch_counts["flash_attention"]``
variant_counts: Dict[str, int] = {"bf16_mma": 0, "f32_simt": 0}
#: calls of the training backward (``ops.FlashAttentionFn.backward``, the
#: reference's ``attn_bwd`` in PyTorch; no kernel of its own)
backward_counts: Dict[str, int] = {"flash_attention_bwd": 0}

MAX_HEAD_DIM = 128           # the accumulators' width in both kernels


def reset_counts() -> None:
    for d in (launch_counts, plain_counts, variant_counts, backward_counts):
        for k in d:
            d[k] = 0


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None,
                          return_lse: bool = False):
    """Plain PyTorch version of :func:`flash_attention`: the blockwise
    online softmax at the reference's blocks of 512 queries and 1024 keys."""
    plain_counts["flash_attention_plain"] += 1
    return blockwise_attention(q, k, v, causal=causal, window=window,
                               block_q=512, block_kv=1024,
                               return_lse=return_lse)


_ENTRY = []


def _entry():
    """The library's C entry with its argument types set (the library is
    built at the first call)."""
    if not _ENTRY:
        fn = build.load_library("flash_attention").flash_attention_launch
        P_, I_ = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P_, P_, P_, P_, P_, I_, I_, I_, I_, I_, I_, I_,
                       ctypes.c_float, I_, I_, I_,
                       ctypes.POINTER(ctypes.c_longlong), P_]
        fn.restype = ctypes.c_int
        _ENTRY.append(fn)
    return _ENTRY[0]


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: need (B, Sq, Hq, D) and k/v "
                         "(B, Skv, Hkv, D)")
    B, Sq, Hq, D = q.shape
    Bk, Skv, Hkv, Dk = k.shape
    if Bk != B or Dk != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit k/v "
                         f"{tuple(k.shape)}")
    if Skv == 0:
        raise ValueError("no keys: Skv == 0")
    return B, Sq, Hq, D, Skv, Hkv


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` if the kernel's 16-byte loads can read it as it is (head axis
    contiguous, every other stride and the base 16-byte aligned), else a
    contiguous copy."""
    vec = 16 // t.element_size()
    if (t.stride(-1) == 1 and all(s % vec == 0 for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0):
        return t
    return t.contiguous()


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, return_lse: bool = False):
    """Attention forward, the contract of
    :func:`repro_torch.kernels.ref.flash_attention_ref`.

    q ``(B, Sq, Hq, D)``, k/v ``(B, Skv, Hkv, D)`` with ``Hq % Hkv == 0``,
    float32 or bfloat16 (one type for all three: bfloat16 goes to the
    tensor-core kernel, float32 to the SIMT kernel); ``causal`` top-left
    aligned (query and key positions both from 0); ``window`` admits keys
    ``k > q - window``, or None.  Returns ``(B, Sq, Hq, D)`` in q's type;
    with ``return_lse``, ``(o, lse)``, lse ``(B, Sq, Hq)`` float32 (each
    row's ``m + log(l)`` with the reference's guards, natural-log units).
    CUDA tensors go to the kernel (D a multiple of 8 up to 128), CPU tensors
    to the plain version."""
    B, Sq, Hq, D, Skv, Hkv = _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     return_lse=return_lse)
    build.require_cuda(q, k, v)
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: need "
                        "one of float32 or bfloat16")
    if D % 8 or D > MAX_HEAD_DIM:
        raise ValueError(f"D={D}: the kernel takes D a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}")
    q, k, v = (_aligned(t) for t in (q, k, v))
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, Sq, Hq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if B * Sq * Hq == 0:             # nothing to launch, nothing counted
        return (out, lse) if return_lse else out
    strides = (ctypes.c_longlong * 9)(*(
        s for t in (q, k, v) for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            int(q.dtype == torch.bfloat16), B, Sq, Skv, Hq, Hkv, D,
            1.0 / math.sqrt(D), int(bool(causal)), int(window is not None),
            0 if window is None else int(window), strides, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: CUDA error {err} at launch "
                           f"(B={B}, Sq={Sq}, Skv={Skv}, Hq={Hq}, Hkv={Hkv}, "
                           f"D={D})")
    launch_counts["flash_attention"] += 1
    variant_counts["bf16_mma" if q.dtype == torch.bfloat16 else
                   "f32_simt"] += 1
    return (out, lse) if return_lse else out
