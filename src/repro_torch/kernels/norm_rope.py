"""RMSNorm and rotary position embedding kernels of the model step for
NVIDIA Hopper.

The JAX package has no Pallas kernel for either: ``repro/models/layers.py``
writes ``apply_rmsnorm_heads`` and ``apply_rope`` as jnp ops, which XLA
fuses on the TPU.  The port's op chains ran one PyTorch call at a time, 8
kernels an RMSNorm and 18 a rotary embedding, most of a decoder layer's
launches in every prefill and every captured decode step.  Here each is one
launch of CUDA C++ in ``csrc/norm_rope.cu``, built by :mod:`.build` at first
use:

* :func:`rmsnorm` -- over the last axis of a contiguous ``x`` of any
  leading shape (``d_model``, or the per-head qk-norm at ``head_dim``),
  bfloat16 or float32, the scale in its own type of the two; float32
  inside, ``eps`` as given, written in ``x``'s type.
* :func:`rope` -- ``x`` ``(B, S, H, D)`` contiguous at positions ``(S,)`` or
  ``(B, S)`` (int32 or int64), with the float32 inverse frequencies the
  caller hands in (:func:`repro_torch.models.layers.rope_inv_frequencies`,
  computed once per ``(D, theta, device)``).

What bounds both on the card: bytes (one read of ``x``, one write).  The
kernels' notes in the source say how they are laid out.

Their plain versions are the op chains themselves, which stay where they
were (:func:`repro_torch.models.layers.rmsnorm_plain`,
:func:`repro_torch.models.layers.rope_plain`) and count their calls here in
``plain_counts``; :mod:`repro_torch.models.layers` takes them for CPU
tensors and these wrappers for every other, which launch the kernel for a
CUDA tensor or raise.  ``launch_counts`` counts launches.
"""
from __future__ import annotations

import ctypes
from typing import Any, Dict, Tuple

import torch

from repro_torch.kernels import build

#: kernel launches per wrapper, bumped where the kernel is launched
launch_counts: Dict[str, int] = {"rmsnorm": 0, "rope": 0}
#: plain-version calls (any caller, any device)
plain_counts: Dict[str, int] = {"rmsnorm_plain": 0, "rope_plain": 0}
#: calls of the training backwards (the op chains recomputed and
#: differentiated in :mod:`repro_torch.models.layers`; no kernel of their
#: own, as the JAX package has none)
backward_counts: Dict[str, int] = {"rmsnorm_bwd": 0, "rope_bwd": 0}

_TYPES = (torch.float32, torch.bfloat16)
_POSITION_TYPES = (torch.int32, torch.int64)


def reset_counts() -> None:
    for d in (launch_counts, plain_counts, backward_counts):
        for k in d:
            d[k] = 0


_ENTRIES: Dict[str, Any] = {}


def _entry(name: str):
    """The library's C entry ``name`` with its argument types set (the
    library is built at the first call)."""
    if name not in _ENTRIES:
        fn = getattr(build.load_library("norm_rope"), name)
        P_, I_, L_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = (
            [P_, P_, P_, I_, I_, L_, I_, ctypes.c_float, P_]
            if name == "rmsnorm_launch" else
            [P_, P_, P_, P_, I_, I_, I_, I_, I_, I_, L_, P_])
        fn.restype = ctypes.c_int
        _ENTRIES[name] = fn
    return _ENTRIES[name]


def _raise_on_error(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def rmsnorm_shape(x: torch.Tensor, scale: torch.Tensor) -> Tuple[int, int]:
    """``(rows, width)`` of an RMSNorm the kernel takes; raises on anything
    else (every check of :func:`rmsnorm` but the device's)."""
    if x.dtype not in _TYPES or scale.dtype not in _TYPES:
        raise TypeError(f"x {x.dtype}, scale {scale.dtype}: need float32 or "
                        "bfloat16")
    if x.dim() == 0 or x.shape[-1] == 0 or \
            tuple(scale.shape) != (x.shape[-1],):
        raise ValueError(f"x {tuple(x.shape)}, scale {tuple(scale.shape)}: "
                         "need a scale of x's last axis, not empty")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm: x and scale must be contiguous")
    width = x.shape[-1]
    if (width * x.element_size()) % 16 == 0 and (
            x.data_ptr() % 16 or scale.data_ptr() % 16):
        raise ValueError("rmsnorm: x and scale must start at 16-byte "
                         "boundaries")
    return x.numel() // width, width


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float
            ) -> torch.Tensor:
    """RMSNorm of ``x`` over its last axis, times ``scale``: one kernel
    launch (CUDA tensors only; raises for anything else).  ``x`` contiguous,
    float32 or bfloat16; ``scale`` ``(width,)`` contiguous, float32 or
    bfloat16; both 16-byte aligned when the width is a multiple of 16
    bytes' elements.  Returns a new tensor of ``x``'s shape and type."""
    build.require_cuda(x, scale)
    rows, width = rmsnorm_shape(x, scale)
    y = torch.empty_like(x)
    if rows == 0:                    # nothing to launch, nothing counted
        return y
    with torch.cuda.device(x.device):
        err = _entry("rmsnorm_launch")(
            x.data_ptr(), scale.data_ptr(), y.data_ptr(),
            int(x.dtype == torch.bfloat16), int(scale.dtype == torch.bfloat16),
            rows, width, float(eps), torch.cuda.current_stream().cuda_stream)
    _raise_on_error(err, f"rmsnorm (rows={rows}, width={width})")
    launch_counts["rmsnorm"] += 1
    return y


def rope_shape(x: torch.Tensor, positions: torch.Tensor, inv: torch.Tensor
               ) -> Tuple[int, int, int, int, int]:
    """``(B, S, H, D, positions' batch stride)`` of a rotary embedding the
    kernel takes; raises on anything else (every check of :func:`rope` but
    the device's)."""
    if x.dtype not in _TYPES or positions.dtype not in _POSITION_TYPES or \
            inv.dtype != torch.float32:
        raise TypeError(f"x {x.dtype}, positions {positions.dtype}, inv "
                        f"{inv.dtype}: need float32 or bfloat16 x, int32 or "
                        "int64 positions, float32 frequencies")
    if x.dim() != 4 or x.shape[-1] % 2:
        raise ValueError(f"x {tuple(x.shape)}: need (B, S, H, D), D even")
    B, S, H, D = x.shape
    if tuple(inv.shape) != (D // 2,):
        raise ValueError(f"inv {tuple(inv.shape)}: need ({D // 2},)")
    if positions.dim() == 1 and positions.shape[0] == S:
        batch_stride = 0
    elif positions.dim() == 2 and positions.shape[1] == S and \
            positions.shape[0] in (1, B):
        batch_stride = S if positions.shape[0] == B and B > 1 else 0
    else:
        raise ValueError(f"positions {tuple(positions.shape)} for x "
                         f"{tuple(x.shape)}: need ({S},) or ({B}, {S})")
    if not (x.is_contiguous() and positions.is_contiguous()
            and inv.is_contiguous()):
        raise ValueError("rope: x, positions and inv must be contiguous")
    return B, S, H, D, batch_stride


def rope(x: torch.Tensor, positions: torch.Tensor, inv: torch.Tensor
         ) -> torch.Tensor:
    """Rotary embedding of ``x`` ``(B, S, H, D)`` at ``positions`` ``(S,)``
    or ``(B, S)`` (a batch of 1 serves every row) with the inverse
    frequencies ``inv`` ``(D/2,)`` float32: one kernel launch (CUDA tensors
    only; raises for anything else).  ``x`` contiguous, float32 or
    bfloat16, D even; positions contiguous int32 or int64.  Returns a new
    tensor of ``x``'s shape and type."""
    build.require_cuda(x, positions, inv)
    B, S, H, D, batch_stride = rope_shape(x, positions, inv)
    y = torch.empty_like(x)
    if x.numel() == 0:               # nothing to launch, nothing counted
        return y
    with torch.cuda.device(x.device):
        err = _entry("rope_launch")(
            x.data_ptr(), positions.data_ptr(), inv.data_ptr(), y.data_ptr(),
            int(x.dtype == torch.bfloat16),
            int(positions.dtype == torch.int64), B, S, H, D, batch_stride,
            torch.cuda.current_stream().cuda_stream)
    _raise_on_error(err, f"rope (B={B}, S={S}, H={H}, D={D})")
    launch_counts["rope"] += 1
    return y
