"""Mamba-2 SSD chunked scan kernel of the serving path for NVIDIA Hopper.

Replaces the Pallas kernel of the JAX package's ``repro/kernels/ssd_scan.py``
(``_kernel``, entry ``ssd_chunked_pallas``) with :func:`ssd_chunked`, CUDA
C++ in ``csrc/ssd_scan.cu``, built by :mod:`.build` at first use.

Two kernels, picked by the inputs' type:

* **bfloat16** (the serving path) -- on the tensor cores
  (``mma.sync.m16n8k16``).  What bounds it on the card: bytes (~110 MB at
  the path's width-8 prefill, 0.033 ms, against 27 GFLOP, 0.028 ms at the
  bf16 rate).  A block takes one row, a tile of :func:`head_tile` heads
  (2 when B and C are one group's stride-0 view and the grid still fills
  the card, else 1) and 32 columns of P, and walks the chunks in order with
  its slice of the state in the accumulators of 4 warps.  For each 64-row
  l-tile of a chunk the s-tiles ``s <= l`` stream through a 2-stage
  ``cp.async`` ring in bf16; ``C B^T`` of a pair is formed once for the
  head tile; ``M = C B^T . decay . dt`` is built in registers (off the
  diagonal from a row and a column factor of the decay, ~Q exponentials a
  head a chunk; on it by a select, ``exp`` only where ``s <= l``) and
  multiplied into ``y``; the state update rides on the diagonal pair.  The
  float32 operands of the products (M, the carried state, the weighted
  ``x``) go in as bf16 ``hi + lo`` pairs, ``x``, B and C as they are.
* **float32** -- the SIMT kernel, plain float32 FMAs (TF32 would miss the
  reference's 1e-4): one block per (row, head), the ``P x N`` state in
  shared memory, 64-row tiles of the chunk, tiles above the diagonal
  skipped, the masked half a select.

Both read ``x``, ``B`` and ``C`` through their strides, so ``B`` and ``C``
may be one group's projection viewed over every head with a stride of 0,
and ``x`` a view into the convolution's output -- no copy is made.

Beside the kernel stands its plain PyTorch version
(:func:`ssd_chunked_plain`, the chunked oracle of
:func:`repro_torch.kernels.ref.ssd_chunked_ref`).  The wrapper takes the
plain version only for tensors that lie on the CPU; for CUDA tensors it
launches the kernel or raises.  ``launch_counts`` and ``plain_counts``
record which way each call went.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

#: kernel launches per wrapper, bumped where the kernel is launched
launch_counts: Dict[str, int] = {"ssd_chunked": 0}
#: plain-version calls (any caller, any device)
plain_counts: Dict[str, int] = {"ssd_chunked_plain": 0}
#: launches by kernel: ``bf16_mma`` (tensor cores), ``f32_simt``
variant_counts: Dict[str, int] = {"bf16_mma": 0, "f32_simt": 0}
#: calls of the training backward (``ops.SsdChunkedFn.backward``: the
#: chunked oracle recomputed and differentiated, no kernel of its own)
backward_counts: Dict[str, int] = {"ssd_chunked_bwd": 0}

MAX_HEAD_DIM = 64            # P: the SIMT kernel's 16 x 16 thread grid
MAX_STATE = 128              # N: ... and the state rows it walks
MAX_CHUNK = 4096             # Q: the chunk's arrays share the block's
                             # shared memory with the tiles
P_TILE = 32                  # columns of P a block of it takes


def reset_counts() -> None:
    for d in (launch_counts, plain_counts, variant_counts, backward_counts):
        for k in d:
            d[k] = 0


def head_tile(b: int, H: int, P: int, shared_bc: bool, sms: int) -> int:
    """Heads a block of the tensor-core kernel takes: 2 when ``B`` and ``C``
    are one group's projection over every head (head stride 0: one ``C
    B^T`` serves both) and the grid of ``b * ceil(H / 2) * ceil(P / 32)``
    blocks still puts one on each of the card's ``sms`` multiprocessors,
    else 1."""
    if shared_bc and b * -(-H // 2) * -(-P // P_TILE) >= sms:
        return 2
    return 1


def ssd_chunked_plain(x, dt, a_log_decay, B, C, *, chunk: int,
                      initial_state: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`ssd_chunked`: the chunked oracle."""
    plain_counts["ssd_chunked_plain"] += 1
    return _ref.ssd_chunked_ref(x, dt, a_log_decay, B, C, chunk,
                                initial_state=initial_state)


_ENTRY = []


def _entry():
    """The library's C entry with its argument types set (the library is
    built at the first call)."""
    if not _ENTRY:
        fn = build.load_library("ssd_scan").ssd_chunked_launch
        P_, I_ = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P_, P_, P_, P_, P_, P_, P_, P_, I_, I_, I_, I_, I_,
                       I_, I_, ctypes.POINTER(ctypes.c_longlong), I_, P_]
        fn.restype = ctypes.c_int
        _ENTRY.append(fn)
    return _ENTRY[0]


def _check(x, dt, a_log_decay, B, C, chunk, initial_state):
    if x.dim() != 4:
        raise ValueError(f"x {tuple(x.shape)}: need (b, L, H, P)")
    b, L, H, P = x.shape
    if tuple(dt.shape) != (b, L, H) or tuple(a_log_decay.shape) != (b, L, H):
        raise ValueError(f"dt {tuple(dt.shape)}, a {tuple(a_log_decay.shape)}"
                         f": need {(b, L, H)}")
    if B.dim() != 4 or tuple(B.shape[:3]) != (b, L, H) or \
            tuple(C.shape) != tuple(B.shape):
        raise ValueError(f"B {tuple(B.shape)}, C {tuple(C.shape)}: need "
                         f"{(b, L, H)} + (N,)")
    N = B.shape[-1]
    if initial_state is not None and \
            tuple(initial_state.shape) != (b, H, P, N):
        raise ValueError(f"initial_state {tuple(initial_state.shape)}: need "
                         f"{(b, H, P, N)}")
    if chunk <= 0 or L % chunk:
        raise ValueError(f"L={L} is not a multiple of chunk={chunk}")
    return b, L, H, P, N


def ssd_chunked(x, dt, a_log_decay, B, C, *, chunk: int,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 chunked SSD scan (the contract of
    :func:`repro_torch.kernels.ref.ssd_chunked_ref`).

    x ``(b, L, H, P)`` float32 or bfloat16; dt, a_log_decay ``(b, L, H)``;
    B, C ``(b, L, H, N)`` of x's type (any strides with a contiguous last
    axis; a head stride of 0 is read as such); ``L % chunk == 0``;
    initial_state ``(b, H, P, N)`` or None (zeros).  Returns ``(y (b, L, H,
    P) in x's type, final state (b, H, P, N) float32)``.  CUDA tensors go to
    the kernel, CPU tensors to the plain version.  The bfloat16 kernel
    cuts the heads into tiles of :func:`head_tile`; a row's result does not
    depend on the cut."""
    b, L, H, P, N = _check(x, dt, a_log_decay, B, C, chunk, initial_state)
    if x.device.type == "cpu":
        return ssd_chunked_plain(x, dt, a_log_decay, B, C, chunk=chunk,
                                 initial_state=initial_state)
    args = [x, dt, a_log_decay, B, C]
    if initial_state is not None:
        args.append(initial_state)
    build.require_cuda(*args)
    if x.dtype not in (torch.float32, torch.bfloat16) or \
            B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"x/B/C dtypes {x.dtype}/{B.dtype}/{C.dtype}: need "
                        "one of float32 or bfloat16")
    if P > MAX_HEAD_DIM or N > MAX_STATE or chunk > MAX_CHUNK:
        raise ValueError(f"P={P}, N={N}, chunk={chunk}: the kernel takes P <= "
                         f"{MAX_HEAD_DIM}, N <= {MAX_STATE}, chunk <= "
                         f"{MAX_CHUNK}")
    x, B, C = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, B, C))
    bf16 = x.dtype == torch.bfloat16
    shared_bc = B.stride(2) == 0 and C.stride(2) == 0
    ht = head_tile(b, H, P, shared_bc, torch.cuda.get_device_properties(
        x.device).multi_processor_count) if bf16 else 1
    dt, a = dt.float(), a_log_decay.float()
    h0 = None if initial_state is None else \
        initial_state.float().contiguous()
    y = torch.empty((b, L, H, P), dtype=x.dtype, device=x.device)
    h = torch.empty((b, H, P, N), dtype=torch.float32, device=x.device)
    if b * H == 0 or L == 0:              # nothing to launch, nothing counted
        return y, (h.zero_() if h0 is None else h.copy_(h0))
    strides = (ctypes.c_longlong * 15)(*(
        s for t in (x, dt, a, B, C) for s in t.stride()[:3]))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), B.data_ptr(),
            C.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
            h.data_ptr(), int(bf16), b, L, H, P, N, chunk, strides, ht,
            stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunked: CUDA error {err} at launch (b={b}, "
                           f"L={L}, H={H}, P={P}, N={N}, chunk={chunk}, "
                           f"head_tile={ht})")
    launch_counts["ssd_chunked"] += 1
    variant_counts["bf16_mma" if bf16 else "f32_simt"] += 1
    return y, h
