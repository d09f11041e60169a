"""Paged-attention kernels of the serving path for NVIDIA Hopper.

Replaces the two Pallas kernels of the JAX package's
``repro/kernels/paged_attention.py``: ``_decode_kernel`` (entry
``paged_attention_decode_pallas``) becomes :func:`paged_attention_decode`,
``_scatter_kernel`` (entry ``paged_prefill_scatter_pallas``) becomes
:func:`paged_prefill_scatter`.  Both kernels are CUDA C++ in
``csrc/paged_attention.cu``, built by :mod:`.build` at first use.

What bounds them on the card, and what the design does about it:

* **decode** is bound by bytes: every page a row's table names is read, K
  and V tiles of ``P x D`` bf16 per kv head, plus the page's positions.  One
  block per (row, kv head), one warp per query head of the group: a tile is
  staged in shared memory once and scored by all ``H / Hkv`` query heads.
  The row's pages are walked two buffers deep -- the next page's tiles are
  in flight (16-byte asynchronous copies; head sizes are multiples of 8 in
  every config, and the wrapper raises for any other) while one is scored,
  and page ids are read from the table inside the kernel, one page ahead.  Online softmax across pages in float32; invalid
  keys get the reference's -1e30 additive bias (not skipped), so an
  all-masked row averages uniformly like the full softmax of the oracle.
  Deterministic (no atomics); the output depends on page content reached
  through the table, never on physical page ids.
* **scatter** is bound by bytes: the values are read once and the named
  pages written once, eight elements a thread, cast by round-to-nearest-even
  -- bit-exact with ``index_copy_`` of ``values.to(torch.bfloat16)``.  It
  writes in place; pages the list does not name are never touched.  A page
  holds ``P * Hkv * D`` elements, a multiple of 8 in every config.

Beside each kernel stands its plain PyTorch version
(:func:`paged_attention_decode_plain`, the dense-gather oracle operation for
operation; :func:`paged_prefill_scatter_plain`, ``index_copy_``).  A wrapper
takes the plain version only for tensors that lie on the CPU; for CUDA
tensors it launches the kernel or raises.  ``launch_counts`` and
``plain_counts`` record which way each call went.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

#: kernel launches per wrapper, bumped where the kernel is launched
launch_counts: Dict[str, int] = {"paged_attention_decode": 0,
                                 "paged_prefill_scatter": 0}
#: plain-version calls per function (any caller, any device)
plain_counts: Dict[str, int] = {"paged_attention_decode_plain": 0,
                                "paged_prefill_scatter_plain": 0}

MAX_HEAD_DIM = 256           # the decode kernel keeps D/32 values per lane
MAX_GROUP = 32               # query heads per kv head: one warp each


def reset_counts() -> None:
    for d in (launch_counts, plain_counts):
        for k in d:
            d[k] = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def paged_attention_decode_plain(q, k_pool, v_pool, pos_pool, page_table,
                                 positions, *, window: Optional[int] = None
                                 ) -> torch.Tensor:
    """Plain PyTorch version of :func:`paged_attention_decode`: the
    dense-gather full softmax of :func:`repro_torch.kernels.ref.
    paged_attention_decode_ref`."""
    plain_counts["paged_attention_decode_plain"] += 1
    return _ref.paged_attention_decode_ref(q, k_pool, v_pool, page_table,
                                           positions, pos_pool=pos_pool,
                                           window=window)


def paged_prefill_scatter_plain(pool, pages, values) -> torch.Tensor:
    """Plain PyTorch version of :func:`paged_prefill_scatter`: in-place
    ``pool[:, pages[j]] = values[:, j].to(pool.dtype)``; returns ``pool``."""
    plain_counts["paged_prefill_scatter_plain"] += 1
    pool.index_copy_(1, pages.long(), values.to(pool.dtype))
    return pool


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------
_ENTRIES: Dict[str, ctypes._CFuncPtr] = {}


def _entry(name: str, argtypes):
    """The library's C entry ``name`` with its argument types set (the
    library is built at the first call)."""
    fn = _ENTRIES.get(name)
    if fn is None:
        fn = getattr(build.load_library("paged_attention"), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _ENTRIES[name] = fn
    return fn


_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
_DECODE_ARGS = [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                _F, _P]
_SCATTER_ARGS = [_P, _P, _P, _I, _I, _I, _L, _L, _L, _P]


def _check_decode(q, k_pool, v_pool, pos_pool, page_table, positions):
    if q.dim() != 3 or k_pool.dim() != 4 or tuple(v_pool.shape) != tuple(
            k_pool.shape):
        raise ValueError("need q (C, H, D) and k_pool/v_pool (NP, P, Hkv, D)")
    C, H, D = q.shape
    NP, P, Hkv, Dk = k_pool.shape
    if Dk != D or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit pools "
                         f"{tuple(k_pool.shape)}")
    if tuple(pos_pool.shape) != (NP, P):
        raise ValueError(f"pos_pool {tuple(pos_pool.shape)}: need {(NP, P)}")
    if page_table.dim() != 2 or page_table.shape[0] != C:
        raise ValueError(f"page_table {tuple(page_table.shape)}: need (C, NB)")
    if tuple(positions.shape) != (C,):
        raise ValueError(f"positions {tuple(positions.shape)}: need ({C},)")
    return C, H, D, NP, P, Hkv, page_table.shape[1]


def paged_attention_decode(q, k_pool, v_pool, pos_pool, page_table,
                           positions, *, window: Optional[int] = None
                           ) -> torch.Tensor:
    """Single-token GQA decode read against a paged KV pool.

    q ``(C, H, D)`` float32 or bfloat16, already roped; k_pool/v_pool
    ``(NP, P, Hkv, D)`` bfloat16 (this step's K/V already written);
    pos_pool ``(NP, P)`` int32 absolute positions (``POS_SENTINEL`` marks
    an empty entry); page_table ``(C, NB)`` int32; positions ``(C,)`` int32
    absolute position of each row's new token; ``window`` the sliding
    window or None.  Returns ``(C, H, D)`` float32.  CUDA tensors go to the
    kernel, CPU tensors to the plain version."""
    C, H, D, NP, P, Hkv, NB = _check_decode(q, k_pool, v_pool, pos_pool,
                                            page_table, positions)
    if q.device.type == "cpu":
        return paged_attention_decode_plain(q, k_pool, v_pool, pos_pool,
                                            page_table, positions,
                                            window=window)
    build.require_cuda(q, k_pool, v_pool, pos_pool, page_table, positions)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q dtype {q.dtype}: need float32 or bfloat16")
    if k_pool.dtype != torch.bfloat16 or v_pool.dtype != torch.bfloat16:
        raise TypeError(f"pool dtype {k_pool.dtype}/{v_pool.dtype}: need "
                        "bfloat16")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("k_pool/v_pool must be contiguous")
    if D > MAX_HEAD_DIM or D % 8 or H // Hkv > MAX_GROUP:
        raise ValueError(f"D={D}, group {H // Hkv}: the kernel takes D a "
                         f"multiple of 8 up to {MAX_HEAD_DIM} and <= "
                         f"{MAX_GROUP} query heads per kv head")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("k_pool/v_pool must be 16-byte aligned")
    q = q.contiguous()
    pos_pool = pos_pool.to(torch.int32).contiguous()
    page_table = page_table.to(torch.int32).contiguous()
    positions = positions.to(torch.int32).contiguous()
    out = torch.empty((C, H, D), dtype=torch.float32, device=q.device)
    if C == 0:
        return out                     # nothing to launch, nothing counted
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry("paged_attention_decode_launch", _DECODE_ARGS)(
            q.data_ptr(), int(q.dtype == torch.bfloat16), k_pool.data_ptr(),
            v_pool.data_ptr(), pos_pool.data_ptr(), page_table.data_ptr(),
            positions.data_ptr(), out.data_ptr(), C, NB, P, Hkv, D, H // Hkv,
            -1 if window is None else int(window), 1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"paged_attention_decode: CUDA error {err} at "
                           f"launch (C={C}, H={H}, Hkv={Hkv}, D={D}, P={P}, "
                           f"NB={NB})")
    launch_counts["paged_attention_decode"] += 1
    return out


def paged_prefill_scatter(pool, pages, values) -> torch.Tensor:
    """Write prefill KV blocks into their allocated pages, in place.

    pool ``(S, NP, P, Hkv, D)`` bfloat16; pages ``(nb,)`` int32 distinct
    non-reserved page ids; values ``(S, nb, P, Hkv, D)`` float32 or bfloat16.
    Afterwards ``pool[:, pages[j]] == values[:, j].to(pool.dtype)`` and
    every other page is bit-untouched; returns ``pool``.  CUDA tensors go to
    the kernel, CPU tensors to the plain version."""
    if pool.dim() != 5 or values.dim() != 5 or pages.dim() != 1:
        raise ValueError("need pool (S, NP, P, Hkv, D), pages (nb,), values "
                         "(S, nb, P, Hkv, D)")
    S, NP, P, Hkv, D = pool.shape
    nb = pages.shape[0]
    if tuple(values.shape) != (S, nb, P, Hkv, D):
        raise ValueError(f"values {tuple(values.shape)}: need "
                         f"{(S, nb, P, Hkv, D)}")
    if pool.device.type == "cpu":
        return paged_prefill_scatter_plain(pool, pages, values)
    build.require_cuda(pool, pages, values)
    if pool.dtype != torch.bfloat16:
        raise TypeError(f"pool dtype {pool.dtype}: need bfloat16")
    if values.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"values dtype {values.dtype}: need float32 or "
                        "bfloat16")
    E = P * Hkv * D
    # each stage's block of pages must be contiguous and 16-byte aligned
    # (the kernel moves 8 elements a thread); the stage axis may be strided
    # (a row sliced out of a batched prefill)
    if (pool.stride()[1:] != (E, Hkv * D, D, 1) or E % 8
            or pool.stride(0) % 8 or pool.data_ptr() % 16):
        raise ValueError("pool must be contiguous and 16-byte aligned within "
                         "each stage, with P * Hkv * D a multiple of 8")
    if (values.stride()[1:] != (E, Hkv * D, D, 1) or values.stride(0) % 8
            or values.data_ptr() % 16):
        values = values.contiguous()
    pages = pages.to(torch.int32).contiguous()
    if S == 0 or nb == 0:
        return pool
    with torch.cuda.device(pool.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry("paged_prefill_scatter_launch", _SCATTER_ARGS)(
            pool.data_ptr(), pages.data_ptr(), values.data_ptr(),
            int(values.dtype == torch.bfloat16), S, nb, E, pool.stride(0),
            values.stride(0), stream)
    if err != 0:
        raise RuntimeError(f"paged_prefill_scatter: CUDA error {err} at "
                           f"launch (S={S}, nb={nb}, E={E})")
    launch_counts["paged_prefill_scatter"] += 1
    return pool
