"""Aggregate Risk Analysis kernels (paper Algorithm 3) for NVIDIA Hopper.

Replaces ``aggregate_loss_pallas`` of the JAX package
(``repro/kernels/aggregate_loss.py``): its body ``_kernel`` (variant
"gather") becomes :func:`aggregate_loss_gather`, its body ``_kernel_onehot``
(variant "onehot") becomes :func:`aggregate_loss_onehot`; both kernels are
CUDA C++ in ``csrc/aggregate_loss.cu``, built by :mod:`.build` at first use.

What bounds them on the card, and what the design does about it:

* **gather** is bound by memory traffic — 4 B of event id plus one ELT row
  per event, a random read.  A warp owns a trial; lanes read its ids
  coalesced and fetch each event's row straight from global memory.  With the
  table's columns padded to a multiple of 4 (15 -> 16: one aligned 64 B
  segment per row, see :func:`pad_elt_columns`) a row is up to four ``float4``
  loads and a lane keeps four events in flight; wider tables are walked in
  column groups of 16.  The kernel reads that layout only, so the wrapper
  asks for it.  No catalog tiling, no atomics, one shuffle reduction per
  trial: deterministic.
* **onehot** is bound by operations — ``T*K*rows*M`` multiply-adds.  A block
  owns a few trials and loops over catalog tiles staged in shared memory; the
  one-hot operand lives in registers (``local_id == r``) and the product is
  plain float32 FMA, exact for a one-hot operand.  Contract inherited from
  the replaced kernel: ``occ_ret >= 0``, so the zero loss vector of an event
  outside the tile contributes zero.  Its cost rules it out at the published
  size; it is kept as the gather-free alternative at small catalogs.

Both kernels mask ragged trial and event counts themselves (nothing is padded
by a copy) and let an id outside ``[0, rows)`` contribute 0 without reading
the table.

Beside each kernel stands its plain PyTorch version
(:func:`aggregate_loss_gather_plain`, :func:`aggregate_loss_onehot_plain`).
A wrapper takes the plain version only for tensors that lie on the CPU; for
CUDA tensors it launches the kernel or raises.  ``launch_counts`` and
``plain_counts`` record which way each call went.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import build

#: kernel launches per wrapper, bumped where the kernel is launched
launch_counts: Dict[str, int] = {"aggregate_loss_gather": 0,
                                 "aggregate_loss_onehot": 0}
#: plain-version calls per function (any caller, any device)
plain_counts: Dict[str, int] = {"aggregate_loss_gather_plain": 0,
                                "aggregate_loss_onehot_plain": 0}

# the onehot kernel's ELT tile lives in 48 KB of static-limit shared memory:
# rows_tile * 16 columns * 4 B
ONEHOT_MAX_ROWS_TILE = 768
ONEHOT_DEFAULT_ROWS_TILE = 256


def reset_counts() -> None:
    for d in (launch_counts, plain_counts):
        for k in d:
            d[k] = 0


def pad_elt_columns(elt_losses: torch.Tensor) -> torch.Tensor:
    """``(rows, M)`` view of a fresh zero-padded ``(rows, 4*ceil(M/4))``
    copy of the table, on the table's device.

    The view computes the same function as the table it was made from; what
    changes is the layout: every row starts on a 16 B boundary (M = 15 gives
    one 64 B segment), which is what the gather kernel's ``float4`` reads
    need.  Do it once per table, not per call."""
    rows, M = elt_losses.shape
    m4 = 4 * (-(-M // 4))
    buf = torch.zeros((rows, m4), dtype=torch.float32,
                      device=elt_losses.device)
    buf[:, :M].copy_(elt_losses)
    return buf[:, :M]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def _finish(acc: torch.Tensor, agg_ret: float, agg_lim: float) -> torch.Tensor:
    return torch.clamp(torch.clamp(acc - agg_ret, min=0.0), max=agg_lim)


def aggregate_loss_gather_plain(event_ids, elt_losses, occ_ret, occ_lim,
                                agg_ret, agg_lim, chunk: int = 128,
                                trial_block: int = 32768) -> torch.Tensor:
    """Plain PyTorch version of :func:`aggregate_loss_gather`.

    Walks the event axis in ``chunk``-sized steps (the last may be short) and
    the trial axis in ``trial_block``-sized blocks, so the ``(trials, chunk,
    M)`` intermediate stays bounded at any table size.  An id outside
    ``[0, rows)`` contributes 0."""
    plain_counts["aggregate_loss_gather_plain"] += 1
    T, K = event_ids.shape
    rows = elt_losses.shape[0]
    elt = elt_losses.float()
    out = torch.empty(T, dtype=torch.float32, device=event_ids.device)
    chunk = max(1, min(chunk, K))
    for t0 in range(0, T, trial_block):
        ids_b = event_ids[t0:t0 + trial_block]
        acc = torch.zeros(ids_b.shape[0], dtype=torch.float32,
                          device=event_ids.device)
        for c0 in range(0, K, chunk):
            ids = ids_b[:, c0:c0 + chunk].long()
            valid = (ids >= 0) & (ids < rows)
            g = elt[torch.where(valid, ids, torch.zeros_like(ids))]
            occ = torch.minimum(torch.clamp(g - occ_ret, min=0.0), occ_lim)
            acc += (occ.sum(dim=-1) * valid).sum(dim=-1)
        out[t0:t0 + trial_block] = _finish(acc, agg_ret, agg_lim)
    return out


def aggregate_loss_onehot_plain(event_ids, elt_losses, occ_ret, occ_lim,
                                agg_ret, agg_lim, chunk: int = 128,
                                rows_tile: Optional[int] = None,
                                trial_block: int = 256) -> torch.Tensor:
    """Plain PyTorch version of :func:`aggregate_loss_onehot`: the same loop
    over catalog tiles and event chunks, the one-hot operand materialised and
    multiplied with ``torch.matmul``.  An id outside the tile yields an
    all-zero one-hot row; requires ``occ_ret >= 0``."""
    plain_counts["aggregate_loss_onehot_plain"] += 1
    T, K = event_ids.shape
    rows, M = elt_losses.shape
    rows_tile = _rows_tile(rows, rows_tile)
    elt = elt_losses.float()
    dev = event_ids.device
    out = torch.empty(T, dtype=torch.float32, device=dev)
    chunk = max(1, min(chunk, K))
    cols = torch.arange(rows_tile, device=dev)
    for t0 in range(0, T, trial_block):
        ids_b = event_ids[t0:t0 + trial_block]
        acc = torch.zeros(ids_b.shape[0], dtype=torch.float32, device=dev)
        for base in range(0, rows, rows_tile):
            tile = torch.zeros((rows_tile, M), dtype=torch.float32, device=dev)
            n = min(rows_tile, rows - base)
            tile[:n] = elt[base:base + n]
            for c0 in range(0, K, chunk):
                local = ids_b[:, c0:c0 + chunk].long() - base     # (tb, c)
                onehot = (local.reshape(-1, 1) == cols).float()   # (tb*c, rt)
                g = (onehot @ tile).reshape(*local.shape, M)
                occ = torch.minimum(torch.clamp(g - occ_ret, min=0.0),
                                    occ_lim)
                acc += occ.sum(dim=(1, 2))
        out[t0:t0 + trial_block] = _finish(acc, agg_ret, agg_lim)
    return out


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------
def _rows_tile(rows: int, rows_tile: Optional[int]) -> int:
    rt = ONEHOT_DEFAULT_ROWS_TILE if rows_tile is None else rows_tile
    rt = min(rt, rows)
    if not 1 <= rt <= ONEHOT_MAX_ROWS_TILE:
        raise ValueError(f"rows_tile={rows_tile}: must be in "
                         f"[1, {ONEHOT_MAX_ROWS_TILE}]")
    return rt


def _check(event_ids, elt_losses, occ_ret, occ_lim, chunk):
    """Validate the arguments shared by both wrappers; returns
    ``(T, K, rows, M, chunk)`` with ``chunk`` clipped to ``[1, K]``."""
    if event_ids.dim() != 2 or elt_losses.dim() != 2:
        raise ValueError("event_ids must be (T, K) and elt_losses (rows, M)")
    T, K = event_ids.shape
    rows, M = elt_losses.shape
    if rows < 1 or M < 1:
        raise ValueError(f"empty ELT table {tuple(elt_losses.shape)}")
    if event_ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"event_ids dtype {event_ids.dtype}: need int32/int64")
    for name, t in (("occ_ret", occ_ret), ("occ_lim", occ_lim)):
        if tuple(t.shape) != (M,):
            raise ValueError(f"{name} shape {tuple(t.shape)}: need ({M},)")
    devs = {t.device for t in (event_ids, elt_losses, occ_ret, occ_lim)}
    if len(devs) != 1:
        raise ValueError(f"arguments on different devices: {sorted(map(str, devs))}")
    if chunk < 1:
        raise ValueError(f"chunk={chunk}: must be positive")
    return T, K, rows, M, max(1, min(chunk, K))


def _cuda_operands(event_ids, elt_losses, occ_ret, occ_lim):
    """What the C entries take: contiguous int32 ids, float32 table with unit
    column stride, contiguous float32 terms -- all on a CUDA device."""
    if event_ids.device.type != "cuda":
        raise RuntimeError(f"tensors on {event_ids.device}: the kernel runs "
                           "on CUDA tensors only")
    ids = event_ids.to(torch.int32).contiguous()
    elt = elt_losses if elt_losses.dtype == torch.float32 else elt_losses.float()
    if elt.stride(1) != 1 or elt.stride(0) < elt.shape[1]:
        elt = elt.contiguous()
    return (ids, elt, occ_ret.float().contiguous(),
            occ_lim.float().contiguous())


def _require_padded_rows(elt: torch.Tensor) -> None:
    """The gather kernel reads rows as ``float4``: 16 B aligned rows of
    ``4*ceil(M/4)`` readable floats inside the tensor's own storage, which is
    what :func:`pad_elt_columns` returns."""
    rows, M = elt.shape
    m4 = 4 * (-(-M // 4))
    stride = elt.stride(0)
    covered = (elt.storage_offset() + (rows - 1) * stride + m4
               <= elt.untyped_storage().nbytes() // elt.element_size())
    if not (stride % 4 == 0 and stride >= m4 and elt.data_ptr() % 16 == 0
            and covered):
        raise ValueError(
            f"aggregate_loss_gather: ELT {tuple(elt.shape)} with row stride "
            f"{stride} is not laid out for float4 row reads; pass "
            "pad_elt_columns(elt_losses), made once per table")


_PTR = ctypes.c_void_p
_COMMON_ARGS = [_PTR, _PTR, _PTR, _PTR, ctypes.c_float, ctypes.c_float, _PTR,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int]


def _entry(name: str, n_extra: int):
    """The C entry ``name`` of the built library: the common arguments up to
    ``chunk``, ``n_extra`` ints of its own, then the stream."""
    fn = getattr(build.load_library("aggregate_loss"), name)
    fn.argtypes = _COMMON_ARGS + [ctypes.c_int] * n_extra + [_PTR]
    fn.restype = ctypes.c_int
    return fn


def _launch(entry: str, counter: str, ids, elt, ret, lim, agg_ret, agg_lim,
            T, K, rows, M, chunk, *extra: int) -> torch.Tensor:
    out = torch.empty(T, dtype=torch.float32, device=ids.device)
    if T == 0:
        return out                     # nothing to launch, nothing counted
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry(entry, len(extra))(
            ids.data_ptr(), elt.data_ptr(), ret.data_ptr(), lim.data_ptr(),
            float(agg_ret), float(agg_lim), out.data_ptr(), T, K, M,
            elt.stride(0), rows, chunk, *extra, stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err} at launch "
                           f"(T={T}, K={K}, M={M}, rows={rows})")
    launch_counts[counter] += 1
    return out


def aggregate_loss_gather(event_ids, elt_losses, occ_ret, occ_lim, agg_ret,
                          agg_lim, chunk: int = 128) -> torch.Tensor:
    """Year loss per trial, ELT rows gathered from global memory.

    event_ids ``(T, K)`` int32 (int64 is converted), elt_losses ``(rows, M)``
    float32 (row 0 the zero pad event; on a CUDA device in the row layout of
    :func:`pad_elt_columns`, else the call raises), occ_ret /
    occ_lim ``(M,)`` float32, agg_ret / agg_lim Python numbers passed to the
    kernel by value.  Returns ``(T,)`` float32 on the inputs' device.  CUDA
    tensors go to the kernel, CPU tensors to the plain version."""
    T, K, rows, M, chunk = _check(event_ids, elt_losses, occ_ret, occ_lim,
                                  chunk)
    if event_ids.device.type == "cpu":
        return aggregate_loss_gather_plain(event_ids, elt_losses, occ_ret,
                                           occ_lim, float(agg_ret),
                                           float(agg_lim), chunk=chunk)
    ids, elt, ret, lim = _cuda_operands(event_ids, elt_losses, occ_ret,
                                        occ_lim)
    _require_padded_rows(elt)
    return _launch("aggregate_loss_gather_launch", "aggregate_loss_gather",
                   ids, elt, ret, lim, agg_ret, agg_lim, T, K, rows, M,
                   chunk)


def aggregate_loss_onehot(event_ids, elt_losses, occ_ret, occ_lim, agg_ret,
                          agg_lim, chunk: int = 128,
                          rows_tile: Optional[int] = None) -> torch.Tensor:
    """Year loss per trial, gather-free: per catalog tile of ``rows_tile``
    rows the local ids form a one-hot operand that multiplies the tile.

    Same arguments and result as :func:`aggregate_loss_gather`.  Requires
    ``occ_ret >= 0`` (a zero loss vector must contribute zero).  Work grows
    with ``T*K*rows*M``: meant for small catalogs."""
    T, K, rows, M, chunk = _check(event_ids, elt_losses, occ_ret, occ_lim,
                                  chunk)
    rt = _rows_tile(rows, rows_tile)
    if event_ids.device.type == "cpu":
        return aggregate_loss_onehot_plain(event_ids, elt_losses, occ_ret,
                                           occ_lim, float(agg_ret),
                                           float(agg_lim), chunk=chunk,
                                           rows_tile=rt)
    ids, elt, ret, lim = _cuda_operands(event_ids, elt_losses, occ_ret,
                                        occ_lim)
    return _launch("aggregate_loss_onehot_launch", "aggregate_loss_onehot",
                   ids, elt, ret, lim, agg_ret, agg_lim, T, K, rows, M,
                   chunk, rt)
