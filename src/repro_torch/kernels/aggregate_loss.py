"""Aggregate Risk Analysis kernels (paper Algorithm 3) for NVIDIA Hopper.

Replaces ``aggregate_loss_pallas`` of the JAX package
(``repro/kernels/aggregate_loss.py``): its body ``_kernel`` (variant
"gather") becomes :func:`aggregate_loss_gather`, its body ``_kernel_onehot``
(variant "onehot") becomes :func:`aggregate_loss_onehot`; both kernels are
CUDA C++ in ``csrc/aggregate_loss.cu``, built by :mod:`.build` at first use.

What bounds them on the card, and what the design does about it:

* **gather** is bound by memory traffic.  An event's row enters only
  through its clipped sum ``f[r] = sum_m min(max(ELT[r, m] - occ_ret[m], 0),
  occ_lim[m])``, so each call runs two kernels: a row pass writes ``f``
  (2,000,001 floats, 8 MB at the published size, which L2 holds) from the
  table in its :func:`pad_elt_columns` layout (one aligned 64 B segment a
  row at M = 15), a row's columns summed four at a time, in order; then a
  trial pass streams the ids once (coalesced, evict-first), gathers
  ``f[id]`` and adds each lane's events in ascending order.  At M <= 16
  that is, bit for bit, what a single pass fetching every event's 64 B row
  and summing it the same way gives, from ~2 GB of reads where that pass
  makes ~34 GB.  ``f`` is scratch of each call, never cached.  A warp owns
  a trial; no atomics, one shuffle reduction per trial: deterministic.
* **onehot** is bound by bytes too: the ids, read once per catalog tile.
  The replaced body multiplies every event's one-hot row with the ELT tile
  (``T*K*rows*M`` multiply-adds).  Summed over a trial's events the one-hot
  rows are the trial's event histogram, and since a one-hot row picks one
  table row and ``occ_ret >= 0``, the clipping commutes with the product:
  ``acc[t] = counts[t] . f``, ``f`` the gather's row losses.  So a call runs
  the row pass (a table not laid out by :func:`pad_elt_columns` is padded
  first, a copy of ``rows x 4*ceil(M/4)`` floats), then one kernel: a block
  holds the 16-bit event counts of 8 trials over a catalog tile of up to
  :data:`ONEHOT_MAX_ROWS_TILE` rows in shared memory, fills them with one
  shared-memory atomic per in-tile id, and forms ``counts . f`` in float32
  FMAs.  Catalogs wider than a tile take more tiles,
  the ids read once per tile; at the published 2,000,001-row catalog that is
  140 reads of the ids, which is what ``gather`` avoids.

Both kernels mask ragged trial and event counts themselves (nothing is padded
by a copy) and let an id outside ``[0, rows)`` contribute 0 without reading
the table.

Beside each kernel stands its plain PyTorch version
(:func:`aggregate_loss_gather_plain`, :func:`aggregate_loss_onehot_plain` --
the replaced body's one-hot product, kept as the oracle -- and
:func:`aggregate_row_losses_plain` for the row pass that both variants run).
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
                                 "aggregate_row_losses": 0,
                                 "aggregate_loss_onehot": 0}
#: plain-version calls per function (any caller, any device)
plain_counts: Dict[str, int] = {"aggregate_loss_gather_plain": 0,
                                "aggregate_row_losses_plain": 0,
                                "aggregate_loss_onehot_plain": 0}

# the onehot kernel's catalog tile: 8 trials' 16-bit counts of up to this
# many rows fill 224 KB of an H100 block's 227 KB of shared memory
ONEHOT_MAX_ROWS_TILE = 14336
# a trial's count of one row lives in 16 bits
ONEHOT_MAX_EVENTS = 65535


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


def aggregate_row_losses_plain(elt_losses, occ_ret, occ_lim) -> torch.Tensor:
    """Plain PyTorch version of the gather's row pass: ``f[r] = sum_m
    min(max(ELT[r, m] - occ_ret[m], 0), occ_lim[m])`` as ``(rows,)``
    float32, summed in the kernel's order -- four columns at a time, each
    group's four terms left to right, the groups left to right, and tables
    wider than 16 columns one group of 16 after another -- so it equals the
    kernel bit for bit."""
    plain_counts["aggregate_row_losses_plain"] += 1
    rows, M = elt_losses.shape
    m4 = 4 * (-(-M // 4))
    occ = torch.minimum(torch.clamp(elt_losses.float() - occ_ret.float(),
                                    min=0.0), occ_lim.float())
    # padding columns get a zero term, as in the kernel
    occ = torch.nn.functional.pad(occ, (0, m4 - M)).reshape(rows, m4 // 4, 4)
    four = ((occ[..., 0] + occ[..., 1]) + occ[..., 2]) + occ[..., 3]
    total = None
    for g0 in range(0, m4 // 4, 4):          # column groups of 16
        s = four[:, g0]
        for v in range(g0 + 1, min(g0 + 4, m4 // 4)):
            s = s + four[:, v]
        total = s if total is None else total + s
    return total.contiguous()


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
                                trial_block: Optional[int] = None
                                ) -> torch.Tensor:
    """Plain PyTorch version of :func:`aggregate_loss_onehot`, the replaced
    Pallas body line for line: per catalog tile and event chunk the one-hot
    operand is materialised and multiplied with the tile by
    ``torch.matmul``.  An id outside the tile yields an all-zero one-hot
    row; requires ``occ_ret >= 0``.  Trials go ``trial_block`` at a time (by
    default as many as keep the one-hot operand at 2^24 elements)."""
    plain_counts["aggregate_loss_onehot_plain"] += 1
    T, K = event_ids.shape
    rows, M = elt_losses.shape
    rows_tile = _rows_tile(rows, rows_tile)
    elt = elt_losses.float()
    dev = event_ids.device
    out = torch.empty(T, dtype=torch.float32, device=dev)
    chunk = max(1, min(chunk, K))
    if trial_block is None:
        trial_block = max(1, (1 << 24) // (chunk * rows_tile))
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
    """The onehot catalog tile: ``rows_tile`` (by default the kernel's
    widest) as an upper bound, no wider than the catalog."""
    rt = ONEHOT_MAX_ROWS_TILE if rows_tile is None else rows_tile
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


def padded_rows(elt: torch.Tensor) -> bool:
    """Whether the row pass can read ``elt``'s rows as ``float4``: 16 B
    aligned rows of ``4*ceil(M/4)`` readable floats inside the tensor's own
    storage, which is what :func:`pad_elt_columns` returns."""
    rows, M = elt.shape
    m4 = 4 * (-(-M // 4))
    stride = elt.stride(0)
    covered = (elt.storage_offset() + (rows - 1) * stride + m4
               <= elt.untyped_storage().nbytes() // elt.element_size())
    return (stride % 4 == 0 and stride >= m4 and elt.data_ptr() % 16 == 0
            and covered)


def _require_padded_rows(elt: torch.Tensor) -> None:
    """The gather takes only a table in the layout of
    :func:`pad_elt_columns` (its row pass reads ``float4`` rows)."""
    if not padded_rows(elt):
        raise ValueError(
            f"aggregate_loss_gather: ELT {tuple(elt.shape)} with row stride "
            f"{elt.stride(0)} is not laid out for float4 row reads; pass "
            "pad_elt_columns(elt_losses), made once per table")


_PTR, _INT, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
# each C entry's arguments before the stream
_ARGTYPES = {
    "aggregate_row_losses_launch": [_PTR, _PTR, _PTR, _INT, _LL, _INT, _PTR],
    "aggregate_loss_gather_launch": [_PTR, _PTR, _F, _F, _PTR, _LL, _INT,
                                     _INT, _INT],
    "aggregate_loss_onehot_launch": [_PTR, _PTR, _F, _F, _PTR, _LL, _INT,
                                     _INT, _INT],
}


def _call(entry: str, counter: str, device, *args) -> None:
    """Launch C entry ``entry`` on the current stream of ``device``; raises
    on a launch error, counts the launch otherwise."""
    fn = getattr(build.load_library("aggregate_loss"), entry)
    fn.argtypes = _ARGTYPES[entry] + [_PTR]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err} at launch")
    launch_counts[counter] += 1


def aggregate_row_losses(elt_losses, occ_ret, occ_lim) -> torch.Tensor:
    """The gather's row pass: ``(rows,)`` float32 ``f[r] = sum_m
    min(max(ELT[r, m] - occ_ret[m], 0), occ_lim[m])``.  On a CUDA device the
    table must be in the layout of :func:`pad_elt_columns`; CPU tensors go
    to :func:`aggregate_row_losses_plain`."""
    rows, M = elt_losses.shape
    if elt_losses.device.type == "cpu":
        return aggregate_row_losses_plain(elt_losses, occ_ret, occ_lim)
    build.require_cuda(elt_losses, occ_ret, occ_lim)
    if elt_losses.dtype != torch.float32:
        raise TypeError(f"ELT dtype {elt_losses.dtype}: need float32 in the "
                        "layout of pad_elt_columns")
    _require_padded_rows(elt_losses)
    ret, lim = occ_ret.float().contiguous(), occ_lim.float().contiguous()
    f = torch.empty(rows, dtype=torch.float32, device=elt_losses.device)
    _call("aggregate_row_losses_launch", "aggregate_row_losses",
          elt_losses.device, elt_losses.data_ptr(), ret.data_ptr(),
          lim.data_ptr(), M, elt_losses.stride(0), rows, f.data_ptr())
    return f


def aggregate_loss_gather(event_ids, elt_losses, occ_ret, occ_lim, agg_ret,
                          agg_lim, chunk: int = 128) -> torch.Tensor:
    """Year loss per trial: the row pass, then the ids gathered from its
    row losses.

    event_ids ``(T, K)`` int32 (int64 is converted), elt_losses ``(rows, M)``
    float32 (row 0 the zero pad event; on a CUDA device in the row layout of
    :func:`pad_elt_columns`, else the call raises), occ_ret /
    occ_lim ``(M,)`` float32, agg_ret / agg_lim Python numbers passed to the
    kernel by value.  Returns ``(T,)`` float32 on the inputs' device.  CUDA
    tensors go to the two kernels (one count each), CPU tensors to the plain
    version."""
    T, K, rows, M, chunk = _check(event_ids, elt_losses, occ_ret, occ_lim,
                                  chunk)
    if event_ids.device.type == "cpu":
        return aggregate_loss_gather_plain(event_ids, elt_losses, occ_ret,
                                           occ_lim, float(agg_ret),
                                           float(agg_lim), chunk=chunk)
    ids, elt, ret, lim = _cuda_operands(event_ids, elt_losses, occ_ret,
                                        occ_lim)
    _require_padded_rows(elt)
    out = torch.empty(T, dtype=torch.float32, device=ids.device)
    if T == 0:
        return out                     # nothing to launch, nothing counted
    f = aggregate_row_losses(elt, ret, lim)
    _call("aggregate_loss_gather_launch", "aggregate_loss_gather",
          ids.device, ids.data_ptr(), f.data_ptr(), float(agg_ret),
          float(agg_lim), out.data_ptr(), T, K, rows, chunk)
    return out


def aggregate_loss_onehot(event_ids, elt_losses, occ_ret, occ_lim, agg_ret,
                          agg_lim, chunk: int = 128,
                          rows_tile: Optional[int] = None) -> torch.Tensor:
    """Year loss per trial, gather-free: per catalog tile of at most
    ``rows_tile`` rows (default and largest :data:`ONEHOT_MAX_ROWS_TILE`)
    each trial's event histogram times the row losses ``f``.

    Same arguments and result as :func:`aggregate_loss_gather`; a table in
    any row layout (one not laid out by :func:`pad_elt_columns` is padded
    for the row pass, a copy).  Requires ``occ_ret >= 0`` (a zero loss
    vector must contribute zero) and ``K <= ONEHOT_MAX_EVENTS``.  CUDA
    tensors go to the row pass
    and the histogram kernel (one count each), CPU tensors to the plain
    version."""
    T, K, rows, M, chunk = _check(event_ids, elt_losses, occ_ret, occ_lim,
                                  chunk)
    rt = _rows_tile(rows, rows_tile)
    if K > ONEHOT_MAX_EVENTS:
        raise ValueError(f"onehot with K={K}: a trial's count of one row "
                         f"must stay within {ONEHOT_MAX_EVENTS}")
    if event_ids.device.type == "cpu":
        return aggregate_loss_onehot_plain(event_ids, elt_losses, occ_ret,
                                           occ_lim, float(agg_ret),
                                           float(agg_lim), chunk=chunk,
                                           rows_tile=rt)
    ids, elt, ret, lim = _cuda_operands(event_ids, elt_losses, occ_ret,
                                        occ_lim)
    out = torch.empty(T, dtype=torch.float32, device=ids.device)
    if T == 0:
        return out                     # nothing to launch, nothing counted
    if not padded_rows(elt):
        elt = pad_elt_columns(elt)
    f = aggregate_row_losses(elt, ret, lim)
    _call("aggregate_loss_onehot_launch", "aggregate_loss_onehot",
          ids.device, ids.data_ptr(), f.data_ptr(), float(agg_ret),
          float(agg_lim), out.data_ptr(), T, K, rows, rt)
    return out
