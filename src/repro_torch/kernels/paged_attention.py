"""Paged-attention kernels of the serving path for NVIDIA Hopper.

Replaces the two Pallas kernels of the JAX package's
``repro/kernels/paged_attention.py``: ``_decode_kernel`` (entry
``paged_attention_decode_pallas``) becomes :func:`paged_attention_decode`,
``_scatter_kernel`` (entry ``paged_prefill_scatter_pallas``) becomes
:func:`paged_prefill_scatter` and, with the same device code, admission's
:func:`paged_admit_kv`.  Both kernels are CUDA C++ in
``csrc/paged_attention.cu``, built by :mod:`.build` at first use.

What bounds them on the card, and what the design does about it:

* **decode** is bound by bytes: the K and V tiles (``P x D`` bf16 per kv
  head) of every page whose keys a row can attend, plus the pages'
  positions.  The kernel reads each page's positions first and fetches the
  tiles only of pages with a key that passes the mask, so SENTINEL padding
  and pages outside a sliding window cost 64 bytes, not a tile (exact: a
  masked key's weight is exactly 0 once the row has a real score; a row
  with no admissible key walks every entry and averages it, as the
  reference's softmax does).  The walk is split across blocks
  (flash-decoding): grid (kv head, row, split), each split a contiguous
  range of table entries (:func:`decode_split`, from the row's own shape,
  so a row's bits do not depend on its batch), its partial ``(m, l,
  acc)`` in f32 combined in split order by the last block of its (row, kv
  head) in the same launch -- one launch a call, no atomics in any sum, so
  two calls give the same bits.  In a block, 8 lanes score a (head, key)
  pair and each tile is staged once for all ``H / Hkv`` query heads; pages
  stream through a 4-deep ``cp.async`` ring.  The partials and the
  per-(row, kv head) tickets live in a per-(device, stream) scratch cache
  (:func:`_scratch`), not a fresh allocation per call; a stream that is
  being captured into a CUDA graph must find its scratch there, and the
  graph's owner takes it out (:func:`detach_scratch`).  Online softmax in
  float32; the output depends on page content reached through the table,
  never on physical page ids.  An optional device row mask (``row_mask``)
  leaves the rows it masks unread -- each of their blocks returns after one
  flag, their outputs zeros -- while the live rows keep their bits: a
  decode round of 64 capacity rows with a few live ones pays for the live
  ones' pages only.
* **scatter** is bound by bytes: the values are read once and the named
  pages written once, cast by round-to-nearest-even -- bit-exact with
  ``index_copy_`` of ``values.to(torch.bfloat16)``.  It writes in place;
  pages the list does not name are never touched.  A block moves one page
  block (``P * Hkv * D`` elements, a multiple of 8 in every config): bf16
  values by Hopper's bulk copies (one thread, through shared memory),
  float32 values eight 16-byte pieces a thread.  :func:`paged_admit_kv`
  launches the same kernel once for one attention sub-layer's admission:
  the K and the V pages of every stage straight from the dense prefill
  cache (through its stage stride; the ring's partial last page is
  completed with zeros) and the pages' rows of the position pool
  (``POS_SENTINEL`` past the ring).

Beside each kernel stands its plain PyTorch version
(:func:`paged_attention_decode_plain`, the dense-gather oracle operation for
operation; :func:`paged_prefill_scatter_plain`, ``index_copy_``, and
:func:`paged_admit_kv_plain`, the pad, reshape and index ops admission ran
before, around two ``index_copy_``).  A wrapper
takes the plain version only for tensors that lie on the CPU; for CUDA
tensors it launches the kernel or raises.  ``launch_counts`` and
``plain_counts`` record which way each call went.

On a device mesh the pools are split on KV heads
(:class:`repro_torch.distributed.sharding.ShardedTensor`) and
:func:`paged_attention_decode_sharded`, :func:`paged_prefill_scatter_sharded`
and :func:`paged_admit_kv_sharded` call the wrappers above once a shard, on
that shard's device (the reference's ``shard_map`` dispatch).
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from repro_torch.distributed.sharding import ShardedTensor, storage_key
from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

#: kernel launches per wrapper, bumped where the kernel is launched
launch_counts: Dict[str, int] = {"paged_attention_decode": 0,
                                 "paged_prefill_scatter": 0}
#: plain-version calls per function (any caller, any device)
plain_counts: Dict[str, int] = {"paged_attention_decode_plain": 0,
                                "paged_prefill_scatter_plain": 0}

MAX_HEAD_DIM = 256           # the decode kernel's widest K/V row
MAX_GROUP = 32               # query heads per kv head sharing a block
ROW_BLOCKS = 66              # decode blocks one row aims for: 8 rows put ~4
                             # on each of an H100's 132 SMs
MAX_SPLIT_ENTRIES = 8        # table entries of one split at most
POS_SENTINEL = 2 ** 30       # the position of an empty pool entry


def reset_counts() -> None:
    for d in (launch_counts, plain_counts):
        for k in d:
            d[k] = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def paged_attention_decode_plain(q, k_pool, v_pool, pos_pool, page_table,
                                 positions, *, window: Optional[int] = None,
                                 row_mask: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """Plain PyTorch version of :func:`paged_attention_decode`: the
    dense-gather full softmax of :func:`repro_torch.kernels.ref.
    paged_attention_decode_ref`, zeros for the rows ``row_mask`` masks."""
    plain_counts["paged_attention_decode_plain"] += 1
    out = _ref.paged_attention_decode_ref(q, k_pool, v_pool, page_table,
                                          positions, pos_pool=pos_pool,
                                          window=window)
    if row_mask is None:
        return out
    return torch.where(row_mask.to(torch.bool)[:, None, None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def paged_prefill_scatter_plain(pool, pages, values) -> torch.Tensor:
    """Plain PyTorch version of :func:`paged_prefill_scatter`: in-place
    ``pool[:, pages[j]] = values[:, j].to(pool.dtype)``; returns ``pool``."""
    plain_counts["paged_prefill_scatter_plain"] += 1
    pool.index_copy_(1, pages.long(), values.to(pool.dtype))
    return pool


def paged_admit_kv_plain(k_pool, v_pool, pos_pool, pages, k_src, v_src,
                         pos_src) -> None:
    """Plain PyTorch version of :func:`paged_admit_kv`: the positions padded
    with ``POS_SENTINEL`` into the pages' rows of ``pos_pool`` (unless it is
    None), then K and V each zero-padded to whole pages and scattered by
    :func:`paged_prefill_scatter_plain`."""
    S, ring = k_src.shape[:2]
    nb, P = pages.shape[0], k_pool.shape[2]
    if pos_pool is not None:
        pos_vals = torch.full((nb * P,), POS_SENTINEL, dtype=torch.int32,
                              device=pos_pool.device)
        pos_vals[:ring] = pos_src
        pos_pool[pages.long()] = pos_vals.view(nb, P)
    pad = nb * P - ring
    for pool, leaf in ((k_pool, k_src), (v_pool, v_src)):
        if pad:
            leaf = torch.nn.functional.pad(leaf, (0, 0, 0, 0, 0, pad))
        paged_prefill_scatter_plain(pool, pages,
                                    leaf.reshape(S, nb, P, *leaf.shape[2:]))


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
_DECODE_ARGS = [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                _I, _I, _I, _I, _F, _I, _P]
_ADMIT_ARGS = [_P, _P, _L, _P, _P, _I, _L, _P, _I, _I, _I, _L, _I, _P, _P,
               _I, _P]


def _check_decode(q, k_pool, v_pool, pos_pool, page_table, positions,
                  row_mask=None):
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
    if row_mask is not None and tuple(row_mask.shape) != (C,):
        raise ValueError(f"row_mask {tuple(row_mask.shape)}: need ({C},)")
    return C, H, D, NP, P, Hkv, page_table.shape[1]


def decode_split(Hkv: int, NB: int) -> int:
    """Table entries per split of the decode kernel's walk: enough splits
    that ``Hkv * splits`` blocks of one row reach ``ROW_BLOCKS``, at most
    ``MAX_SPLIT_ENTRIES`` entries each, so a split that holds only skipped
    pages ends early and the live ones are short.  It depends on the row's
    own shape only, never on how many rows share the launch, so a row gives
    the same bits alone or in any batch."""
    want = -(-ROW_BLOCKS // max(1, Hkv))
    return max(1, min(MAX_SPLIT_ENTRIES, -(-NB // want)))


#: (device index, stream) -> the decode kernel's partials and tickets
_SCRATCH: Dict[tuple, Dict[str, torch.Tensor]] = {}


def _scratch(dev: torch.device, stream: int, n_parts: int, D: int,
             n_tickets: int) -> Dict[str, torch.Tensor]:
    """The decode kernel's scratch for launches on ``stream``: partial
    ``(m, l)`` pairs and accumulators of ``n_parts`` (row, head, split)
    triples, and ``n_tickets`` per-(row, kv head) tickets that start at 0
    and that the kernel leaves at 0.  Kept per (device, stream) -- launches
    on one stream run in order, so they never share it at once -- and grown,
    never shrunk; growing allocates on the stream and does not
    synchronise."""
    need = dict(ml=2 * n_parts, acc=n_parts * D, tickets=n_tickets)
    sc = _SCRATCH.get((dev.index, stream))
    if sc is None or any(sc[k].numel() < n for k, n in need.items()):
        if torch.cuda.is_current_stream_capturing():
            # a graph may capture only scratch allocated outside it, which
            # its owner then takes out of the cache (detach_scratch)
            raise RuntimeError(
                "paged_attention_decode: the capturing stream has no scratch "
                f"for {n_parts} partials; run the same calls eagerly on it "
                "before capturing them")
        size = {k: max(n, sc[k].numel() if sc else 0) for k, n in need.items()}
        sc = _SCRATCH[(dev.index, stream)] = dict(
            ml=torch.empty(size["ml"], dtype=torch.float32, device=dev),
            acc=torch.empty(size["acc"], dtype=torch.float32, device=dev),
            tickets=torch.zeros(size["tickets"], dtype=torch.int32,
                                device=dev))
    return sc


def detach_scratch(dev: torch.device, stream: int
                   ) -> Optional[Dict[str, torch.Tensor]]:
    """Take the decode kernel's scratch for launches on ``stream`` out of
    the cache and give it to the caller (None if there is none).  A CUDA
    graph that captured launches on ``stream`` keeps what this returns for
    as long as it may replay: no later call can then replace, free or share
    the buffers it captured, and the next launch on ``stream`` allocates
    scratch of its own."""
    return _SCRATCH.pop((dev.index, stream), None)


def paged_attention_decode(q, k_pool, v_pool, pos_pool, page_table,
                           positions, *, window: Optional[int] = None,
                           split_kv_heads: Optional[int] = None,
                           row_mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Single-token GQA decode read against a paged KV pool.

    q ``(C, H, D)`` float32 or bfloat16, already roped; k_pool/v_pool
    ``(NP, P, Hkv, D)`` bfloat16 (this step's K/V already written);
    pos_pool ``(NP, P)`` int32 absolute positions (``POS_SENTINEL`` marks
    an empty entry); page_table ``(C, NB)`` int32; positions ``(C,)`` int32
    absolute position of each row's new token; ``window`` the sliding
    window or None.  Returns ``(C, H, D)`` float32.  CUDA tensors go to the
    kernel, CPU tensors to the plain version.

    ``split_kv_heads`` sizes the walk's split (:func:`decode_split`) from
    that many kv heads instead of the pools' ``Hkv``: a shard holding some
    of a pool's heads passes the whole pool's count, so it splits and
    combines as the whole call does and gives its heads' bits.

    ``row_mask`` ``(C,)`` bool on the device, or None (every row live): a
    row it masks is not read and gets zeros; every other row gets the bits
    it gets with no mask.  A device tensor, so a captured call serves any
    set of live rows without a host synchronisation."""
    C, H, D, NP, P, Hkv, NB = _check_decode(q, k_pool, v_pool, pos_pool,
                                            page_table, positions, row_mask)
    if q.device.type == "cpu":
        return paged_attention_decode_plain(q, k_pool, v_pool, pos_pool,
                                            page_table, positions,
                                            window=window, row_mask=row_mask)
    build.require_cuda(*(t for t in (q, k_pool, v_pool, pos_pool, page_table,
                                     positions, row_mask) if t is not None))
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
    if NB == 0:
        raise ValueError("page_table has no entries")
    chunk = decode_split(split_kv_heads or Hkv, NB)
    q = q.contiguous()
    pos_pool = pos_pool.to(torch.int32).contiguous()
    page_table = page_table.to(torch.int32).contiguous()
    positions = positions.to(torch.int32).contiguous()
    if row_mask is not None:
        row_mask = row_mask.to(torch.bool).contiguous()
    out = torch.empty((C, H, D), dtype=torch.float32, device=q.device)
    if C == 0:
        return out                     # nothing to launch, nothing counted
    splits = -(-NB // chunk)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        sc = _scratch(q.device, stream, C * H * splits, D, C * Hkv)
        err = _entry("paged_attention_decode_launch", _DECODE_ARGS)(
            q.data_ptr(), int(q.dtype == torch.bfloat16), k_pool.data_ptr(),
            v_pool.data_ptr(), pos_pool.data_ptr(), page_table.data_ptr(),
            positions.data_ptr(),
            None if row_mask is None else row_mask.data_ptr(),
            out.data_ptr(), sc["ml"].data_ptr(),
            sc["acc"].data_ptr(), sc["tickets"].data_ptr(), C, NB, P, Hkv, D,
            H // Hkv, -1 if window is None else int(window),
            1.0 / math.sqrt(D), chunk, stream)
    if err != 0:
        raise RuntimeError(f"paged_attention_decode: CUDA error {err} at "
                           f"launch (C={C}, H={H}, Hkv={Hkv}, D={D}, P={P}, "
                           f"NB={NB}, split={chunk})")
    launch_counts["paged_attention_decode"] += 1
    return out


def _check_pool(pool: torch.Tensor) -> None:
    """What the scatter kernel takes of a pool: bfloat16, each stage's block
    of pages contiguous and 16-byte aligned, a page a multiple of 8
    elements; the stage axis may be strided."""
    S, NP, P, Hkv, D = pool.shape
    E = P * Hkv * D
    if pool.dtype != torch.bfloat16:
        raise TypeError(f"pool dtype {pool.dtype}: need bfloat16")
    if (pool.stride()[1:] != (E, Hkv * D, D, 1) or E % 8
            or pool.stride(0) % 8 or pool.data_ptr() % 16):
        raise ValueError("pool must be contiguous and 16-byte aligned within "
                         "each stage, with P * Hkv * D a multiple of 8")


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
    _check_pool(pool)
    if values.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"values dtype {values.dtype}: need float32 or "
                        "bfloat16")
    E = P * Hkv * D
    # the values' stage axis may be strided (a row sliced out of a batched
    # prefill); within a stage they must be contiguous and 16-byte aligned
    if (values.stride()[1:] != (E, Hkv * D, D, 1) or values.stride(0) % 8
            or values.data_ptr() % 16):
        values = values.contiguous()
    pages = pages.to(torch.int32).contiguous()
    if S == 0 or nb == 0:
        return pool
    # the values as a dense cache whose ring fills its nb pages
    _admit_launch("paged_prefill_scatter", pool, None, None, pages,
                  values.view(S, nb * P, Hkv, D), None, None)
    return pool


def _admit_launch(what, k_pool, v_pool, pos_pool, pages, k_src, v_src,
                  pos_src) -> None:
    """Launch the admission kernel on checked operands (``v_pool`` None: K
    alone; ``pos_pool`` None: no positions) and count it as
    ``paged_prefill_scatter``."""
    S, _, P, Hkv, D = k_pool.shape
    nb, ring = pages.shape[0], k_src.shape[1]
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(k_pool.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry("paged_admit_kv_launch", _ADMIT_ARGS)(
            k_pool.data_ptr(), ptr(v_pool), k_pool.stride(0),
            k_src.data_ptr(), ptr(v_src),
            int(k_src.dtype == torch.bfloat16), k_src.stride(0),
            pages.data_ptr(), S, nb, P, Hkv * D, ring, ptr(pos_pool),
            ptr(pos_src), POS_SENTINEL, stream)
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch (S={S}, "
                           f"nb={nb}, P={P}, ring={ring})")
    launch_counts["paged_prefill_scatter"] += 1


def paged_admit_kv(k_pool, v_pool, pos_pool, pages, k_src, v_src,
                   pos_src) -> None:
    """Admission of one attention sub-layer's prefill into its allocated
    pages, in place, in one launch.

    k_pool / v_pool ``(S, NP, P, Hkv, D)`` bfloat16 (one layout for both);
    pages ``(nb,)`` int32 distinct non-reserved page ids; k_src / v_src the
    dense prefill cache ``(S, ring, Hkv, D)`` float32 or bfloat16 (one dtype
    and layout for both; the stage axis may be strided) with ``(nb - 1) * P
    < ring <= nb * P``; pos_pool ``(NP, P)`` int32, or None to leave the
    positions alone (a second attention sub-layer); pos_src ``(ring,)``
    int32.  Afterwards page ``pages[j]`` of every stage holds ring positions
    ``j * P ..`` cast to bfloat16, zeros past the ring, and its row of
    ``pos_pool`` their positions, ``POS_SENTINEL`` past the ring; nothing
    else is touched.  CUDA tensors go to the scatter kernel (one launch,
    counted as ``paged_prefill_scatter``), CPU tensors to the plain
    version."""
    if k_pool.dim() != 5 or k_src.dim() != 4 or pages.dim() != 1:
        raise ValueError("need pools (S, NP, P, Hkv, D), pages (nb,), "
                         "sources (S, ring, Hkv, D)")
    S, NP, P, Hkv, D = k_pool.shape
    nb, ring = pages.shape[0], k_src.shape[1]
    if (tuple(v_pool.shape) != tuple(k_pool.shape)
            or tuple(k_src.shape) != (S, ring, Hkv, D)
            or tuple(v_src.shape) != (S, ring, Hkv, D)
            or tuple(pos_src.shape) != (ring,)
            or (pos_pool is not None and tuple(pos_pool.shape) != (NP, P))):
        raise ValueError(f"admission shapes do not fit pools "
                         f"{tuple(k_pool.shape)}: sources "
                         f"{tuple(k_src.shape)} / {tuple(v_src.shape)}, "
                         f"positions {tuple(pos_src.shape)}")
    if not (nb - 1) * P < ring <= nb * P:
        raise ValueError(f"a ring of {ring} fills {-(-ring // P)} pages of "
                         f"{P}, not {nb}")
    if k_pool.device.type == "cpu":
        paged_admit_kv_plain(k_pool, v_pool, pos_pool, pages, k_src, v_src,
                             pos_src)
        return
    build.require_cuda(*(t for t in (k_pool, v_pool, pos_pool, pages, k_src,
                                     v_src, pos_src) if t is not None))
    for pool in (k_pool, v_pool):
        _check_pool(pool)
    if v_pool.stride() != k_pool.stride():
        raise ValueError("k_pool and v_pool must share one layout")
    if k_src.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"source dtype {k_src.dtype}: need float32 or "
                        "bfloat16")
    if (Hkv * D) % 8:
        raise ValueError(f"Hkv * D = {Hkv * D}: the kernel moves 8 elements "
                         "at a time")

    def fit(src):
        # the stage axis may be strided; within a stage contiguous, aligned
        ok = (src.stride()[1:] == (Hkv * D, D, 1) and src.stride(0) % 8 == 0
              and src.data_ptr() % 16 == 0)
        return src if ok else src.contiguous()

    k_src, v_src = fit(k_src), fit(v_src.to(k_src.dtype))
    if k_src.stride(0) != v_src.stride(0):
        k_src, v_src = k_src.contiguous(), v_src.contiguous()
    pages = pages.to(torch.int32).contiguous()
    pos_src = pos_src.to(torch.int32).contiguous()
    if pos_pool is not None and not (pos_pool.dtype == torch.int32
                                     and pos_pool.is_contiguous()):
        raise ValueError("pos_pool must be contiguous int32")
    if S == 0 or nb == 0:
        return
    _admit_launch("paged_admit_kv", k_pool, v_pool, pos_pool, pages, k_src,
                  v_src, pos_src)


# ---------------------------------------------------------------------------
# mesh dispatch: per-shard kernel calls along the KV-head axis
# ---------------------------------------------------------------------------
# The reference runs its kernels per shard under shard_map
# (src/repro/kernels/paged_attention.py:198-270); here each shard's call is
# the kernel's own wrapper on that shard's device.  Three shapes cover
# every arch in configs/:
#   * Hkv divisible by the "model" extent -- pools and q both split on
#     heads.  A shard's contiguous query heads (H/n = group * Hkv/n) are
#     exactly its kv heads' group, so its call is a self-contained decode;
#     sized by the whole pool's Hkv (split_kv_heads) it splits and combines
#     as the unsharded call does: bit-identical with its heads of it.
#   * MQA (Hkv == 1) -- pools replicated, q split on H.
#   * otherwise -- everything replicated: one call per distinct storage.
# The outputs are sharded like q; the caller gathers them (data movement).

def _heads(src, p: int, dim: int, sl: slice, dev: torch.device
           ) -> torch.Tensor:
    """Mesh position ``p``'s slice ``sl`` of ``src`` along ``dim`` on
    ``dev``: its own local when ``src`` is sharded so, else a view of the
    global tensor moved there (no copy on its own device)."""
    if isinstance(src, ShardedTensor):
        if src.slices[p][dim] != sl:
            raise ValueError(f"source shard {src.slices[p][dim]} on dim "
                             f"{dim} does not match the pool's {sl}")
        return src.locals[p]
    return src[(slice(None),) * dim + (sl,)].to(dev)


def paged_attention_decode_sharded(q, k_pool, v_pool, pos_pool, page_table,
                                   positions, sh, *,
                                   window: Optional[int] = None,
                                   row_mask: Optional[torch.Tensor] = None):
    """:func:`paged_attention_decode` partitioned along KV heads.

    q ``(C, H, D)``, pos_pool, page_table and positions are global tensors
    on the mesh's first device; k_pool / v_pool ``(NP, P, Hkv, D)``
    :class:`ShardedTensor` placed by ``sh`` on ``(None, None, "kv",
    None)``; ``row_mask`` (global, like the rows) goes to every shard's
    call.  Returns a :class:`ShardedTensor` ``(C, H, D)`` float32, one
    kernel launch per distinct shard.  Plain pools (off-mesh) take the
    unsharded call."""
    if not isinstance(k_pool, ShardedTensor):
        return paged_attention_decode(q, k_pool, v_pool, pos_pool,
                                      page_table, positions, window=window,
                                      row_mask=row_mask)
    mesh = k_pool.mesh
    H, Hkv = q.shape[1], k_pool.shape[2]
    devs = mesh.position_devices()
    if k_pool.spec[2] is not None:                 # GQA / MHA on kv heads
        group = H // Hkv
        q_sl = [slice(s[2].start * group, s[2].stop * group)
                for s in k_pool.slices]
        out_spec = (None, k_pool.spec[2], None)
    elif Hkv == 1 and sh.extent("heads", H) > 1:   # MQA
        q_sl = [s[1] for s in sh.index_map((None, "heads", None), q.shape)]
        out_spec = sh.spec((None, "heads", None), q.shape)
    else:                                          # indivisible: replicated
        q_sl = [slice(0, H)] * mesh.size
        out_spec = (None, None, None)
    done: Dict[tuple, torch.Tensor] = {}
    outs = []
    for p, dev in enumerate(devs):
        kl, vl = k_pool.locals[p], v_pool.locals[p]
        key = (storage_key(kl), q_sl[p].start, q_sl[p].stop)
        if key not in done:
            done[key] = paged_attention_decode(
                q[:, q_sl[p]].to(dev), kl, vl, pos_pool.to(dev),
                page_table.to(dev), positions.to(dev), window=window,
                split_kv_heads=Hkv,
                row_mask=None if row_mask is None else row_mask.to(dev))
        outs.append(done[key])
    return ShardedTensor.from_locals(mesh, out_spec, outs)


def paged_prefill_scatter_sharded(pool, pages, values, sh):
    """:func:`paged_prefill_scatter` partitioned along KV heads: pool
    ``(S, NP, P, Hkv, D)`` a :class:`ShardedTensor` placed on ``(None,
    None, None, "kv", None)``, values global or sharded alike.  One launch
    per distinct shard (each its own heads of the values); returns the
    pool.  A plain pool (off-mesh) takes the unsharded call."""
    if not isinstance(pool, ShardedTensor):
        return paged_prefill_scatter(pool, pages, values)
    for p, local, sl in pool.unique():
        dev = local.device
        paged_prefill_scatter(local, pages.to(dev),
                              _heads(values, p, 3, sl[3], dev))
    return pool


def paged_admit_kv_sharded(k_pool, v_pool, pos_pool, pages, k_src, v_src,
                           pos_src, sh) -> None:
    """:func:`paged_admit_kv` partitioned along KV heads: pools
    :class:`ShardedTensor` placed on ``(None, None, None, "kv", None)``,
    sources ``(S, ring, Hkv, D)`` global or sharded alike on their head
    axis.  One launch per distinct shard, each its heads of K and V; the
    (replicated, global) position pool is written once, by the launch of the
    shard on its device.  Plain pools (off-mesh) take the unsharded call."""
    if not isinstance(k_pool, ShardedTensor):
        paged_admit_kv(k_pool, v_pool, pos_pool, pages, k_src, v_src,
                       pos_src)
        return
    todo = pos_pool
    for p, kl, sl in k_pool.unique():
        dev = kl.device
        pp = todo if todo is not None and todo.device == dev else None
        paged_admit_kv(kl, v_pool.locals[p], pp, pages.to(dev),
                       _heads(k_src, p, 2, sl[3], dev),
                       _heads(v_src, p, 2, sl[3], dev), pos_src.to(dev))
        if pp is not None:
            todo = None
    if todo is not None:
        raise ValueError(f"the position pool on {todo.device} lies on no "
                         "shard's device")
