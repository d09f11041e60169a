"""Pure-PyTorch oracles for the kernels of this package.

Twins of the JAX package's ``repro/kernels/ref.py`` oracles, same operation
order.  Here: the three Mamba-2 SSD oracles, the two Aggregate Risk
Analysis oracles, the two paged-attention oracles of the serving path, and
the FlashAttention forward's (the reference has none of its own: its kernel
is held against ``naive_attention``; this is the Pallas kernel's function
written densely), and the reference's blockwise attention, the plain
version the FlashAttention wrapper takes on the CPU.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Mamba-2 SSD (state-space duality) -- chunked form and step oracle
# ---------------------------------------------------------------------------
def ssd_chunked_ref(x, dt, a_log_decay, B, C, chunk: int,
                    initial_state: Optional[torch.Tensor] = None,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan (Mamba-2, arXiv:2405.21060 §6).

    x : (b, L, H, P)   per-head inputs
    dt: (b, L, H)      positive step sizes (already softplus'ed)
    a_log_decay: (b, L, H)  log a_t = A * dt_t (A negative)
    B : (b, L, H, N)   input projections (already head-expanded)
    C : (b, L, H, N)   output projections
    Returns (y: (b,L,H,P) in x's dtype, final_state: (b,H,P,N) float32).

    Recurrence: h_t = exp(a_t) h_{t-1} + dt_t * (B_t ⊗ x_t);  y_t = C_t · h_t.
    The masked half of the decay matrix is a select, never a product with a
    0/1 mask: there ``a_cum[l] - a_cum[s] > 0`` and its ``exp`` may be inf.
    The select comes before the ``exp`` (-inf there, so 0 after it): the
    values are the reference's ``where(causal, exp(seg), 0)`` bit for bit,
    and so are the gradients wherever the reference's are finite; where
    ``exp(seg)`` overflows (a chunk of 256 steps whose decays sum below
    -88, as mamba2-2.7b's strongest heads give), the reference's backward
    is ``0 * inf = nan`` and this one is 0.
    """
    b, L, H, P = x.shape
    N = B.shape[-1]
    if L % chunk:
        raise ValueError(f"L={L} is not a multiple of chunk={chunk}")
    nc = L // chunk
    f32 = torch.float32

    xc = x.float().reshape(b, nc, chunk, H, P)
    dtc = dt.float().reshape(b, nc, chunk, H)
    ac = a_log_decay.float().reshape(b, nc, chunk, H)
    Bc = B.float().reshape(b, nc, chunk, H, N)
    Cc = C.float().reshape(b, nc, chunk, H, N)

    a_cum = torch.cumsum(ac, dim=2)                     # inclusive (b,nc,Q,H)
    a_tot = a_cum[:, :, -1]                             # (b,nc,H)

    # ---- intra-chunk (quadratic within the chunk) ---------------------------
    seg = a_cum[:, :, :, None, :] - a_cum[:, :, None, :, :]   # (b,nc,l,s,H)
    li = torch.arange(chunk, device=x.device)
    causal = (li[:, None] >= li[None, :])[None, None, :, :, None]
    Lmat = torch.exp(torch.where(causal, seg, torch.full(
        (), float("-inf"), dtype=f32, device=x.device)))
    CB = torch.einsum("bclhn,bcshn->bclsh", Cc, Bc)
    M = CB * Lmat * dtc[:, :, None, :, :]               # dt_s enters at source
    y_diag = torch.einsum("bclsh,bcshp->bclhp", M, xc)

    # ---- per-chunk end states ----------------------------------------------
    decay_states = torch.exp(a_tot[:, :, None] - a_cum)  # (b,nc,Q,H)
    states = torch.einsum("bcshn,bcsh,bcshp->bchpn",
                          Bc, decay_states * dtc, xc)    # (b,nc,H,P,N)

    # ---- inter-chunk recurrence over chunk index ----------------------------
    h = (torch.zeros((b, H, P, N), dtype=f32, device=x.device)
         if initial_state is None else initial_state.float())
    h_before = []
    for c in range(nc):                                 # emit state BEFORE chunk
        h_before.append(h)
        h = torch.exp(a_tot[:, c])[:, :, None, None] * h + states[:, c]
    h_before = torch.stack(h_before, dim=1)             # (b,nc,H,P,N)

    # ---- inter-chunk output contribution ------------------------------------
    y_off = torch.einsum("bclhn,bchpn,bclh->bclhp",
                         Cc, h_before, torch.exp(a_cum))
    y = (y_diag + y_off).reshape(b, L, H, P)
    return y.to(x.dtype), h


def ssd_recurrent_ref(x, dt, a_log_decay, B, C,
                      initial_state: Optional[torch.Tensor] = None,
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step-by-step recurrence oracle (same contract as ssd_chunked_ref)."""
    b, L, H, P = x.shape
    N = B.shape[-1]
    h = (torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    ys = []
    for t in range(L):
        x_t, dt_t, a_t, B_t, C_t = (v[:, t].float()
                                    for v in (x, dt, a_log_decay, B, C))
        h = torch.exp(a_t)[..., None, None] * h + \
            dt_t[..., None, None] * (x_t[..., :, None] * B_t[..., None, :])
        ys.append(torch.einsum("bhn,bhpn->bhp", C_t, h))
    y = torch.stack(ys, dim=1)
    return y.to(x.dtype), h


def ssd_decode_step_ref(state, x_t, dt_t, a_t, B_t, C_t):
    """One decode step.  state: (b,H,P,N); x_t: (b,H,P); dt/a: (b,H);
    B_t/C_t: (b,H,N).  Returns (y_t, new_state)."""
    state = state.float()
    h = torch.exp(a_t.float())[..., None, None] * state + \
        dt_t.float()[..., None, None] * (
            x_t.float()[..., :, None] * B_t.float()[..., None, :])
    y = torch.einsum("bhn,bhpn->bhp", C_t.float(), h)
    return y.to(x_t.dtype), h


def _occurrence(gathered, occ_ret, occ_lim):
    """min(max(l - OccR, 0), OccL) per ELT on a (..., M) block of losses."""
    occ = torch.clamp(gathered - occ_ret, min=0.0)
    return torch.minimum(occ, occ_lim)


def aggregate_loss_ref(event_ids, elt_losses, occ_ret, occ_lim, agg_ret,
                       agg_lim):
    """Year-loss for each trial (paper Algorithm 3).

    event_ids : (T, K) int     — per-trial event sequence (0 = no event pad)
    elt_losses: (E_cat, M) f32 — direct-access loss tables for M ELTs
                                 (row 0 must be zero: the pad event)
    occ_ret/occ_lim : (M,) f32 — per-ELT occurrence terms (financial terms I)
    agg_ret/agg_lim : float    — layer aggregate terms T
    Returns yl: (T,) f32 — the Year Loss Table.

    Occurrence terms clip each event-occurrence loss per ELT; event losses sum
    across ELTs, accumulate over the trial, then aggregate terms apply:
        l = min(max(l - ret, 0), lim)
    """
    gathered = elt_losses.float()[event_ids.long()]       # (T, K, M)
    per_event = _occurrence(gathered, occ_ret, occ_lim).sum(dim=-1)
    agg = per_event.sum(dim=-1)                           # (T,)
    return torch.clamp(torch.clamp(agg - agg_ret, min=0.0), max=agg_lim)


def aggregate_loss_chunked_ref(event_ids, elt_losses, occ_ret, occ_lim,
                               agg_ret, agg_lim, chunk: int):
    """Chunked variant (paper §IV-B "chunking"): identical numerics, processes
    the event axis in fixed-size chunks."""
    T, K = event_ids.shape
    if K % chunk:
        raise ValueError(f"K={K} is not a multiple of chunk={chunk}")
    elt = elt_losses.float()
    acc = torch.zeros(T, dtype=torch.float32, device=event_ids.device)
    for c0 in range(0, K, chunk):
        g = elt[event_ids[:, c0:c0 + chunk].long()]       # (T, chunk, M)
        acc = acc + _occurrence(g, occ_ret, occ_lim).sum(dim=(1, 2))
    return torch.clamp(torch.clamp(acc - agg_ret, min=0.0), max=agg_lim)


# ---------------------------------------------------------------------------
# Paged attention (serving decode hot path) -- gather/scatter oracles
# ---------------------------------------------------------------------------
def paged_attention_decode_ref(q, k_pool, v_pool, page_table, positions, *,
                               kpos: Optional[torch.Tensor] = None,
                               pos_pool: Optional[torch.Tensor] = None,
                               window: Optional[int] = None) -> torch.Tensor:
    """Dense-gather paged decode read.

    q: (C, H, D) compute dtype, already roped; k_pool/v_pool: (NP, P, Hkv, D)
    storage dtype; page_table: (C, NB) int; positions: (C,) int.  Validity
    comes from ``kpos`` (C, NB*P), pre-gathered, or is gathered here from
    ``pos_pool`` (NP, P).  Returns (C, H, D) float32.

    Operation for operation the reference's oracle: gather the logical window
    through the table, score in float32 (``einsum(..., preferred_element_type
    =f32)`` on the compute dtype: the operands are upcast first, which is
    exact for bf16), add a -1e30 bias where ``kpos <= pos`` (and ``kpos > pos
    - window``) fails, full-row softmax, float32 weighted sum."""
    C, H, D = q.shape
    Hkv = k_pool.shape[2]
    pt = page_table.long()

    def gather(pool):
        g = pool[pt]                               # (C, NB, P, ...)
        return g.reshape((g.shape[0], g.shape[1] * g.shape[2])
                         + tuple(g.shape[3:]))

    k = gather(k_pool)                             # (C, L, Hkv, D)
    v = gather(v_pool)
    if kpos is None:
        kpos = gather(pos_pool[..., None])[..., 0]
    pos = positions[:, None]
    valid = kpos <= pos
    if window is not None:
        valid &= kpos > pos - window
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    bias = torch.where(valid, zero, torch.full_like(zero, -1e30))   # (C, L)
    rep = H // Hkv
    qr = q.reshape(C, 1, Hkv, rep, D)
    scale = 1.0 / (D ** 0.5)
    s = torch.einsum("bqhrd,bkhd->bqhrk", qr.float(),
                     k.to(q.dtype).float()) * scale
    s = s + bias[:, None, None, None, :]
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqhrk,bkhd->bqhrd", p, v.to(q.dtype).float())
    return o.reshape(C, H, D)


def paged_scatter_ref(pool, pages, values) -> torch.Tensor:
    """Scatter oracle for the prefill write: a new pool equal to ``pool``
    (S, NP, P, ...) with ``values`` (S, nb, P, ...) written at page ids
    ``pages`` (nb,), cast to the pool dtype."""
    out = pool.clone()
    out[:, pages.long()] = values.to(pool.dtype)
    return out


# ---------------------------------------------------------------------------
# FlashAttention forward (prefill attention)
# ---------------------------------------------------------------------------
def flash_attention_ref(q, k, v, causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """What the Pallas kernel ``flash_attention_pallas`` computes, in one
    pass over the whole key axis.

    q ``(B, Sq, Hq, D)``, k/v ``(B, Skv, Hkv, D)``; query head ``h`` reads kv
    head ``h // (Hq // Hkv)``.  Operands widened to float32, scale
    ``1/sqrt(D)``; query and key positions both start at 0, so ``causal``
    admits ``k <= q`` even when ``Sq != Skv`` (top-left); ``window`` admits
    ``k > q - window``.  An inadmissible score becomes -1e30, never -inf (a
    row with no admissible key averages every key uniformly); the softmax
    keeps the kernel's ``l == 0`` guard; the output is cast to q's type."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    qr = q.float().reshape(B, Sq, Hkv, rep, D)
    s = torch.einsum("bqhrd,bkhd->bqhrk", qr, k.float()) * (1.0 / math.sqrt(D))
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos <= q_pos
    if window is not None:
        ok &= k_pos > q_pos - window
    s = torch.where(ok[None, :, None, None, :], s,
                    torch.full((), NEG_INF, device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bqhrk,bkhd->bqhrd", p, v.float()) / l_safe[..., None]
    return o.reshape(B, Sq, Hq, D).to(q.dtype)


# ---------------------------------------------------------------------------
# Blockwise attention: the reference's jnp stand-in for the FlashAttention
# kernel (``repro/models/attention_core.py``), which its layers compute on
# every prefill; the plain version of the port's kernel
# ---------------------------------------------------------------------------
def _pick_block(size: int, target: int) -> int:
    """Largest divisor of ``size`` that is <= target (prefers powers of two)."""
    if size <= target:
        return size
    b = math.gcd(size, target)
    if b >= 16 or b == size:
        return b
    for cand in range(target, 0, -1):
        if size % cand == 0:
            return cand
    return size


def mask_bias(q_pos, k_pos, causal: bool, window: Optional[int],
              kv_valid: Optional[int] = None) -> torch.Tensor:
    """(q, k) additive bias: 0 where attendable, -1e30 elsewhere."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= k_pos[None, :] > (q_pos[:, None] - window)
    if kv_valid is not None:
        ok &= k_pos[None, :] < kv_valid
    return torch.where(ok, 0.0, NEG_INF).float()


def _blockwise_fwd(q, k, v, causal: bool, window: Optional[int],
                   block_q: int, block_kv: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (B, Sq, Hkv, rep, D); returns the float32 output, same shape,
    and each row's log-sum-exp ``m + log(l_safe)`` (B, Sq, Hkv, rep), the
    reference's ``_fwd_inner`` residuals."""
    B, Sq, Hkv, rep, D = q.shape
    Skv = k.shape[1]
    nq, nk = Sq // block_q, Skv // block_kv
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    outs, lses = [], []
    for qi in range(nq):
        qblk = q[:, qi * block_q:(qi + 1) * block_q].float()
        q_pos = qi * block_q + torch.arange(block_q, device=dev)
        m = torch.full((B, block_q, Hkv, rep), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, block_q, Hkv, rep), dtype=torch.float32,
                        device=dev)
        acc = torch.zeros((B, block_q, Hkv, rep, D), dtype=torch.float32,
                          device=dev)
        for j in range(nk):
            kj = k[:, j * block_kv:(j + 1) * block_kv].float()
            vj = v[:, j * block_kv:(j + 1) * block_kv].float()
            s = torch.einsum("bqhrd,bkhd->bqhrk", qblk, kj) * scale
            k_pos = j * block_kv + torch.arange(block_kv, device=dev)
            s = s + mask_bias(q_pos, k_pos, causal, window)[
                None, :, None, None, :]
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bqhrk,bkhd->bqhrd", p, vj)
            m = m_new
        l_safe = torch.where(l == 0.0, 1.0, l)
        outs.append(acc / l_safe[..., None])
        lses.append(m + torch.log(l_safe))
    return torch.cat(outs, dim=1), torch.cat(lses, dim=1)


def blockwise_attention(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        block_q: int = 512, block_kv: int = 1024,
                        return_lse: bool = False):
    """Flash-style attention.  q: (B,Sq,Hq,D); k/v: (B,Skv,Hkv,D).  With
    ``return_lse``, also each row's log-sum-exp, float32 ``(B, Sq, Hq)``."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    assert Hq % Hkv == 0, (Hq, Hkv)
    rep = Hq // Hkv
    bq = _pick_block(Sq, block_q)
    bk = _pick_block(k.shape[1], block_kv)
    qr = q.reshape(B, Sq, Hkv, rep, D)
    o, lse = _blockwise_fwd(qr, k, v, causal, window, bq, bk)
    o = o.to(q.dtype).reshape(B, Sq, Hq, D)
    return (o, lse.reshape(B, Sq, Hq)) if return_lse else o
