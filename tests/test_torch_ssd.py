"""The port's Mamba-2 SSD scan against the JAX package's, on the same inputs.

Inputs are drawn with numpy from a seed and handed to both packages.  On the
CPU the port's ``ssd_chunked`` takes its plain version (the chunked oracle);
the reference runs its Pallas kernel in interpret mode or its jnp oracles.
Tolerances are the reference's own (``tests/test_kernels_ssd.py``):
``rtol = atol = 1e-4`` in float32 -- the two sum the chunk's cumulative
decay in different orders, and ``exp(a_cum[l] - a_cum[s])`` amplifies the
difference -- and for bfloat16 inputs ``5e-2`` on y and ``2e-2`` on the
state.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_chunked_pallas
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan

# (b, L, H, P, N, chunk): tests/test_kernels_ssd.py::SWEEP
SWEEP = [(2, 64, 4, 8, 16, 16), (1, 128, 2, 16, 32, 32),
         (2, 32, 8, 4, 8, 8), (1, 256, 1, 64, 128, 64)]
F32 = dict(rtol=1e-4, atol=1e-4)


def _case(b, L, H, P, N, seed=0, decay=1.0):
    """x, dt, a, B, C, h0 as tests/test_kernels_ssd.py::_case draws them
    (normal inputs, softplus step sizes, A = -exp(normal)), scaled by
    ``decay`` in A."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, L, H, P)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, L, H)), 0.0).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H)) * decay).astype(np.float32)
    a = (A[None, None, :] * dt).astype(np.float32)
    B = rng.standard_normal((b, L, H, N)).astype(np.float32)
    C = rng.standard_normal((b, L, H, N)).astype(np.float32)
    h0 = rng.standard_normal((b, H, P, N)).astype(np.float32)
    return x, dt, a, B, C, h0


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or F32))


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_oracles_match_jax(chunk):
    """ssd_chunked_ref, ssd_recurrent_ref and ssd_decode_step_ref against
    their JAX twins, with an initial state."""
    arrs = _case(2, 64, 4, 8, 16, seed=chunk)
    (x, dt, a, B, C, h0), jx = _t(arrs), _j(arrs)
    y1, s1 = tref.ssd_chunked_ref(x, dt, a, B, C, chunk, initial_state=h0)
    y2, s2 = jref.ssd_chunked_ref(*jx[:5], chunk, initial_state=jx[5])
    _close(y1, y2)
    _close(s1, s2)
    y1, s1 = tref.ssd_recurrent_ref(x, dt, a, B, C, initial_state=h0)
    y2, s2 = jref.ssd_recurrent_ref(*jx[:5], initial_state=jx[5])
    _close(y1, y2)
    _close(s1, s2)
    h, jh = h0, jx[5]
    for t in range(4):
        y1, h = tref.ssd_decode_step_ref(h, x[:, t], dt[:, t], a[:, t],
                                         B[:, t], C[:, t])
        y2, jh = jref.ssd_decode_step_ref(jh, *(v[:, t] for v in jx[:5]))
        _close(y1, y2)
        _close(h, jh)
    y_t, h_t = ops.ssd_decode_step(h0, x[:, 0], dt[:, 0], a[:, 0], B[:, 0],
                                   C[:, 0])
    y_j, h_j = jops.ssd_decode_step(jx[5], *(v[:, 0] for v in jx[:5]))
    _close(y_t, y_j)
    _close(h_t, h_j)


@pytest.mark.parametrize("b,L,H,P,N,chunk", SWEEP)
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_pallas_interpret(b, L, H, P, N, chunk, with_h0):
    """The port's wrapper on CPU tensors (its plain version) against the
    reference's Pallas kernel in interpret mode."""
    arrs = _case(b, L, H, P, N)
    (x, dt, a, B, C, h0), jx = _t(arrs), _j(arrs)
    ssd_scan.reset_counts()
    y1, s1 = ssd_scan.ssd_chunked(x, dt, a, B, C, chunk=chunk,
                                  initial_state=h0 if with_h0 else None)
    y2, s2 = ssd_chunked_pallas(*jx[:5], chunk=chunk,
                                initial_state=jx[5] if with_h0 else None,
                                interpret=True)
    assert y1.dtype == torch.float32 and tuple(y1.shape) == (b, L, H, P)
    assert s1.dtype == torch.float32 and tuple(s1.shape) == (b, H, P, N)
    _close(y1, y2)
    _close(s1, s2)
    assert ssd_scan.plain_counts == {"ssd_chunked_plain": 1}
    assert ssd_scan.launch_counts == {"ssd_chunked": 0}


def test_bf16_inputs():
    """x, B and C in bfloat16 (the full-width serving path): y comes back
    in bfloat16, the state in float32 (tests/test_kernels_ssd.py::
    test_bf16_inputs)."""
    x, dt, a, B, C, _ = _case(1, 32, 2, 8, 16)
    tb = [torch.from_numpy(v).to(torch.bfloat16) for v in (x, B, C)]
    jb = [jnp.asarray(v).astype(jnp.bfloat16) for v in (x, B, C)]
    y1, s1 = ssd_scan.ssd_chunked(tb[0], torch.from_numpy(dt),
                                  torch.from_numpy(a), tb[1], tb[2], chunk=16)
    y2, s2 = ssd_chunked_pallas(jb[0], jnp.asarray(dt), jnp.asarray(a),
                                jb[1], jb[2], chunk=16)
    assert y1.dtype == torch.bfloat16 and s1.dtype == torch.float32
    _close(y1.float(), y2, rtol=5e-2, atol=5e-2)
    _close(s1, s2, rtol=2e-2, atol=2e-2)


def test_ops_padding_path():
    """L = 33 with chunk 16: ops.ssd pads state-neutrally (dt = a = 0) and
    cuts y back to L, as the reference's ops.ssd does."""
    arrs = _case(1, 33, 2, 4, 8)
    (x, dt, a, B, C, h0), jx = _t(arrs), _j(arrs)
    y1, s1 = ops.ssd(x, dt, a, B, C, chunk=16, initial_state=h0)
    y2, s2 = jops.ssd(*jx[:5], chunk=16, initial_state=jx[5])
    assert tuple(y1.shape) == (1, 33, 2, 4)
    _close(y1, y2)
    _close(s1, s2)
    y3, s3 = tref.ssd_recurrent_ref(x, dt, a, B, C, initial_state=h0)
    _close(y1, y3)
    _close(s1, s3)


def test_large_decay_masked_half_stays_finite():
    """|A| dt in the tens: above the diagonal a_cum[l] - a_cum[s] is far
    past exp's range.  The masked half is a select, so y and the state are
    finite and equal to the reference's Pallas kernel's."""
    arrs = _case(2, 64, 3, 8, 16, seed=5, decay=40.0)
    (x, dt, a, B, C, _), jx = _t(arrs), _j(arrs)
    a_cum = torch.cumsum(a.reshape(2, 1, 64, 3), dim=2)
    assert float((a_cum[:, :, 0] - a_cum[:, :, -1]).max()) > 89.0  # exp: inf
    y1, s1 = ssd_scan.ssd_chunked(x, dt, a, B, C, chunk=64)
    y2, s2 = ssd_chunked_pallas(*jx[:5], chunk=64, interpret=True)
    assert bool(torch.isfinite(y1).all()) and bool(torch.isfinite(s1).all())
    _close(y1, y2)
    _close(s1, s2)


def test_stride0_heads_and_padding_keep_the_view():
    """One group's B/C viewed over every head (head stride 0) gives the
    numbers of a materialised copy, and ops.ssd's pad keeps it a view."""
    x, dt, a, B, C, h0 = _t(_case(2, 40, 4, 8, 16, seed=7))
    Bg, Cg = B[:, :, :1].expand(-1, -1, 4, -1), C[:, :, :1].expand(-1, -1, 4,
                                                                   -1)
    assert Bg.stride(2) == 0
    y1, s1 = ops.ssd(x, dt, a, Bg, Cg, chunk=16, initial_state=h0)
    y2, s2 = ops.ssd(x, dt, a, Bg.contiguous(), Cg.contiguous(), chunk=16,
                     initial_state=h0)
    torch.testing.assert_close(y1, y2, rtol=0, atol=0)
    torch.testing.assert_close(s1, s2, rtol=0, atol=0)
    padded = ops._pad_steps(Bg, 8)
    assert tuple(padded.shape) == (2, 48, 4, 16) and padded.stride(2) == 0
    assert bool((padded[:, 40:] == 0).all())
    assert torch.equal(padded[:, :40], Bg)


def test_wrapper_checks_shapes():
    x, dt, a, B, C, h0 = _t(_case(1, 32, 2, 4, 8))
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_scan.ssd_chunked(x, dt, a, B, C, chunk=12)
    with pytest.raises(ValueError, match="initial_state"):
        ssd_scan.ssd_chunked(x, dt, a, B, C, chunk=16,
                             initial_state=h0[:, :1])
    with pytest.raises(ValueError, match="dt"):
        ssd_scan.ssd_chunked(x, dt[:, :16], a, B, C, chunk=16)


# ---------------------------------------------------------------------------
# the numerics of the bf16 tensor-core kernel, written out on the CPU
# ---------------------------------------------------------------------------
LOG2E = 1.4426950408889634
TILE = 64                        # the kernel's l- and s-tiles
BF16_Y, BF16_STATE = dict(rtol=5e-2, atol=5e-2), dict(rtol=2e-2, atol=2e-2)
# the serving path's head geometry: P 64, N 128, two chunks of 256
PATH_CASE = (1, 512, 2, 64, 128, 256)


def _split(v, on=True):
    """v = hi + lo, hi = bf16(v), lo = bf16(v - hi); ``on=False`` keeps hi
    alone (one bf16 rounding)."""
    hi = v.to(torch.bfloat16).float()
    return hi, ((v - hi).to(torch.bfloat16).float() if on
                else torch.zeros_like(v))


def _tensor_core_emulation(x, dt, a, B, C, chunk, h0=None,
                           split=("m", "h", "w"), heads_per_block=1):
    """The arithmetic of the bf16 tensor-core kernel in float32: bf16
    operands (exact in f32), the cumulative decay in the log2 domain, C B^T
    formed once per (row, chunk, head tile) from the tile's first head, M
    from it -- off the diagonal of 64-step tiles by a row factor
    exp2(A[l] - A[m]) times a column factor dt[s] exp2(A[m] - A[s]) (m the
    s-tile's last step), on it by a select -- the three float32 operands
    (M, the state before the chunk, the weighted x) split into bf16 hi + lo
    (``split`` names those split; the others are rounded once), products
    summed in f32, y rounded to bf16.  x, B, C float tensors holding bf16
    values."""
    b, L, H, P = x.shape
    Q = chunk
    y = torch.empty((b, L, H, P))
    hs = (torch.zeros((b, H, P, B.shape[-1])) if h0 is None
          else h0.clone().float())
    idx = torch.arange(Q)
    tile = idx // TILE
    m_of = torch.clamp(tile * TILE + TILE, max=Q) - 1
    off = tile[:, None] > tile[None, :]
    diag = (tile[:, None] == tile[None, :]) & (idx[:, None] >= idx[None, :])
    zero = torch.zeros(())
    for bi in range(b):
        for hb in range(0, H, heads_per_block):
            for c in range(L // Q):
                sl = slice(c * Q, (c + 1) * Q)
                CB = C[bi, sl, hb] @ B[bi, sl, hb].T       # once a tile
                for h in range(hb, min(hb + heads_per_block, H)):
                    Ch, Bh, xh = C[bi, sl, h], B[bi, sl, h], x[bi, sl, h]
                    A2 = torch.cumsum(a[bi, sl, h], 0) * LOG2E
                    d = dt[bi, sl, h]
                    colw = d * torch.exp2(A2[m_of] - A2)
                    rf = torch.exp2(A2[:, None] - A2[m_of][None, :])
                    seg = torch.where(diag, A2[:, None] - A2[None, :], zero)
                    M = torch.where(off, CB * rf * colw[None, :],
                                    torch.where(diag, CB * torch.exp2(seg)
                                                * d[None, :], zero))
                    Mh, Ml = _split(M, "m" in split)
                    hold = hs[bi, h]
                    Hh, Hl = _split(hold, "h" in split)
                    carry = (Ch @ Hh.T + Ch @ Hl.T) * torch.exp2(A2)[:, None]
                    y[bi, sl, h] = Mh @ xh + Ml @ xh + carry
                    atot = A2[-1]
                    xw = ((xh * colw[:, None])
                          * torch.exp2(atot - A2[m_of])[:, None])
                    Xh, Xl = _split(xw, "w" in split)
                    hs[bi, h] = torch.exp2(atot) * hold + Xh.T @ Bh + Xl.T @ Bh
    return y.to(torch.bfloat16), hs


def _bf16_case(b, L, H, P, N, seed=0, one_group=False, decay=1.0):
    """The sweep's inputs with x, B and C rounded to bf16 (as float32 for
    the emulation, as bf16 for the reference); ``one_group``: one group's
    B and C repeated over every head."""
    x, dt, a, B, C, h0 = _case(b, L, H, P, N, seed=seed, decay=decay)
    if one_group:
        B, C = (np.repeat(v[:, :, :1], H, axis=2) for v in (B, C))
    tb = [torch.from_numpy(v).to(torch.bfloat16).float() for v in (x, B, C)]
    jb = [jnp.asarray(v).astype(jnp.bfloat16) for v in (x, B, C)]
    return tb, jb, (dt, a, h0)


def _bf16_reference(jb, dt, a, h0, chunk):
    """The reference on bf16 inputs: its Pallas kernel in interpret mode
    at the sweep's chunks, its jnp oracle at the path's chunk of 256."""
    args = (jb[0], jnp.asarray(dt), jnp.asarray(a), jb[1], jb[2])
    init = None if h0 is None else jnp.asarray(h0)
    if chunk <= TILE:
        y, h = ssd_chunked_pallas(*args, chunk=chunk, initial_state=init,
                                  interpret=True)
    else:
        y, h = jref.ssd_chunked_ref(*args, chunk, initial_state=init)
    return np.asarray(y, np.float32), np.asarray(h, np.float32)


@pytest.mark.parametrize("b,L,H,P,N,chunk", SWEEP + [PATH_CASE])
@pytest.mark.parametrize("with_h0", [False, True])
def test_tensor_core_numerics_meet_the_bf16_hold(b, L, H, P, N, chunk,
                                                 with_h0):
    """The bf16 kernel's arithmetic (emulated above) against the
    reference's Pallas kernel in interpret mode over the sweep, and its
    oracle at the serving path's head geometry, at the holds the card
    applies to the kernel: 5e-2 on y, 2e-2 on the state.  This checks the
    design's numerics; ``chip_smoke.py`` holds the kernel itself."""
    tb, jb, (dt, a, h0) = _bf16_case(b, L, H, P, N)
    init = h0 if with_h0 else None
    y, h = _tensor_core_emulation(
        *[tb[0], torch.from_numpy(dt), torch.from_numpy(a), tb[1], tb[2]],
        chunk, None if init is None else torch.from_numpy(init))
    wy, wh = _bf16_reference(jb, dt, a, init, chunk)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    _close(y.float(), wy, **BF16_Y)
    _close(h, wh, **BF16_STATE)


def test_one_bf16_rounding_of_m_misses_the_bf16_hold():
    """Why the kernel splits M: rounded once to bf16 (2^-9 a weight), M
    misses the y hold at the serving path's head geometry, where a chunk
    sums 256 of its terms; with M split the same case holds (above)."""
    tb, jb, (dt, a, h0) = _bf16_case(*PATH_CASE)
    y, _ = _tensor_core_emulation(
        tb[0], torch.from_numpy(dt), torch.from_numpy(a), tb[1], tb[2],
        PATH_CASE[-1], torch.from_numpy(h0), split=("h", "w"))
    wy, _ = _bf16_reference(jb, dt, a, h0, PATH_CASE[-1])
    assert not np.allclose(y.float().numpy(), wy, **BF16_Y)


@pytest.mark.parametrize("bc", ["one_group", "per_head"])
@pytest.mark.parametrize("H", [2, 3, 8])
def test_cb_shared_across_a_head_tile_equals_per_head(H, bc):
    """The head tiles the kernel cuts, against the reference: with B and C
    one group's projection over every head, C B^T formed once for a tile
    of two heads (from the tile's first head; a ragged last tile at H 3)
    meets the bf16 holds; with per-head B and C, one head a block meets
    them too.  Two heads a block on per-head B and C miss them: the tile
    really uses its first head's C B^T for both."""
    one_group = bc == "one_group"
    tb, jb, (dt, a, h0) = _bf16_case(2, 128, H, 16, 32, seed=3,
                                     one_group=one_group)
    args = (tb[0], torch.from_numpy(dt), torch.from_numpy(a), tb[1], tb[2],
            64, torch.from_numpy(h0))
    wy, wh = _bf16_reference(jb, dt, a, h0, 64)
    y, h = _tensor_core_emulation(*args,
                                  heads_per_block=2 if one_group else 1)
    _close(y.float(), wy, **BF16_Y)
    _close(h, wh, **BF16_STATE)
    if not one_group:
        y2, _ = _tensor_core_emulation(*args, heads_per_block=2)
        assert not np.allclose(y2.float().numpy(), wy, **BF16_Y)


def test_head_tile_rule():
    """Two heads a block only where B and C are shared by the heads and the
    grid still fills the card."""
    assert ssd_scan.head_tile(8, 80, 64, True, 132) == 2      # 640 blocks
    assert ssd_scan.head_tile(1, 80, 64, True, 132) == 1      # 80 < 132
    assert ssd_scan.head_tile(8, 80, 64, False, 132) == 1     # per-head B/C
    assert ssd_scan.head_tile(2, 81, 64, True, 132) == 2      # ragged tile
    assert ssd_scan.head_tile(1, 81, 64, True, 132) == 1      # a row alone


def test_large_decay_tensor_core_numerics_stay_finite():
    """|A| dt in the tens: the factored decay off the diagonal (both
    factors <= 1) and the select on it keep y and the state finite."""
    tb, jb, (dt, a, _) = _bf16_case(2, 128, 3, 16, 32, seed=5, decay=40.0)
    y, h = _tensor_core_emulation(tb[0], torch.from_numpy(dt),
                                  torch.from_numpy(a), tb[1], tb[2], 64)
    assert bool(torch.isfinite(y.float()).all())
    assert bool(torch.isfinite(h).all())
    wy, wh = _bf16_reference(jb, dt, a, None, 64)
    _close(y.float(), wy, **BF16_Y)
    _close(h, wh, **BF16_STATE)
