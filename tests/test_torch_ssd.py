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
