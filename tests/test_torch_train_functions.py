"""The port's autograd Functions against the JAX package's custom VJPs, on
the same seeded numpy inputs (CPU: the kernels' plain versions forward):

* ``FlashAttentionFn`` against the reference's blockwise attention VJP
  (tests/test_attention.py's grad cases, cross lengths and a row with no
  admissible key) at 2e-3;
* ``SsdChunkedFn`` against the reference's Pallas VJP in interpret mode
  (tests/test_kernels_ssd.py::test_ops_pallas_path_differentiable) at
  1e-4 for x, B and C as there, and for dt and a, whose grads reach the
  hundreds, at 1e-4 of their largest; one group's B/C as the port's
  stride-0 view, with an initial state and a padded length, against the
  reference's repeated heads;
* ``ops.flash_attention`` / ``ops.ssd`` take the Functions only under
  grad with an input that requires grad.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models.attention_core import blockwise_attention as jblockwise
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,causal,window", [
    (2, 64, 64, 4, 2, 16, True, None), (2, 64, 64, 4, 2, 16, True, 16),
    (2, 64, 64, 4, 2, 16, False, None), (1, 32, 96, 4, 2, 16, False, None),
    (1, 140, 20, 2, 1, 16, True, 8)])
def test_flash_function_grads_match_reference_vjp(B, Sq, Skv, Hq, Hkv, D,
                                                  causal, window):
    rng = np.random.default_rng(5)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in (
        (B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D), (B, Sq, Hq, D)))
    jo, vjp = jax.vjp(lambda *a: jblockwise(*a, causal=causal,
                                            window=window), q, k, v)
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    fa.reset_counts()
    o = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    assert fa.backward_counts["flash_attention_bwd"] == 1
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                               rtol=1e-5, atol=1e-5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-3,
                                   atol=2e-3)


def _ssd_case(b, L, H, P, N, G=None, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, L, H, P)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, L, H)), 0.0).astype(np.float32)
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    a = (A[None, None, :] * dt).astype(np.float32)
    Bm = rng.standard_normal((b, L, G or H, N)).astype(np.float32)
    Cm = rng.standard_normal((b, L, G or H, N)).astype(np.float32)
    return x, dt, a, Bm, Cm


def test_ssd_function_grads_match_reference_pallas_vjp():
    """tests/test_kernels_ssd.py::test_ops_pallas_path_differentiable: the
    reference's Pallas VJP (interpret mode) and the port's Function, the
    loss sum(y^2) + sum(h^2), grads of x, B, C (and dt, a here)."""
    x, dt, a, Bm, Cm = _ssd_case(1, 32, 2, 4, 8)
    jops.use_pallas(True)
    try:
        def loss(x, dt, a, B, C):
            y, h = jops.ssd(x, dt, a, B, C, chunk=16)
            return jnp.sum(y ** 2) + jnp.sum(h ** 2)
        want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(x, dt, a, Bm, Cm)
    finally:
        jops.use_pallas(False)
    ts = [torch.from_numpy(t).requires_grad_() for t in (x, dt, a, Bm, Cm)]
    ssd_scan.reset_counts()
    y, h = ops.ssd(*ts, chunk=16)
    got = torch.autograd.grad((y ** 2).sum() + (h ** 2).sum(), ts)
    assert ssd_scan.backward_counts["ssd_chunked_bwd"] == 1
    for n, g, w in zip(("x", "dt", "a", "B", "C"), got, want):
        w = np.asarray(w)
        scale = float(np.abs(w).max()) if n in ("dt", "a") else 1.0
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=n)


def test_ssd_function_one_group_and_h0_and_pad_match_reference():
    """One group's B/C viewed over the heads with stride 0 (the port's
    layout) against the reference's repeated heads; an initial state; L
    not a multiple of the chunk (ops.ssd's pad)."""
    b, L, H, P, N = 2, 40, 4, 8, 16
    x, dt, a, Bg, Cg = _ssd_case(b, L, H, P, N, G=1, seed=2)
    h0 = np.random.default_rng(3).standard_normal((b, H, P, N)).astype(
        np.float32)
    rng = np.random.default_rng(4)
    dy = rng.standard_normal((b, L, H, P)).astype(np.float32)
    dh = rng.standard_normal((b, H, P, N)).astype(np.float32)

    @jax.jit
    def jgrads(x, dt, a, B, C, h0, dy, dh):
        def jfn(x, dt, a, B, C, h0):
            B, C = (jnp.repeat(t, H, axis=2) for t in (B, C))
            return jops.ssd(x, dt, a, B, C, chunk=16, initial_state=h0)
        return jax.vjp(jfn, x, dt, a, B, C, h0)[1]((dy, dh))
    want = jgrads(x, dt, a, Bg, Cg, h0, dy, dh)
    ts = [torch.from_numpy(t).requires_grad_() for t in (x, dt, a, Bg, Cg, h0)]
    Bv, Cv = (t.expand(-1, -1, H, -1) for t in ts[3:5])
    assert Bv.stride(2) == 0
    y, h = ops.ssd(ts[0], ts[1], ts[2], Bv, Cv, chunk=16,
                   initial_state=ts[5])
    got = torch.autograd.grad((y, h), ts, (torch.from_numpy(dy),
                                           torch.from_numpy(dh)))
    for n, g, w in zip(("x", "dt", "a", "B", "C", "h0"), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * max(1.0, float(
                                       np.abs(w).max())), err_msg=n)


def test_functions_only_under_grad():
    """No grad mode, or no input requiring grad: the wrappers are called
    as on the serving path (no graph, no backward recorded)."""
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.standard_normal((1, 16, 2, 8)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 16, 2, 8)).astype(
        np.float32))
    assert ops.flash_attention(q, k, k).grad_fn is None
    qg = q.clone().requires_grad_()
    with torch.no_grad():
        assert ops.flash_attention(qg, k, k).grad_fn is None
    o = ops.flash_attention(qg, k, k)
    assert type(o.grad_fn).__name__ == "FlashAttentionFnBackward"
    x, dt, a, Bm, Cm = (torch.from_numpy(t) for t in _ssd_case(1, 16, 2, 4,
                                                             8))
    y, _ = ops.ssd(x, dt, a, Bm, Cm, chunk=16)
    assert y.grad_fn is None
    y, _ = ops.ssd(x.requires_grad_(), dt, a, Bm, Cm, chunk=16)
    assert type(y.grad_fn).__name__ == "SsdChunkedFnBackward"
