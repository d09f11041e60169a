"""The model step's RMSNorm and RoPE: their plain versions, the routing in
``models/layers.py`` and the training Functions, on the CPU.

On the card each of ``apply_rmsnorm_heads`` and ``apply_rope`` is one
launch of a kernel of ``kernels/csrc/norm_rope.cu`` (held against these
plain versions by ``chip_smoke.py``); on the CPU it is the op chain it
always was.  Here:

* the plain versions give today's op chains bit for bit, and the JAX
  package's RMSNorm and RoPE at ``tests/test_torch_lm.py``'s tolerance;
* CPU calls move the plain counters, never the launch counters, and a
  reduced prefill makes ``2 L + 1`` RMSNorm and ``2 L`` RoPE calls;
* the inverse frequencies are computed once per ``(D, theta, device)``;
* the autograd Functions' backwards equal autograd through the op chains;
* a tensor that is not on the CPU goes to the kernel wrapper, which
  raises for anything but CUDA; the dry-run's meta pass takes the chain
  uncounted.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.configs import get_config
from repro_torch.kernels import norm_rope, ops
from repro_torch.models import layers as tl
from repro_torch.models.model import build_model

TOL = dict(rtol=1e-5, atol=1e-5)     # tests/test_torch_lm.py's


def _old_rmsnorm(scale, x, eps=1e-6):
    """``apply_rmsnorm_heads`` as it was before the kernel."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def _old_rope(x, positions, theta):
    """``apply_rope`` as it was before the kernel."""
    D = x.shape[-1]
    half = D // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                        device=x.device) / half))
    if positions.dim() == 1:
        ang = positions[:, None].float() * inv[None, :]
        ang = ang[None, :, None, :]
    else:
        ang = positions[..., None].float() * inv
        ang = ang[:, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# (x shape, scale dtype): a residual row of d_model, the per-head qk-norm
NORM_CASES = [((2, 5, 64), torch.float32), ((3, 7, 4, 16), torch.float32),
              ((2, 5, 64), torch.bfloat16), ((1, 9, 2, 80), torch.bfloat16)]
# (x shape, positions rank, positions dtype, theta)
ROPE_CASES = [((2, 6, 4, 16), 1, torch.int64, 1e4),
              ((2, 6, 4, 16), 2, torch.int32, 1e6),
              ((3, 5, 2, 80), 2, torch.int64, 1e4),
              ((1, 4, 8, 64), 1, torch.int32, 5e5)]


def _positions(rank, dtype, B, S, seed=1):
    rng = np.random.default_rng(seed)
    p = np.arange(S) if rank == 1 else rng.integers(0, 4000, (B, S))
    return torch.from_numpy(p).to(dtype)


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,sdt", NORM_CASES)
def test_rmsnorm_plain_is_the_old_chain(shape, sdt, xdt):
    x = torch.from_numpy(_rand(shape)).to(xdt)
    scale = torch.from_numpy(1 + 0.1 * _rand(shape[-1:], 3)).to(sdt)
    for eps in (1e-6, 1e-5):
        want = _old_rmsnorm(scale, x, eps)
        assert torch.equal(tl.rmsnorm_plain(scale, x, eps), want)
        assert torch.equal(tl.apply_rmsnorm_heads(scale, x, eps), want)
    assert torch.equal(tl.apply_rmsnorm({"scale": scale}, x),
                       _old_rmsnorm(scale, x))


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,rank,pdt,theta", ROPE_CASES)
def test_rope_plain_is_the_old_chain(shape, rank, pdt, theta, xdt):
    x = torch.from_numpy(_rand(shape)).to(xdt)
    pos = _positions(rank, pdt, shape[0], shape[1])
    want = _old_rope(x, pos, theta)
    assert torch.equal(tl.rope_plain(x, pos, theta), want)
    assert torch.equal(tl.apply_rope(x, pos, theta), want)


@pytest.mark.parametrize("shape,sdt", NORM_CASES[:2])
def test_rmsnorm_matches_jax(shape, sdt):
    x, scale = _rand(shape), 1 + 0.1 * _rand(shape[-1:], 3)
    got = tl.apply_rmsnorm_heads(torch.from_numpy(scale), torch.from_numpy(x))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jl.apply_rmsnorm_heads(jnp.asarray(scale),
                                                       jnp.asarray(x))), **TOL)
    got = tl.apply_rmsnorm({"scale": torch.from_numpy(scale)},
                           torch.from_numpy(x))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jl.apply_rmsnorm({"scale": jnp.asarray(scale)},
                                                 jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("shape,rank,pdt,theta", ROPE_CASES)
def test_rope_matches_jax(shape, rank, pdt, theta):
    x = _rand(shape)
    pos = _positions(rank, pdt, shape[0], shape[1])
    got = tl.apply_rope(torch.from_numpy(x), pos, theta)
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos.numpy()), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cpu_calls_count_plain_versions_only():
    """Every CPU call is a plain one; a reduced internlm2 prefill makes one
    RMSNorm a sub-layer input and one at the end, two RoPEs a layer."""
    norm_rope.reset_counts()
    x = torch.from_numpy(_rand((2, 3, 4, 16)))
    tl.apply_rmsnorm_heads(torch.ones(16), x)
    tl.apply_rope(x, torch.arange(3), 1e4)
    assert norm_rope.plain_counts == {"rmsnorm_plain": 1, "rope_plain": 1}
    assert norm_rope.launch_counts == {"rmsnorm": 0, "rope": 0}

    cfg = get_config("internlm2-1.8b").reduced()
    bundle = build_model(cfg)
    params = bundle.init(0, "cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        1, cfg.vocab_size, (2, 9)).astype(np.int32))
    norm_rope.reset_counts()
    with torch.no_grad():
        bundle.prefill_fn(params, {"tokens": toks})
    L = cfg.num_layers
    assert norm_rope.plain_counts == {"rmsnorm_plain": 2 * L + 1,
                                      "rope_plain": 2 * L}
    assert norm_rope.launch_counts == {"rmsnorm": 0, "rope": 0}
    assert norm_rope.backward_counts == {"rmsnorm_bwd": 0, "rope_bwd": 0}
    counted = [id(c) for c in ops.counters()]
    assert id(norm_rope.launch_counts) in counted
    assert id(norm_rope.plain_counts) in counted


def test_frequency_cache_keeps_one_tensor_per_key():
    a = tl.rope_inv_frequencies(16, 1e4, torch.device("cpu"))
    assert tl.rope_inv_frequencies(16, 1e4, "cpu") is a
    assert torch.equal(a, tl.rope_frequencies(16, 1e4))
    b = tl.rope_inv_frequencies(16, 1e6, torch.device("cpu"))
    c = tl.rope_inv_frequencies(80, 1e4, torch.device("cpu"))
    assert b is not a and c is not a and c.shape == (40,)
    assert torch.equal(b, tl.rope_frequencies(16, 1e6))
    assert tl.rope_inv_frequencies(80, 1e4, "cpu") is c


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,sdt", NORM_CASES[:2])
def test_rmsnorm_function_grads_equal_autograd_of_the_chain(
        monkeypatch, shape, sdt, xdt):
    monkeypatch.setattr(norm_rope, "rmsnorm",
                        lambda x, s, eps: tl._rmsnorm_chain(s, x, eps))
    x0 = torch.from_numpy(_rand(shape)).to(xdt)
    s0 = torch.from_numpy(1 + 0.1 * _rand(shape[-1:], 3)).to(sdt)
    dy = torch.from_numpy(_rand(shape, 5)).to(xdt)
    norm_rope.reset_counts()
    x, s = x0.clone().requires_grad_(), s0.clone().requires_grad_()
    y = tl.RmsNormFn.apply(x, s, 1e-5)
    y.backward(dy)
    xr, sr = x0.clone().requires_grad_(), s0.clone().requires_grad_()
    yr = tl._rmsnorm_chain(sr, xr, 1e-5)
    yr.backward(dy)
    assert torch.equal(y, yr)
    assert torch.equal(x.grad, xr.grad) and torch.equal(s.grad, sr.grad)
    assert norm_rope.backward_counts["rmsnorm_bwd"] == 1
    # the scale alone (a frozen input)
    s.grad = None
    tl.RmsNormFn.apply(x0, s, 1e-5).backward(dy)
    assert torch.equal(s.grad, sr.grad)


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,rank,pdt,theta", ROPE_CASES[:3])
def test_rope_function_grads_equal_autograd_of_the_chain(
        monkeypatch, shape, rank, pdt, theta, xdt):
    inv_of = {}

    def kernel(x, pos, inv):
        inv_of["inv"] = inv
        return tl._rope_chain(x, pos, theta)
    monkeypatch.setattr(norm_rope, "rope", kernel)
    x0 = torch.from_numpy(_rand(shape)).to(xdt)
    pos = _positions(rank, pdt, shape[0], shape[1])
    dy = torch.from_numpy(_rand(shape, 5)).to(xdt)
    norm_rope.reset_counts()
    x = x0.clone().requires_grad_()
    y = tl.RopeFn.apply(x, pos, theta)
    y.backward(dy)
    assert inv_of["inv"] is tl.rope_inv_frequencies(shape[-1], theta, "cpu")
    xr = x0.clone().requires_grad_()
    tl._rope_chain(xr, pos, theta).backward(dy)
    assert torch.equal(y, _old_rope(x0, pos, theta))
    assert torch.equal(x.grad, xr.grad)
    assert norm_rope.backward_counts["rope_bwd"] == 1


def test_tensors_off_the_cpu_go_to_the_wrappers():
    """Not on the CPU: the kernel wrapper, which raises for anything but a
    CUDA tensor (the meta device stands in for a card); in the dry-run's
    pass a meta tensor takes the op chain, uncounted."""
    meta = torch.empty((2, 5, 4, 16), device="meta")
    scale = torch.empty((16,), device="meta")
    pos = torch.empty((5,), dtype=torch.int64, device="meta")
    norm_rope.reset_counts()
    with pytest.raises(RuntimeError, match="CUDA tensors only"):
        tl.apply_rmsnorm_heads(scale, meta)
    with pytest.raises(RuntimeError, match="CUDA tensors only"):
        tl.apply_rope(meta, pos, 1e4)
    with pytest.raises(RuntimeError, match="CUDA tensors only"):
        norm_rope.rmsnorm(torch.ones(2, 16), torch.ones(16), 1e-6)
    with pytest.raises(RuntimeError, match="CUDA tensors only"):
        norm_rope.rope(torch.ones(1, 2, 1, 16), torch.arange(2),
                       torch.ones(8))
    with ops.shape_only():
        y = tl.apply_rmsnorm_heads(scale, meta.to(torch.bfloat16))
        z = tl.apply_rope(meta, pos, 1e4)
    assert y.device.type == "meta" and y.shape == meta.shape
    assert y.dtype == torch.bfloat16
    assert z.device.type == "meta" and z.shape == meta.shape
    assert not any(norm_rope.plain_counts.values())
    assert not any(norm_rope.launch_counts.values())
