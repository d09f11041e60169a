"""The paged-attention kernels' plain versions against the JAX package.

On CPU tensors the port's wrappers take their kernels' plain versions, so
these tests hold, on seeded numpy inputs handed to both packages:

* the decode (K3) plain version against ``repro.kernels.ref.
  paged_attention_decode_ref`` and against the Pallas kernel in interpret
  mode, over the cases and tolerance of ``tests/test_paged_attention.py``
  (GQA, MHA, MQA, sliding window, an all-masked row, page permutations);
* the scatter (K4) plain version bit for bit against ``paged_scatter_ref``
  and the interpret-mode Pallas scatter, with float32 and bfloat16 values;
* the wrappers' dispatch: a CPU tensor goes to the plain version and is
  counted as such, a bad shape raises.

The CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import (paged_attention_decode_pallas,
                                           paged_prefill_scatter_pallas)
from repro.kernels.ref import paged_attention_decode_ref as jax_decode_ref
from repro.kernels.ref import paged_scatter_ref as jax_scatter_ref
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref
from repro_torch.serving.kvcache import POS_SENTINEL, PagedKVCache

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                      # pragma: no cover - CI installs it
    HAVE_HYPOTHESIS = False

RESERVED, SENTINEL = PagedKVCache.RESERVED, PagedKVCache.SENTINEL


def rand_paged_state(rng, *, C, NB, P, H, Hkv, D, n_extra_pages=3):
    """Numpy twin of tests/test_paged_attention.py::_rand_paged_state:
    ragged per-row rings over distinct pages, SENTINEL-padded tables, the
    dense ring's positions (rings may have wrapped), distractor pages.
    Returns float32 pools; each side casts them to bfloat16."""
    NP_ = RESERVED + C * NB + n_extra_pages
    k_pool = rng.standard_normal((NP_, P, Hkv, D)).astype(np.float32)
    v_pool = rng.standard_normal((NP_, P, Hkv, D)).astype(np.float32)
    pos_pool = np.full((NP_, P), POS_SENTINEL, np.int32)
    table = np.full((C, NB), SENTINEL, np.int32)
    free = list(rng.permutation(np.arange(RESERVED, NP_)))
    positions = np.zeros((C,), np.int32)
    for c in range(C):
        nb_c = int(rng.integers(1, NB + 1))
        ring = nb_c * P
        pos = int(rng.integers(ring - P, 2 * ring + 3))
        positions[c] = pos
        pages = [free.pop() for _ in range(nb_c)]
        table[c, :nb_c] = pages
        for j in range(ring):
            filled = j <= pos
            wraps = (pos - j) // ring if filled else 0
            pos_pool[pages[j // P], j % P] = (j + wraps * ring if filled
                                              else POS_SENTINEL)
    q = rng.standard_normal((C, H, D)).astype(np.float32)
    return q, k_pool, v_pool, pos_pool, table, positions


def as_jax(q, k_pool, v_pool, pos_pool, table, positions, q_dtype=jnp.float32):
    return (jnp.asarray(q, q_dtype), jnp.asarray(k_pool, jnp.bfloat16),
            jnp.asarray(v_pool, jnp.bfloat16), jnp.asarray(pos_pool),
            jnp.asarray(table), jnp.asarray(positions))


def as_torch(q, k_pool, v_pool, pos_pool, table, positions,
             q_dtype=torch.float32):
    t = torch.from_numpy
    return (t(q).to(q_dtype), t(k_pool).to(torch.bfloat16),
            t(v_pool).to(torch.bfloat16), t(pos_pool), t(table),
            t(positions))


def agree(a, b, rtol=3e-5, atol=3e-6):
    """tests/test_paged_attention.py::_agree"""
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def test_bf16_casts_agree_bit_for_bit():
    """Both frameworks round float32 to bfloat16 to nearest even, so the
    pools handed to either side hold the same bits."""
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    a = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    b = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(a, b)


CASES = [(4, 3, 4, 2, None),   # GQA 2:1, three ragged blocks
         (8, 2, 2, 2, None),   # MHA
         (4, 2, 4, 1, None),   # MQA
         (4, 4, 4, 2, 6)]      # sliding window smaller than the ring


@pytest.mark.parametrize("P,NB,H,Hkv,window", CASES)
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_jax_oracle(P, NB, H, Hkv, window, q_dtype):
    rng = np.random.default_rng(hash((P, NB, H, Hkv, window or 0)) % 2**31)
    state = rand_paged_state(rng, C=3, NB=NB, P=P, H=H, Hkv=Hkv, D=8)
    pa.reset_counts()
    got = pa.paged_attention_decode(
        *as_torch(*state, q_dtype=getattr(torch, q_dtype)), window=window)
    assert pa.plain_counts["paged_attention_decode_plain"] == 1
    assert pa.launch_counts["paged_attention_decode"] == 0
    j = as_jax(*state, q_dtype=getattr(jnp, q_dtype))
    want = jax_decode_ref(j[0], j[1], j[2], j[4], j[5], pos_pool=j[3],
                          window=window)
    assert got.shape == want.shape == (3, H, 8)
    assert got.dtype == torch.float32
    agree(got.numpy(), want)


@pytest.mark.parametrize("P,NB,H,Hkv,window", CASES)
def test_decode_plain_matches_pallas_interpret(P, NB, H, Hkv, window):
    rng = np.random.default_rng(hash((P, NB, H, Hkv, window or 0)) % 2**31)
    state = rand_paged_state(rng, C=3, NB=NB, P=P, H=H, Hkv=Hkv, D=8)
    got = pa.paged_attention_decode(*as_torch(*state), window=window)
    want = paged_attention_decode_pallas(*as_jax(*state), window=window)
    agree(got.numpy(), want)


def test_decode_all_masked_row_degenerates_like_softmax():
    """An all-SENTINEL table row averages its (masked) values uniformly,
    finite, like the full softmax over an all -1e30 row and like the
    Pallas kernel."""
    rng = np.random.default_rng(5)
    state = list(rand_paged_state(rng, C=2, NB=2, P=4, H=2, Hkv=2, D=8))
    state[4][0] = SENTINEL
    got = pa.paged_attention_decode(*as_torch(*state))
    assert torch.isfinite(got).all()
    agree(got.numpy(), paged_attention_decode_pallas(*as_jax(*state)))
    # H == Hkv: head h reads kv head h, averaged over the SENTINEL page
    sentinel_v = torch.from_numpy(state[2][SENTINEL]).to(torch.bfloat16)
    agree(got[0].numpy(), sentinel_v.float().mean(dim=0).numpy())


def test_decode_kpos_and_pos_pool_forms_agree():
    """The oracle takes validity pre-gathered (kpos) or from the position
    pool, like the reference's; both give the same numbers."""
    rng = np.random.default_rng(11)
    q, k, v, pp_, pt, pos = as_torch(*rand_paged_state(
        rng, C=4, NB=3, P=4, H=4, Hkv=2, D=8))
    kpos = pp_[pt.long()].reshape(4, -1)
    a = ref.paged_attention_decode_ref(q, k, v, pt, pos, kpos=kpos)
    b = ref.paged_attention_decode_ref(q, k, v, pt, pos, pos_pool=pp_)
    assert torch.equal(a, b)
    assert torch.equal(ops.paged_attention_decode(q, k, v, pp_, pt, pos), b)


def _permuted(perm, q, k, v, pp_, pt, pos):
    inv = torch.from_numpy(np.argsort(perm))
    return (q, k[inv], v[inv], pp_[inv],
            torch.from_numpy(perm.astype(np.int32))[pt.long()], pos)


def _page_permutation(rng, n):
    ids = np.arange(n)
    body = ids[RESERVED:].copy()
    rng.shuffle(body)
    ids[RESERVED:] = body
    return ids


def test_page_permutation_invariance_fuzz():
    """Relabelling every physical page (pool rows and table entries alike)
    leaves the output bit for bit: it depends on page content and block
    order only."""
    rng = np.random.default_rng(17)
    for _ in range(6):
        state = as_torch(*rand_paged_state(rng, C=3, NB=3, P=4, H=4, Hkv=2,
                                           D=8))
        base = pa.paged_attention_decode(*state)
        perm = _page_permutation(rng, state[1].shape[0])
        assert torch.equal(base, pa.paged_attention_decode(
            *_permuted(perm, *state)))


@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis not installed")
def test_page_permutation_invariance_property():
    rng = np.random.default_rng(23)
    state = as_torch(*rand_paged_state(rng, C=2, NB=2, P=4, H=2, Hkv=2, D=8))
    base = pa.paged_attention_decode(*state)
    n = state[1].shape[0]

    @settings(max_examples=10, deadline=None)
    @given(st.permutations(list(range(RESERVED, n))))
    def run(body):
        perm = np.concatenate([np.arange(RESERVED), np.asarray(body)])
        assert torch.equal(base, pa.paged_attention_decode(
            *_permuted(perm, *state)))

    run()


@pytest.mark.parametrize("values_dtype", ["float32", "bfloat16"])
def test_scatter_plain_bit_exact_with_jax(values_dtype):
    """The scatter's plain version writes exactly the cast values into the
    named pages, in place, and leaves every other page's bits alone -- as
    ``paged_scatter_ref`` and the interpret-mode Pallas scatter do."""
    rng = np.random.default_rng(3)
    S, NP_, P, Hkv, D, nb = 2, 9, 4, 2, 8, 3
    pool_np = rng.standard_normal((S, NP_, P, Hkv, D)).astype(np.float32)
    vals_np = rng.standard_normal((S, nb, P, Hkv, D)).astype(np.float32)
    pages_np = np.asarray([4, 2, 7], np.int32)
    pool = torch.from_numpy(pool_np).to(torch.bfloat16)
    before = pool.clone()
    values = torch.from_numpy(vals_np).to(getattr(torch, values_dtype))
    pa.reset_counts()
    out = pa.paged_prefill_scatter(pool, torch.from_numpy(pages_np), values)
    assert out is pool and out.dtype == torch.bfloat16
    assert pa.plain_counts["paged_prefill_scatter_plain"] == 1
    jpool = jnp.asarray(pool_np, jnp.bfloat16)
    jvals = jnp.asarray(vals_np, getattr(jnp, values_dtype))
    jpages = jnp.asarray(pages_np)
    for want in (jax_scatter_ref(jpool, jpages, jvals),
                 paged_prefill_scatter_pallas(jpool, jpages, jvals)):
        np.testing.assert_array_equal(
            out.float().numpy(), np.asarray(want.astype(jnp.float32)))
    untouched = [p for p in range(NP_) if p not in pages_np]
    assert torch.equal(out[:, untouched].view(torch.int16),
                       before[:, untouched].view(torch.int16))
    assert torch.equal(ref.paged_scatter_ref(before, torch.from_numpy(
        pages_np), values).view(torch.int16), out.view(torch.int16))


def test_scatter_takes_stage_strided_values():
    """Admission hands the scatter one row of a batched prefill: values
    strided along the stage axis give the same pool as contiguous ones."""
    rng = np.random.default_rng(9)
    S, NP_, P, Hkv, D = 3, 10, 4, 2, 8
    pool = torch.from_numpy(rng.standard_normal(
        (S, NP_, P, Hkv, D)).astype(np.float32)).to(torch.bfloat16)
    wide = torch.from_numpy(rng.standard_normal(
        (S, 4, 2, P, Hkv, D)).astype(np.float32))
    pages = torch.tensor([5, 8], dtype=torch.int32)
    a = ops.paged_scatter(pool.clone(), pages, wide[:, 2])
    b = ops.paged_scatter(pool.clone(), pages, wide[:, 2].contiguous())
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_wrappers_reject_bad_shapes():
    q, k, v, pp_, pt, pos = as_torch(*rand_paged_state(
        np.random.default_rng(1), C=2, NB=2, P=4, H=4, Hkv=2, D=8))
    with pytest.raises(ValueError):
        pa.paged_attention_decode(q[:, :3], k, v, pp_, pt, pos)    # H % Hkv
    with pytest.raises(ValueError):
        pa.paged_attention_decode(q, k, v, pp_[:, :2], pt, pos)
    with pytest.raises(ValueError):
        pa.paged_attention_decode(q, k, v, pp_, pt[:1], pos)
    pool = torch.zeros((2, 6, 4, 2, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        pa.paged_prefill_scatter(pool, torch.tensor([2, 3]),
                                 torch.zeros((2, 3, 4, 2, 8)))
