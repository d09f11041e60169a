"""The paged-attention kernels' plain versions against the JAX package.

On CPU tensors the port's wrappers take their kernels' plain versions, so
these tests hold, on seeded numpy inputs handed to both packages:

* the decode (K3) plain version against ``repro.kernels.ref.
  paged_attention_decode_ref`` and against the Pallas kernel in interpret
  mode, over the cases and tolerance of ``tests/test_paged_attention.py``
  (GQA, MHA, MQA, sliding window, an all-masked row, page permutations),
  and with a row mask: masked rows zeros, live rows bit for bit the call
  without it;
* the scatter (K4) plain version bit for bit against ``paged_scatter_ref``
  and the interpret-mode Pallas scatter, with float32 and bfloat16 values;
* admission's entry into the same kernel (K and V of every stage and the
  positions in one call): its plain version bit for bit against the
  sequence of ops the continuous engine ran before it;
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


ROW_MASKS = {"some": [True, False, True, False], "none": [False] * 4,
             "all": [True] * 4}


@pytest.mark.parametrize("P,NB,H,Hkv,window", CASES)
@pytest.mark.parametrize("live", sorted(ROW_MASKS))
def test_decode_row_mask_zeros_masked_rows_and_keeps_live_bits(
        P, NB, H, Hkv, window, live):
    """K3 with a row mask, as the continuous engine hands it a round's
    live rows: each masked row is zeros, each live row bit for bit what the
    call without the mask gives it (the last row names SENTINEL only, as a
    row that never held a request does)."""
    rng = np.random.default_rng(
        [P, NB, H, Hkv, sorted(ROW_MASKS).index(live)])
    state = list(as_torch(*rand_paged_state(rng, C=4, NB=NB, P=P, H=H,
                                            Hkv=Hkv, D=8)))
    state[4][3] = SENTINEL
    mask = torch.tensor(ROW_MASKS[live])
    pa.reset_counts()
    base = pa.paged_attention_decode(*state, window=window)
    got = pa.paged_attention_decode(*state, window=window, row_mask=mask)
    assert pa.plain_counts["paged_attention_decode_plain"] == 2
    assert pa.launch_counts["paged_attention_decode"] == 0
    assert got.shape == base.shape and got.dtype == torch.float32
    assert torch.equal(got[mask], base[mask])
    assert torch.equal(got[~mask], torch.zeros_like(got[~mask]))


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
    a = pa.paged_prefill_scatter(pool.clone(), pages, wide[:, 2])
    b = pa.paged_prefill_scatter(pool.clone(), pages, wide[:, 2].contiguous())
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def _admit_sequence(k_pool, v_pool, pos_pool, pages, k_src, v_src,
                    pos_src):
    """Admission as the continuous engine wrote it before the admission
    entry: the positions padded with POS_SENTINEL by ``torch.full``, a slice
    copy and an index-put; K and V each zero-padded to whole pages by
    ``F.pad``, reshaped into page blocks and scattered."""
    nb, P = pages.shape[0], k_pool.shape[2]
    ring = k_src.shape[1]
    pos_vals = torch.full((nb * P,), POS_SENTINEL, dtype=torch.int32)
    pos_vals[:ring] = pos_src
    pos_pool[pages.long()] = pos_vals.view(nb, P)
    pad = nb * P - ring
    for pool, leaf in ((k_pool, k_src), (v_pool, v_src)):
        if pad:
            leaf = torch.nn.functional.pad(leaf, (0, 0, 0, 0, 0, pad))
        vals = leaf.reshape(k_src.shape[0], nb, P, *leaf.shape[2:])
        pa.paged_prefill_scatter(pool, pages, vals)


# (S, NP, P, Hkv, D, pages, ring): rings that fill their last page and
# rings that do not
ADMIT_CASES = [(2, 9, 4, 2, 8, [4, 2, 7], 12), (3, 10, 4, 1, 24, [2, 9], 5),
               (2, 12, 8, 2, 16, [3, 5, 6, 11], 27),
               (1, 6, 4, 2, 8, [3], 1)]


@pytest.mark.parametrize("stride", ["contiguous", "stage-strided"])
@pytest.mark.parametrize("values_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,NP_,P,Hkv,D,pages,ring", ADMIT_CASES)
def test_admission_plain_equals_the_sequence_it_replaces(
        S, NP_, P, Hkv, D, pages, ring, values_dtype, stride):
    """One call writes K, V and the positions exactly as the pad, reshape,
    full, slice copy and index-put sequence did: the same bits in every
    pool, the sentinel tail past the ring, every other page untouched."""
    rng = np.random.default_rng(11)
    dt = getattr(torch, values_dtype)
    kp, vp = (torch.from_numpy(rng.standard_normal(
        (S, NP_, P, Hkv, D)).astype(np.float32)).to(torch.bfloat16)
        for _ in range(2))
    pos_pool = torch.from_numpy(rng.integers(0, 99, (NP_, P)).astype(
        np.int32))
    wide = [torch.from_numpy(rng.standard_normal(
        (S, 3, ring, Hkv, D)).astype(np.float32)).to(dt) for _ in range(2)]
    k_src, v_src = ((w[:, 1] if stride == "stage-strided"
                     else w[:, 1].contiguous()) for w in wide)
    pos_src = torch.arange(40, 40 + ring, dtype=torch.int32)
    pg = torch.tensor(pages, dtype=torch.int32)
    want = [t.clone() for t in (kp, vp, pos_pool)]
    _admit_sequence(*want[:3], pg, k_src, v_src, pos_src)
    got = [t.clone() for t in (kp, vp, pos_pool)]
    pa.reset_counts()
    ops.paged_admit_kv(*got, pg, k_src, v_src, pos_src)
    assert pa.plain_counts["paged_prefill_scatter_plain"] == 2
    assert not any(pa.launch_counts.values())
    for a, b in zip(got[:2], want[:2]):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert torch.equal(got[2], want[2])
    last = got[2][pages[-1]]
    live = ring - (len(pages) - 1) * P
    assert (last[live:] == POS_SENTINEL).all()
    assert torch.equal(last[:live], pos_src[-live:])
    untouched = [p for p in range(NP_) if p not in pages]
    for a, b in zip(got[:2], (kp, vp)):
        assert torch.equal(a[:, untouched].view(torch.int16),
                           b[:, untouched].view(torch.int16))
    assert torch.equal(got[2][untouched], pos_pool[untouched])
    # the reference's scatter on the zero-padded K gives the same pool
    padded = torch.nn.functional.pad(k_src.float(), (0, 0, 0, 0, 0,
                                                     len(pages) * P - ring))
    jk = jax_scatter_ref(jnp.asarray(kp.float().numpy(), jnp.bfloat16),
                         jnp.asarray(pages, jnp.int32),
                         jnp.asarray(padded.reshape(
                             S, len(pages), P, Hkv, D).numpy()).astype(
                                 getattr(jnp, values_dtype)))
    np.testing.assert_array_equal(got[0].float().numpy(),
                                  np.asarray(jk.astype(jnp.float32)))


def test_admission_of_a_second_sublayer_leaves_positions_alone():
    """``pos_pool=None``: K and V are written, the positions are not."""
    S, NP_, P, Hkv, D = 2, 8, 4, 2, 8
    kp = torch.zeros((S, NP_, P, Hkv, D), dtype=torch.bfloat16)
    vp = torch.zeros_like(kp)
    src = torch.ones((S, 6, Hkv, D))
    pa.reset_counts()
    ops.paged_admit_kv(kp, vp, None, torch.tensor([3, 5], dtype=torch.int32),
                       src, 2 * src, torch.arange(6, dtype=torch.int32))
    assert pa.plain_counts["paged_prefill_scatter_plain"] == 2
    assert (kp[:, 3] == 1).all() and (vp[:, 5, :2] == 2).all()
    assert (vp[:, 5, 2:] == 0).all()


def test_admission_rejects_a_ring_that_does_not_fit_its_pages():
    kp = torch.zeros((1, 8, 4, 2, 8), dtype=torch.bfloat16)
    pos_pool = torch.zeros((8, 4), dtype=torch.int32)
    for ring in (4, 9):                 # two pages of 4 hold 5 .. 8
        src = torch.zeros((1, ring, 2, 8))
        with pytest.raises(ValueError, match="ring"):
            pa.paged_admit_kv(kp, kp.clone(), pos_pool,
                              torch.tensor([2, 3], dtype=torch.int32), src,
                              src, torch.arange(ring, dtype=torch.int32))


def test_wrappers_reject_bad_shapes():
    q, k, v, pp_, pt, pos = as_torch(*rand_paged_state(
        np.random.default_rng(1), C=2, NB=2, P=4, H=4, Hkv=2, D=8))
    with pytest.raises(ValueError):
        pa.paged_attention_decode(q[:, :3], k, v, pp_, pt, pos)    # H % Hkv
    with pytest.raises(ValueError):
        pa.paged_attention_decode(q, k, v, pp_[:, :2], pt, pos)
    with pytest.raises(ValueError):
        pa.paged_attention_decode(q, k, v, pp_, pt[:1], pos)
    with pytest.raises(ValueError, match="row_mask"):
        pa.paged_attention_decode(q, k, v, pp_, pt, pos,
                                  row_mask=torch.ones(3, dtype=torch.bool))
    pool = torch.zeros((2, 6, 4, 2, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        pa.paged_prefill_scatter(pool, torch.tensor([2, 3]),
                                 torch.zeros((2, 3, 4, 2, 8)))


def _admits(kpos, pos, window):
    ok = kpos <= pos
    if window is not None:
        ok &= kpos > pos - window
    return ok


def _readable(pos_pool, row, pos, window):
    """Which entries of a table row name a page holding a key the row
    admits (the pages the kernel reads)."""
    return [bool(_admits(pos_pool[int(p)], pos, window).any()) for p in row]


def _with_sentinel_middle(state, rng):
    """The state with a SENTINEL entry inserted at a random place of every
    row's table (the named pages keep their order)."""
    q, k, v, pp_, table, pos = state
    C, NB = table.shape
    wide = np.full((C, NB + 1), SENTINEL, np.int32)
    for c in range(C):
        j = int(rng.integers(0, NB + 1))
        wide[c, :j], wide[c, j + 1:] = table[c, :j], table[c, j:]
    return q, k, v, pp_, wide, pos


def _windowed(state, window):
    """Every row's position moved late enough that its window masks the
    pages early in its table whole (each row keeps one admissible key)."""
    q, k, v, pp_, table, pos = state
    pos = pos.copy()
    for c in range(table.shape[0]):
        named = pp_[table[c][table[c] != SENTINEL]]
        pos[c] = int(named[named != POS_SENTINEL].max())
    return q, k, v, pp_, table, pos


@pytest.mark.parametrize("layout", ["sentinel padding", "sentinel middle",
                                    "window masks early pages"])
def test_dropping_unreadable_entries_keeps_every_live_row(layout):
    """K3 reads only pages holding a key the row admits.  For a row with an
    admissible key, the plain version over that row's table with every
    other entry dropped agrees with the reference's oracle over the full
    table at the paged tolerance: the dropped entries' weights are exactly
    0."""
    rng = np.random.default_rng(29)
    window = 5 if layout.startswith("window") else None
    state = rand_paged_state(rng, C=4, NB=4, P=4, H=4, Hkv=2, D=8)
    if layout == "sentinel padding":
        q, k, v, pp_, table, pos = state
        state = (q, k, v, pp_, np.concatenate(
            [table, np.full((4, 5), SENTINEL, np.int32)], axis=1), pos)
    elif layout == "sentinel middle":
        state = _with_sentinel_middle(state, rng)
    else:
        state = _windowed(state, window)
    q, k, v, pp_, table, pos = state
    j = as_jax(*state)
    full = np.asarray(jax_decode_ref(j[0], j[1], j[2], j[4], j[5],
                                     pos_pool=j[3], window=window))
    dropped = 0
    for c in range(table.shape[0]):
        keep = _readable(pp_, table[c], pos[c], window)
        assert any(keep)
        dropped += keep.count(False)
        row = table[c][keep][None]
        one = pa.paged_attention_decode_plain(*as_torch(
            q[c:c + 1], k, v, pp_, row, pos[c:c + 1]), window=window)
        agree(one[0].numpy(), full[c])
    assert dropped > 0


def _split_decode(q, k_pool, v_pool, pos_pool, table, positions, window,
                  chunk):
    """The K3 kernel's walk, written out in float32: the table cut into
    splits of ``chunk`` entries; a split reads only pages holding an
    admissible key, or -- when the whole row has none -- every page of its
    range; an online softmax over its pages gives a partial (m, l, acc);
    the partials are combined in split order."""
    C, H, D = q.shape
    NB = table.shape[1]
    Hkv = k_pool.shape[2]
    rep = H // Hkv
    qf = q.float()
    out = torch.empty((C, H, D))
    for c in range(C):
        pos = int(positions[c])
        ok = [_admits(pos_pool[int(p)], pos, window) for p in table[c]]
        row_any = any(bool(o.any()) for o in ok)
        parts = []
        for e0 in range(0, NB, chunk):
            m = torch.full((H,), -1e30)
            l = torch.zeros((H,))
            acc = torch.zeros((H, D))
            for e in range(e0, min(NB, e0 + chunk)):
                if row_any and not bool(ok[e].any()):
                    continue                      # a page the row cannot read
                kt = k_pool[int(table[c, e])].float()     # (P, Hkv, D)
                vt = v_pool[int(table[c, e])].float()
                kh = kt.repeat_interleave(rep, dim=1)     # (P, H, D)
                vh = vt.repeat_interleave(rep, dim=1)
                s = (kh * qf[c][None]).sum(-1).T / D ** 0.5   # (H, P)
                s = s + torch.where(ok[e], 0.0, -1e30)[None].float()
                m_new = torch.maximum(m, s.amax(-1))
                p = torch.exp(s - m_new[:, None])
                alpha = torch.exp(m - m_new)
                acc = acc * alpha[:, None] + torch.einsum("hp,phd->hd", p, vh)
                l = l * alpha + p.sum(-1)
                m = m_new
            parts.append((m, l, acc))
        M = torch.stack([p[0] for p in parts]).amax(0)
        L = sum(torch.exp(p[0] - M) * p[1] for p in parts)
        A = sum(torch.exp(p[0] - M)[:, None] * p[2] for p in parts)
        out[c] = A / torch.where(L == 0, torch.ones_like(L), L)[:, None]
    return out


@pytest.mark.parametrize("chunk", [1, 2, 3, 5, 6])
@pytest.mark.parametrize("layout", ["sentinel padding", "sentinel middle",
                                    "window masks early pages",
                                    "all-masked row"])
def test_split_and_combine_equals_the_full_softmax(layout, chunk):
    """The kernel's split walk -- splits of 1 .. NB entries, some of them
    holding only skipped pages -- equals the full-row softmax of the
    reference's oracle and of the port's plain version at the paged
    tolerance; an all-masked row keeps its uniform average over every
    entry, SENTINEL pages included.  This checks the design's numerics; the
    kernel itself is held on the card by ``chip_smoke.py``."""
    rng = np.random.default_rng(31 + chunk)
    window = 5 if layout.startswith("window") else None
    state = rand_paged_state(rng, C=3, NB=4, P=4, H=4, Hkv=2, D=8)
    q, k, v, pp_, table, pos = state
    if layout == "sentinel padding":
        state = (q, k, v, pp_, np.concatenate(
            [table, np.full((3, 2), SENTINEL, np.int32)], axis=1), pos)
    elif layout == "sentinel middle":
        state = _with_sentinel_middle(state, rng)
    elif layout.startswith("window"):
        state = _windowed(state, window)
    else:
        table = table.copy()
        table[1] = SENTINEL
        table[1, 2] = table[0, 0]                 # a named page, all ahead
        pos = pos.copy()
        pos[1] = -1                               # ... of a row at -1
        state = (q, k, v, pp_, table, pos)
    ts = as_torch(*state)
    j = as_jax(*state)
    oracle = jax_decode_ref(j[0], j[1], j[2], j[4], j[5], pos_pool=j[3],
                            window=window)
    want = pa.paged_attention_decode_plain(*ts, window=window)
    got = _split_decode(*ts, window, chunk)
    agree(got.numpy(), oracle)
    agree(got.numpy(), want.numpy())
    if layout == "all-masked row":
        v_row = ts[2][ts[4][1].long()].float()     # (NB, P, Hkv, D)
        uniform = v_row.reshape(-1, 2, 8).mean(0).repeat_interleave(2, 0)
        agree(got[1].numpy(), uniform.numpy())
