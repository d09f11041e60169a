"""The port's device mesh against the JAX package's sharding rules, and the
sharded paged-attention wrappers against their unsharded calls.

* ``Sharder.spec`` / ``extent`` / ``_axes_for`` equal the reference's
  ``Sharder`` on a ``jax.sharding.AbstractMesh((2, 4), ("data",
  "model"))`` (one process, no devices) for the rule cases of
  ``tests/test_sharding.py`` and ``tests/test_mesh_serving.py``, and
  ``param_shardings`` over every reduced arch's parameter axes;
* ``parse_mesh`` names and extents as the reference's, raising with too
  few devices; the production meshes raise on one device;
* a ``ShardedTensor``'s shards are the slices ``index_map`` names,
  gathered back bit for bit; a replicated shard on a repeated device is
  one storage; the staging lanes land what ``place`` would;
* the three dispatch shapes of the reference's ``SHARDED_KERNEL_SCRIPT``
  against the unsharded calls, through the kernels' plain versions (CPU
  tensors): GQA split on kv heads and indivisible heads replicated bit for
  bit, MQA with q split on heads at the reference's ``atol=1e-5``; the
  sharded scatter and admission bit for bit.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as jax_config
from repro.distributed.sharding import DEFAULT_RULES as JAX_DEFAULT_RULES
from repro.distributed.sharding import Sharder as JaxSharder
from repro.distributed.sharding import serving_sharder as jax_serving
from repro.models import params as jparams
from repro.models.model import build_model as jax_build
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.transfer import MeshStagingLanes
from repro_torch.distributed.sharding import (DEFAULT_RULES, SERVING_RULES,
                                              Mesh, Sharder, ShardedTensor,
                                              null_sharder, param_shardings,
                                              parse_mesh, serving_sharder)
from repro_torch.kernels import paged_attention as pa
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models.model import build_model
from repro_torch.models.params import param_axes
from repro_torch.obs.telemetry import TELEMETRY

CPU = torch.device("cpu")


def _meshes(fsdp=False, seq_shard=False, rules=None):
    """The port's and the reference's Sharder on one (2, 4) mesh."""
    mesh = Mesh([CPU] * 8, (2, 4), ("data", "model"))
    amesh = AbstractMesh((2, 4), ("data", "model"))
    kw = dict(fsdp=fsdp, seq_shard=seq_shard, rules=rules)
    return Sharder(mesh, **kw), JaxSharder(amesh, **kw)


# the rule cases of tests/test_sharding.py and tests/test_mesh_serving.py
RULE_CASES = [
    (("fsdp", "heads"), (256, 64)),
    ((None, "heads"), (256, 6)),
    (("batch", "kvseq"), (1, 64)),
    (("batch", "kvseq"), (8, 64)),
    (("heads", "ff"), (64, 64)),
    (("batch", "seq", "embed"), (8, 16, 32)),
    ((None, None, None, "kv", None), (2, 40, 8, 8, 16)),
    ((None, None, None, "kv", None), (2, 40, 8, 3, 16)),
    ((None, "heads", None), (4, 16, 16)),
    (("expert", "embed", "ff"), (8, 32, 64)),
    (("vocab", "embed"), (250, 32)),
]


@pytest.mark.parametrize("fsdp,seq_shard", [(False, False), (True, False),
                                            (True, True)])
@pytest.mark.parametrize("logical,shape", RULE_CASES)
def test_spec_and_extent_match_reference(logical, shape, fsdp, seq_shard):
    sh, jsh = _meshes(fsdp=fsdp, seq_shard=seq_shard)
    assert sh.spec(logical, shape) == tuple(jsh.spec(logical, shape))
    for name, dim in zip(logical, shape):
        assert sh.extent(name, dim) == jsh.extent(name, dim)


def test_serving_rules_shard_only_heads():
    assert DEFAULT_RULES == JAX_DEFAULT_RULES
    assert set(SERVING_RULES) == {"heads", "kv"}
    sh, _ = _meshes(rules=SERVING_RULES)
    jsh = jax_serving(AbstractMesh((2, 4), ("data", "model")))
    for name in ("ff", "vocab", "expert", "inner", "seq", "batch"):
        assert DEFAULT_RULES[name] is not None
        assert sh._axes_for(name, 64) is None
        assert jsh._axes_for(name, 64) is None
    assert sh.extent("kv", 8) == jsh.extent("kv", 8) == 4
    one = serving_sharder(parse_mesh("1x1", [CPU]))
    assert one.extent("kv", 8) == 1


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shardings_match_reference_specs(arch):
    sh, jsh = _meshes(fsdp=True)
    boxed = jax.eval_shape(
        lambda: jax_build(jax_config(arch).reduced()).init(
            jax.random.PRNGKey(0)))
    vals, axes = jparams.split(boxed)
    cfg = get_config(arch).reduced()
    got = param_shardings(sh, param_axes(cfg),
                          build_model(cfg).init(0, "meta"))
    want = jax.tree.map(lambda a, v: tuple(jsh.spec(a, v.shape)), axes,
                        vals, is_leaf=lambda x: isinstance(x, tuple) and all(
                            isinstance(e, (str, type(None))) for e in x))

    def walk(g, w):
        if isinstance(w, dict):
            assert sorted(g) == sorted(w)
            for k in w:
                walk(g[k], w[k])
        else:
            assert g.spec == w and g.mesh is sh.mesh
    walk(got, want)
    off = param_shardings(null_sharder(), param_axes(cfg),
                          build_model(cfg).init(0, "meta"))
    assert off["final_norm"]["scale"] is None


def test_parse_mesh_names_extents_and_too_few_devices():
    assert parse_mesh(None) is None and parse_mesh("", [CPU]) is None
    m = parse_mesh("1x1", [CPU])
    assert m.axis_names == ("data", "model") and m.shape["model"] == 1
    assert parse_mesh("1", [CPU]).shape == {"data": 1, "model": 1}
    assert parse_mesh("4", [CPU] * 4).shape == {"data": 1, "model": 4}
    m3 = parse_mesh("2x2x2", [CPU] * 8)
    assert m3.axis_names == ("pod", "data", "model")
    assert m3.shape == {"pod": 2, "data": 2, "model": 2}
    assert parse_mesh("1x2", [CPU] * 5).size == 2   # the first two
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        parse_mesh("1x2", [CPU])
    with pytest.raises(ValueError, match="needs 256 devices"):
        make_production_mesh(devices=[CPU])
    with pytest.raises(ValueError, match="needs 512 devices"):
        make_production_mesh(multi_pod=True, devices=[CPU] * 8)
    loc = make_local_mesh([CPU] * 3)
    assert loc.axis_names == ("data",) and loc.shape == {"data": 3}


def test_null_sharder_is_identity():
    sh = null_sharder()
    x = torch.ones(4, 4)
    assert sh.constrain(x, ("batch", None)) is x
    assert sh.place(x, ("batch", None)) is x
    assert sh.named(("batch", None), (4, 4)) is None
    assert sh.spec(("kv",), (8,)) == (None,)


def test_place_index_map_and_gather():
    sh = Sharder(Mesh([CPU] * 8, (2, 4), ("data", "model")), fsdp=True)
    x = torch.arange(8 * 12 * 4, dtype=torch.float32).reshape(8, 12, 4)
    TELEMETRY.reset().enable()
    try:
        st = sh.place(x, ("fsdp", "heads", None))
        assert TELEMETRY.counter_snapshot()["shard.placements"] == 1
        assert TELEMETRY.counter_snapshot()["shard.placed_bytes"] == x.numel() * 4
    finally:
        TELEMETRY.disable()
    assert st.spec == ("data", "model", None)
    idx = sh.index_map(("fsdp", "heads", None), x.shape)
    for p in range(8):
        assert torch.equal(st.locals[p], x[idx[p]])
        assert st.locals[p].is_contiguous()
    assert idx[5] == (slice(4, 8), slice(3, 6), slice(0, 4))
    assert torch.equal(st.full(), x)
    assert torch.equal(sh.constrain(st, (None, None, None)), x)
    # a replicated placement on a repeated device is one storage
    rep = sh.place(x, (None, None, None))
    assert len(rep.unique()) == 1
    assert all(t.data_ptr() == x.data_ptr() for t in rep.locals)
    # split on model only: positions of one model column share a storage
    kv = sh.place(x, (None, "kv", None))
    assert len(kv.unique()) == 4 and torch.equal(kv.full(), x)
    assert torch.equal(kv[2].full(), x[2])
    z = sh.zeros((3, 8, 2), (None, "kv", None), torch.bfloat16)
    assert {tuple(t.shape) for t in z.locals} == {(3, 2, 2)}
    assert len(z.unique()) == 4 and z.dtype == torch.bfloat16


def test_staging_lanes_land_what_place_would():
    sh = serving_sharder(parse_mesh("1x4", [CPU] * 4))
    lanes = MeshStagingLanes(sh)
    assert lanes.n_lanes == 4
    rng = np.random.default_rng(0)
    tree = {"kv": torch.from_numpy(rng.normal(size=(2, 3, 4, 8, 16))
                                   .astype(np.float32)),
            "pos": torch.arange(12, dtype=torch.int32).reshape(3, 4)}
    axes = lambda a: ((None, None, None, "kv", None) if a.dim() == 5  # noqa
                      else (None,) * a.dim())
    got = lanes.wait(lanes.put(tree, axes, slot=7))
    want = sh.place(tree["kv"], axes(tree["kv"]))
    assert isinstance(got["kv"], ShardedTensor)
    assert got["kv"].spec == want.spec == (None, None, None, "model", None)
    for a, b in zip(got["kv"].locals, want.locals):
        assert torch.equal(a, b)
    assert torch.equal(got["pos"].full(), tree["pos"])
    assert all(len(e.log) == 1 for e in lanes.engines)


def _decode_case(rng, C=4, H=16, Hkv=8, D=16, NP=10, P=4, NB=3):
    """The reference's SHARDED_KERNEL_SCRIPT inputs, as torch tensors."""
    q = torch.from_numpy(rng.normal(size=(C, H, D)).astype(np.float32))
    kp = torch.from_numpy(rng.normal(size=(NP, P, Hkv, D))).to(torch.bfloat16)
    vp = torch.from_numpy(rng.normal(size=(NP, P, Hkv, D))).to(torch.bfloat16)
    pos_pool = torch.from_numpy(rng.integers(0, 8, (NP, P)).astype(np.int32))
    pt = torch.from_numpy(rng.integers(2, NP, (C, NB)).astype(np.int32))
    pos = torch.from_numpy(rng.integers(4, 12, (C,)).astype(np.int32))
    return q, kp, vp, pos_pool, pt, pos


POOL = (None, None, "kv", None)


@pytest.mark.parametrize("spec", ["1x2", "1x4", "1x8", "2x4"])
@pytest.mark.parametrize("shape", ["gqa", "mqa", "indivisible"])
def test_sharded_decode_is_its_heads_of_the_unsharded_call(spec, shape):
    rng = np.random.default_rng(0)
    q, kp, vp, pos_pool, pt, pos = _decode_case(rng)
    if shape == "mqa":
        kp, vp = kp[:, :, :1].contiguous(), vp[:, :, :1].contiguous()
    elif shape == "indivisible":
        q, kp, vp = (q[:, :12].contiguous(), kp[:, :, :3].contiguous(),
                     vp[:, :, :3].contiguous())
    sh = serving_sharder(parse_mesh(spec, [CPU] * 8))
    ref = pa.paged_attention_decode(q, kp, vp, pos_pool, pt, pos)
    ks, vs = sh.place(kp, POOL), sh.place(vp, POOL)
    n0 = pa.plain_counts["paged_attention_decode_plain"]
    out = pa.paged_attention_decode_sharded(q, ks, vs, pos_pool, pt, pos, sh)
    calls = pa.plain_counts["paged_attention_decode_plain"] - n0
    M = sh.mesh.shape["model"]
    assert isinstance(out, ShardedTensor)
    if shape == "indivisible":
        assert out.spec == (None, None, None) and calls == 1
    else:
        assert out.spec == (None, "model", None) and calls == M
        assert {tuple(t.shape) for t in out.locals} == {
            (q.shape[0], q.shape[1] // M, q.shape[2])}
    got = sh.constrain(out, (None, None, None))
    if shape == "mqa":
        # q split on heads against one kv head: each shard's dot has a
        # different group width, so its reduction may tile differently --
        # the reference's own hold for this case (f32 rounding)
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)
    else:
        assert torch.equal(got, ref)


@pytest.mark.parametrize("spec", ["1x2", "1x8"])
def test_sharded_decode_hands_the_row_mask_to_every_shard(spec):
    """The round's row mask is global, like the rows: every shard's call
    takes it, so the gathered output is the unsharded masked call's bit for
    bit, zeros in every head of a masked row."""
    rng = np.random.default_rng(2)
    q, kp, vp, pos_pool, pt, pos = _decode_case(rng)
    mask = torch.tensor([True, False, False, True])
    sh = serving_sharder(parse_mesh(spec, [CPU] * 8))
    ref = pa.paged_attention_decode(q, kp, vp, pos_pool, pt, pos,
                                    row_mask=mask)
    out = pa.paged_attention_decode_sharded(
        q, sh.place(kp, POOL), sh.place(vp, POOL), pos_pool, pt, pos, sh,
        row_mask=mask)
    got = sh.constrain(out, (None, None, None))
    assert torch.equal(got, ref)
    assert (got[~mask] == 0).all() and (got[mask] != 0).any()


@pytest.mark.parametrize("spec", ["1x2", "1x8"])
@pytest.mark.parametrize("hkv", [8, 3])
def test_sharded_scatter_and_admission_bit_for_bit(spec, hkv):
    rng = np.random.default_rng(1)
    S, NP, P, D, nb = 2, 10, 4, 16, 3
    sh = serving_sharder(parse_mesh(spec, [CPU] * 8))
    pages = torch.tensor([3, 5, 7], dtype=torch.int32)
    vals = torch.from_numpy(rng.normal(size=(S, nb, P, hkv, D))
                            .astype(np.float32))
    ref = torch.zeros((S, NP, P, hkv, D), dtype=torch.bfloat16)
    pa.paged_prefill_scatter(ref, pages, vals)
    pool = sh.place(torch.zeros_like(ref), (None, None, None, "kv", None))
    pa.paged_prefill_scatter_sharded(pool, pages, vals, sh)
    assert torch.equal(pool.full(), ref)
    # admission: K, V and positions from a dense ring of 10 (< 3 pages)
    ring = 10
    k_src = torch.from_numpy(rng.normal(size=(S, ring, hkv, D))
                             .astype(np.float32))
    v_src = torch.from_numpy(rng.normal(size=(S, ring, hkv, D))
                             .astype(np.float32))
    pos_src = torch.arange(5, 5 + ring, dtype=torch.int32)
    want = [torch.zeros((S, NP, P, hkv, D), dtype=torch.bfloat16)
            for _ in range(2)]
    want_pos = torch.full((NP, P), pa.POS_SENTINEL, dtype=torch.int32)
    pa.paged_admit_kv(*want, want_pos, pages, k_src, v_src, pos_src)
    kp, vp = (sh.place(torch.zeros_like(want[0]),
                       (None, None, None, "kv", None)) for _ in range(2))
    got_pos = torch.full((NP, P), pa.POS_SENTINEL, dtype=torch.int32)
    pa.paged_admit_kv_sharded(kp, vp, got_pos, pages, k_src, v_src, pos_src,
                              sh)
    assert torch.equal(kp.full(), want[0]) and torch.equal(vp.full(), want[1])
    assert torch.equal(got_pos, want_pos)
