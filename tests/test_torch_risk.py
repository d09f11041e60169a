"""Port's risk application vs the JAX engine on the same seeded tables (CPU)."""
import contextlib
import dataclasses
import io
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.risk_app import RiskAppConfig as JaxCfg
from repro.core.tenancy import TenancyConfig as JaxTenancy
from repro.launch import risk as jax_cli
from repro.risk import metrics as jax_metrics
from repro.risk.analysis import AggregateRiskAnalysis as JaxEngine
from repro.risk.tables import generate as jax_generate
from repro.risk.tables import paper_scale_nbytes as jax_paper_scale_nbytes
from repro_torch.configs.risk_app import RISK_SHAPES, RiskAppConfig
from repro_torch.core.pipeline import timeline_overlaps
from repro_torch.core.tenancy import TenancyConfig
from repro_torch.kernels import aggregate_loss as tagg
from repro_torch.launch import risk as torch_cli
from repro_torch.risk import metrics
from repro_torch.risk.analysis import AggregateRiskAnalysis
from repro_torch.risk.tables import (RiskTables, from_arrays, generate,
                                     paper_scale_nbytes)

FIELDS = ("yet", "elt_losses", "occ_ret", "occ_lim", "agg_ret", "agg_lim")


@pytest.fixture(scope="module")
def cfg():
    return RiskAppConfig().reduced()


@pytest.fixture(scope="module")
def jax_tables():
    """One table set, made by the JAX package, feeds both engines."""
    return jax_generate(JaxCfg().reduced(), seed=0)


@pytest.fixture(scope="module")
def tables(jax_tables):
    return from_arrays(jax_tables)


@pytest.fixture(scope="module")
def jax_ylt(jax_tables):
    return np.array(JaxEngine(JaxCfg().reduced()).run_single(jax_tables))


def _engine(cfg, tenants=2, mode="sequential"):
    return AggregateRiskAnalysis(cfg, TenancyConfig(1, tenants, mode),
                                 device="cpu")


def test_configs_equal():
    assert dataclasses.asdict(RiskAppConfig()) == dataclasses.asdict(JaxCfg())
    assert dataclasses.asdict(RiskAppConfig().reduced()) == \
        dataclasses.asdict(JaxCfg().reduced())
    from repro.configs.risk_app import RISK_SHAPES as jax_shapes
    assert RISK_SHAPES == jax_shapes


@pytest.mark.parametrize("seed", [0, 7])
def test_generate_bit_identical_by_seed(cfg, seed):
    a, b = generate(cfg, seed), jax_generate(JaxCfg().reduced(), seed)
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert np.asarray(x).dtype == np.asarray(y).dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert paper_scale_nbytes(RiskAppConfig()) == \
        jax_paper_scale_nbytes(JaxCfg())


def test_from_arrays_is_duck_typed(jax_tables, tables):
    assert isinstance(tables, RiskTables)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tables, f),
                                      getattr(jax_tables, f))
    assert tables.yet.dtype == np.int32 and tables.elt_losses.dtype == np.float32
    assert tables.yet is jax_tables.yet            # right dtype: no copy
    assert tables.nbytes() == jax_tables.nbytes()

    class Bag:
        yet = [[1, 2], [0, 1]]
        elt_losses = [[0.0], [1.0], [2.0]]
        occ_ret, occ_lim, agg_ret, agg_lim = [0.0], [5.0], 0, 10
    t = from_arrays(Bag)
    assert t.num_trials == 2 and isinstance(t.agg_lim, float)


def test_metrics_summary_matches_jax(jax_ylt):
    rng = np.random.default_rng(3)
    for ylt in (jax_ylt,
                rng.lognormal(12.0, 1.0, 5000).astype(np.float32)):
        want = jax_metrics.summary(jnp.asarray(ylt))
        got = metrics.summary(torch.from_numpy(ylt))
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-6, err_msg=k)


def test_run_single_matches_jax_engine(cfg, tables, jax_ylt):
    np.testing.assert_allclose(_engine(cfg).run_single(tables), jax_ylt,
                               rtol=1e-6)


@pytest.mark.parametrize("tenants,mode", [(1, "sequential"),
                                          (2, "sequential"),
                                          (4, "sequential"),
                                          (2, "concurrent")])
def test_tenant_chunked_matches_jax_engine(cfg, tables, jax_tables, tenants,
                                           mode):
    """Multi-tenancy is a pure scheduling change, in both packages."""
    want = JaxEngine(JaxCfg().reduced(), JaxTenancy(1, tenants, mode)
                     ).run_tenant_chunked(jax_tables)
    rep = _engine(cfg, tenants, mode).run_tenant_chunked(tables)
    np.testing.assert_allclose(rep.ylt, want.ylt, rtol=1e-6)
    assert rep.wall_s > 0
    assert len(rep.per_tenant_s) == tenants == len(rep.timeline)
    assert [e["vdev"] for e in rep.staging_log] == \
        [e["vdev"] for e in want.staging_log]
    assert all(tl.device_ms is None for tl in rep.timeline)   # CPU run


def test_ragged_trials_match_jax_engine(cfg):
    """67 trials over 4 vdevs: uniform padding must not perturb results."""
    jt = jax_generate(dataclasses.replace(JaxCfg().reduced(), num_trials=67),
                      seed=3)
    want = JaxEngine(JaxCfg().reduced(), JaxTenancy(1, 4)).run_tenant_chunked(jt)
    ara = _engine(cfg, 4)
    rep = ara.run_tenant_chunked(from_arrays(jt))
    np.testing.assert_allclose(rep.ylt, want.ylt, rtol=1e-6)
    np.testing.assert_array_equal(rep.ylt, ara.run_single(from_arrays(jt)))


def test_straggler_order_matches_jax_engine(cfg, tables, jax_tables):
    hist = {0: 5.0, 1: 1.0, 2: 3.0, 3: 0.5}
    want = JaxEngine(JaxCfg().reduced(), JaxTenancy(1, 4)).run_tenant_chunked(
        jax_tables, straggler_hist=hist)
    rep = _engine(cfg, 4).run_tenant_chunked(tables, straggler_hist=hist)
    np.testing.assert_allclose(rep.ylt, want.ylt, rtol=1e-6)
    assert [tl.vdev for tl in rep.timeline] == \
        [tl.vdev for tl in want.timeline] == [0, 2, 1, 3]


def test_blocking_schedule_matches_and_scores_zero_overlap(cfg, tables,
                                                           jax_tables):
    want = JaxEngine(JaxCfg().reduced(), JaxTenancy(1, 4)).run_tenant_chunked(
        jax_tables, overlapped=False)
    ara = _engine(cfg, 4)
    rep = ara.run_tenant_chunked(tables, overlapped=False)
    np.testing.assert_allclose(rep.ylt, want.ylt, rtol=1e-6)
    np.testing.assert_array_equal(
        rep.ylt, ara.run_tenant_chunked(tables, overlapped=True).ylt)
    assert len(rep.per_tenant_s) == 4
    # every transfer precedes every compute: the predicate is structurally 0
    assert timeline_overlaps(rep.timeline) == [False] * 3


def test_launch_shape_count_and_ragged_remainders(cfg, tables):
    """Uniform padding -> one chunk shape per deployment (the counterpart of
    the JAX engine's one-trace-per-deployment contract)."""
    ara = _engine(cfg, 4)
    assert ara.launch_shape_count == 0
    ara.run_tenant_chunked(tables)
    assert ara.launch_shape_count == 1     # one shape for all 4 tenants
    ara.run_tenant_chunked(tables)
    t67 = generate(dataclasses.replace(cfg, num_trials=67), seed=1)
    # 67 = 4x16+3: unpadded this would need two shapes (17- and 16-row)
    ara.run_tenant_chunked(t67)
    ara.run_tenant_chunked(t67)
    assert ara.launch_shape_count == 2     # only the new 17-row shape


def test_resident_tables_uploaded_once(cfg, tables):
    ara = _engine(cfg, 2)
    ara.run_tenant_chunked(tables)
    uploads = ara.table_uploads
    assert uploads == 1
    ara.run_tenant_chunked(tables)
    assert ara.table_uploads == uploads    # cache hit, no second upload
    # perturbing only the layer aggregate terms (what-if pricing) keeps
    # table identity, so still no upload — and changes the result
    t2 = dataclasses.replace(tables, agg_ret=tables.agg_ret * 1.5)
    y2 = ara.run_tenant_chunked(t2).ylt
    assert ara.table_uploads == uploads
    assert not np.array_equal(y2, ara.run_tenant_chunked(tables).ylt)
    ara.run_tenant_chunked(generate(cfg, seed=9))
    assert ara.table_uploads == uploads + 1
    # the resident ELT is the column-padded view (M=3 -> row stride 4)
    elt = next(iter(ara._table_cache.values()))[1][0][0]
    assert elt.shape == (cfg.event_catalog + 1, 3) and elt.stride() == (4, 1)
    ara.clear_table_cache()
    ara.run_tenant_chunked(tables)
    assert ara.table_uploads == uploads + 2


def test_resident_cache_detects_inplace_mutation(cfg):
    t = generate(cfg, seed=11)
    ara = _engine(cfg, 2)
    before = ara.run_tenant_chunked(t).ylt.copy()
    uploads = ara.table_uploads
    t.elt_losses *= 2.0                    # same array object, new content
    after = ara.run_tenant_chunked(t).ylt
    assert ara.table_uploads > uploads     # stale entry evicted + re-staged
    np.testing.assert_array_equal(after, ara.run_single(t))
    assert not np.array_equal(before, after)
    uploads = ara.table_uploads
    t.occ_ret[0] *= 0.5
    np.testing.assert_array_equal(ara.run_tenant_chunked(t).ylt,
                                  ara.run_single(t))
    assert ara.table_uploads > uploads


def test_main_path_goes_through_the_wrapper(cfg, tables):
    """On the CPU the wrapper takes the plain version — once per tenant —
    and launches nothing."""
    tagg.reset_counts()
    _engine(cfg, 4).run_tenant_chunked(tables)
    assert tagg.plain_counts["aggregate_loss_gather_plain"] == 4
    assert tagg.launch_counts == {"aggregate_loss_gather": 0,
                                  "aggregate_loss_onehot": 0}


def test_input_specs_match_jax(cfg):
    want = JaxEngine(JaxCfg().reduced()).input_specs(128)
    got = _engine(cfg).input_specs(128)
    assert list(got) == list(want)
    for k, (shape, dtype) in got.items():
        assert shape == tuple(want[k].shape) and dtype == str(want[k].dtype)


def test_metrics_properties(cfg, tables):
    ylt = torch.from_numpy(_engine(cfg).run_single(tables))
    p = metrics.pml(ylt)
    vals = [float(p[r]) for r in (10, 50, 100, 250, 500, 1000)]
    assert all(b >= a for a, b in zip(vals, vals[1:]))   # monotone in period
    assert float(metrics.tvar(ylt)) >= float(metrics.var(ylt))
    assert float(metrics.expected_loss(ylt)) <= float(tables.agg_lim)
    assert (ylt >= 0).all() and (ylt <= tables.agg_lim + 1e-3).all()


def _cli_numbers(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    out = buf.getvalue()
    vals = {m.group(1): float(m.group(2).replace(",", ""))
            for m in re.finditer(r"^\s+(\w+)\s+([\d,]+)$", out, re.M)}
    return out, vals


@pytest.mark.parametrize("extra", [[], ["--tenants", "4", "--mode",
                                        "concurrent", "--trials", "50"]])
def test_cli_metrics_match_jax_cli(extra):
    jout, want = _cli_numbers(jax_cli.main, ["--reduced"] + extra)
    tout, got = _cli_numbers(torch_cli.main,
                             ["--reduced", "--device", "cpu"] + extra)
    assert list(got) == list(want) and len(want) == 9
    for k in want:
        # printed as integers: allow the last printed digit to round apart
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1.0,
                                   err_msg=k)
    assert jout.splitlines()[-1] == tout.splitlines()[-1]   # the model's plan


def test_cli_no_reduced_selects_the_published_config(monkeypatch):
    """--no-reduced reaches RiskAppConfig() as published (checked without
    generating it: stop at table generation)."""
    seen = {}

    def stop(cfg, seed):
        seen["cfg"] = cfg
        raise KeyboardInterrupt

    monkeypatch.setattr(torch_cli, "generate", stop)
    with pytest.raises(KeyboardInterrupt):
        torch_cli.main(["--no-reduced", "--device", "cpu", "--tenants", "2"])
    assert seen["cfg"] == RiskAppConfig()
