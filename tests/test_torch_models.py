"""The port's framework-free modules (perf model, energy model, planner,
telemetry) equal the JAX package's over a grid of inputs."""
import dataclasses

import pytest

from repro.core import energymodel as jem
from repro.core import perfmodel as jpm
from repro.core import planner as jplanner
from repro.obs import telemetry as jtel
from repro_torch.core import energymodel as em
from repro_torch.core import perfmodel as pm
from repro_torch.core import planner
from repro_torch.obs import Telemetry, get_telemetry, record_timeline
from repro_torch.obs import telemetry as ttel

NETS = ["QDR", "FDR"]
GRID = [(p, v) for p in (1, 2, 5, 9, 12) for v in (1, 2, 4, 7)]


def _inputs(mod, net, **kw):
    return mod.PerfModelInputs(net=getattr(mod, net), **kw)


@pytest.mark.parametrize("net", NETS)
def test_constants_equal(net):
    assert dataclasses.asdict(getattr(pm, net)) == \
        dataclasses.asdict(getattr(jpm, net))
    assert dataclasses.asdict(_inputs(pm, net)) == \
        dataclasses.asdict(_inputs(jpm, net))
    assert dataclasses.asdict(em.K20) == dataclasses.asdict(jem.K20)
    assert pm.MAX_PDEV_PLATFORM == jpm.MAX_PDEV_PLATFORM


@pytest.mark.parametrize("net", NETS)
@pytest.mark.parametrize("compute", [9.55, 0.4])
def test_perfmodel_equal_over_grid(net, compute):
    a = _inputs(pm, net, compute_time_1pdev=compute)
    b = _inputs(jpm, net, compute_time_1pdev=compute)
    for p, v in GRID:
        assert pm.t_computation(p, a) == jpm.t_computation(p, b)
        assert pm.t_transfer(p, a) == jpm.t_transfer(p, b)
        assert pm.exec_time_no_mt(p, a) == jpm.exec_time_no_mt(p, b)
        assert pm.exec_time_multitenancy(p, v, a) == \
            jpm.exec_time_multitenancy(p, v, b)
        for ctx in (False, True):
            assert pm.memory_per_pdev_mb(p, v, a, ctx) == \
                jpm.memory_per_pdev_mb(p, v, b, ctx)
        assert pm.feasible(p, v, a) == jpm.feasible(p, v, b)
    assert pm.surface(a) == jpm.surface(b)


@pytest.mark.parametrize("net", NETS)
def test_energymodel_equal_over_grid(net):
    a, b = _inputs(pm, net), _inputs(jpm, net)
    for p, v in GRID:
        assert em.total_energy(p, v, a) == jem.total_energy(p, v, b)
    assert em.energy_surface(a) == jem.energy_surface(b)
    assert em.edp_surface(a) == jem.edp_surface(b)


@pytest.mark.parametrize("net", NETS)
@pytest.mark.parametrize("objective", ["time", "energy", "edp"])
@pytest.mark.parametrize("budget", [None, 3])
def test_planner_equal(net, objective, budget):
    got = planner.plan(_inputs(pm, net), objective, budget_pdev=budget)
    want = jplanner.plan(_inputs(jpm, net), objective, budget_pdev=budget)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.n_vdev, got.edp) == (want.n_vdev, want.edp)


def test_planner_reproduces_paper_optima_and_surface():
    assert (lambda d: (d.n_pdev, d.tenants_per_pdev))(
        planner.plan(_inputs(pm, "FDR"), "time")) == (9, 2)
    assert (lambda d: (d.n_pdev, d.tenants_per_pdev))(
        planner.plan(_inputs(pm, "QDR"), "time")) == (7, 2)
    got = planner.full_surface(_inputs(pm, "FDR"), max_pdev=4, max_tenants=4)
    want = jplanner.full_surface(_inputs(jpm, "FDR"), max_pdev=4,
                                 max_tenants=4)
    assert {k: dataclasses.asdict(v) for k, v in got.items()} == \
        {k: dataclasses.asdict(v) for k, v in want.items()}
    assert dataclasses.asdict(planner.evaluate(2, 2, _inputs(pm, "QDR"))) == \
        dataclasses.asdict(jplanner.evaluate(2, 2, _inputs(jpm, "QDR")))


def _drive(mod):
    """The same script of telemetry calls against either package."""
    tel = mod.Telemetry(enabled=True, max_spans=4)
    with tel.span("a.outer", k=1) as s:
        s.note(extra=2)
        with tel.span("a.inner"):
            tel.count("c.hits")
            tel.count("c.hits", 2)
        tel.event("a.tick", n=3)
    tel.gauge("g.depth", 7)
    for v in (3.0, 1.0, 2.0):
        tel.observe("h.lat", v)
    tel.record_span("r.window", tel.t0 + 1.0, tel.t0 + 2.5, vdev=4)
    for i in range(3):
        tel.event("a.fill", i=i)
    spans = [(s.name, s.parent_id, s.span_id, dict(s.attrs))
             for s in tel.spans()]
    return (spans, tel.metric_snapshot(), tel.spans_opened,
            tel.spans_dropped, [s.name for s in tel.spans(prefix="a.f")],
            [round(s.duration, 9) for s in tel.spans("r.window")])


def test_telemetry_spans_and_counters_equal():
    assert _drive(ttel) == _drive(jtel)


def test_telemetry_disabled_costs_nothing_and_timeline_spans():
    tel = Telemetry(enabled=False)
    assert tel.span("x") is ttel.NULL_SPAN
    tel.count("c")
    tel.event("e")
    assert tel.record_span("r", 0.0, 1.0) is None
    assert tel.spans_opened == 0 and tel.counter_snapshot() == {}
    assert get_telemetry(None) is ttel.TELEMETRY and get_telemetry(tel) is tel

    from repro_torch.core.pipeline import TenantTimeline
    from repro.core.pipeline import TenantTimeline as JaxTimeline
    out = []
    for mod, cls in ((ttel, TenantTimeline), (jtel, JaxTimeline)):
        t = mod.Telemetry(enabled=True)
        mod.record_timeline(t, cls(3, 0, 1, 0.1, 0.2, 0.2, 0.5), base=t.t0,
                            run=1)
        out.append([(s.name, round(s.t_start, 9), round(s.t_end, 9),
                     s.parent_id, dict(s.attrs)) for s in t.spans()])
    assert out[0] == out[1] and len(out[0]) == 2
    assert record_timeline is ttel.record_timeline
