"""The port's discrete-event simulator against the JAX package's.

``repro_torch.core.simulator`` is pure Python on the port's own tenancy
pool, perf model and energy model; it must give the reference's results
exactly -- the same float arithmetic in the same order -- over a grid of
deployments (n_pdev 1-12, tenants 1-8), both transfer modes, QDR and FDR,
the cell-quantised and the continuous schedule, and the paper's own cell
counts (88, 80, 76).
"""
import dataclasses

import pytest

from repro.core import perfmodel as jpm
from repro.core import simulator as jsim
from repro.core.tenancy import TenancyConfig as JTenancy
from repro.core.tenancy import VirtualDevicePool as JPool
from repro_torch.core import perfmodel as pm
from repro_torch.core import simulator as sim
from repro_torch.core.tenancy import TenancyConfig, VirtualDevicePool

NETS = {"QDR": (pm.QDR, jpm.QDR), "FDR": (pm.FDR, jpm.FDR)}
MODES = ("sequential", "concurrent")
GRID = [(p, t) for p in range(1, 13) for t in range(1, 9)]


def _fields(res):
    """Every number a SimResult carries, in order."""
    return (res.makespan, res.utilization, res.energy_ws,
            [dataclasses.astuple(e) for e in res.events])


def _pair(net, mode, p, t, **kw):
    n, jn = NETS[net]
    return (sim.SimInputs(TenancyConfig(p, t, mode), net=n, **kw),
            jsim.SimInputs(JTenancy(p, t, mode), net=jn, **kw))


@pytest.mark.parametrize("cells", [False, True], ids=["continuous", "cells"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("net", sorted(NETS))
def test_simulate_equals_reference_over_the_grid(net, mode, cells):
    """``simulate`` / ``simulate_cells``: makespan, utilisation, energy and
    every event's windows equal the reference's bit for bit."""
    for p, t in GRID:
        si, jsi = _pair(net, mode, p, t)
        got = sim.simulate_cells(si) if cells else sim.simulate(si)
        want = jsim.simulate_cells(jsi) if cells else jsim.simulate(jsi)
        assert _fields(got) == _fields(want), (p, t)
        assert got.steps() == want.steps()


@pytest.mark.parametrize("cells", [False, True], ids=["continuous", "cells"])
@pytest.mark.parametrize("net", sorted(NETS))
def test_makespan_steps_equal_reference(net, cells):
    for mode in MODES:
        for p, t in GRID:
            si, jsi = _pair(net, mode, p, t)
            assert (sim.makespan_steps(p, t, mode, si=si, cells=cells)
                    == jsim.makespan_steps(p, t, mode, si=jsi, cells=cells))
            assert (sim.makespan_steps(p, t, mode, cells=cells)
                    == jsim.makespan_steps(p, t, mode, cells=cells))


@pytest.mark.parametrize("net", sorted(NETS))
def test_concurrent_vs_sequential_equals_reference(net):
    for p in range(1, 13):
        si, jsi = _pair(net, "sequential", p, 1)
        got = sim.concurrent_vs_sequential(p, si)
        want = jsim.concurrent_vs_sequential(p, jsi)
        assert list(got) == list(want) == ["concurrent", "sequential"]
        for mode in got:
            assert _fields(got[mode]) == _fields(want[mode]), (p, mode)
        assert (_fields(sim.concurrent_vs_sequential(p)["sequential"])
                == _fields(jsim.concurrent_vs_sequential(p)["sequential"]))


def test_inputs_off_the_paper_equal_reference():
    """Fitted-looking inputs (a card's link and compute, a cut YET, other
    power constants) through both, as ``plan_from_telemetry`` feeds them."""
    from repro.core import energymodel as jem
    from repro_torch.core import energymodel as em
    n = pm.NetworkParams("card", 0.0, 0.00021, 0.0, 0.0, 0.0741)
    jn = jpm.NetworkParams("card", 0.0, 0.00021, 0.0, 0.0, 0.0741)
    pw = em.PowerParams("card", 312.5, 98.25, 0.0)
    jpw = jem.PowerParams("card", 312.5, 98.25, 0.0)
    for p, t in GRID:
        for mode in MODES:
            kw = dict(compute_time_1pdev=0.00753, yet_mb=3999.9, elt_mb=120.0)
            got = sim.simulate(sim.SimInputs(TenancyConfig(p, t, mode), net=n,
                                             power=pw, **kw))
            want = jsim.simulate(jsim.SimInputs(JTenancy(p, t, mode), net=jn,
                                                power=jpw, **kw))
            assert _fields(got) == _fields(want), (p, t, mode)


@pytest.mark.parametrize("tenants,cells_want", [(1, 88), (2, 80), (4, 76)])
def test_paper_cells(tenants, cells_want):
    """Fig 11b / 13a / 13b: 4 pdev, sequential, FDR -- 88 / 80 / 76 cells
    of 35 ms, in both packages."""
    r = sim.simulate_cells(sim.SimInputs(TenancyConfig(4, tenants)))
    assert r.steps() == cells_want
    assert sim.makespan_steps(4, tenants) == cells_want
    assert jsim.makespan_steps(4, tenants) == cells_want
    if tenants == 1:       # "data transferred completely ... at step 20"
        assert max(e.transfer_end for e in r.events) == pytest.approx(
            20 * sim.PAPER_STEP_S)


def test_plan_order_is_the_references_slot_major_order():
    """``VirtualDevicePool.plan(nv)`` -- the staging order the simulator
    walks -- is the reference's: every pdev's first tenant before any
    second tenant (Fig 13)."""
    for p, t in GRID:
        got = [dataclasses.astuple(x) for x in
               VirtualDevicePool(TenancyConfig(p, t)).plan(p * t)]
        want = [dataclasses.astuple(x) for x in
                JPool(JTenancy(p, t)).plan(p * t)]
        assert got == want
        slots = [x[2] for x in got]
        assert slots == sorted(slots)


def test_effective_bandwidth_equals_reference():
    for n in range(0, 17):
        assert (sim.effective_bandwidth(n, 6000.0)
                == jsim.effective_bandwidth(n, 6000.0))
