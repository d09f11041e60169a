"""The port's observability slice against the JAX package's: the fits and
``plan_from_telemetry`` on the same sweeps, the exporters' text on equal
planes, the card-side recorders, the serve driver's telemetry flags and
the examples.

* ``replay_sim_run``, ``samples_from_telemetry``, ``fit_perf_inputs`` and
  ``fit_power_params`` give the reference's numbers (``rel=1e-12``) and
  error messages; ``plan_from_telemetry`` its plans across the objectives,
  budgets and a given ``pw`` -- among them the paper's FDR optimum, 9x2
  sequential;
* ``chrome_trace`` / ``prometheus_text`` / ``stats_line`` give identical
  text on planes filled with the same spans and metrics at the same stamps;
* ``record_run_timeline`` takes a run's CUDA-event windows over its host
  stamps (host stamps only where there are none); the power samples come
  from the gauge's counter ticks, and the gauge raises without a driver;
* ``launch.serve`` writes a loadable trace over the scheduler, round,
  admission and page-pool layers and a parsable metrics file, and the
  plane changes no token; with the round program's stub graph the plane's
  counters are those of eager rounds.
"""
import dataclasses
import json
import os
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest

from repro.core import energymodel as jem
from repro.core import perfmodel as jpm
from repro.core.planner import plan_from_telemetry as jplan_from_telemetry
from repro.core.simulator import SimInputs as JSimInputs
from repro.core.tenancy import TenancyConfig as JTenancy
from repro.obs import export as jexport
from repro.obs import fit as jfit
from repro.obs.telemetry import Telemetry as JTelemetry
from repro_torch.core import energymodel as em
from repro_torch.core import perfmodel as pm
from repro_torch.core.pipeline import TenantTimeline
from repro_torch.core.planner import plan, plan_from_telemetry
from repro_torch.core.simulator import SimInputs
from repro_torch.core.tenancy import TenancyConfig
from repro_torch.obs import TELEMETRY
from repro_torch.obs import export
from repro_torch.obs import fit
from repro_torch.obs.gauge import PowerGauge
from repro_torch.obs.telemetry import Telemetry

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
EXAMPLES = ["torch_quickstart.py", "torch_risk_realtime.py",
            "torch_deployment_planner.py", "torch_serve_multitenant.py"]


def _sweep(tel, jtel, net, nvs=(1, 2, 4, 8, 16), n_pdev=1, pw=True):
    """The same sequential sweep replayed on both planes, from one origin:
    a span keeps ``t - t0``, so planes made at different instants would
    round the same replayed times differently."""
    jtel.t0 = tel.t0
    n, jn = {"FDR": (pm.FDR, jpm.FDR), "QDR": (pm.QDR, jpm.QDR)}[net]
    m = pm.PerfModelInputs(net=n)
    res = []
    for nv in nvs:
        kw = dict(compute_time_1pdev=m.compute_time_1pdev, yet_mb=m.yet_mb,
                  elt_mb=m.elt_mb, pf_mb=m.pf_mb)
        si = SimInputs(TenancyConfig(n_pdev, nv, "sequential"), net=n,
                       power=em.K20, **kw)
        jsi = JSimInputs(JTenancy(n_pdev, nv, "sequential"), net=jn,
                         power=jem.K20, **kw)
        res.append((fit.replay_sim_run(tel, si, pw=em.K20 if pw else None,
                                       base=0.0),
                    jfit.replay_sim_run(jtel, jsi,
                                        pw=jem.K20 if pw else None,
                                        base=0.0)))
    return res


def _spans(tel):
    return [(s.name, s.duration, sorted(s.attrs.items()))
            for s in tel.spans()]


@pytest.mark.parametrize("net", ["FDR", "QDR"])
def test_replay_samples_and_fits_equal_reference(net):
    tel, jtel = Telemetry(enabled=True), JTelemetry(enabled=True)
    for got, want in _sweep(tel, jtel, net):
        assert got.makespan == want.makespan
        assert got.energy_ws == want.energy_ws
    assert _spans(tel) == _spans(jtel)
    samples = fit.samples_from_telemetry(tel)
    jsamples = jfit.samples_from_telemetry(jtel)
    assert ([dataclasses.astuple(s) for s in samples]
            == [dataclasses.astuple(s) for s in jsamples])
    assert (fit.power_samples_from_telemetry(tel)
            == jfit.power_samples_from_telemetry(jtel))
    pf = fit.fit_perf_inputs(samples, name="x", device_memory_mb=81920.0)
    jpf = jfit.fit_perf_inputs(jsamples, name="x", device_memory_mb=81920.0)
    assert pf.n_samples == jpf.n_samples
    for a, b in ((pf.transfer_rms_s, jpf.transfer_rms_s),
                 (pf.compute_rms_s, jpf.compute_rms_s),
                 (pf.m.net.t_4gb, jpf.m.net.t_4gb),
                 (pf.m.net.t_small, jpf.m.net.t_small),
                 (pf.m.compute_time_1pdev, jpf.m.compute_time_1pdev)):
        assert a == pytest.approx(b, rel=1e-12, abs=1e-300)
    assert pf.m.device_memory_mb == jpf.m.device_memory_mb == 81920.0
    pw = fit.fit_power_params(fit.power_samples_from_telemetry(tel))
    jpw = jfit.fit_power_params(jfit.power_samples_from_telemetry(jtel))
    assert pw.p_busy == pytest.approx(jpw.p_busy, rel=1e-12)
    assert pw.p_idle_assigned == pytest.approx(jpw.p_idle_assigned,
                                               rel=1e-12)
    assert pw.p_busy == pytest.approx(em.K20.p_busy, rel=1e-6)


def test_fits_on_noisy_samples_equal_reference():
    """Samples that do not come from the model (a fit with residuals)."""
    rng = np.random.default_rng(3)
    raw = [(int(nv), float(0.074 / nv + 2e-4 + rng.normal(0, 1e-4)),
            float(0.0075 / nv + rng.normal(0, 5e-5)))
           for nv in (1, 2, 4, 8) for _ in range(3)]
    pf = fit.fit_perf_inputs([fit.PhaseSample(*r) for r in raw],
                             yet_mb=3900.0, elt_mb=120.0)
    jpf = jfit.fit_perf_inputs([jfit.PhaseSample(*r) for r in raw],
                               yet_mb=3900.0, elt_mb=120.0)
    for a, b in ((pf.transfer_rms_s, jpf.transfer_rms_s),
                 (pf.compute_rms_s, jpf.compute_rms_s),
                 (pf.m.net.t_4gb, jpf.m.net.t_4gb),
                 (pf.m.net.per_vdev_overhead, jpf.m.net.per_vdev_overhead),
                 (pf.m.compute_time_1pdev, jpf.m.compute_time_1pdev)):
        assert a == pytest.approx(b, rel=1e-12)
    ps = [(float(f), float(100 + 300 * f + rng.normal(0, 5)))
          for f in rng.uniform(0, 1, 40)]
    pw, jpw = fit.fit_power_params(ps), jfit.fit_power_params(ps)
    assert (pw.p_busy, pw.p_idle_assigned) == pytest.approx(
        (jpw.p_busy, jpw.p_idle_assigned), rel=1e-12)


def _message(fn, *a, **kw):
    with pytest.raises(ValueError) as e:
        fn(*a, **kw)
    return str(e.value)


def test_fit_error_messages_equal_reference():
    one_nv = [(2, 0.5, 1.0), (2, 0.5, 1.0)]
    assert (_message(fit.fit_perf_inputs,
                     [fit.PhaseSample(*s) for s in one_nv])
            == _message(jfit.fit_perf_inputs,
                        [jfit.PhaseSample(*s) for s in one_nv]))
    for bad in ([(0.5, 80.0)], [(0.5, 80.0), (0.5, 80.0)]):
        assert (_message(fit.fit_power_params, bad)
                == _message(jfit.fit_power_params, bad))
    assert "distinct" in _message(fit.fit_perf_inputs, [])


PLAN_CASES = [("time", None, False), ("energy", None, False),
              ("edp", None, False), ("time", 4, False), ("energy", 3, False),
              ("edp", 1, False), ("time", None, True), ("energy", 2, True)]


@pytest.mark.parametrize("objective,budget,given_pw", PLAN_CASES)
@pytest.mark.parametrize("net", ["FDR", "QDR"])
def test_plan_from_telemetry_equals_reference(net, objective, budget,
                                              given_pw):
    tel, jtel = Telemetry(enabled=True), JTelemetry(enabled=True)
    _sweep(tel, jtel, net)
    kw = dict(objective=objective, budget_pdev=budget)
    pw = em.PowerParams("given", 150.0, 60.0, 20.0)
    jpw = jem.PowerParams("given", 150.0, 60.0, 20.0)
    tp = plan_from_telemetry(tel, pw=pw if given_pw else None, **kw)
    jtp = jplan_from_telemetry(jtel, pw=jpw if given_pw else None, **kw)
    d, jd = tp.deployment, jtp.deployment
    assert (d.n_pdev, d.tenants_per_pdev) == (jd.n_pdev, jd.tenants_per_pdev)
    assert tp.transfer_mode == jtp.transfer_mode
    for a, b in ((d.exec_time_s, jd.exec_time_s), (d.energy_ws, jd.energy_ws),
                 (d.memory_per_pdev_mb, jd.memory_per_pdev_mb),
                 (tp.pw.p_busy, jtp.pw.p_busy),
                 (tp.pw.p_idle_assigned, jtp.pw.p_idle_assigned),
                 (tp.transfer_rms_s, jtp.transfer_rms_s),
                 (tp.compute_rms_s, jtp.compute_rms_s)):
        assert a == pytest.approx(b, rel=1e-12, abs=1e-300)
    assert tp.pw.name == jtp.pw.name
    if budget:
        assert d.n_pdev <= budget


def test_plan_from_telemetry_fdr_acceptance_and_k20_fallback():
    """tests/test_obs.py's acceptance in the port: the replayed FDR sweep
    plans 9x2 sequential, the static planner's optimum; without power
    samples the power falls back to the paper's K20 set, as there."""
    tel, jtel = Telemetry(enabled=True), JTelemetry(enabled=True)
    _sweep(tel, jtel, "FDR")
    tp = plan_from_telemetry(tel)
    d = tp.deployment
    st = plan(pm.PerfModelInputs(net=pm.FDR), "time")
    assert (d.n_pdev, d.tenants_per_pdev) == (st.n_pdev,
                                              st.tenants_per_pdev) == (9, 2)
    assert tp.transfer_mode == "sequential"
    assert tp.m.net.t_4gb == pytest.approx(pm.FDR.t_4gb, rel=1e-6)
    assert tp.transfer_rms_s < 1e-9 and tp.compute_rms_s < 1e-9
    tel2, jtel2 = Telemetry(enabled=True), JTelemetry(enabled=True)
    _sweep(tel2, jtel2, "FDR", pw=False)
    tp2, jtp2 = plan_from_telemetry(tel2), jplan_from_telemetry(jtel2)
    assert tp2.pw is em.K20 and jtp2.pw.name == "K20"
    assert (tp2.deployment.energy_ws
            == pytest.approx(jtp2.deployment.energy_ws, rel=1e-12))


# ---------------------------------------------------------------------
# the card's side: device windows and the power gauge
# ---------------------------------------------------------------------
@dataclasses.dataclass
class _Report:
    timeline: list
    t0_s: float


def _entry(vdev, device_ms):
    # host stamps that disagree with the device windows: the launch comes
    # before the copy lands, the waiter wakes late
    return TenantTimeline(vdev, 0, vdev, transfer_start=0.001 * vdev,
                          transfer_end=0.040 + 0.04 * vdev,
                          compute_start=0.0395 + 0.04 * vdev,
                          compute_end=0.050 + 0.04 * vdev,
                          device_ms=device_ms)


def test_record_run_timeline_takes_device_windows_over_host_stamps():
    dms = [{"copy_start": 0.5, "copy_end": 37.5, "compute_start": 37.75,
            "compute_end": 41.5},
           {"copy_start": 38.5, "copy_end": 75.0, "compute_start": 75.25,
            "compute_end": 79.0}]
    rep = _Report([_entry(i, d) for i, d in enumerate(dms)], t0_s=100.0)
    tel = Telemetry(enabled=True)
    assert fit.record_run_timeline(tel, rep, nv=2) == 2
    tr = tel.spans(name="timeline.transfer")
    cp = tel.spans(name="timeline.compute")
    for s, d in zip(tr, dms):
        assert s.t_start + tel.t0 == pytest.approx(100.0 + d["copy_start"]
                                                   * 1e-3, abs=1e-9)
        assert s.duration == pytest.approx(
            (d["copy_end"] - d["copy_start"]) * 1e-3, abs=1e-9)
        assert s.attrs["nv"] == 2
    for s, d, p in zip(cp, dms, tr):
        assert s.duration == pytest.approx(
            (d["compute_end"] - d["compute_start"]) * 1e-3, abs=1e-9)
        assert s.parent_id == p.span_id
    samples = fit.samples_from_telemetry(tel)
    assert [round(s.transfer_s * 1e3, 6) for s in samples] == [37.0, 36.5]
    assert [round(s.compute_s * 1e3, 6) for s in samples] == [3.75, 3.75]
    assert fit.busy_windows(rep) == [
        pytest.approx((100.03775, 100.0415)),
        pytest.approx((100.07525, 100.079))]

    # no device windows (the CPU): the host stamps, as record_timeline
    cpu = _Report([_entry(i, None) for i in range(2)], t0_s=5.0)
    tel2 = Telemetry(enabled=True)
    fit.record_run_timeline(tel2, cpu, nv=2)
    got = [s.duration for s in tel2.spans(name="timeline.compute")]
    assert got == pytest.approx([e.compute_s for e in cpu.timeline])
    assert fit.record_run_timeline(Telemetry(), rep, nv=2) == 0


def test_entry_windows_ms_prefers_device_windows():
    d = {"copy_start": 0.5, "copy_end": 37.5, "compute_start": 37.75,
         "compute_end": 41.5}
    assert fit.entry_windows_ms(_entry(1, d)) == d
    host = _entry(1, None)
    assert fit.entry_windows_ms(host) == pytest.approx(
        {"copy_start": 1.0, "copy_end": 80.0, "compute_start": 79.5,
         "compute_end": 90.0})


class _Engine:
    def __init__(self, nv):
        self.nv, self.calls = nv, 0

    def run_tenant_chunked(self, tables):
        self.calls += 1
        dms = [{"copy_start": 10.0 * i, "copy_end": 10.0 * i + 8.0,
                "compute_start": 10.0 * i + 8.0,
                "compute_end": 10.0 * i + 9.0} for i in range(self.nv)]
        return _Report([_entry(i, d) for i, d in enumerate(dms)],
                       t0_s=float(self.calls))


def test_record_sweep_records_every_run_under_its_nv():
    engines = {nv: _Engine(nv) for nv in (1, 2, 4)}
    tel = Telemetry(enabled=True)
    runs = fit.record_sweep(tel, engines, tables=None, runs=3)
    assert [nv for nv, _ in runs] == [1] * 3 + [2] * 3 + [4] * 3
    assert all(e.calls == 3 for e in engines.values())
    assert len(tel.spans(name=fit.TRANSFER_SPAN)) == 3 * (1 + 2 + 4)
    samples = fit.samples_from_telemetry(tel)
    assert sorted({s.nv for s in samples}) == [1, 2, 4]
    assert all(s.transfer_s == pytest.approx(8e-3) for s in samples)
    assert all(s.compute_s == pytest.approx(1e-3) for s in samples)


def test_record_run_timeline_on_a_cpu_risk_run_feeds_the_fit():
    from repro_torch.configs.risk_app import RiskAppConfig
    from repro_torch.risk.analysis import AggregateRiskAnalysis
    from repro_torch.risk.tables import generate
    cfg = dataclasses.replace(RiskAppConfig().reduced(), num_trials=512)
    tables = generate(cfg, seed=0)
    tel = Telemetry(enabled=True)
    for nv in (1, 2, 4):
        ara = AggregateRiskAnalysis(cfg, TenancyConfig(1, nv), device="cpu")
        rep = ara.run_tenant_chunked(tables)
        assert rep.t0_s > 0 and rep.timeline[0].device_ms is None
        fit.record_run_timeline(tel, rep, nv=nv)
    samples = fit.samples_from_telemetry(tel)
    assert sorted(s.nv for s in samples) == [1, 2, 2, 4, 4, 4, 4]
    tp = plan_from_telemetry(tel, budget_pdev=1)
    assert tp.deployment.n_pdev == 1 and tp.pw is em.K20


def test_gauge_power_samples_from_counter_ticks():
    """Watts from the counter's own energy between ticks; busy share from
    the kernel windows inside each interval; nothing synthesised."""
    ticks = [(10.0, 1000.0), (10.1, 1010.0), (10.2, 1050.0), (10.2, 1050.0),
             (10.3, 1060.0)]
    busy = [(10.15, 10.2), (10.2, 10.25)]
    got = fit.gauge_power_samples(ticks, busy)
    assert got == [pytest.approx((0.0, 100.0)), pytest.approx((0.5, 400.0)),
                   pytest.approx((0.5, 100.0))]
    tel = Telemetry(enabled=True)
    assert fit.record_power_samples(tel, ticks, busy, window="w") == got
    assert fit.power_samples_from_telemetry(tel) == got
    assert all(s.attrs["window"] == "w"
               for s in tel.spans(name="power.sample"))
    assert fit.busy_seconds(busy, 10.0, 10.3) == pytest.approx(0.1)


class _CountingGauge(PowerGauge):
    """The gauge's thread over a counter that counts its reads."""

    def __init__(self):
        self._ticks, self._lock = [], threading.Lock()
        self._stop, self._thread, self.errors = threading.Event(), None, []
        self._nvml = type("N", (), {"nvmlShutdown": lambda self: 0})()
        self.reads = 0

    def read_j(self):
        self.reads += 1
        return float(self.reads // 10)


def test_power_gauge_sleeps_between_reads():
    """The thread leaves the measured run its core: at most one read a
    polling period, and each change of the counter is one tick."""
    import time
    from repro_torch.obs import gauge as gauge_mod
    g = _CountingGauge().start()
    time.sleep(0.2)
    g.close()
    assert 2 <= g.reads <= 0.2 / gauge_mod.POLL_S + 2
    tk = g.ticks()
    assert len(tk) == g.reads // 10 or len(tk) == (g.reads - 1) // 10
    assert [e for _, e in tk] == sorted({e for _, e in tk})


def test_power_gauge_raises_without_a_driver(tmp_path):
    """No library, no reading: the gauge raises, it never returns zeros."""
    with pytest.raises(RuntimeError, match="power gauge"):
        PowerGauge(lib=str(tmp_path / "libnvidia-ml.so.1"))


def test_power_gauge_windows_on_a_fake_counter():
    """The sampler's bookkeeping on a counter that steps every few polls:
    ticks only where the value moved, mean watts between the first and
    last tick of a window, too few ticks raise."""
    g = PowerGauge.__new__(PowerGauge)
    g._ticks, g.errors = [], []
    g._lock, g._stop, g._thread = threading.Lock(), threading.Event(), None
    values = iter([5.0, 5.0, 6.0, 6.0, 6.0, 8.0, 9.0])
    stamps = iter([1.0, 1.1, 1.2, 1.3, 1.4, 1.5])
    g.read_j = lambda: next(values)
    import repro_torch.obs.gauge as gauge_mod
    real = gauge_mod.time.perf_counter
    gauge_mod.time.perf_counter = lambda: next(stamps)
    try:
        g._stop.wait = lambda timeout, it=iter([False] * 6 + [True]): next(it)
        g._run()
    finally:
        gauge_mod.time.perf_counter = real
    # the first reading is the value before any tick, not a tick
    assert g.ticks() == [(1.1, 6.0), (1.4, 8.0), (1.5, 9.0)]
    assert g.mean_watts(0.0, 2.0) == pytest.approx(3.0 / 0.4)
    assert g.mean_watts(1.2, 1.6) == pytest.approx(1.0 / 0.1)
    with pytest.raises(RuntimeError, match="lengthen"):
        g.mean_watts(1.0, 1.3)


def test_power_gauge_leaves_out_ticks_seen_late():
    """A tick seen long after the read before it (the thread held back)
    has an unsure time: ``within`` leaves it out, which merges the two
    intervals around it into one with exact energy and length.  A change
    on the first poll has no read before it and counts as late."""
    g = PowerGauge.__new__(PowerGauge)
    g._ticks, g.errors = [], []
    g._lock, g._stop, g._thread = threading.Lock(), threading.Event(), None
    values = iter([4.0, 5.0, 6.0, 6.0, 7.0, 8.0])
    stamps = iter([1.000, 1.001, 1.101, 1.151, 1.152])
    g.read_j = lambda: next(values)
    import repro_torch.obs.gauge as gauge_mod
    real = gauge_mod.time.perf_counter
    gauge_mod.time.perf_counter = lambda: next(stamps)
    try:
        g._stop.wait = lambda timeout, it=iter([False] * 5 + [True]): next(it)
        g._run()
    finally:
        gauge_mod.time.perf_counter = real
    assert g.ticks() == [(1.000, 5.0), (1.001, 6.0), (1.151, 7.0),
                         (1.152, 8.0)]
    assert g.ticks(within=0.010) == [(1.001, 6.0), (1.152, 8.0)]
    assert g.late(0.010) == 2
    assert g.mean_watts(0.0, 2.0, within=0.010) == pytest.approx(2.0 / 0.151)
    with pytest.raises(RuntimeError, match="lengthen"):
        g.mean_watts(1.1, 1.2, within=0.010)


# ---------------------------------------------------------------------
# exporters: the same text as the reference's on equal planes
# ---------------------------------------------------------------------
def _fill(tel):
    tel.t0 = 1000.0
    a = tel.record_span("sched.step", 1000.5, 1000.75, mode="continuous")
    tel.record_span("round.dispatch", 1000.5, 1000.5625, parent_id=a,
                    round=0, pdev=0)
    tel.record_span("round.device", 1000.5, 1000.7, round=0, steps=4)
    tel.record_span("kv.alloc", 1000.25, 1000.25, slot=1, fresh=3)
    tel.record_span("admit.prefill", 1000.125, 1000.2, bucket=32)
    for k, n in (("kv.pages_allocated", 24), ("heartbeat.beats", 6),
                 ("trace.decode", 1), ("transfer.bytes", 1.5e9)):
        tel.count(k, n)
    tel.gauge("kv.free_pages", 4)
    tel.gauge("heartbeat.suspects", 0.0)
    for v in (3.0, 4.0, 1.5):
        tel.observe("round.steps_live", v)


def test_exporters_give_the_reference_text():
    tel, jtel = Telemetry(enabled=True), JTelemetry(enabled=True)
    _fill(tel)
    _fill(jtel)
    assert export.chrome_trace(tel) == jexport.chrome_trace(jtel)
    assert json.dumps(export.chrome_trace(tel)) == json.dumps(
        jexport.chrome_trace(jtel))
    assert export.prometheus_text(tel) == jexport.prometheus_text(jtel)
    keys = ("heartbeat.beats", "kv.pages_allocated", "kv.free_pages",
            "swap.preemptions")
    for kw in ({}, dict(keys=keys, step=4, pending=2)):
        assert export.stats_line(tel, **kw) == jexport.stats_line(jtel, **kw)
    text = export.prometheus_text(tel)
    assert (export.parse_prometheus_text(text)
            == jexport.parse_prometheus_text(text))
    assert export.parse_prometheus_text(text)["repro_kv_pages_allocated"] == 24


def test_written_files_equal_reference(tmp_path):
    tel, jtel = Telemetry(enabled=True), JTelemetry(enabled=True)
    _fill(tel)
    _fill(jtel)
    export.write_chrome_trace(tel, str(tmp_path / "a.json"))
    jexport.write_chrome_trace(jtel, str(tmp_path / "b.json"))
    export.write_metrics(tel, str(tmp_path / "a.prom"))
    jexport.write_metrics(jtel, str(tmp_path / "b.prom"))
    for a, b in (("a.json", "b.json"), ("a.prom", "b.prom")):
        assert (tmp_path / a).read_text() == (tmp_path / b).read_text()


# ---------------------------------------------------------------------
# the serve driver and the decode path with the plane lit
# ---------------------------------------------------------------------
class _Tokens:
    """``observe`` hook: every retired request's tokens, by prompt."""

    def __init__(self):
        self.sched, self.tokens = None, {}

    def __call__(self, sched):
        if self.sched is None:
            self.sched = sched
            eng = sched.continuous_engine
            collect = eng.collect

            def recording(handle):
                res = collect(handle)
                for r, t, _ in res.finished:
                    self.tokens[r.prompt.tobytes()] = t
                return res

            eng.collect = recording


ARGV = ["--device", "cpu", "--reduced", "--mode", "continuous",
        "--requests", "6",
        "--new-tokens", "6", "--capacity", "2"]


def test_serve_driver_writes_trace_and_metrics(tmp_path, capsys):
    from repro_torch.launch import serve
    off = _Tokens()
    assert serve.main(ARGV, observe=off) == 0
    capsys.readouterr()
    trace, prom = tmp_path / "trace.json", tmp_path / "metrics.prom"
    on = _Tokens()
    assert serve.main(ARGV + ["--trace-out", str(trace), "--metrics-out",
                              str(prom), "--stats-every", "2"],
                      observe=on) == 0
    assert not TELEMETRY.enabled          # lit for the run only
    out = capsys.readouterr().out
    assert out.count("obs: ") >= 2 and "heartbeat.suspects=" in out
    doc = json.loads(trace.read_text())
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert {"sched", "round", "admit", "kv"} <= {e["cat"] for e in spans}
    eng = on.sched.continuous_engine
    assert sum(e["name"] == "round.device" for e in spans) == eng.rounds
    parsed = export.parse_prometheus_text(prom.read_text())
    assert parsed["repro_kv_pages_allocated"] == eng.kv.pages_allocated
    assert parsed["repro_heartbeat_beats"] >= 1
    assert on.tokens.keys() == off.tokens.keys() and len(on.tokens) == 6
    for k, t in on.tokens.items():
        np.testing.assert_array_equal(t, off.tokens[k])
    TELEMETRY.reset()


def test_no_flag_of_this_slice_raises():
    from repro_torch.launch import serve
    args = serve.build_parser().parse_args(
        ["--trace-out", "t", "--metrics-out", "m", "--stats-every", "3"])
    assert (args.trace_out, args.metrics_out, args.stats_every) == (
        "t", "m", 3)
    assert not {"trace_out", "metrics_out", "stats_every"} & set(serve.LATER)


@pytest.fixture(scope="module")
def cpu_engine():
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import ServingEngine
    cfg = get_config("internlm2-1.8b").reduced()
    return ServingEngine(cfg, build_model(cfg).init(0, "cpu"), device="cpu")


def _reqs(eng, seed=5, n=5):
    from repro_torch.serving.multitenant import Request
    rng = np.random.default_rng(seed)
    return [Request("a", rng.integers(1, eng.cfg.vocab_size, 5 + 3 * i)
                    .astype(np.int32), max_new_tokens=2 + 3 * i,
                    temperature=0.8 if i % 2 else 0.0, seed=i)
            for i in range(n)]


KW = dict(capacity=2, page_size=8, inner_steps=4, max_prompt_len=32)


def _run(eng, tel, program=None):
    from repro_torch.serving.continuous import ContinuousBatchingEngine
    ceng = ContinuousBatchingEngine(eng, telemetry=tel, **KW)
    if program is not None:
        ceng.round_program = program
    reqs = _reqs(eng)
    got = {id(r): t for r, t in ceng.run_all(reqs)}
    return ceng, [got[id(r)] for r in reqs]


def _shape(tel):
    snap = tel.metric_snapshot()
    names = sorted(s.name for s in tel.spans())
    return snap["counters"], snap["gauges"], snap["histograms"], names


def test_plane_changes_no_token_and_counts_graph_rounds_as_eager(cpu_engine):
    """Tokens identical with the plane on and off; through the round
    program's stub graph (capture records the round, replay runs it) the
    plane's counters, gauges and span names per round are the eager
    rounds': no hook sits inside the captured region."""
    from test_torch_round_graph import StubBackend
    from repro_torch.serving.continuous import RoundProgram
    _, off = _run(cpu_engine, Telemetry(enabled=False))
    tel_eager = Telemetry(enabled=True)
    ceng_e, eager = _run(cpu_engine, tel_eager)
    tel_graph = Telemetry(enabled=True)
    ceng_g, graph = _run(cpu_engine, tel_graph, RoundProgram(StubBackend()))
    for a, b, c in zip(off, eager, graph):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert ceng_e.rounds == ceng_g.rounds > ceng_g.decode_traces
    assert sum(c.replays for c in ceng_g.round_program.rounds.values()) > 0
    assert _shape(tel_eager) == _shape(tel_graph)
    assert len(tel_graph.spans(name="round.device")) == ceng_g.rounds
    assert tel_graph.counter_snapshot()["trace.decode"] == \
        ceng_g.decode_traces


# ---------------------------------------------------------------------
# the examples, on the CPU
# ---------------------------------------------------------------------
@pytest.mark.parametrize("script", EXAMPLES)
def test_example_runs_on_the_cpu(script):
    argv = [sys.executable, os.path.join(ROOT, "examples", script),
            "--device", "cpu"]
    if script == "torch_deployment_planner.py":
        argv += ["--reduced", "--trials", "1024"]
    if script == "torch_risk_realtime.py":
        argv += ["--requests", "3"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(argv, capture_output=True, text=True, env=env,
                          timeout=240, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = {"torch_quickstart.py": "time-optimal deployment",
            "torch_risk_realtime.py": "p50 latency",
            "torch_deployment_planner.py": "optima agree",
            "torch_serve_multitenant.py": "continuous (paged KV cache): "
                                          "served 36 requests"}[script]
    assert want in proc.stdout
