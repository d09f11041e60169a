"""The port's spans inside the risk path and a request's life, on the CPU.

* ``run_tenant_chunked`` gives ``risk.run`` with ``risk.prepare``, the
  executor's ``pipeline.*`` spans and ``risk.collect`` beneath it, every
  span of one analysis with one ``run`` id, and the ``transfer.*``
  counters on the analysis' plane;
* the resident step gives ``risk.step`` with ``risk.launch``; on the CPU,
  which reads any ELT layout, no ``risk.pad``;
* the continuous scheduler writes one ``sched.queue`` and one
  ``sched.first_token`` per admitted request under its ``rid``, meeting at
  the admission pass, and no ``admission.*`` span; ``admit.prefill`` names
  the rids it prefilled and its entry in ``prefill_ms()``;
* written spans are not live; a disabled plane opens no span.
"""
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.risk_app import RiskAppConfig
from repro_torch.core.tenancy import TenancyConfig
from repro_torch.distributed.sharding import parse_mesh
from repro_torch.kernels.aggregate_loss import pad_elt_columns
from repro_torch.models.model import build_model
from repro_torch.obs.telemetry import Telemetry
from repro_torch.risk.analysis import AggregateRiskAnalysis
from repro_torch.risk.tables import generate
from repro_torch.serving.continuous import ContinuousBatchingEngine
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.multitenant import MultiTenantScheduler, Request

CPU = torch.device("cpu")
PER_TENANT = ("pipeline.stage", "pipeline.wait", "pipeline.launch")


@pytest.fixture(scope="module")
def cfg():
    return RiskAppConfig().reduced()


@pytest.fixture(scope="module")
def tables(cfg):
    return generate(cfg, seed=0)


def _ara(cfg, tel, tenants=3, mode="sequential"):
    return AggregateRiskAnalysis(cfg, TenancyConfig(1, tenants, mode),
                                 device="cpu", telemetry=tel)


@pytest.mark.parametrize("mode", ["sequential", "concurrent"])
def test_tenant_chunked_spans_nest_under_one_run(cfg, tables, mode):
    tel = Telemetry(enabled=True)
    ara = _ara(cfg, tel, mode=mode)
    rep = ara.run_tenant_chunked(tables)
    spans = tel.spans()
    (root,) = [s for s in spans if s.name == "risk.run"]
    assert root.parent_id is None and root.attrs["run"] == 0
    under = {"risk.prepare", "pipeline.start", "pipeline.join",
             "risk.collect", *PER_TENANT}
    mine = [s for s in spans if s.name in under]
    assert all(s.parent_id == root.span_id and s.live for s in mine)
    assert all(s.attrs["run"] == 0 for s in spans)
    for name in PER_TENANT:
        got = [s for s in mine if s.name == name]
        assert sorted(s.attrs["vdev"] for s in got) == [0, 1, 2]
        assert all(s.attrs["bytes"] > 0 for s in got)
    # the phases tile the run: prepare, start, then staging, then collect
    one = {s.name: s for s in mine}
    first_stage = min(s.t_start for s in mine if s.name == "pipeline.stage")
    assert root.t_start <= one["risk.prepare"].t_start
    assert one["risk.prepare"].t_end <= one["pipeline.start"].t_start
    assert one["pipeline.start"].t_end <= first_stage
    assert one["pipeline.join"].t_end <= one["risk.collect"].t_start
    assert one["risk.collect"].t_end <= root.t_end
    stage = tel.spans("transfer.stage")
    assert len(stage) == 3 and not any(s.live for s in stage)
    assert {s.name for s in tel.live_spans()} == under | {"risk.run"}
    T = tables.num_trials
    yet_bytes = sum(s.attrs["bytes"] for s in stage)
    assert tel.counter_snapshot() == {"transfer.bytes": yet_bytes,
                                      "transfer.chunks": 3}
    assert rep.ylt.shape == (T,)
    # the next analysis: its own run id, the tables stay resident
    ara.run_tenant_chunked(tables)
    assert [s.attrs["run"] for s in tel.spans("risk.run")] == [0, 1]
    assert ara.table_uploads == 1


@pytest.mark.parametrize("mesh,prepadded", [
    ("1x1", False), ("1x1", True),
    ("1x2", False),             # two positions: a launch each, one table
])
def test_resident_step_pads_only_when_it_must(cfg, tables, mesh, prepadded):
    # the CPU's K1 reads the ELT in either layout, so neither is padded
    tel = Telemetry(enabled=True)
    ara = _ara(cfg, tel)
    mesh = parse_mesh(mesh, [CPU, CPU])
    step = ara.make_sharded_step(mesh)
    elt = torch.from_numpy(tables.elt_losses)
    if prepadded:
        elt = pad_elt_columns(elt)
    args = (torch.from_numpy(tables.yet), elt,
            torch.from_numpy(tables.occ_ret),
            torch.from_numpy(tables.occ_lim), tables.agg_ret, tables.agg_lim)
    got = [step(*args) for _ in range(2)]
    want = _ara(cfg, Telemetry()).run_single(tables)
    for ylt in got:
        np.testing.assert_allclose(ylt.numpy(), want, rtol=1e-6)
    steps = tel.spans("risk.step")
    assert [s.attrs["run"] for s in steps] == [0, 1]
    launches = tel.spans("risk.launch")
    n = len(mesh.position_devices())
    assert [s.parent_id for s in launches] == \
        [s.span_id for s in steps for _ in range(n)]
    assert not tel.spans("risk.pad")
    assert tel.counter_snapshot() == {}


class _Event:
    """A stand-in CUDA event: host stamps, enough for ``prefill_ms()`` and
    a round handle."""

    def record(self, *_):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3

    def synchronize(self):
        pass

    def query(self):
        return True


def _event():
    ev = _Event()
    ev.record()
    return ev


@pytest.fixture(scope="module")
def internlm2():
    cfg = get_config("internlm2-1.8b").reduced()
    return ServingEngine(cfg, build_model(cfg).init(0, "cpu"), device="cpu")


def _serve(eng, tel, n=7):
    """``n`` requests of two tenants through a continuous scheduler of 2
    rows, so that most of them queue."""
    ceng = ContinuousBatchingEngine(eng, capacity=2, page_size=8,
                                    inner_steps=2, max_prompt_len=32,
                                    telemetry=tel)
    sched = MultiTenantScheduler(eng, mode="continuous",
                                 continuous_engine=ceng, telemetry=tel)
    rng = np.random.default_rng(4)
    reqs = [Request("ab"[i % 2], rng.integers(1, eng.cfg.vocab_size, 5 + 3 * i)
                    .astype(np.int32), max_new_tokens=2 + i % 3)
            for i in range(n)]
    for r in reqs:
        sched.submit(r)
    return ceng, reqs, sched.drain()


def test_request_spans_meet_at_admission(internlm2, monkeypatch):
    monkeypatch.setattr(internlm2, "_event", _event)
    tel = Telemetry(enabled=True)
    ceng, reqs, out = _serve(internlm2, tel)
    assert sorted(r.rid for r in out) == [r.rid for r in reqs] == \
        list(range(len(reqs)))
    queue = {s.attrs["rid"]: s for s in tel.spans("sched.queue")}
    first = {s.attrs["rid"]: s for s in tel.spans("sched.first_token")}
    assert set(queue) == set(first) == {r.rid for r in reqs}
    for r in reqs:
        q, f = queue[r.rid], first[r.rid]
        assert not q.live and not f.live
        assert q.t_start == pytest.approx(r.arrival_s - tel.t0, abs=1e-9)
        assert q.t_end == f.t_start <= f.t_end
        assert q.attrs == f.attrs == dict(
            rid=r.rid, tenant=r.tenant, prompt=r.prompt.size,
            bucket=ceng.bucket_len(r.prompt.size))
    # queue wait and admission to first token add up to the response's ttft
    for resp in out:
        f = first[resp.rid]
        r = reqs[resp.rid]
        assert f.t_end + tel.t0 - r.arrival_s == pytest.approx(resp.ttft_s,
                                                               abs=1e-9)
    assert not tel.spans(prefix="admission.")
    prefills = tel.spans("admit.prefill")
    assert prefills and [s.attrs["call"] for s in prefills] == \
        list(range(len(ceng.prefill_ms())))
    assert sorted(rid for s in prefills for rid in s.attrs["rids"]) == \
        sorted(queue)
    # a queue wait ends as the admission pass that prefilled the request
    # begins: no pass starts between the two
    batches = [s.t_start for s in tel.spans("admit.batch")]
    for pf in prefills:
        (start,) = [b.t_start for b in tel.spans("admit.batch")
                    if b.t_start <= pf.t_start <= b.t_end]
        for rid in pf.attrs["rids"]:
            end = queue[rid].t_end
            assert end <= start
            assert not [b for b in batches if end < b < start]


def test_live_spans_leave_out_written_windows():
    tel = Telemetry(enabled=True)
    with tel.span("a.live"):
        tel.event("a.event")
    t = time.perf_counter()
    tel.record_span("a.window", t - 1.0, t)
    assert [s.live for s in tel.spans()] == [True, True, False]
    assert [s.name for s in tel.live_spans()] == ["a.event", "a.live"]


def test_disabled_plane_opens_no_span(cfg, tables, internlm2):
    tel = Telemetry(enabled=False)
    ara = _ara(cfg, tel)
    ara.run_tenant_chunked(tables)
    ara.run_tenant_chunked(tables, overlapped=False)
    ara.make_sharded_step(parse_mesh("1x1", [CPU]))(
        torch.from_numpy(tables.yet), torch.from_numpy(tables.elt_losses),
        torch.from_numpy(tables.occ_ret), torch.from_numpy(tables.occ_lim),
        tables.agg_ret, tables.agg_lim)
    _, reqs, out = _serve(internlm2, tel, n=4)
    assert len(out) == 4 and [r.rid for r in reqs] == [0, 1, 2, 3]
    assert tel.spans_opened == 0 and tel.spans() == []
    assert tel.metric_snapshot() == {"counters": {}, "gauges": {},
                                     "histograms": {}}
