"""Port's tenancy plan, staging engine and pipeline executor on the CPU:
the contracts of tests/test_pipeline.py and tests/test_transfer.py, and
field-for-field equality of the plan with the JAX package's."""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro.core.tenancy import (TenancyConfig as JaxTenancy,
                                VirtualDevicePool as JaxPool)
from repro.core.transfer import reorder_for_stragglers as jax_reorder
from repro_torch.core import pipeline as tpipe
from repro_torch.core.pipeline import (CompletionWaiter, PipelineExecutor,
                                       TenantTimeline, timeline_overlaps)
from repro_torch.core.tenancy import (TenancyConfig, VirtualDevicePool,
                                      memory_per_pdev_mb, resolve_devices)
from repro_torch.core.transfer import (PaddedRows, StagingEngine,
                                       reorder_for_stragglers)
from repro_torch.obs.telemetry import Telemetry

CPU = torch.device("cpu")


def _pool(n_pdev, tenants, mode="sequential"):
    return VirtualDevicePool(TenancyConfig(n_pdev, tenants, mode),
                             [CPU] * n_pdev)


@pytest.mark.parametrize("uniform", [False, True])
@pytest.mark.parametrize("n_pdev,tenants,items", [(1, 1, 10), (1, 4, 67),
                                                  (2, 2, 67), (3, 2, 5),
                                                  (8, 2, 4096)])
def test_plan_equals_reference_field_for_field(n_pdev, tenants, items, uniform):
    want = JaxPool(JaxTenancy(n_pdev, tenants)).plan(items, uniform=uniform)
    pool = _pool(n_pdev, tenants)
    got = pool.plan(items, uniform=uniform)
    assert [dataclasses.asdict(t) for t in got] == \
        [dataclasses.asdict(t) for t in want]
    assert [(t.size, t.pad) for t in got] == [(t.size, t.pad) for t in want]
    assert [[t.vdev for t in l] for l in pool.tasks_by_pdev(got)] == \
        [[t.vdev for t in l]
         for l in JaxPool(JaxTenancy(n_pdev, tenants)).tasks_by_pdev(want)]
    hist = {t.vdev: float((t.vdev * 7) % 5) for t in got}
    assert [t.vdev for t in reorder_for_stragglers(got, hist)] == \
        [t.vdev for t in jax_reorder(want, hist)]


def test_uniform_plan_shapes_and_memory_model():
    pool = _pool(2, 2)
    tasks = pool.plan(67, uniform=True)
    assert all(t.padded_size == 17 for t in tasks)
    assert sum(t.size for t in tasks) == 67
    assert {t.size + t.pad for t in tasks} == {17}
    assert all(t.padded_size is None and t.pad == 0 for t in pool.plan(67))
    from repro.core.tenancy import memory_per_pdev_mb as jax_mem
    assert memory_per_pdev_mb(4, 1, 4000.0, 120.0, 1.0) == \
        jax_mem(4, 1, 4000.0, 120.0, 1.0)


def _chunks(tasks, rng):
    return {t.vdev: rng.normal(size=(t.size, 8)).astype(np.float32)
            for t in tasks}


def test_sequential_staging_order_and_log(rng):
    pool = _pool(1, 4)
    tasks = pool.plan(64)
    data = _chunks(tasks, rng)
    eng = StagingEngine(pool)
    staged = eng.stage(tasks, lambda t: {"x": data[t.vdev]})
    assert [c.task.vdev for c in staged] == [t.vdev for t in tasks]
    times = [c.ready_s for c in staged]
    assert all(t is not None for t in times)
    assert times == sorted(times)
    assert all(e["mode"] == "sequential" for e in eng.log)
    assert [e["vdev"] for e in eng.log] == [t.vdev for t in tasks]
    assert [e["bytes"] for e in eng.log] == [data[t.vdev].nbytes for t in tasks]
    np.testing.assert_array_equal(staged[0].arrays["x"].numpy(),
                                  data[staged[0].task.vdev])


def test_concurrent_staging_enqueues_all_before_any_wait(rng):
    pool = _pool(1, 4)
    tasks = pool.plan(64)
    data = _chunks(tasks, rng)
    eng = StagingEngine(pool, mode="concurrent")
    staged = eng.stage(tasks, lambda t: {"x": data[t.vdev]})   # block=False
    assert len(staged) == 4 and eng.log == []                  # none waited
    assert all(c.ready_s is None for c in staged)
    staged = eng.stage(tasks, lambda t: {"x": data[t.vdev]}, block=True)
    assert all(c.ready_s is not None for c in staged)
    assert [e["mode"] for e in eng.log] == ["concurrent"] * 4


def test_stage_covers_all_items_and_pads_on_the_target(rng):
    pool = _pool(1, 4)
    tasks = pool.plan(37, uniform=True)  # ragged split: sizes 10,9,9,9
    data = _chunks(tasks, rng)
    eng = StagingEngine(pool)
    staged = eng.stage(tasks, lambda t: {
        "x": PaddedRows(data[t.vdev], t.pad) if t.pad else data[t.vdev]})
    assert sum(c.task.size for c in staged) == 37
    for c in staged:
        x = c.arrays["x"]
        assert x.shape == (10, 8)
        np.testing.assert_array_equal(x[:c.task.size].numpy(),
                                      data[c.task.vdev])
        assert not x[c.task.size:].any()          # neutral rows are zero


def test_transfer_telemetry_span_and_counters(rng):
    tel = Telemetry(enabled=True)
    pool = _pool(1, 2)
    tasks = pool.plan(8)
    data = _chunks(tasks, rng)
    StagingEngine(pool, telemetry=tel).stage(tasks, lambda t: data[t.vdev])
    spans = tel.spans("transfer.stage")
    assert [s.attrs["vdev"] for s in spans] == [0, 1]
    assert all(s.attrs["mode"] == "sequential" and s.duration >= 0
               for s in spans)
    nbytes = sum(a.nbytes for a in data.values())
    assert tel.counter_snapshot() == {"transfer.bytes": nbytes,
                                      "transfer.chunks": 2}


def test_timeline_overlaps_predicate():
    def tl(v, ts, te, cs, ce):
        return TenantTimeline(v, 0, v, ts, te, cs, ce)
    # transfer(1) starts inside compute(0): overlap
    assert timeline_overlaps([tl(0, 0, 1, 1, 3), tl(1, 1.5, 2, 3, 4)]) == [True]
    # blocking: both transfers precede both computes
    assert timeline_overlaps([tl(0, 0, 1, 2, 3), tl(1, 1, 2, 3, 4)]) == [False]
    # compute(0) drained before transfer(1) began
    assert timeline_overlaps([tl(0, 0, 1, 1, 2), tl(1, 2.5, 3, 3, 4)]) == [False]
    assert timeline_overlaps([]) == []


@pytest.mark.parametrize("mode", ["sequential", "concurrent"])
def test_executor_generic_payload(mode):
    """The executor is workload-agnostic: any stage_fn/compute_fn pair."""
    pool = _pool(1, 3, mode)
    tasks = pool.plan(30, uniform=True)
    data = np.arange(30, dtype=np.float32)
    ex = PipelineExecutor(pool)
    rep = ex.run(tasks, lambda t: data[t.start:t.stop], lambda t, x: x * 2.0)
    assert rep.mode == mode
    out = np.concatenate([rep.results[t.vdev].numpy() for t in tasks])
    np.testing.assert_array_equal(out, data * 2.0)
    assert rep.wall_s > 0 and len(rep.timeline) == 3
    assert set(rep.per_tenant_s()) == {0, 1, 2}
    for e in rep.timeline:
        assert e.transfer_start <= e.transfer_end <= e.compute_start \
            <= e.compute_end
    assert [e["vdev"] for e in ex.engine.log] == [0, 1, 2]


class _Boom:
    def synchronize(self):
        raise RuntimeError("device boom")


def test_waiter_records_errors_and_keeps_serving():
    w = CompletionWaiter(lambda: 1.0)
    a, b = TenantTimeline(0, 0, 0, 0, 0, 0, 0.0), \
        TenantTimeline(1, 0, 1, 0, 0, 0, 0.0)
    done = []
    fa = w.submit(_Boom(), a, on_ready=lambda: done.append("a"))
    fb = w.submit(None, b, on_ready=lambda: done.append("b"))
    assert fa.wait(10) and fb.wait(10)
    w.close()
    assert [str(e) for e in w.errors] == ["device boom"]
    assert done == ["b"] and b.compute_end == 1.0 and a.compute_end == 0.0


def test_executor_propagates_waiter_errors(monkeypatch):
    """A device error surfacing in the waiter thread must re-raise on the
    main thread, not silently yield a partial result dict."""
    monkeypatch.setattr(tpipe, "launch_after_copy",
                        lambda chunk, fn, stream:
                        (fn(chunk.task, chunk.arrays), None, _Boom()))
    pool = _pool(1, 2)
    ex = PipelineExecutor(pool)
    with pytest.raises(RuntimeError, match="device boom"):
        ex.run(pool.plan(4, uniform=True), lambda t: np.float32([1.0]),
               lambda t, x: x)
    assert not any(th.name == "pipeline-waiter" and th.is_alive()
                   for th in threading.enumerate())


def test_executor_reaps_waiter_on_stage_error():
    """stage_fn raising mid-loop must not leak a blocked waiter thread."""
    def bad_stage(t):
        raise ValueError("bad stage")

    pool = _pool(1, 2)
    ex = PipelineExecutor(pool)
    with pytest.raises(ValueError, match="bad stage"):
        ex.run(pool.plan(4, uniform=True), bad_stage, lambda t, x: x)
    assert not any(th.name == "pipeline-waiter" and th.is_alive()
                   for th in threading.enumerate())


def test_waiter_stress_many_submitters():
    """More submitting threads than cores: every entry is stamped once."""
    import sys
    ticks = iter(range(1, 10**6))
    lock = threading.Lock()

    def clock():
        with lock:
            return float(next(ticks))

    w = CompletionWaiter(clock)
    entries = [TenantTimeline(i, 0, i, 0, 0, 0, 0.0) for i in range(400)]
    flags = [None] * len(entries)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def work(lo):
            for i in range(lo, len(entries), 16):
                flags[i] = w.submit(None, entries[i])
        threads = [threading.Thread(target=work, args=(k,)) for k in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(30)
            assert not th.is_alive()
        assert all(f.wait(30) for f in flags)
    finally:
        sys.setswitchinterval(old)
        w.close()
    stamps = sorted(e.compute_end for e in entries)
    assert stamps == [float(i) for i in range(1, 401)] and not w.errors


def test_resolve_devices():
    assert resolve_devices(3, "cpu") == [CPU] * 3
    with pytest.raises(ValueError):
        resolve_devices(1, "meta")
