"""The device trace of a ``--trace 1`` run, reduced to numbers.

:class:`Tracer` runs ``torch.profiler`` (CPU and CUDA activities) over a
traced window, writes the Chrome trace under ``TMPDIR``, reads it back and
deletes it.  What is kept: every device operation (kernels, copies, sets)
as ``(name, start_us, duration_us)``, the host spans (the benchmark's own
``record_function`` spans, and any program spans handed in with their
``perf_counter`` times), and the traced window.  From those it gives the
busy seconds (the union of the device operations), the device operations
that took most time, and the idle gaps by what the host was doing.

A tracer that is off profiles nothing and its spans cost nothing.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
ANCHOR = "bench.anchor"


def short_name(name: str) -> str:
    """A kernel's name without its argument list and return type."""
    head = name.replace("(anonymous namespace)::", "").split("(", 1)[0]
    head = head.strip()
    if head.startswith("void "):
        head = head[5:]
    return head[:120]


def union_s(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def gaps(intervals: List[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The parts of ``[lo, hi]`` that no interval covers."""
    out, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


class Tracer:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.ops: List[Tuple[str, float, float]] = []     # us
        self.host: List[Tuple[str, float, float]] = []    # us
        self.lo_us = self.hi_us = 0.0
        self._anchor_pc = 0.0
        self._anchor_us: Optional[float] = None

    def span(self, name: str):
        if not self.enabled or self.prof is None:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(name)

    def start(self) -> None:
        """Begin the traced window (the device is drained first, so that
        the trace holds only work enqueued inside it)."""
        if not self.enabled:
            return
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self._anchor_pc = time.perf_counter()
        with torch.profiler.record_function(ANCHOR):
            pass
        self._t_start = time.perf_counter()

    def stop(self, program_spans: Iterable[Tuple[str, float, float]] = ()
             ) -> None:
        """End the traced window once the device has finished what was
        enqueued in it; ``program_spans`` are ``(name, start, end)`` in
        ``perf_counter`` seconds."""
        if not self.enabled or self.prof is None:
            return
        import torch
        t_end = time.perf_counter()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t_sync = time.perf_counter()
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.remove(path)
        self.prof = None
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, dur = e.get("cat", ""), float(e.get("dur", 0.0))
            ts = float(e["ts"])
            if cat in DEVICE_CATS:
                self.ops.append((e.get("name", "?"), ts, dur))
            elif cat == "user_annotation":
                if e.get("name") == ANCHOR:
                    self._anchor_us = ts
                else:
                    self.host.append((e.get("name", "?"), ts, dur))
        if self._anchor_us is None:
            raise RuntimeError("device trace: the anchor span is missing")
        to_us = self.to_us
        self.lo_us = to_us(self._t_start)
        # the window runs to the end of the device work enqueued in it
        last = max((ts + d for _, ts, d in self.ops), default=0.0)
        self.hi_us = max(to_us(t_end), min(last, to_us(t_sync)))
        for name, a, b in program_spans:
            self.host.append((name, to_us(a), (b - a) * 1e6))

    def to_us(self, t_pc: float) -> float:
        return self._anchor_us + (t_pc - self._anchor_pc) * 1e6

    def summary(self) -> Optional[Dict]:
        """busy_s, window_s, the top device operations, the longest idle
        gaps by host span, and per-kernel seconds (None when off)."""
        if not self.enabled or self._anchor_us is None:
            return None
        lo, hi = self.lo_us, self.hi_us
        iv = [(max(ts, lo), min(ts + d, hi)) for _, ts, d in self.ops
              if ts + d > lo and ts < hi]
        busy_us = union_s(iv)
        by_op: Dict[str, float] = defaultdict(float)
        for name, ts, d in self.ops:
            by_op[short_name(name)] += d * 1e-6
        idle: Dict[str, float] = defaultdict(float)
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        for a, b in gaps(iv, lo, hi):
            mid = 0.5 * (a + b)
            # nested spans: the innermost holding ``mid`` is the latest
            # started one that has not ended by then
            name = "(no host span)"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 256, -1), -1):
                if host[j][1] + host[j][2] >= mid:
                    name = host[j][0]
                    break
            idle[name] += (b - a) * 1e-6
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        worst = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
        return {"busy_s": busy_us * 1e-6, "window_s": (hi - lo) * 1e-6,
                "kernels_s": dict(by_op),
                "breakdown": {"device_ops": [[k, v] for k, v in top],
                              "idle_gaps": [[k, v] for k, v in worst]}}

    def kernel_s(self, needle: str) -> Tuple[float, int]:
        """Seconds and launches of the device operations whose name holds
        ``needle``."""
        hit = [d for name, _, d in self.ops if needle in name]
        return sum(hit) * 1e-6, len(hit)
