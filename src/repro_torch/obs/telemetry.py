"""Low-overhead structured telemetry: counters/gauges/histograms + spans.

Design constraints (see the package docstring for the naming scheme):

* one monotonic clock (`time.perf_counter`) for every span, stored
  relative to the instance's ``t0`` so exporters never see wall-clock;
* parent/child links from a per-thread open-span stack, so nested
  ``with tel.span(...)`` blocks reconstruct as a tree;
* a bounded, thread-safe ring buffer of closed spans (oldest dropped,
  drop count kept) so long serving runs cannot grow without bound;
* near-zero cost when disabled: ``span()`` returns a shared no-op
  singleton and ``count``/``gauge``/``observe`` return after a single
  attribute check — no telemetry objects are allocated.
  ``spans_opened`` counts every span/event ever opened on the instance
  (including ones the ring later dropped), which is what the overhead
  contract test asserts stays flat across a disabled run.

The process-global plane is ``TELEMETRY`` (disabled by default).
Instrumented layers accept ``telemetry=None`` meaning "the global
plane", so ``TELEMETRY.enable()`` before construction lights up the
whole stack and the default costs nothing.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional


class Span:
    """A closed ``[t_start, t_end)`` interval on the telemetry clock.

    Times are seconds relative to the owning :class:`Telemetry`'s
    ``t0``.  ``parent_id`` is the ``span_id`` of the span that was open
    on the same thread when this one started (None for roots and
    retrospective spans).
    """

    __slots__ = ("name", "t_start", "t_end", "span_id", "parent_id",
                 "thread", "attrs")

    def __init__(self, name: str, t_start: float, t_end: float,
                 span_id: int, parent_id: Optional[int], thread: int,
                 attrs: Dict[str, Any]):
        self.name = name
        self.t_start = t_start
        self.t_end = t_end
        self.span_id = span_id
        self.parent_id = parent_id
        self.thread = thread
        self.attrs = attrs

    @property
    def duration(self) -> float:
        return self.t_end - self.t_start

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Span({self.name!r}, [{self.t_start:.6f},"
                f" {self.t_end:.6f}), id={self.span_id},"
                f" parent={self.parent_id}, attrs={self.attrs})")


class _NullSpan:
    """Shared no-op span: the disabled path allocates nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def note(self, **attrs) -> None:
        pass


NULL_SPAN = _NullSpan()


class _LiveSpan:
    """Context manager for an open span on an enabled plane."""

    __slots__ = ("_tel", "name", "attrs", "span_id", "parent_id",
                 "_t_start")

    def __init__(self, tel: "Telemetry", name: str,
                 attrs: Dict[str, Any]):
        self._tel = tel
        self.name = name
        self.attrs = attrs
        self.span_id = tel._new_id()
        self.parent_id: Optional[int] = None
        self._t_start = 0.0

    def note(self, **attrs) -> None:
        """Attach attrs discovered mid-span (e.g. steps after collect)."""
        self.attrs.update(attrs)

    def __enter__(self) -> "_LiveSpan":
        stack = self._tel._stack()
        self.parent_id = stack[-1].span_id if stack else None
        stack.append(self)
        self._t_start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t_end = time.perf_counter()
        tel = self._tel
        stack = tel._stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:  # pragma: no cover - unbalanced exit
            stack.remove(self)
        tel._close(Span(self.name, self._t_start - tel.t0,
                        t_end - tel.t0, self.span_id, self.parent_id,
                        threading.get_ident(), self.attrs))
        return False


class Telemetry:
    """Thread-safe registry of counters, gauges, histograms and spans."""

    def __init__(self, enabled: bool = False, max_spans: int = 65536):
        self._lock = threading.Lock()
        self.enabled = enabled
        self.t0 = time.perf_counter()
        self.max_spans = max_spans
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        # name -> [count, sum, min, max]
        self.histograms: Dict[str, List[float]] = {}
        self._spans: deque = deque(maxlen=max_spans)
        self._tls = threading.local()
        self._next_id = 0
        self.spans_opened = 0
        self.spans_dropped = 0

    # -- lifecycle ----------------------------------------------------
    def enable(self, max_spans: Optional[int] = None) -> "Telemetry":
        if max_spans is not None and max_spans != self.max_spans:
            self.max_spans = max_spans
            with self._lock:
                self._spans = deque(self._spans, maxlen=max_spans)
        self.enabled = True
        return self

    def disable(self) -> "Telemetry":
        self.enabled = False
        return self

    def reset(self) -> "Telemetry":
        """Clear all recorded state (keeps the enabled flag and clock)."""
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self.histograms.clear()
            self._spans.clear()
            self.spans_dropped = 0
        return self

    def now(self) -> float:
        """Absolute monotonic time, same clock spans are stamped with."""
        return time.perf_counter()

    # -- internals ----------------------------------------------------
    def _new_id(self) -> int:
        with self._lock:
            self._next_id += 1
            self.spans_opened += 1
            return self._next_id

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _close(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.spans_dropped += 1
            self._spans.append(span)

    # -- metrics ------------------------------------------------------
    def count(self, name: str, n: float = 1) -> None:
        if not self.enabled:
            return
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        if not self.enabled:
            return
        with self._lock:
            self.gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        if not self.enabled:
            return
        with self._lock:
            h = self.histograms.get(name)
            if h is None:
                self.histograms[name] = [1, value, value, value]
            else:
                h[0] += 1
                h[1] += value
                h[2] = min(h[2], value)
                h[3] = max(h[3], value)

    # -- spans --------------------------------------------------------
    def span(self, name: str, **attrs):
        """Open a live span: ``with tel.span("round.dispatch", r=3):``."""
        if not self.enabled:
            return NULL_SPAN
        return _LiveSpan(self, name, attrs)

    def event(self, name: str, **attrs) -> None:
        """Record a zero-length span at now."""
        if not self.enabled:
            return
        t = time.perf_counter() - self.t0
        stack = self._stack()
        parent = stack[-1].span_id if stack else None
        self._close(Span(name, t, t, self._new_id(), parent,
                         threading.get_ident(), attrs))

    def record_span(self, name: str, t_start: float, t_end: float, *,
                    parent_id: Optional[int] = None,
                    **attrs) -> Optional[int]:
        """Record a retrospective span from absolute perf_counter times.

        Used for device-side windows stamped by round handles and for
        simulator replays; returns the new span_id (for explicit
        parent linking) or None when disabled.
        """
        if not self.enabled:
            return None
        sid = self._new_id()
        self._close(Span(name, t_start - self.t0, t_end - self.t0, sid,
                         parent_id, threading.get_ident(), attrs))
        return sid

    def spans(self, name: Optional[str] = None,
              prefix: Optional[str] = None) -> List[Span]:
        """Snapshot of the ring, oldest first, optionally filtered."""
        with self._lock:
            out = list(self._spans)
        if name is not None:
            out = [s for s in out if s.name == name]
        if prefix is not None:
            out = [s for s in out if s.name.startswith(prefix)]
        return out

    # -- snapshots ----------------------------------------------------
    def counter_snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self.counters)

    def metric_snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {"counters": dict(self.counters),
                    "gauges": dict(self.gauges),
                    "histograms": {k: {"count": v[0], "sum": v[1],
                                       "min": v[2], "max": v[3]}
                                   for k, v in self.histograms.items()}}


#: Process-global plane; disabled by default so the stack costs nothing.
TELEMETRY = Telemetry(enabled=False)


def get_telemetry(tel: Optional[Telemetry] = None) -> Telemetry:
    """Resolve a layer's ``telemetry=None`` arg to the global plane."""
    return TELEMETRY if tel is None else tel


def record_timeline(tel: Telemetry, entry, *, base: float,
                    prefix: str = "timeline", **attrs) -> None:
    """Re-express a ``TenantTimeline`` entry as two spans on the plane.

    ``entry`` keeps its API (the scheduler still appends it to
    ``timeline``/``admission_timeline``); this mirrors its transfer and
    compute windows as ``<prefix>.transfer`` / ``<prefix>.compute``
    spans.  ``base`` is the absolute perf_counter origin the entry's
    relative stamps were taken against.
    """
    if not tel.enabled:
        return
    common = dict(vdev=entry.vdev, pdev=entry.pdev, slot=entry.slot,
                  **attrs)
    pid = tel.record_span(f"{prefix}.transfer",
                          base + entry.transfer_start,
                          base + entry.transfer_end, **common)
    tel.record_span(f"{prefix}.compute", base + entry.compute_start,
                    base + entry.compute_end, parent_id=pid, **common)
