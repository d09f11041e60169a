"""The card's power gauge: NVML's total-energy counter, read through ctypes.

A frozen copy of the port's ``obs/gauge.py``, kept with the benchmark so that
the yardstick does not change when the program does; it polls every 5 ms,
not 0.5 ms, so that its thread takes the interpreter lock from the run it
measures 200 times a second, not 2,000 (a tick's time is then exact to
5 ms at each end of a 30 s window).

``nvmlDeviceGetTotalEnergyConsumption`` gives the energy in mJ the board
has drawn since the driver loaded.  The counter moves in steps (about every
100 ms on an NVIDIA H100 80GB HBM3), so a :class:`PowerGauge` polls it from
a thread and keeps each ``(perf_counter time, joules)`` at which the value
changed: a *tick*.  The energy between two ticks over the time between them
is the board's mean power over that interval, exact to the polling period
(``POLL_S``) at each end.  The thread sleeps between reads, so it takes
neither a core nor the GIL from the run it measures.  A busy host can hold
the thread back; each tick keeps the time since the read before it, so a
tick seen late can be left out (``within=``): the two intervals around it
then merge into one whose energy and length are both exact.
``nvidia-smi``'s ``power.draw`` is a one-second average on Ampere and
later cards, which would smear windows shorter than that; the counter does
not.

The library ships with the NVIDIA driver (``libnvidia-ml.so.1``), so
nothing is installed for it.  The gauge never makes up a reading: it raises
when the library, the device or the counter is missing.
"""
from __future__ import annotations

import ctypes
import math
import threading
import time
from typing import List, Optional, Tuple

NVML_LIB = "libnvidia-ml.so.1"
WAIT_TIMEOUT_S = 10.0        # wait_ticks gives up (the counter stopped)
POLL_S = 0.005               # between reads; the counter steps every ~100 ms


class PowerGauge:
    """Ticks of one card's energy counter, polled by a thread between
    :meth:`start` and :meth:`close` (or inside ``with``)."""

    source = "nvml total energy counter"

    def __init__(self, index: int = 0, lib: str = NVML_LIB):
        try:
            self._nvml = ctypes.CDLL(lib)
        except OSError as e:
            raise RuntimeError(
                f"power gauge: cannot load {lib} ({e}); it ships with the "
                "NVIDIA driver, which this machine lacks") from e
        self._nvml.nvmlErrorString.restype = ctypes.c_char_p
        self._check(self._nvml.nvmlInit_v2(), "nvmlInit_v2")
        self._handle = ctypes.c_void_p()
        self._check(self._nvml.nvmlDeviceGetHandleByIndex_v2(
            ctypes.c_uint(index), ctypes.byref(self._handle)),
            f"nvmlDeviceGetHandleByIndex_v2({index})")
        self._mj = ctypes.c_ulonglong()
        self.read_j()                  # raises where there is no counter
        # (time, joules, seconds since the read before it) per tick
        self._ticks: List[Tuple[float, float, float]] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.errors: List[BaseException] = []

    def _check(self, rc: int, what: str) -> None:
        if rc != 0:
            msg = self._nvml.nvmlErrorString(rc)
            raise RuntimeError(f"power gauge: {what} failed: NVML error {rc}"
                               f" ({msg.decode() if msg else '?'})")

    def read_j(self) -> float:
        """The counter now, in joules."""
        self._check(self._nvml.nvmlDeviceGetTotalEnergyConsumption(
            self._handle, ctypes.byref(self._mj)),
            "nvmlDeviceGetTotalEnergyConsumption")
        return self._mj.value * 1e-3

    # -- the sampler thread ---------------------------------------------
    def start(self) -> "PowerGauge":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="power-gauge")
            self._thread.start()
        return self

    def _run(self) -> None:
        try:
            last = self.read_j()         # the value before the first tick
            t_last = -math.inf           # untimed: a first-poll tick is late
            while not self._stop.wait(POLL_S):
                t = time.perf_counter()
                e = self.read_j()        # the ctypes call drops the GIL
                if e != last:
                    with self._lock:
                        self._ticks.append((t, e, t - t_last))
                    last = e
                t_last = t
        except RuntimeError as e:        # surfaced by ticks() and close()
            self.errors.append(e)

    def close(self) -> None:
        """Stop the thread and release NVML."""
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=10.0)
            self._thread = None
        self._check(self._nvml.nvmlShutdown(), "nvmlShutdown")
        if self.errors:
            raise self.errors[0]

    def __enter__(self) -> "PowerGauge":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # -- readings ---------------------------------------------------------
    def ticks(self, lo: float = -math.inf, hi: float = math.inf,
              within: float = math.inf) -> List[Tuple[float, float]]:
        """The ticks seen within ``[lo, hi]`` (perf_counter seconds), in
        time order: ``(time, joules)``; with ``within``, only those seen at
        most ``within`` seconds after the read before them."""
        if self.errors:
            raise self.errors[0]
        with self._lock:
            return [(t, e) for t, e, d in self._ticks
                    if lo <= t <= hi and d <= within]

    def late(self, within: float) -> int:
        """How many ticks were seen more than ``within`` seconds after the
        read before them."""
        with self._lock:
            return sum(d > within for _, _, d in self._ticks)

    def wait_ticks(self, n: int) -> None:
        """Block until ``n`` more ticks than now have been seen."""
        if self._thread is None:
            raise RuntimeError("power gauge: start() it first")
        with self._lock:
            want = len(self._ticks) + n
        end = time.perf_counter() + WAIT_TIMEOUT_S
        while True:
            with self._lock:
                if len(self._ticks) >= want:
                    return
            if self.errors:
                raise self.errors[0]
            if time.perf_counter() > end:
                raise RuntimeError(f"power gauge: no {n} counter ticks in "
                                   f"{WAIT_TIMEOUT_S} s")
            time.sleep(0.005)

    def mean_watts(self, lo: float, hi: float,
                   within: float = math.inf) -> float:
        """Mean board power over the ticks within ``[lo, hi]`` (and
        ``within``, as in :meth:`ticks`): the energy between the first and
        the last over the time between them.  Raises when the window holds
        fewer than two ticks."""
        tk = self.ticks(lo, hi, within)
        if len(tk) < 2:
            raise RuntimeError(
                f"power gauge: {len(tk)} counter ticks in a window of "
                f"{(hi - lo) * 1e3:.1f} ms; lengthen the window")
        (t0, e0), (t1, e1) = tk[0], tk[-1]
        return (e1 - e0) / (t1 - t0)
