"""The benchmark's general machinery: find a cell of ``BENCHMARK.json`` by
name, load its configuration, traffic mix and driver, run it, and turn the
driver's record into the result line through one reader a metric.

Everything a cell owns sits in files found by name:

* ``configs/<file>``: the configuration, as ``BENCHMARK.json`` names it;
* ``traffic/<traffic>.json``: the mix's parameters, with ``driver``, the
  module of ``drivers/`` that runs it, and ``limits``, one per number that
  decides ``correct``;
* ``metrics/<metric>.py``: ``read(record)`` gives the metric's value, or
  None where the record holds nothing to read.

Adding a cell, a mix, a configuration or a metric therefore adds files and
entries and edits none.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import pathlib
import sys
import time
from typing import Any, Callable, Dict, List, Optional

# top-level module names no run may hold: the JAX stack and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: pathlib.Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: pathlib.Path):
    """A module of the benchmark's own, loaded from its file (its name may
    hold dots, as a metric's does)."""
    name = "perfbench_" + "_".join(path.with_suffix("").parts[-2:]) \
        .replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules=None) -> List[str]:
    """The loaded modules whose top-level name, the part before the first
    dot, is one of :data:`FORBIDDEN` (whole names: ``repro_torch`` is not
    ``repro``)."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def assert_no_forbidden(where: str) -> None:
    found = forbidden_modules()
    if found:
        raise SystemExit(f"import guard ({where}): loaded {', '.join(found)}")


def fix_caches(root: pathlib.Path) -> None:
    """Kernel caches at fixed paths inside the checkout, so that only a
    cell's first run there builds.  The port's nvcc libraries already live
    in ``src/repro_torch/kernels/_build/``."""
    cache = root / "perfbench" / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


@dataclasses.dataclass
class Spec:
    """``BENCHMARK.json`` read once, with lookups by name."""
    data: Dict[str, Any]
    root: pathlib.Path

    @classmethod
    def load(cls, root: pathlib.Path) -> "Spec":
        return cls(load_json(root / "BENCHMARK.json"), root)

    def cell(self, name: str) -> Dict[str, Any]:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict[str, Any]:
        for c in self.data["configs"]:
            if c["name"] == name:
                return load_json(self.root / c["file"])
        raise SystemExit(f"no config {name!r} in BENCHMARK.json")

    @property
    def bench(self) -> pathlib.Path:
        return self.root / "perfbench"

    def traffic(self, name: str) -> Dict[str, Any]:
        return load_json(self.bench / "traffic" / f"{name}.json")

    def metrics(self, cell: str, trace: bool) -> List[Dict[str, Any]]:
        """The cell's end-to-end metrics (``trace`` off) or per-layer ones
        (on): every entry that lists the cell, or lists no cells."""
        group = self.data["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if "workloads" not in m or cell in m["workloads"]]


class Context:
    """What a driver gets: the cell's configuration and mix, the seed, the
    window's length, the device, and the hooks that close set-up and the
    window.  ``faults`` lets a test break the timed path underneath."""

    def __init__(self, *, config, traffic, seed: int, seconds: float,
                 trace: bool, device, t_start: float, guard: bool = True,
                 overrides: Optional[Dict[str, Any]] = None,
                 faults: Optional[Dict[str, Callable]] = None):
        self.config = config
        self.traffic = dict(traffic, **(overrides or {}))
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.t_start = t_start
        self.guard = guard
        self.faults = faults or {}
        self.setup_s: Optional[float] = None

    def setup_done(self) -> None:
        """Closes set-up: the time since the process started, and the
        import guard."""
        self.setup_s = time.perf_counter() - self.t_start
        if self.guard:
            assert_no_forbidden("after set-up")


def run_cell(spec: Spec, name: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, guard: bool = True,
             overrides: Optional[Dict[str, Any]] = None,
             faults: Optional[Dict[str, Callable]] = None,
             config_overrides: Optional[Dict[str, Any]] = None
             ) -> Dict[str, Any]:
    """One run of a cell: the result line's object, with the numbers that
    decided ``correct`` under ``checks``, last.  ``overrides`` and
    ``config_overrides`` replace keys of the mix and of the configuration
    (the tests' small sizes, the sweep's rates)."""
    imports_s = time.perf_counter() - t_start
    cell = spec.cell(name)
    traffic = spec.traffic(cell["traffic"])
    driver = load_module(spec.bench / "drivers" / f"{traffic['driver']}.py")
    config = dict(spec.config(cell["config"]), **(config_overrides or {}))
    ctx = Context(config=config, traffic=traffic,
                  seed=seed, seconds=seconds, trace=trace, device=device,
                  t_start=t_start, guard=guard, overrides=overrides,
                  faults=faults)
    rec = driver.run(ctx)
    rec.setdefault("setup_s", ctx.setup_s)
    metrics = {}
    for m in spec.metrics(name, trace):
        value = load_module(spec.bench / "metrics" / f"{m['name']}.py") \
            .read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    checks = rec["checks"]
    dev = {"platform": rec["platform"], "kind": rec["kind"], "count": 1,
           "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    out: Dict[str, Any] = {
        "correct": bool(checks) and all(c["value"] <= c["limit"]
                                        for c in checks.values()),
        "attempted": int(rec["attempted"]), "failed": int(rec["failed"]),
        "metrics": metrics, "device": dev}
    if trace and rec.get("trace"):
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]
        out["breakdown"] = rec["trace"]["breakdown"]
    for key in ("control", "memory"):
        if key in rec:
            out[key] = rec[key]
    out["phases"] = dict(rec.get("phases", {}), imports_s=imports_s,
                         setup_s=ctx.setup_s)
    out["checks"] = checks
    if guard:
        assert_no_forbidden("after the window")
    return out
