"""BENCHMARK.json against the benchmark's contract, and the harness finding
a cell, a configuration, a mix, a driver and a metric by name: a new cell
takes new files and entries, and edits none."""
import hashlib
import json
import pathlib
import re
import shutil
import sys
import time

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

import harness  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["perfbench"]
    assert SPEC["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_keys():
    names = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"}),
                        ("end_to_end", {"name", "unit", "better", "bound",
                                        "source", "workloads"}),
                        ("per_layer", {"name", "unit", "better", "source",
                                       "layer", "moves", "workloads"})):
        for e in SPEC[group]:
            assert set(e) <= keys, (group, e)
            assert NAME.match(e["name"]), e["name"]
            assert (group, e["name"]) not in names
            names.add((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                                 "higher")
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]


def test_every_cell_finds_its_files():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    configs = {c["name"] for c in SPEC["configs"]}
    spec = harness.Spec.load(ROOT)
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and w["config"] in configs
        mix = spec.traffic(w["traffic"])
        assert (BENCH / "drivers" / f"{mix['driver']}.py").is_file()
        assert mix["limits"]
        spec.config(w["config"])
        reported = {m["name"] for m in spec.metrics(w["name"], False)}
        assert "setup_s" in reported and len(reported) >= 2
        layer = spec.metrics(w["name"], True)
        assert layer
        for m in layer:
            assert m["moves"] in reported, (w["name"], m["name"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] <= 0.25


def _digest(root: pathlib.Path):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_cell_is_new_files_and_entries(tmp_path):
    """A configuration, a mix, a driver and a metric added beside the
    benchmark's own: the harness runs the new cell by name and no file that
    was there changes."""
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    spec_data = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = _digest(tmp_path / "perfbench")
    b = tmp_path / "perfbench"
    (b / "configs" / "toy.json").write_text(json.dumps({"size": 3}))
    (b / "traffic" / "toy-once.json").write_text(json.dumps(
        {"driver": "toy_driver", "repeat": 4, "limits": {"gap": 0.5}}))
    (b / "drivers" / "toy_driver.py").write_text(
        "def run(ctx):\n"
        "    ctx.setup_done()\n"
        "    n = ctx.config['size'] * ctx.traffic['repeat']\n"
        "    return {'platform': 'cpu', 'kind': 'cpu',\n"
        "            'memory_peak_bytes': 0, 'attempted': n, 'failed': 0,\n"
        "            'done': n, 'window_s': 2.0,\n"
        "            'checks': {'gap': {'value': 0.1, 'limit': 0.5}}}\n")
    (b / "metrics" / "toy.done_per_s.py").write_text(
        "def read(rec):\n    return rec.get('done', 0) / rec['window_s']\n")
    spec_data["configs"].append({"name": "toy",
                                 "source": "https://example.org",
                                 "file": "perfbench/configs/toy.json",
                                 "reduced": [], "why": "a test"})
    spec_data["workloads"].append({"name": "toy-once", "config": "toy",
                                   "traffic": "toy-once", "chips": 1,
                                   "why": "a test"})
    spec_data["end_to_end"].append({"name": "toy.done_per_s", "unit": "1/s",
                                    "better": "higher", "bound": 0.05,
                                    "source": "host_clock",
                                    "workloads": ["toy-once"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec_data))
    spec = harness.Spec.load(tmp_path)
    out = harness.run_cell(spec, "toy-once", 7, 1.0, False, "cpu",
                           time.perf_counter(), guard=False)
    assert out["correct"] is True and out["attempted"] == 12
    assert out["metrics"]["toy.done_per_s"]["value"] == 6.0
    assert "setup_s" in out["metrics"]
    assert list(out)[-1] == "checks"
    after = _digest(tmp_path / "perfbench")
    assert {k: v for k, v in after.items() if k in before} == before
    # the existing cells still find theirs in the copy
    assert spec.traffic("internlm2-chat")["driver"] == "serve_open"
