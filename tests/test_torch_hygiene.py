"""The port stands alone: it imports without jax, loads nothing of the JAX
package, and never runs on the CPU unless asked to."""
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.configs.risk_app import RiskAppConfig
from repro_torch.core.pipeline import PipelineExecutor
from repro_torch.core.tenancy import (TenancyConfig, VirtualDevicePool,
                                      resolve_devices)
from repro_torch.core.transfer import StagingEngine
from repro_torch.launch import risk as cli
from repro_torch.risk.analysis import AggregateRiskAnalysis

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
DIAGNOSTICS = [os.path.join(ROOT, "diagnostics", f)
               for f in ("f1_internlm2.py", "ssd_head_tiles.py",
                         "risk_pairs.py", "slot_dispatch.py")]
EXAMPLES = [os.path.join(ROOT, "examples", f)
            for f in ("torch_quickstart.py", "torch_risk_realtime.py",
                      "torch_deployment_planner.py",
                      "torch_serve_multitenant.py", "torch_train_lm.py")]

IMPORT_ALL = textwrap.dedent("""
    import importlib, pkgutil, sys
    sys.modules["jax"] = None            # any `import jax` now raises
    import repro_torch
    names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch.")]
    for n in names:
        importlib.import_module(n)
    import chip_smoke                    # import only: nothing runs
    bad = sorted(m for m in sys.modules
                 if m == "repro" or m.startswith("repro.")
                 or m == "jax" and sys.modules[m] is not None
                 or m.startswith("jax."))
    assert not bad, bad
    want = {"repro_torch.kernels.aggregate_loss", "repro_torch.kernels.build",
            "repro_torch.kernels.ops", "repro_torch.kernels.ref",
            "repro_torch.core.pipeline", "repro_torch.core.transfer",
            "repro_torch.core.tenancy", "repro_torch.core.planner",
            "repro_torch.core.perfmodel", "repro_torch.core.energymodel",
            "repro_torch.obs.telemetry", "repro_torch.risk.analysis",
            "repro_torch.risk.metrics", "repro_torch.risk.tables",
            "repro_torch.launch.risk", "repro_torch.configs.risk_app",
            "repro_torch.kernels.paged_attention",
            "repro_torch.configs.internlm2_1_8b",
            "repro_torch.configs.h2o_danube_1_8b",
            "repro_torch.configs.qwen3_32b",
            "repro_torch.models.layers", "repro_torch.models.attention_core",
            "repro_torch.models.transformer", "repro_torch.models.model",
            "repro_torch.models.convert", "repro_torch.serving.kvcache",
            "repro_torch.serving.engine", "repro_torch.serving.continuous",
            "repro_torch.serving.multitenant",
            "repro_torch.distributed.fault", "repro_torch.launch.serve",
            "repro_torch.kernels.ssd_scan", "repro_torch.models.ssm",
            "repro_torch.configs.mamba2_2_7b",
            "repro_torch.kernels.flash_attention", "repro_torch.models.moe",
            "repro_torch.configs.olmoe_1b_7b",
            "repro_torch.core.simulator", "repro_torch.obs.fit",
            "repro_torch.obs.export", "repro_torch.obs.gauge",
            "repro_torch.data.tokens", "repro_torch.models.params",
            "repro_torch.training.optimizer",
            "repro_torch.training.train_loop",
            "repro_torch.training.grad_compression",
            "repro_torch.launch.train",
            "repro_torch.distributed.sharding", "repro_torch.launch.mesh"}
    assert want <= set(names), want - set(names)
    print("IMPORTED", len(names))
""")


def test_port_imports_without_jax_and_without_the_jax_package():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT, env.get("PYTHONPATH", "")])
    proc = subprocess.run([sys.executable, "-c", IMPORT_ALL],
                          capture_output=True, text=True, env=env,
                          timeout=240, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "IMPORTED" in proc.stdout


def test_sources_name_neither_jax_nor_the_jax_package():
    import re
    pat = re.compile(r"^\s*(import jax|from jax|from repro\b|import repro\b)",
                     re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")] + DIAGNOSTICS + EXAMPLES
    for d, _, fs in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    assert len(files) > 15
    names = {os.path.relpath(f, ROOT) for f in files}
    assert {"src/repro_torch/kernels/ssd_scan.py",
            "src/repro_torch/models/ssm.py",
            "src/repro_torch/configs/mamba2_2_7b.py",
            "src/repro_torch/kernels/flash_attention.py",
            "src/repro_torch/models/moe.py",
            "src/repro_torch/configs/olmoe_1b_7b.py",
            "src/repro_torch/core/simulator.py",
            "src/repro_torch/obs/fit.py", "src/repro_torch/obs/export.py",
            "src/repro_torch/obs/gauge.py", "diagnostics/risk_pairs.py",
            "examples/torch_deployment_planner.py",
            "src/repro_torch/training/train_loop.py",
            "src/repro_torch/data/tokens.py", "src/repro_torch/launch/train.py",
            "examples/torch_train_lm.py"} <= names
    for f in files:
        with open(f) as fh:
            assert not pat.search(fh.read()), f


def _skip_if_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would not raise")


@pytest.mark.parametrize("device", [None, "cuda"])
def test_entry_points_raise_without_a_card(device):
    """No quiet retreat to the CPU: the default device is CUDA."""
    _skip_if_card()
    cfg = RiskAppConfig().reduced()
    pool = VirtualDevicePool(TenancyConfig(1, 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        AggregateRiskAnalysis(cfg, device=device)
    with pytest.raises(RuntimeError, match="CUDA"):
        StagingEngine(pool, device=device)
    with pytest.raises(RuntimeError, match="CUDA"):
        PipelineExecutor(pool, device=device)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_devices(1, device)
    with pytest.raises(RuntimeError, match="CUDA"):
        StagingEngine(VirtualDevicePool(TenancyConfig(1, 1),
                                        [torch.device("cuda:0")]))


def test_cli_raises_without_a_card():
    _skip_if_card()
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--reduced"])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--reduced", "--device", "cuda"])


@pytest.mark.parametrize("device", [None, "cuda"])
def test_serving_entry_points_raise_without_a_card(device):
    """The serving stack, like the risk stack, runs on the CPU only when
    asked: engine, continuous engine, scheduler and the serve CLI."""
    _skip_if_card()
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.model import build_model
    from repro_torch.serving.continuous import ContinuousBatchingEngine
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.multitenant import MultiTenantScheduler
    cfg = get_config("internlm2-1.8b").reduced()
    params = build_model(cfg).init(0, "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg, params, device=device)
    eng = ServingEngine(cfg, params, device="cpu")
    kw = dict(capacity=2, max_prompt_len=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousBatchingEngine(eng, device=device or "cuda", **kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiTenantScheduler(eng, continuous=kw, device=device or "cuda")
    argv = [] if device is None else ["--device", device]
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--reduced"] + argv)


def test_kernel_wrapper_never_falls_back_for_non_cpu_tensors():
    """A tensor that is not on the CPU goes to the kernel or raises; the
    meta device stands in for a card here."""
    from repro_torch.kernels import aggregate_loss as agg
    from repro_torch.kernels import paged_attention as pa
    ids = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    elt = torch.zeros((3, 2), device="meta")
    terms = torch.zeros(2, device="meta")
    agg.reset_counts()
    for fn in (agg.aggregate_loss_gather, agg.aggregate_loss_onehot):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(ids, elt, terms, terms, 0.0, 1.0)
    assert not any(agg.plain_counts.values())
    assert not any(agg.launch_counts.values())

    meta = lambda shape, dt=torch.bfloat16: torch.zeros(shape, dtype=dt,
                                                        device="meta")
    i32 = torch.int32
    pa.reset_counts()
    with pytest.raises(RuntimeError, match="CUDA"):
        pa.paged_attention_decode(meta((2, 4, 8)), meta((6, 4, 2, 8)),
                                  meta((6, 4, 2, 8)), meta((6, 4), i32),
                                  meta((2, 3), i32), meta((2,), i32))
    with pytest.raises(RuntimeError, match="CUDA"):
        pa.paged_prefill_scatter(meta((2, 6, 4, 2, 8)), meta((3,), i32),
                                 meta((2, 3, 4, 2, 8), torch.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        pa.paged_admit_kv(meta((2, 6, 4, 2, 8)), meta((2, 6, 4, 2, 8)),
                          meta((6, 4), i32), meta((3,), i32),
                          meta((2, 10, 2, 8)), meta((2, 10, 2, 8)),
                          meta((10,), i32))
    assert not any(pa.plain_counts.values())
    assert not any(pa.launch_counts.values())

    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan
    f32 = torch.float32
    x, B = meta((1, 32, 2, 8), f32), meta((1, 32, 2, 16), f32)
    dt = meta((1, 32, 2), f32)
    ssd_scan.reset_counts()
    with pytest.raises(RuntimeError, match="CUDA"):
        ssd_scan.ssd_chunked(x, dt, dt, B, B, chunk=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.ssd(x[:, :30], dt[:, :30], dt[:, :30], B[:, :30], B[:, :30],
                chunk=16, initial_state=meta((1, 2, 8, 16), f32))
    assert not any(ssd_scan.plain_counts.values())
    assert not any(ssd_scan.launch_counts.values())

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers
    from repro_torch.configs import get_config
    fa.reset_counts()
    q, kv = meta((2, 16, 4, 8)), meta((2, 16, 2, 8))
    for fn in (fa.flash_attention, ops.flash_attention):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(q, kv, kv, causal=True, window=4)
    # the prefill's one call site, reached with the weights on the card
    cfg = get_config("olmoe-1b-7b").reduced()
    d, H, D = cfg.d_model, cfg.num_heads, cfg.head_dim
    p = {"wq": meta((d, H * D), f32),
         "wk": meta((d, cfg.num_kv_heads * D), f32),
         "wv": meta((d, cfg.num_kv_heads * D), f32),
         "wo": meta((H * D, d), f32),
         "q_norm": meta((D,), f32), "k_norm": meta((D,), f32)}
    with pytest.raises(RuntimeError, match="CUDA"):
        layers.apply_attention(p, meta((2, 16, d), f32), cfg)
    assert not any(fa.plain_counts.values())
    assert not any(fa.launch_counts.values())


def test_chip_smoke_fails_without_a_card():
    _skip_if_card()
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                          capture_output=True, text=True, timeout=240,
                          cwd=ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


@pytest.mark.parametrize("script", DIAGNOSTICS,
                         ids=[os.path.basename(f) for f in DIAGNOSTICS])
def test_diagnostics_fail_without_a_card(script):
    _skip_if_card()
    proc = subprocess.run([sys.executable, script], capture_output=True,
                          text=True, timeout=240, cwd=ROOT)
    assert proc.returncode == 1
    assert "no CUDA device" in proc.stderr


@pytest.mark.parametrize("script", EXAMPLES,
                         ids=[os.path.basename(f) for f in EXAMPLES])
def test_examples_fail_without_a_card(script):
    """The port's examples default to the card, like its entry points."""
    _skip_if_card()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, script], capture_output=True,
                          text=True, timeout=240, cwd=ROOT, env=env)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr


def test_power_gauge_raises_without_a_card():
    """The gauge reads the driver's energy counter or raises: it never
    reports made-up watts on a machine without one."""
    _skip_if_card()
    from repro_torch.obs.gauge import PowerGauge
    with pytest.raises(RuntimeError, match="power gauge"):
        PowerGauge()


def test_f1_diagnostic_runs_reduced_on_the_cpu():
    """The F1 measurement end to end at the reduced width on the host,
    where the continuous path and ``generate`` agree token for token: no
    divergence, every step counted as agreeing."""
    import json
    proc = subprocess.run(
        [sys.executable, DIAGNOSTICS[0], "--reduced", "--device", "cpu",
         "--dtypes", "float32"], capture_output=True, text=True,
        timeout=240, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])["float32"]
    assert out["token_agreement"] == 1.0 and out["divergent"] == 0
    assert out["requests_identical"] == 12
    assert out["agreeing_steps"] == 12 * 32


def test_a_header_edit_renames_every_library_that_includes_it(tmp_path,
                                                              monkeypatch):
    """Kernel libraries are named by a hash of their source, the csrc/
    headers it includes, and the flags: editing the shared tensor-core
    header renames the libraries of both kernels that include it (so a
    stale build is never loaded) and no other."""
    import shutil
    from repro_torch.kernels import build
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    users = {n for n in build.sources()
             if "mma_bf16.cuh" in {h.name for h in build.local_headers(n)}}
    assert users == {"flash_attention", "ssd_scan"}
    before = {n: build.library_path(n).name for n in build.sources()}
    header = csrc / "mma_bf16.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: build.library_path(n).name for n in build.sources()}
    assert {n for n in before if before[n] != after[n]} == users


def test_train_lm_example_runs_on_the_cpu(tmp_path):
    """examples/torch_train_lm.py end to end on the host at a few steps
    (the full ~100M model, a short batch): finite losses, its JSON line."""
    import json
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, EXAMPLES[-1], "--device", "cpu", "--steps", "2",
         "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=240, cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])["train_lm"]
    assert out["steps"] == 2 and len(out["losses"]) == 2
    assert all(10.0 < x < 11.0 for x in out["losses"])


def test_serving_calls_take_no_autograd_function(monkeypatch):
    """Under ``torch.no_grad()`` (every serving path), and with inputs that
    require no grad, ``ops.flash_attention`` and ``ops.ssd`` call the
    kernel wrappers as before the training slice: no ``Function``, the
    same numbers bit for bit, no backward counted."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan

    def refuse(*a, **k):
        raise AssertionError("an autograd Function on a serving call")
    monkeypatch.setattr(ops.FlashAttentionFn, "apply", refuse)
    monkeypatch.setattr(ops.SsdChunkedFn, "apply", refuse)
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 40, 4, 16), generator=g, requires_grad=True)
    k = torch.randn((2, 40, 2, 16), generator=g, requires_grad=True)
    fa.reset_counts()
    ssd_scan.reset_counts()
    with torch.no_grad():
        o = ops.flash_attention(q, k, k, causal=True, window=8)
    assert torch.equal(o, fa.flash_attention(q.detach(), k.detach(),
                                             k.detach(), causal=True,
                                             window=8))
    assert torch.equal(ops.flash_attention(q.detach(), k.detach(),
                                           k.detach()),
                       fa.flash_attention_plain(q.detach(), k.detach(),
                                                k.detach()))
    x = torch.randn((1, 40, 2, 8), generator=g, requires_grad=True)
    dt = torch.rand((1, 40, 2), generator=g)
    B = torch.randn((1, 40, 1, 16), generator=g).expand(1, 40, 2, 16)
    with torch.no_grad():
        y, h = ops.ssd(x, dt, -dt, B, B, chunk=16)
    y2, h2 = ops.ssd(x.detach(), dt, -dt, B, B, chunk=16)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    assert fa.backward_counts["flash_attention_bwd"] == 0
    assert ssd_scan.backward_counts["ssd_chunked_bwd"] == 0
