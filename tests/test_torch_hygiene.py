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
            "repro_torch.launch.risk", "repro_torch.configs.risk_app"}
    assert want <= set(names), want - set(names)
    print("IMPORTED", len(names))
""")


def test_port_imports_without_jax_and_without_the_jax_package():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT, env.get("PYTHONPATH", "")])
    proc = subprocess.run([sys.executable, "-c", IMPORT_ALL],
                          capture_output=True, text=True, env=env,
                          timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "IMPORTED" in proc.stdout


def test_sources_name_neither_jax_nor_the_jax_package():
    import re
    pat = re.compile(r"^\s*(import jax|from jax|from repro\b|import repro\b)",
                     re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, fs in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    assert len(files) > 15
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


def test_kernel_wrapper_never_falls_back_for_non_cpu_tensors():
    """A tensor that is not on the CPU goes to the kernel or raises; the
    meta device stands in for a card here."""
    from repro_torch.kernels import aggregate_loss as agg
    ids = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    elt = torch.zeros((3, 2), device="meta")
    terms = torch.zeros(2, device="meta")
    agg.reset_counts()
    for fn in (agg.aggregate_loss_gather, agg.aggregate_loss_onehot):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(ids, elt, terms, terms, 0.0, 1.0)
    assert not any(agg.plain_counts.values())
    assert not any(agg.launch_counts.values())


def test_chip_smoke_fails_without_a_card():
    _skip_if_card()
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                          capture_output=True, text=True, timeout=600,
                          cwd=ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
