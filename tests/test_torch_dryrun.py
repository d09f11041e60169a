"""The dry-run on the meta device against the JAX package's compiled one.

* the reference's four tool tests (HLO collective parser, payloads,
  extrapolation, shape bytes) as cases over both modules;
* in a subprocess with eight host devices, the reference's ``_lower`` of
  reduced internlm2-1.8b on a 2x4 mesh of ``AxisType.Auto`` axes
  (``train_4k`` and ``decode_32k`` cut to ``seq_len=256,
  global_batch=8``), compiled: the port's per-position
  ``argument_bytes`` equals ``memory_analysis().argument_size_in_bytes`` to
  the byte, and the port's planned collectives are nonzero in exactly the
  kinds the reference's HLO holds;
* the shallow aux reckonings extrapolate to the raw figures (on meta every
  layer is counted once);
* inside the dry-run's pass (``ops.shape_only()``) a meta tensor takes
  the plain computation, a CUDA-typed one never does, and outside it a
  meta tensor goes to the kernel's wrapper (which refuses it);
* ``main([... "--mesh", "pod", "--out", tmp])`` writes a record with the
  reference's keys and creates no CUDA tensor; the risk cell's bytes.
"""
import dataclasses
import importlib
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_config, get_shape
from repro_torch.distributed.sharding import Mesh, Sharder
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.launch import dryrun

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = {"train_4k": (256, 8), "decode_32k": (256, 8)}

SAMPLE_HLO = """
HloModule jit_step
  %x = f32[16,4096]{1,0} parameter(0)
  %ag = f32[256,4096]{1,0} all-gather(f32[16,4096]{1,0} %x), replica_groups={}
  %ar = f32[16,4096]{1,0} all-reduce(%x), to_apply=%add
  %tup = (f32[8,128]{1,0}, f32[8,128]{1,0}) all-reduce(%a, %b), to_apply=%add
  %a2a = f32[16,64]{1,0} all-to-all(%x), dimensions={0}
  %cp = f32[4,4]{1,0} collective-permute(%y), source_target_pairs={{0,1}}
  %ags = f32[32,32]{1,0} all-gather-start(f32[16,32]{1,0} %z)
  %agd = f32[32,32]{1,0} all-gather-done(%ags)
  %fusion.1 = f32[99,99]{1,0} fusion(%all-reduce.7, %c), kind=kLoop
  %gte = f32[1,1]{0,1} get-tuple-element(%all-reduce.8), index=0
"""


@pytest.fixture(params=["repro.launch.dryrun", "repro_torch.launch.dryrun"])
def mod(request):
    return importlib.import_module(request.param)


def test_parser_counts_only_defining_instructions(mod):
    c = mod.parse_collectives(SAMPLE_HLO)
    assert c["all-gather"]["count"] == 2          # %ag and %ags (-start)
    assert c["all-reduce"]["count"] == 2          # %ar and %tup
    assert c["all-to-all"]["count"] == 1
    assert c["collective-permute"]["count"] == 1


def test_parser_payloads(mod):
    c = mod.parse_collectives(SAMPLE_HLO)
    assert c["all-gather"]["bytes"] == 256 * 4096 * 4 + 32 * 32 * 4
    assert c["all-reduce"]["bytes"] == 2 * (16 * 4096 * 4) + 2 * (
        2 * 8 * 128 * 4)
    assert c["all-to-all"]["bytes"] == 16 * 64 * 4
    assert c["total_bytes"] == sum(
        v["bytes"] for k, v in c.items() if isinstance(v, dict))


def test_extrapolation_linear(mod):
    mk = lambda f, ag: {"flops": f, "bytes_accessed": 10 * f,
                        "transcendentals": 0.0,
                        "collectives": {k: {"count": 1 if k == "all-gather"
                                            else 0,
                                            "bytes": ag if k == "all-gather"
                                            else 0}
                                        for k in mod.COLL_KINDS}}
    v1, v2 = mk(100.0, 50), mk(160.0, 80)
    ex = mod._extrapolate(v1, v2, 10)
    assert ex["flops"] == pytest.approx(100 + 60 * 9)
    assert ex["collectives"]["all-gather"]["bytes"] == 50 + 30 * 9
    assert ex["collectives"]["total_bytes"] == 50 + 30 * 9


def test_shape_bytes(mod):
    assert mod._shape_bytes("bf16", "4,8") == 64
    assert mod._shape_bytes("f32", "") == 4     # scalar
    assert mod._shape_bytes("nosuch", "4") == 0


REF_SCRIPT = textwrap.dedent("""
    import os, sys, json, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    jax.devices()                  # eight devices, before dryrun's flag
    from jax.sharding import AxisType
    from repro.configs import get_config, get_shape
    from repro.distributed.sharding import Sharder
    from repro.launch import dryrun
    cfg = get_config("internlm2-1.8b").reduced()
    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    out = {}
    for name, (seq, batch) in json.loads(sys.argv[1]).items():
        shape = dataclasses.replace(get_shape(name), seq_len=seq,
                                    global_batch=batch)
        sh = Sharder(mesh, fsdp=cfg.fsdp, seq_shard=cfg.fsdp)
        lowered = dryrun._lower(cfg, shape, mesh, sh)
        with mesh:
            compiled = lowered.compile()
        out[name] = {
            "argument_bytes":
                compiled.memory_analysis().argument_size_in_bytes,
            "collectives": dryrun.parse_collectives(compiled.as_text())}
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def ref_2x4():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT,
                        json.dumps(SHAPES)], capture_output=True, text=True,
                       env=env, cwd=ROOT, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _meta_2x4(cfg):
    mesh = Mesh([torch.device("meta")] * 8, (2, 4), ("data", "model"))
    return Sharder(mesh, fsdp=cfg.fsdp, seq_shard=cfg.fsdp)


def _cut(name):
    seq, batch = SHAPES[name]
    return dataclasses.replace(get_shape(name), seq_len=seq,
                               global_batch=batch)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_argument_bytes_equal_the_compiled_reference(name, ref_2x4):
    cfg = get_config("internlm2-1.8b").reduced()
    r = dryrun.reckon(cfg, _cut(name), _meta_2x4(cfg))
    want = ref_2x4[name]
    assert r["memory"]["argument_bytes"] == want["argument_bytes"]
    kinds = lambda c: {k for k in dryrun.COLL_KINDS if c[k]["count"]}
    assert kinds(r["collectives"]) == kinds(want["collectives"])
    assert kinds(want["collectives"]) == {"all-reduce", "all-gather"}
    for k in kinds(want["collectives"]):
        assert r["collectives"][k]["bytes"] > 0


@pytest.mark.parametrize("arch,shape", [
    ("internlm2-1.8b", "train_4k"), ("internlm2-1.8b", "decode_32k"),
    ("olmoe-1b-7b", "train_4k"), ("whisper-base", "prefill_32k"),
    ("jamba-1.5-large-398b", "decode_32k")])
def test_extrapolated_costs_equal_the_raw_ones(arch, shape):
    base = get_config(arch).reduced()
    period = base.stage_period if not base.enc_dec else 1
    repl = {"num_layers": 3 * period}
    if base.enc_dec:
        repl["num_encoder_layers"] = 3
    cfg = dataclasses.replace(base, **repl)
    sh = _meta_2x4(cfg)
    cell = dataclasses.replace(get_shape(shape), seq_len=64, global_batch=8)
    raw = dryrun.reckon(cfg, cell, sh)
    v1 = dryrun._aux_metrics(cfg, cell, sh, period)
    v2 = dryrun._aux_metrics(cfg, cell, sh, 2 * period)
    ex = dryrun._extrapolate(v1, v2, 3)
    for k in dryrun.COST_KEYS:
        assert ex[k] == raw["cost"][k], k
    assert ex["collectives"] == raw["collectives"]
    assert raw["cost"]["flops"] > 0 and raw["memory"]["temp_bytes"] > 0


def test_meta_takes_the_plain_computation_and_cuda_never(monkeypatch):
    calls = []
    monkeypatch.setattr(kref, "blockwise_attention",
                        lambda *a, **k: calls.append("plain") or a[0])
    monkeypatch.setattr(kref, "ssd_chunked_ref",
                        lambda *a, **k: calls.append("plain ssd") or a[:2])
    monkeypatch.setattr(fa, "flash_attention",
                        lambda *a, **k: calls.append("kernel") or a[:2])
    monkeypatch.setattr(ssd, "ssd_chunked",
                        lambda *a, **k: calls.append("kernel ssd") or a[:2])
    meta = torch.empty((1, 16, 2, 16), device="meta")
    with ops.shape_only():
        ops.flash_attention(meta, meta, meta)
        ops.ssd(meta, meta[..., 0], meta[..., 0], meta, meta, chunk=16)
    assert calls == ["plain", "plain ssd"]
    # outside the dry-run's pass a meta tensor goes to the wrapper
    ops.flash_attention(meta, meta, meta)
    assert calls == ["plain", "plain ssd", "kernel"]
    calls.clear()
    calls.clear()
    # a CUDA-typed argument (this build links no CUDA: a stand-in carrying
    # the device) goes to the kernel's wrapper, eagerly and in the
    # autograd Function's forward
    cuda = _OnCuda()
    with ops.shape_only():
        ops._flash_forward(cuda, cuda, cuda, True, None)
        ops._ssd_forward(cuda, cuda, cuda, cuda, cuda, 16, None)
        ops.FlashAttentionFn.forward(_Ctx(), cuda, cuda, cuda, True, None)
        ops.SsdChunkedFn.forward(_Ctx(), cuda, cuda, cuda, cuda, cuda, None,
                                 16)
    assert calls == ["kernel", "kernel ssd", "kernel", "kernel ssd"]


class _OnCuda:
    device = torch.device("cuda", 0)


class _Ctx:
    def save_for_backward(self, *tensors):
        self.saved = tensors


def test_the_unpatched_wrapper_refuses_a_meta_tensor():
    """Only ops.py routes meta, and only in the dry-run's pass: the kernel
    wrapper itself raises, and so does ops outside the pass."""
    meta = torch.empty((1, 16, 2, 16), device="meta")
    with ops.shape_only():
        with pytest.raises(RuntimeError, match="CUDA tensors only"):
            fa.flash_attention(meta, meta, meta)
    with pytest.raises(RuntimeError, match="CUDA tensors only"):
        ops.flash_attention(meta, meta, meta)


class _NoCuda(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else [out]):
            assert not (isinstance(t, torch.Tensor)
                        and t.device.type == "cuda"), func
        return out


REF_KEYS = {"arch", "shape", "mesh", "chips", "kind", "lower_s",
            "compile_s", "memory", "cost_raw", "collectives_raw",
            "hlo_lines", "cost", "collectives", "aux_s", "status"}


def test_main_writes_the_reference_record(tmp_path, capsys):
    with _NoCuda():
        rc = dryrun.main(["--arch", "internlm2-1.8b", "--shape", "train_4k",
                          "--mesh", "pod", "--out", str(tmp_path)])
    assert rc == 0
    rec = json.loads((tmp_path / "internlm2-1.8b__train_4k__pod.json"
                      ).read_text())
    assert REF_KEYS <= set(rec) and rec["status"] == "ok"
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "generated_code_bytes"}
    assert set(rec["cost"]) == set(dryrun.COST_KEYS)
    assert set(rec["collectives"]) == set(dryrun.COLL_KINDS) | {
        "total_bytes"}
    assert rec["chips"] == 256 and rec["mesh"] == "16x16"
    assert rec["cost"] == rec["cost_raw"]
    assert json.loads(capsys.readouterr().out) == rec
    assert not torch.cuda.is_initialized()


def test_skipped_and_risk_cells(tmp_path):
    rec = dryrun.lower_cell("internlm2-1.8b", "long_500k", False)
    assert rec["status"] == "skipped" and rec["reason"]
    risk = dryrun.lower_risk_cell("risk_1m_t8", True)
    t_step = (1_000_000 // 8 // 512) * 512
    elt = (2_000_001 * 15 + 15 * 2 + 2) * 4
    assert risk["memory"]["argument_bytes"] == t_step * 1000 * 4 // 512 + elt
    assert risk["chips"] == 512 and risk["status"] == "ok"
    assert risk["cost"]["flops"] > 0
