"""Multi-pod dry-run on the meta device: every (arch x shape x mesh) cell
reckoned without a compiler and without allocating device memory.

The JAX package's ``repro/launch/dryrun.py`` lowers and compiles each cell
for 512 fake host devices and reads ``memory_analysis()``,
``cost_analysis()`` and the collectives of the compiled HLO.  The port has
no compiler to ask, so it reckons the same record:

* **mesh** -- :func:`repro_torch.launch.mesh.make_production_mesh` over 512
  repetitions of ``torch.device("meta")``: 16x16 or 2x16x16.  Shardings
  come from the same ``Sharder`` rules and ``param_shardings``; nothing is
  placed.
* **memory** -- ``argument_bytes`` and ``output_bytes``: the bytes one mesh
  position holds of the step's arguments and outputs, from the shard
  shapes of their logical axes (parameters by ``param_axes``, optimizer
  state by ``opt.state_axes``, caches by ``bundle.cache_axes()``, the batch
  split by ``("batch", None, ...)``, as the reference's ``_batch_axes``).
  ``temp_bytes``: the peak of live intermediate bytes while the step runs
  on meta tensors (:class:`Reckoner`, a ``TorchDispatchMode``), divided
  over the positions the batch axis splits -- a reckoning of what the step
  keeps alive, not an allocator's figure.
* **cost** -- ``flops`` from ``torch.utils.flop_counter.FlopCounterMode``
  over the step on meta tensors (inside ``kernels/ops.shape_only()`` meta
  tensors take the kernels' plain computation), ``bytes_accessed`` the
  bytes every
  non-view operator of that pass reads and writes, ``transcendentals`` the
  elements its exponentials, logarithms, square roots and sigmoids produce;
  each spread evenly over the mesh's positions (the reference's figures are
  per device).
* **collectives** -- from the sharding plan, not parsed (there is no HLO):
  :func:`plan_collectives` counts the all-gathers of fsdp-split parameters
  (again in the backward under ``remat="full"``), the gradients'
  reduce-scatters and all-reduces over the batch axes, the tensor-parallel
  all-reduces after every heads-, ff- or inner-split block (and before it
  in the backward), the vocab-parallel embedding's all-reduce and the
  logits' all-gather, the split-K decode's combine, and expert
  parallelism's all-to-alls, in the reference's schema (an all-reduce at 2x
  its payload).  :func:`parse_collectives` stays, a text utility over HLO.

The reference lowers two shallow configs besides (period and 2 x period
layers, one microbatch) because XLA's cost analysis visits a loop body
once; :func:`_aux_metrics` and :func:`_extrapolate` are kept.  On meta
every layer is run, so the extrapolated figures equal the raw ones for any
stack linear in depth (a test holds that they do).  Where a step's shapes
depended on its data the plain versions would need the data; none of the
port's do (the MoE dispatch is capacity-shaped), so nothing is counted in
closed form but the risk cell: K1's gather has no matmul for
``FlopCounterMode`` to see, and :func:`lower_risk_cell` counts its work as
``PERF.md``'s bound column does.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b \\
        --shape train_4k --mesh pod          # 16x16, 256 positions
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import pathlib
import re
import sys
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (ARCH_IDS, ATTN, MAMBA, MOE, NONE, SHAPES,
                                 ArchConfig, cell_is_applicable, get_config,
                                 get_shape)
from repro_torch.distributed.sharding import (DEFAULT_RULES, Sharder,
                                              _entry_axes)
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.layers import dtype_of
from repro_torch.models.model import build_model, input_specs
from repro_torch.models.params import param_axes
from repro_torch.models.ssm import ssm_dims
from repro_torch.models.transformer import ATTN_CACHE_AXES, tree_leaves
from repro_torch.training.optimizer import make_optimizer
from repro_torch.training.train_loop import build_train_step

RESULTS_DIR = (pathlib.Path(__file__).resolve().parents[3] / "results"
               / "dryrun_torch")
META = torch.device("meta")
N_FAKE = 512                     # the reference's forced host device count

# matches only *defining* collective instructions:  %x = <shape> all-reduce(
COLLECTIVE_RE = re.compile(
    r"=\s*(\([^=]*?\)|[a-z0-9]+\[[0-9,]*\]\S*)\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(")
SHAPE_RE = re.compile(r"\b([a-z0-9]+)\[([0-9,]*)\]")
DTYPE_BYTES = {"f32": 4, "f16": 2, "bf16": 2, "f64": 8, "s32": 4, "u32": 4,
               "s8": 1, "u8": 1, "s16": 2, "u16": 2, "s64": 8, "u64": 8,
               "pred": 1, "f8e4m3fn": 1, "f8e5m2": 1, "c64": 8, "c128": 16}
COLL_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
              "collective-permute")
COST_KEYS = ("flops", "bytes_accessed", "transcendentals")


def _shape_bytes(dtype: str, dims: str) -> int:
    if dtype not in DTYPE_BYTES:
        return 0
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * DTYPE_BYTES[dtype]


def parse_collectives(hlo_text: str) -> Dict[str, Any]:
    """Per-device collective traffic of an HLO text (the reference's
    parser; the port's own records take theirs from
    :func:`plan_collectives`).

    For each collective instruction, the largest shape on the line (covers
    all-gather results and all-reduce operands) is its per-device payload;
    ring all-reduce moves ~2x its payload (reduce-scatter + all-gather
    phases)."""
    out = _no_collectives()
    for line in hlo_text.splitlines():
        m = COLLECTIVE_RE.search(line)
        if not m:
            continue
        result_shapes, kind = m.group(1), m.group(2)
        payload = sum(_shape_bytes(d, s)
                      for d, s in SHAPE_RE.findall(result_shapes))
        if payload == 0:
            continue
        _add(out, kind, payload)
    return _total(out)


def _no_collectives() -> Dict[str, Any]:
    return {k: {"count": 0, "bytes": 0} for k in COLL_KINDS}


def _add(out: Dict[str, Any], kind: str, payload: int, times: int = 1
         ) -> None:
    """``times`` instructions of ``kind`` with a per-device ``payload``
    (an all-reduce counted at twice it)."""
    if payload <= 0 or times <= 0:
        return
    out[kind]["count"] += times
    out[kind]["bytes"] += times * payload * (2 if kind == "all-reduce"
                                             else 1)


def _total(out: Dict[str, Any]) -> Dict[str, Any]:
    out["total_bytes"] = int(sum(v["bytes"] for v in out.values()
                                 if isinstance(v, dict)))
    return out


def _extrapolate(v1: Dict, v2: Dict, n: float) -> Dict[str, Any]:
    """Linear in stage count: v(n) = v1 + (v2 - v1) * (n - 1)."""
    lin = lambda a, b: a + (b - a) * (n - 1)
    out = {k: lin(v1[k], v2[k]) for k in COST_KEYS}
    colls = {}
    for kind in COLL_KINDS:
        colls[kind] = {
            "count": int(round(lin(v1["collectives"][kind]["count"],
                                   v2["collectives"][kind]["count"]))),
            "bytes": int(round(lin(v1["collectives"][kind]["bytes"],
                                   v2["collectives"][kind]["bytes"]))),
        }
    out["collectives"] = _total(colls)
    return out


# ---------------------------------------------------------------------------
# shard bytes
# ---------------------------------------------------------------------------
def meta_mesh(multi_pod: bool):
    """16x16 (or 2x16x16) over ``N_FAKE`` repetitions of the meta device."""
    return make_production_mesh(multi_pod=multi_pod,
                                devices=[META] * N_FAKE)


def _split(sh: Sharder, spec) -> int:
    return math.prod(math.prod(sh.mesh.shape[a] for a in _entry_axes(e))
                     for e in spec)


def shard_bytes(sh: Sharder, axes, t: torch.Tensor) -> int:
    """Bytes one mesh position holds of ``t`` laid out by ``axes``."""
    spec = sh.spec(axes, tuple(t.shape))
    return t.numel() // _split(sh, spec) * t.element_size()


def tree_bytes(sh: Sharder, axes, tree) -> int:
    """:func:`shard_bytes` summed over a tree and its axes tree."""
    if isinstance(tree, dict):
        return sum(tree_bytes(sh, axes[k], v) for k, v in tree.items())
    return shard_bytes(sh, axes, tree)


def _batch_axes(specs: Dict[str, torch.Tensor]) -> Dict[str, Tuple]:
    return {k: ("batch",) + (None,) * (v.dim() - 1)
            for k, v in specs.items()}


# ---------------------------------------------------------------------------
# the meta pass
# ---------------------------------------------------------------------------
_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log1p", "log2", "tanh",
                   "sigmoid", "rsqrt", "sqrt", "sin", "cos", "erf",
                   "softplus", "silu", "gelu", "_softmax", "_log_softmax",
                   "pow"}


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class Reckoner(TorchDispatchMode):
    """Counts a pass over meta tensors: the peak of live bytes in storages
    the pass made (a storage dies with the last tensor that views it; the
    ``known`` storages -- the arguments, written in place or not -- are not
    intermediates), the bytes every non-view operator reads and writes, and
    the elements of transcendental results."""

    def __init__(self, known: List[torch.Tensor]):
        super().__init__()
        self.known = {_storage_key(t) for t in known}
        self.refs: Dict[int, int] = {}       # storage -> live tensors
        self.sizes: Dict[int, int] = {}
        self.live = self.peak = 0
        self.bytes_accessed = 0
        self.transcendentals = 0

    def _drop(self, key: int) -> None:
        self.refs[key] -= 1
        if not self.refs[key]:
            del self.refs[key]
            self.live -= self.sizes.pop(key)

    def _track(self, t: torch.Tensor) -> None:
        key = _storage_key(t)
        if key in self.known:
            return
        if key not in self.refs:
            self.refs[key] = 0
            self.sizes[key] = t.untyped_storage().nbytes()
            self.live += self.sizes[key]
            self.peak = max(self.peak, self.live)
        self.refs[key] += 1
        weakref.finalize(t, self._drop, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in _tensors(out)]
        if not func.is_view:
            self.bytes_accessed += sum(
                t.numel() * t.element_size()
                for t in _tensors((args, kwargs)) + outs)
        if func.overloadpacket.__name__.rstrip("_") in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in outs)
        for t in outs:
            self._track(t)
        return out


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _cell_step(cfg: ArchConfig, shape, sh: Sharder):
    """(argument trees with their axes, a pass running the cell's step on
    meta tensors and returning its output trees with their axes)."""
    bundle = build_model(cfg)
    params = bundle.init(0, META)
    p_axes = param_axes(cfg)
    batch = input_specs(cfg, shape)
    b_axes = _batch_axes(batch)
    logits_axes = ("batch", "vocab")
    if shape.kind == "train":
        opt = make_optimizer(cfg)
        o_state = opt.init(params)
        o_axes = opt.state_axes(p_axes, params)
        step = torch.zeros((), dtype=torch.int32, device=META)
        state = {"params": params, "opt": o_state, "step": step}
        step_fn = build_train_step(bundle, None, opt)
        args = [(params, p_axes), (o_state, o_axes), (step, ()),
                (batch, b_axes)]

        def run():
            _, metrics = step_fn(state, batch)
            return [(state["params"], p_axes), (state["opt"], o_axes),
                    (state["step"], ()),
                    (metrics, {k: () for k in metrics})]
        return args, run
    c_axes = bundle.cache_axes()
    if shape.kind == "prefill":
        args = [(params, p_axes), (batch, b_axes)]

        def run():
            with torch.no_grad():
                logits, caches, _ = bundle.prefill_fn(params, batch)
            idx = torch.zeros((), dtype=torch.int32, device=META)
            return [(logits, logits_axes), (caches, c_axes), (idx, ())]
        return args, run
    caches = bundle.init_caches(shape.global_batch, shape.seq_len, META)
    tokens = batch["tokens"]
    idx = torch.zeros((), dtype=torch.int32, device=META)
    args = [(params, p_axes), (tokens, b_axes["tokens"]), (caches, c_axes),
            (idx, ())]

    def run():
        with torch.no_grad():
            logits, new = bundle.decode_fn(params, tokens, caches,
                                           shape.seq_len - 1)
        return [(logits, logits_axes), (new, c_axes)]
    return args, run


def reckon(cfg: ArchConfig, shape, sh: Sharder) -> Dict[str, Any]:
    """The cell's record fields: ``memory``, ``cost`` (per position) and
    ``collectives``, from one pass on meta tensors and the sharding plan."""
    args, run = _cell_step(cfg, shape, sh)
    rk = Reckoner(_tensors([t for t, _ in args]))
    with kops.shape_only(), FlopCounterMode(display=False) as fc, rk:
        outs = run()
    n = sh.mesh.size
    b_ext = sh.extent("batch", shape.global_batch)
    return {
        "memory": {
            "argument_bytes": sum(tree_bytes(sh, a, t) for t, a in args),
            "output_bytes": sum(tree_bytes(sh, a, t) for t, a in outs),
            "temp_bytes": rk.peak // b_ext,
            "generated_code_bytes": 0},
        "cost": {"flops": float(fc.get_total_flops()) / n,
                 "bytes_accessed": float(rk.bytes_accessed) / n,
                 "transcendentals": float(rk.transcendentals) / n},
        "collectives": plan_collectives(cfg, shape, sh)}


# ---------------------------------------------------------------------------
# collectives from the sharding plan
# ---------------------------------------------------------------------------
def plan_collectives(cfg: ArchConfig, shape, sh: Sharder) -> Dict[str, Any]:
    """The collectives one mesh position runs in the cell's step, reckoned
    from where ``sh`` splits each tensor (payloads per position, the
    reference's convention: an all-gather's result, a reduce-scatter's
    shard, an all-reduce's operand at 2x).

    * every heads-, ff- or inner-split block sums its row-parallel product
      (``wo``, ``w_down``, ``out_proj``) with an all-reduce of the
      activations, and in the backward the column-parallel input gradient
      with another; the vocab-split embedding's lookup is an all-reduce, the
      vocab-split logits are all-gathered (and their input gradient
      all-reduced in the backward);
    * an expert-split MoE block exchanges its capacity rows twice
      (all-to-all out and back);
    * an fsdp-split parameter is all-gathered once a layer in the forward,
      and again in the backward's recompute under ``remat="full"``;
    * a decode over a cache split on its sequence combines each attention
      layer's partial output and softmax statistics (an all-reduce);
    * a training step reduces each parameter's float32 gradient over the
      batch axes: a reduce-scatter over those that split the parameter, an
      all-reduce over the rest; the loss and the metrics, and the squared
      gradient norm, are all-reduced.
    """
    out = _no_collectives()
    mesh = sh.mesh
    train = shape.kind == "train"
    B = shape.global_batch
    S = 1 if shape.kind == "decode" else shape.seq_len
    b_ext = sh.extent("batch", B)
    b_loc = B // b_ext
    cb = torch.empty((), dtype=dtype_of(cfg.compute_dtype)).element_size()
    d = cfg.d_model
    fwd = 1 + int(train and cfg.remat == "full")   # recomputed forward

    def tp_block(logical: str, dim: int, tokens: int) -> None:
        if sh.extent(logical, dim) > 1:
            _add(out, "all-reduce", b_loc * tokens * d * cb,
                 fwd + int(train))

    def mixer(kind: str, tokens: int) -> None:
        if kind == ATTN:
            tp_block("heads", cfg.num_heads * cfg.head_dim, tokens)
        elif kind == MAMBA:
            tp_block("inner", ssm_dims(cfg)[0], tokens)

    def ffn(kind: str, tokens: int) -> None:
        if kind == MOE:
            mc = cfg.moe
            if sh.extent("expert", mc.num_experts) > 1:
                rows = math.ceil(b_loc * tokens * mc.top_k
                                 * mc.capacity_factor)
                _add(out, "all-to-all", rows * d * cb, 2 * (fwd + int(train)))
            if mc.num_shared_experts:
                tp_block("ff", mc.d_ff_expert * mc.num_shared_experts,
                         tokens)
        elif kind != NONE:
            tp_block("ff", cfg.d_ff, tokens)

    sched = cfg.block_schedule()
    for mix, mlp in sched:
        mixer(mix, S)
        ffn(mlp, S)
        if cfg.enc_dec:
            mixer(ATTN, S)                         # cross-attention
    if cfg.enc_dec and shape.kind != "decode":
        for _ in range(cfg.num_encoder_layers):
            mixer(ATTN, cfg.encoder_seq_len)
            ffn(sched[0][1], cfg.encoder_seq_len)
    if shape.kind == "decode":
        S_c = (min(shape.seq_len, cfg.sliding_window) if cfg.sliding_window
               else shape.seq_len)
        k_shape = (B, S_c, cfg.num_kv_heads, cfg.head_dim)
        if sh.spec(ATTN_CACHE_AXES["k"][1:], k_shape)[1] is not None:
            _add(out, "all-reduce",
                 b_loc * cfg.num_heads * (cfg.head_dim + 2) * 4,
                 sum(1 for m, _ in sched if m == ATTN))
    if sh.extent("vocab", cfg.vocab_size) > 1:
        _add(out, "all-reduce", b_loc * S * d * cb)      # embedding lookup
        _add(out, "all-gather", b_loc * (S if train else 1)
             * cfg.vocab_size * 4)
        if train:
            _add(out, "all-reduce", b_loc * S * d * cb)  # dlogits -> dh

    params = build_model(cfg).init(0, META)
    axes = param_axes(cfg)
    batch_axes = _entry_axes(sh.spec(("batch",), (B,))[0])
    for t, a in zip(tree_leaves(params), tree_leaves(axes)):
        spec = sh.spec(a, tuple(t.shape))
        local = t.numel() // _split(sh, spec) * t.element_size()
        if "fsdp" in a:
            e = spec[a.index("fsdp")]
            if e is not None:
                per = (t.shape[0] if a[0] == "layers" else 1)
                _add(out, "all-gather",
                     local * _split(sh, (e,)) // per, per * fwd)
        if train:
            used = {x for e in spec for x in _entry_axes(e)}
            if any(x in used for x in batch_axes):
                _add(out, "reduce-scatter", local // t.element_size() * 4)
            if any(x not in used for x in batch_axes):
                _add(out, "all-reduce", local // t.element_size() * 4)
    if train:
        if b_ext > 1:
            _add(out, "all-reduce", 5 * 4)                # loss, metrics
        if mesh.size > 1:
            _add(out, "all-reduce", 4)                    # squared norm
    return _total(out)


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------
def _aux_metrics(cfg: ArchConfig, shape, sh: Sharder,
                 n_layers: int) -> Dict[str, Any]:
    """The reference's shallow variant (``n_layers`` layers, one
    microbatch), reckoned as the cell is: on meta every layer is counted,
    so its role is the check that the stack is linear in depth."""
    repl = {"num_layers": n_layers, "microbatches": 1}
    if cfg.enc_dec:
        repl["num_encoder_layers"] = max(
            1, cfg.num_encoder_layers * n_layers // cfg.num_layers)
    r = reckon(dataclasses.replace(cfg, **repl), shape, sh)
    return dict(r["cost"], collectives=r["collectives"])


def lower_risk_cell(shape_name: str, multi_pod: bool) -> Dict[str, Any]:
    """The paper's own workload: one tenant wave of Aggregate Risk Analysis
    with its trials split over every mesh axis.  Shape risk_1m_t<k>: 1M
    trials over k tenant waves.  Bytes from the port's
    ``AggregateRiskAnalysis.input_specs`` (the YET split over every axis,
    the tables whole on each position); the cost counted from K1's work as
    ``PERF.md``'s bound column counts it: the row pass reads the ELT once
    and writes one float32 row loss a catalog row (one clip and add an
    ELT), the trial pass reads every event id and adds its row loss, then
    clips each trial's sum by the aggregate layer.  No collective: trials
    are independent and the YLT stays split like them."""
    from repro_torch.configs.risk_app import CONFIG as RISK_CFG
    from repro_torch.risk.analysis import AggregateRiskAnalysis

    tenants = int(shape_name.rsplit("_t", 1)[1])
    rec: Dict[str, Any] = {
        "arch": "risk-analysis", "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": 512 if multi_pod else 256, "kind": "risk",
        "tenants": tenants, "method": "meta reckoning",
    }
    mesh = meta_mesh(multi_pod)
    cfg = RISK_CFG
    t0 = time.time()
    t_step = max(512, (cfg.num_trials // tenants // 512) * 512)
    ara = AggregateRiskAnalysis.__new__(AggregateRiskAnalysis)
    ara.cfg = cfg
    specs = ara.input_specs(t_step)
    n = mesh.size

    def nbytes(shp, dt) -> int:
        return math.prod(shp) * (4 if dt in ("int32", "float32") else 8)

    K, M = cfg.events_per_trial, cfg.num_elts
    rows = specs["elt"][0][0]
    t_loc = t_step // n
    rec["memory"] = {
        "argument_bytes": nbytes(*specs["yet"]) // n + sum(
            nbytes(*specs[k]) for k in ("elt", "occ_ret", "occ_lim",
                                        "agg_ret", "agg_lim")),
        "output_bytes": t_loc * 4,
        "temp_bytes": rows * 4,                 # the row losses f
        "generated_code_bytes": 0,
    }
    flops = rows * M * 3 + t_loc * K + t_loc * 4
    moved = (nbytes(*specs["elt"]) + rows * 4 * 2 + t_loc * K * 4
             + t_loc * K * 4 + t_loc * 4)
    rec["cost_raw"] = {"flops": float(flops), "bytes_accessed": float(moved),
                       "transcendentals": 0.0}
    rec["collectives_raw"] = _total(_no_collectives())
    rec["compile_s"] = round(time.time() - t0, 2)
    rec["cost"] = dict(rec["cost_raw"])
    rec["collectives"] = _total(_no_collectives())
    rec["status"] = "ok"
    return rec


def _sharder(cfg: ArchConfig, mesh) -> Sharder:
    """The reference's choice of rules, with its ``REPRO_*`` switches."""
    fsdp = cfg.fsdp or os.environ.get("REPRO_FSDP") == "1"
    seq_shard = (fsdp if not os.environ.get("REPRO_SEQSHARD")
                 else os.environ["REPRO_SEQSHARD"] == "1")
    if os.environ.get("REPRO_DP_ONLY") == "1":
        # pure data parallelism: batch over every mesh axis, weights fully
        # FSDP-sharded, no tensor parallelism (small-arch optimised layout)
        rules = dict(DEFAULT_RULES)
        rules.update({"batch": ("pod", "data", "model"),
                      "fsdp": ("pod", "data", "model"),
                      "heads": None, "kv": None, "ff": None, "vocab": None,
                      "inner": None, "expert": None, "seq": None,
                      "kvseq": ("model", "data")})
        return Sharder(mesh, fsdp=True, seq_shard=False, rules=rules)
    return Sharder(mesh, fsdp=fsdp, seq_shard=seq_shard)


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               exact_costs: bool = True) -> Dict[str, Any]:
    if arch == "risk-analysis":
        return lower_risk_cell(shape_name, multi_pod)
    cfg = get_config(arch)
    if os.environ.get("REPRO_MICROBATCHES"):
        cfg = dataclasses.replace(
            cfg, microbatches=int(os.environ["REPRO_MICROBATCHES"]))
    if os.environ.get("REPRO_REMAT"):
        cfg = dataclasses.replace(cfg, remat=os.environ["REPRO_REMAT"])
    shape = get_shape(shape_name)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": 512 if multi_pod else 256,
        "kind": shape.kind, "method": "meta reckoning",
    }
    ok, reason = cell_is_applicable(cfg, shape)
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return rec

    mesh = meta_mesh(multi_pod)
    sh = _sharder(cfg, mesh)
    t0 = time.time()
    r = reckon(cfg, shape, sh)
    rec["lower_s"] = round(time.time() - t0, 2)
    rec["compile_s"] = 0.0                      # no compiler
    rec["memory"] = r["memory"]
    rec["cost_raw"] = r["cost"]
    rec["collectives_raw"] = r["collectives"]
    rec["hlo_lines"] = 0                        # no HLO

    rec["cost"], rec["collectives"] = rec["cost_raw"], rec["collectives_raw"]
    if exact_costs:
        period = cfg.stage_period if not cfg.enc_dec else 1
        n = cfg.num_layers // period
        if n >= 2:
            t0 = time.time()
            v1 = _aux_metrics(cfg, shape, sh, period)
            v2 = _aux_metrics(cfg, shape, sh, 2 * period)
            ex = _extrapolate(v1, v2, n)
            rec["cost"] = {k: ex[k] for k in COST_KEYS}
            rec["collectives"] = ex["collectives"]
            rec["aux_s"] = round(time.time() - t0, 2)
    rec["status"] = "ok"
    return rec


def run_one(arch: str, shape_name: str, mesh_name: str,
            out_dir: pathlib.Path, exact: bool = True) -> Dict[str, Any]:
    rec = lower_cell(arch, shape_name, mesh_name == "multipod",
                     exact_costs=exact)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{arch}__{shape_name}__{mesh_name}.json"
    path.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape x mesh) cell")
    ap.add_argument("--no-exact", action="store_true",
                    help="skip the shallow aux reckonings (raw costs only)")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    out_dir = pathlib.Path(args.out)

    if args.all:
        cells = [(a, s.name, m) for a in ARCH_IDS for s in SHAPES
                 for m in ("pod", "multipod")]
        failures = 0
        for a, s, m in cells:
            path = out_dir / f"{a}__{s}__{m}.json"
            if args.skip_existing and path.exists():
                st = json.loads(path.read_text()).get("status")
                if st in ("ok", "skipped"):
                    print(f"[skip] {a} {s} {m}: {st}", flush=True)
                    continue
            print(f"[run ] {a} {s} {m}", flush=True)
            t0 = time.time()
            try:
                run_one(a, s, m, out_dir, exact=not args.no_exact)
            except Exception as e:              # a cell's error is its record
                failures += 1
                out_dir.mkdir(parents=True, exist_ok=True)
                path.write_text(json.dumps({
                    "arch": a, "shape": s, "mesh": m, "status": "error",
                    "error": f"{type(e).__name__}: {e}"}, indent=1))
                print(f"[FAIL {time.time() - t0:.1f}s] {a} {s} {m}: "
                      f"{type(e).__name__}: {e}", flush=True)
            else:
                print(f"[ok   {time.time() - t0:.1f}s] {a} {s} {m}",
                      flush=True)
        print(f"done; {failures} failures")
        return 1 if failures else 0

    rec = run_one(args.arch, args.shape, args.mesh, out_dir,
                  exact=not args.no_exact)
    print(json.dumps(rec, indent=1))
    return 0 if rec.get("status") in ("ok", "skipped") else 1


if __name__ == "__main__":
    sys.exit(main())
