"""Architecture configuration system (the port's own copy).

Every architecture of the JAX package keeps its id (``ARCH_IDS``); a config
is a frozen dataclass consumed by ``repro_torch.models.model.build_model``
and, cut to size by ``.reduced()``, by the CPU tests.  The classes and
``reduced()`` are the JAX package's, field for field, so a config built here
and one built there describe the same model.

The port serves every arch (``PORTED_ARCHS``): the dense attention archs,
the pure-SSM mamba2, the MoE olmoe and llama4 (routed experts beside a
shared one), the hybrid jamba (Mamba-2 and attention layers, MoE every
other layer), the vision llava (patch embeddings merged into the leading
positions) and the encoder-decoder whisper-base (encoder frames, decoder
cross-attention).
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field, replace
from typing import Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Block schedule atoms
# ---------------------------------------------------------------------------
# A model is a stack of (mixer, mlp) blocks.  ``stage`` grouping drives
# scan-over-layers: layers are grouped into ``n_stages`` identical stages and
# scanned; within a stage the (possibly heterogeneous) sublayers are unrolled.
ATTN = "attn"          # GQA attention (optionally sliding-window / qk-norm)
MAMBA = "mamba"        # Mamba-2 SSD mixer
DENSE = "dense"        # SwiGLU MLP
MOE = "moe"            # top-k routed experts
NONE = "none"          # no MLP sublayer (mamba2 blocks carry their own gating)


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int            # per-expert hidden size
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    group_size: int = 1024      # routing-group size (tokens) for capacity dispatch
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01
    dispatch: str = "scatter"   # scatter (paper-era baseline) | ep (shard_map)


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    d_conv: int = 4
    n_groups: int = 1
    chunk_size: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1
    a_init_range: Tuple[float, float] = (1.0, 16.0)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int               # query heads (0 for attention-free archs)
    num_kv_heads: int
    d_ff: int                    # dense-MLP hidden size (0 if none)
    vocab_size: int
    head_dim: int = 128
    # --- attention options -------------------------------------------------
    qk_norm: bool = False
    sliding_window: Optional[int] = None   # SWA window (h2o-danube)
    rope_theta: float = 10000.0
    use_rope: bool = True                  # False => sinusoidal abs positions
    # --- block schedule ----------------------------------------------------
    # mixer schedule: "attn" everywhere unless overridden
    attn_period: int = 1         # hybrid: one attention layer per this many
    attn_offset: int = 0         # index within a period that is attention
    moe_period: int = 0          # 0 = no MoE; 1 = every layer; 2 = every other
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # --- encoder-decoder (whisper) -----------------------------------------
    enc_dec: bool = False
    num_encoder_layers: int = 0
    encoder_seq_len: int = 1500  # precomputed frame embeddings (frontend stub)
    # --- multimodal stub ----------------------------------------------------
    num_patches: int = 0         # llava: patch embeddings prepended (stub)
    # --- numerics / distribution -------------------------------------------
    param_dtype: str = "float32"       # bf16 for the 100B+ archs
    compute_dtype: str = "bfloat16"
    fsdp: bool = False                 # shard d_model dim of big mats over data
    remat: str = "full"                # none | full | dots
    optimizer: str = "adamw"           # adamw | adafactor
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    microbatches: int = 1              # tenancy: tenant chunks per train step
    logical_rules_override: Tuple[Tuple[str, Optional[str]], ...] = ()
    # --- capability flags ---------------------------------------------------
    subquadratic: bool = False   # may run long_500k
    tie_embeddings: bool = False

    # ------------------------------------------------------------------
    def mixer_kind(self, layer_idx: int) -> str:
        if self.num_heads == 0:
            return MAMBA
        if self.attn_period <= 1:
            return ATTN
        return ATTN if (layer_idx % self.attn_period) == self.attn_offset else MAMBA

    def mlp_kind(self, layer_idx: int) -> str:
        if self.d_ff == 0 and self.moe is None:
            return NONE
        if self.moe is not None and self.moe_period > 0 and (
            layer_idx % self.moe_period == self.moe_period - 1
        ):
            return MOE
        return DENSE if self.d_ff > 0 else NONE

    def block_schedule(self) -> Tuple[Tuple[str, str], ...]:
        return tuple(
            (self.mixer_kind(i), self.mlp_kind(i)) for i in range(self.num_layers)
        )

    @property
    def stage_period(self) -> int:
        """Smallest period after which the block schedule repeats."""
        sched = self.block_schedule()
        n = len(sched)
        for p in range(1, n + 1):
            if n % p == 0 and all(sched[i] == sched[i % p] for i in range(n)):
                return p
        return n

    # ------------------------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """A tiny same-family config for CPU smoke tests."""
        period = max(self.stage_period, 1)
        n_layers = 2 * period if period <= 4 else period
        kv = min(self.num_kv_heads, 2) if self.num_kv_heads else 0
        heads = 0 if self.num_heads == 0 else max(kv * 2, 2)
        moe = None
        if self.moe is not None:
            moe = replace(
                self.moe,
                num_experts=4,
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=64,
                group_size=32,
            )
        ssm = None
        if self.ssm is not None:
            ssm = replace(self.ssm, d_state=16, head_dim=8, chunk_size=16)
        return replace(
            self,
            name=self.name + "-reduced",
            num_layers=n_layers,
            num_encoder_layers=min(self.num_encoder_layers, 2),
            d_model=64,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            moe=moe,
            ssm=ssm,
            sliding_window=8 if self.sliding_window else None,
            param_dtype="float32",
            compute_dtype="float32",
            fsdp=False,
            microbatches=1,
            encoder_seq_len=16,
            num_patches=4 if self.num_patches else 0,
            remat="none",
        )


# ---------------------------------------------------------------------------
# Shape cells
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)


def get_shape(name: str) -> ShapeCell:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
ARCH_IDS = (
    "llama4-maverick-400b-a17b",
    "olmoe-1b-7b",
    "internlm2-1.8b",
    "qwen3-32b",
    "mistral-large-123b",
    "h2o-danube-1.8b",
    "mamba2-2.7b",
    "llava-next-mistral-7b",
    "whisper-base",
    "jamba-1.5-large-398b",
)

_MODULE_FOR = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}
_MODULE_FOR["risk-analysis"] = "risk_app"

# archs whose whole serving path the port runs (attention and Mamba-2
# mixers with a dense, routed or no MLP, patch embeddings merged into the
# prompt, and the encoder-decoder with its cross-attention pages)
PORTED_ARCHS = ("internlm2-1.8b", "qwen3-32b", "h2o-danube-1.8b",
                "mamba2-2.7b", "olmoe-1b-7b", "mistral-large-123b",
                "jamba-1.5-large-398b", "llama4-maverick-400b-a17b",
                "llava-next-mistral-7b", "whisper-base", "risk-analysis")


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULE_FOR:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULE_FOR)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_MODULE_FOR[arch_id]}")
    return mod.CONFIG


def cell_is_applicable(cfg: ArchConfig, shape: ShapeCell) -> Tuple[bool, str]:
    """Whether an (arch x shape) cell runs; else the documented skip reason."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch: unbounded KV at 512k (DESIGN.md §5)"
    return True, ""
