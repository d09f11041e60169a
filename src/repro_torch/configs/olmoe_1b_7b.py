"""OLMoE-1B-7B [moe] — arXiv:2409.02060 (hf-verified).

16L, d_model=2048, 16 heads (GQA kv=16 ⇒ MHA), per-expert d_ff=1024,
vocab=50304, MoE 64 experts top-8, no shared expert. ~6.9B total / 1.3B active.
"""
from repro_torch.configs import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=0,                      # every MLP is routed; no dense fallback
    vocab_size=50304,
    moe_period=1,
    moe=MoEConfig(
        num_experts=64,
        top_k=8,
        d_ff_expert=1024,
        num_shared_experts=0,
        capacity_factor=1.25,
        group_size=1024,
    ),
    qk_norm=True,                # OLMoE uses QK-norm
    rope_theta=10000.0,
    fsdp=True,
    microbatches=1,
    remat="full",
)
