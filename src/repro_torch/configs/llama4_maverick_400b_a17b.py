"""Llama-4 Maverick 400B-A17B [moe] — hf:meta-llama/Llama-4-Scout-17B-16E (unverified).

48L, d_model=5120, 40 query heads, GQA kv=8, dense d_ff=8192, vocab=202048,
MoE 128 experts top-1 + 1 shared expert (Maverick early-fusion design).
Active params ≈ 17B/token; total ≈ 784B with the pool's literal per-layer MoE
reading (the pool marks the 400B label unverified).
"""
from repro_torch.configs import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    moe_period=1,
    moe=MoEConfig(
        num_experts=128,
        top_k=1,
        d_ff_expert=8192,
        num_shared_experts=1,
        capacity_factor=1.25,
        group_size=1024,
    ),
    rope_theta=500000.0,
    param_dtype="bfloat16",
    optimizer="adafactor",
    fsdp=True,
    microbatches=4,
    remat="full",
)
