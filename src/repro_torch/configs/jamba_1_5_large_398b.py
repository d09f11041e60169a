"""Jamba-1.5-Large 398B [hybrid] — arXiv:2403.19887 (hf-verified).

72L, d_model=8192, 64 heads, GQA kv=8, d_ff=24576, vocab=65536.
Mamba:attention 7:1 interleave (attention at index 4 of every 8-layer period),
MoE 16 experts top-2 on every other layer.  Sub-quadratic at 512k: only the
9 attention layers carry KV.
"""
from repro_torch.configs import ArchConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    attn_period=8,
    attn_offset=4,
    moe_period=2,
    moe=MoEConfig(
        num_experts=16,
        top_k=2,
        d_ff_expert=24576,
        num_shared_experts=0,
        capacity_factor=1.25,
        group_size=1024,
    ),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, d_conv=4, chunk_size=256),
    param_dtype="bfloat16",
    optimizer="adafactor",
    fsdp=True,
    microbatches=4,
    remat="full",
    subquadratic=True,
)
