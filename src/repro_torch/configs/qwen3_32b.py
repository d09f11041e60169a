"""Qwen3-32B [dense] — hf:Qwen/Qwen3-8B family (hf-verified).

64L, d_model=5120, 64 heads, GQA kv=8, d_ff=25600, vocab=151936, QK-norm.
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1000000.0,
    fsdp=True,
    microbatches=2,
    remat="full",
)
