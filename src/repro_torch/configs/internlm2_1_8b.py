"""InternLM2-1.8B [dense] — arXiv:2403.17297 (hf-verified).

24L, d_model=2048, 16 heads, GQA kv=8, d_ff=8192, vocab=92544.
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-1.8b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92544,
    rope_theta=1000000.0,
    fsdp=False,
    microbatches=1,
    remat="full",
)
