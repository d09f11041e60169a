"""H2O-Danube-1.8B [dense] — arXiv:2401.16818 (hf-verified).

24L, d_model=2560, 32 heads, GQA kv=8, d_ff=6912, vocab=32000.
Llama+Mistral mix with sliding-window attention (window 4096) ⇒ sub-quadratic
cache, so the long_500k cell runs (window-bounded KV).
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=80,                 # 2560 / 32; kept faithful (not 128-padded)
    d_ff=6912,
    vocab_size=32000,
    sliding_window=4096,
    rope_theta=10000.0,
    fsdp=False,
    microbatches=1,
    remat="full",
    subquadratic=True,
)
