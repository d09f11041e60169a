"""Mamba2-2.7B [ssm] — arXiv:2405.21060 (unverified).

64L, d_model=2560, attention-free (SSD state-space duality), ssm_state=128,
vocab=50280.  d_inner = 2*d_model = 5120, head_dim 64 ⇒ 80 SSD heads.
"""
from repro_torch.configs import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,                 # attention-free
    num_kv_heads=0,
    d_ff=0,                      # SSD block carries its own gating; no MLP
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, d_conv=4, chunk_size=256),
    fsdp=False,
    microbatches=1,
    remat="full",
    subquadratic=True,
    tie_embeddings=True,
)
