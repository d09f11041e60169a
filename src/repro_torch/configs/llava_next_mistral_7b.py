"""LLaVA-NeXT (Mistral-7B backbone) [vlm] — hf:llava-hf/llava-v1.6-mistral-7b-hf (unverified).

Backbone: 32L, d_model=4096, 32 heads, GQA kv=8, d_ff=14336, vocab=32000.
The anyres-tiling vision frontend is a stub: a request carries precomputed
patch embeddings (576 base-resolution patches of width 1024, see
``launch.serve.synth_extra_inputs``), which are projected and merged into the
leading positions of the token sequence.
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    num_patches=576,
    rope_theta=1000000.0,
    fsdp=True,
    microbatches=1,
    remat="full",
)
