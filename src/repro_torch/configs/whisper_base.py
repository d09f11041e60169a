"""Whisper-base [audio] — arXiv:2212.04356 (unverified).

Encoder-decoder, 6+6L, d_model=512, 8 heads (MHA; pool lists GQA kv=8 = MHA at
8 heads), d_ff=2048, vocab=51865.  The conv frontend is a STUB, as in the
JAX package: a request carries precomputed frame embeddings for the encoder
(``launch.serve.synth_extra_inputs``).  Norms and MLPs are the stack's
RMSNorm and SwiGLU, as the reference builds them.
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,                # decoder layers
    num_encoder_layers=6,
    enc_dec=True,
    encoder_seq_len=1500,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    use_rope=False,              # whisper uses absolute positions (sinusoidal stub)
    fsdp=False,
    microbatches=1,
    remat="none",
)
