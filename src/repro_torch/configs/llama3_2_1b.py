"""llama3.2-1b: 16L dense GQA (kv=8), 128k vocab, tied embeddings.

[hf:meta-llama/Llama-3.2-1B; unverified]  The same numbers as
``repro.configs.llama3_2_1b``.
"""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="llama3.2-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=128256,
    block_cycle=("dense",),
    mlp_variant="swiglu",
    rope_theta=500_000.0,
    tie_embeddings=True,
    remat="full",
    grad_accum=4,
))
