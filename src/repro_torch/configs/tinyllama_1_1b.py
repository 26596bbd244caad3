"""tinyllama-1.1b: 22L llama2-family GQA (kv=4).  [arXiv:2401.02385; hf]

The same numbers as ``repro.configs.tinyllama_1_1b``.
"""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="tinyllama-1.1b",
    family="dense",
    num_layers=22,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=64,
    d_ff=5632,
    vocab_size=32000,
    block_cycle=("dense",),
    mlp_variant="swiglu",
    rope_theta=10_000.0,
    remat="full",
    grad_accum=4,
))
