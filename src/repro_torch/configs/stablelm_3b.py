"""stablelm-3b: 32L dense MHA (kv=32, head 80), LayerNorm and the GELU MLP.

[hf:stabilityai/stablelm-2-1_6b scaled per assignment; unverified]  The
same numbers as ``repro.configs.stablelm_3b``: each layer GQA attention at
G = 1 (32 heads over 32 kv heads of 80) and the non-gated GELU MLP, under
LayerNorm (scale and bias); an untied head.
"""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="stablelm-3b",
    family="dense",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=6912,
    vocab_size=50304,
    block_cycle=("dense",),
    mlp_variant="gelu",
    norm="layernorm",
    rope_theta=10_000.0,
    fsdp=True,
    remat="full",
    grad_accum=8,
))
