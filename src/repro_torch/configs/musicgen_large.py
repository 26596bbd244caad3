"""musicgen-large: 48L decoder over EnCodec tokens, 4 codebooks.

[arXiv:2306.05284; hf]  The same numbers as
``repro.configs.musicgen_large``: 48 ``dense`` layers (32 heads over 32 kv
heads of 64, LayerNorm, the GELU MLP of 8192); the audio frontend is a
stub: the batch carries precomputed frame embeddings (``embeds``), there
is no embedding table, and 4 parallel codebook heads (vocabulary 2048
each) replace the LM head.
"""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    block_cycle=("dense",),
    mlp_variant="gelu",
    norm="layernorm",
    rope_theta=10_000.0,
    frontend="audio",
    num_codebooks=4,
    fsdp=True,
    remat="full",
    grad_accum=8,
))
