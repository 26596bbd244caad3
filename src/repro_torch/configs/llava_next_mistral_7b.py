"""llava-next-mistral-7b: mistral-7B backbone + anyres vision stub.

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]  The same numbers as
``repro.configs.llava_next_mistral_7b``: 32 ``dense`` layers (GQA of 32
heads over 8 kv heads of 128, SwiGLU of 14336), an untied head; the
vision frontend is a stub: the batch carries 576 precomputed patch
embeddings (``image_embeds``), which go before the text tokens, and the
loss covers the text region only.
"""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    block_cycle=("dense",),
    mlp_variant="swiglu",
    rope_theta=1_000_000.0,
    frontend="vision",
    num_patches=576,
    fsdp=True,
    remat="full",
    grad_accum=8,
))
