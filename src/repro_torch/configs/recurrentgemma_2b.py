"""recurrentgemma-2b: RG-LRU + local-attention hybrid (Griffin), 1 attn : 2 rec.

[arXiv:2402.19427; hf]  The same numbers as
``repro.configs.recurrentgemma_2b``: a cycle of two ``rg`` layers (the
RG-LRU block of width 2560, conv width 4) and one ``local`` layer (MQA: 10
query heads over 1 kv head of 256, window 2048), each with the GeGLU MLP;
26 layers, so eight cycles and a trailing (rg, rg); tied embeddings.
"""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    block_cycle=("rg", "rg", "local"),
    window_size=2048,
    lru_width=2560,
    conv_width=4,
    mlp_variant="geglu",
    rope_theta=10_000.0,
    tie_embeddings=True,
    supports_long_context=True,
    fsdp=True,
    remat="full",
    grad_accum=8,
))
