"""gemma3-12b: 48L dense GQA (kv=8, head 256), 5:1 local:global sliding
window (1024), GeGLU, 262k vocab, tied embeddings.

[hf:google/gemma-3-1b-pt scaled per assignment; unverified]  The same
numbers as ``repro.configs.gemma3_12b``: five ``local`` layers (attention
over the last 1024 positions) to one ``global`` layer, each GQA attention
plus the GeGLU MLP.  Like the reference, no QK-norm, no sandwich norms and
one rope theta for both kinds.
"""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    block_cycle=("local", "local", "local", "local", "local", "global"),
    window_size=1024,
    mlp_variant="geglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    fsdp=True,
    seq_shard_activations=True,
    supports_long_context=True,
    remat="full",
    grad_accum=8,
    xent_chunk=512,
))
