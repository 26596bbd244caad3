"""grok-1-314b: 64L MoE (8 experts top-2), GQA kv=8, 131k vocab.

[hf:xai-org/grok-1; unverified]  The same numbers as
``repro.configs.grok_1_314b``: the paper's soft top-k router (eps 1.0), an
untied head with logit soft-cap 30, bf16.  The parameters (316.5e9, 590
GiB in bf16) do not fit one card: it is served there cut in depth
(``--set num_layers=6``, 58 GiB).
"""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    block_cycle=("moe",),
    num_experts=8,
    experts_per_token=2,
    moe_d_ff=32768,
    router="soft_topk",
    router_eps=1.0,
    logit_softcap=30.0,
    mlp_variant="swiglu",
    rope_theta=10_000.0,
    fsdp=True,
    seq_shard_activations=True,
    remat="full",
    grad_accum=8,
    grad_accum_dtype="bfloat16",
    xent_chunk=512,
))
