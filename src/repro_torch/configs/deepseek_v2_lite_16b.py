"""deepseek-v2-lite-16b: 27L MLA + MoE (64 routed top-6, 2 shared).

[arXiv:2405.04434; hf]  MLA: kv_lora_rank=512, rope_dim=64, nope=128, v=128.
The paper-technique router (soft top-k via permutahedron projection) is the
default.  The same numbers as ``repro.configs.deepseek_v2_lite_16b``,
including its one deviation: V2-Lite's single leading dense layer is made
MoE, so all 27 blocks are identical.
"""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=192,           # qk_nope + qk_rope
    d_ff=1408,
    vocab_size=102400,
    block_cycle=("mla_moe",),
    num_experts=64,
    experts_per_token=6,
    num_shared_experts=2,
    moe_d_ff=1408,
    router="soft_topk",
    router_eps=1.0,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    mlp_variant="swiglu",
    rope_theta=10_000.0,
    fsdp=True,
    seq_shard_activations=True,
    remat="full",
    grad_accum=8,
))
