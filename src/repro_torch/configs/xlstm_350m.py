"""xlstm-350m: mLSTM + sLSTM blocks (7:1), O(1) recurrent state.

[arXiv:2405.04517; unverified]  The same numbers as
``repro.configs.xlstm_350m``: 24 layers in three cycles of seven ``mlstm``
layers (matrix memory, 4 heads of 256) and one ``slstm`` layer (scalar
memory, block-diagonal recurrence per head), under LayerNorm; ``d_ff`` is
0 because each kind carries its own FFN (``mlstm`` the GELU MLP of
2 d_model, ``slstm`` GeGLU of 4/3 d_model rounded to 64:
``repro_torch.models.transformer.ffn_width``); an untied head.
"""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab_size=50304,
    block_cycle=("mlstm",) * 7 + ("slstm",),
    norm="layernorm",
    supports_long_context=True,
    remat="full",
    grad_accum=8,
))
