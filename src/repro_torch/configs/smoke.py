"""Reduced same-family smoke variants of the port's configurations.

Counterpart of ``repro.configs.smoke.smoke_config``: the same reductions
(small widths, depth and vocabulary, float32), so that a forward pass runs
on the CPU in seconds and the tests compare it with the JAX package's.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ASSIGNED, ArchConfig, get_config


def smoke_config(name: str) -> ArchConfig:
  cfg = get_config(name)
  cycle_len = len(cfg.block_cycle)
  reductions = dict(
      name=f"{cfg.name}-smoke",
      num_layers=2 * cycle_len if cycle_len > 1 else 2,
      d_model=64,
      num_heads=4,
      num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads
      else 4,
      head_dim=16,
      d_ff=128 if cfg.d_ff else 0,
      vocab_size=256,
      window_size=min(cfg.window_size, 32) if cfg.window_size else 0,
      xent_chunk=16,
      q_chunk=16,
      kv_chunk=16,
      moe_group_size=32,
      grad_accum=1,
      dtype="float32",
      remat="none",
      fsdp=False,
      seq_shard_activations=False,
  )
  if cfg.num_experts:
    reductions.update(
        num_experts=8,
        experts_per_token=min(cfg.experts_per_token, 2),
        moe_d_ff=32,
    )
  if cfg.kv_lora_rank:
    reductions.update(
        kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
        head_dim=24)
  if cfg.lru_width:
    reductions.update(lru_width=64)
  if cfg.num_patches:
    reductions.update(num_patches=8)
  return dataclasses.replace(cfg, **reductions)


def all_smoke_configs() -> list[ArchConfig]:
  """The smoke variant of each of the reference's ten configs, in its
  order (``repro.configs.smoke.all_smoke_configs``)."""
  return [smoke_config(n) for n in ASSIGNED]
