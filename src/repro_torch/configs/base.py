"""Architecture configuration schema + registry.

Counterpart of ``repro.configs.base``: the same ``ArchConfig`` fields and
defaults, kept as the port's own copy (the port imports nothing of the JAX
package).  ``layer_kinds()`` expands the block-pattern cycle into a
per-layer kind list; ``plan_segments()`` groups it into the segments whose
stacked parameters ``repro_torch.models.convert`` splits into layers.
Every configuration the reference registers has its module here
(``ASSIGNED``).
"""

from __future__ import annotations

import dataclasses

_REGISTRY: dict[str, "ArchConfig"] = {}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
  name: str
  family: str                     # dense|moe|vlm|hybrid|ssm|audio
  num_layers: int
  d_model: int
  num_heads: int
  num_kv_heads: int
  head_dim: int
  d_ff: int
  vocab_size: int

  # Block pattern: cycle of layer kinds, applied as kind[i % len(cycle)].
  # Kinds: dense | local | moe | local_moe | mla_dense | mla_moe | rg |
  #        mlstm | slstm
  block_cycle: tuple[str, ...] = ("dense",)
  window_size: int = 0            # sliding window for "local" layers

  # MoE
  num_experts: int = 0
  experts_per_token: int = 0
  num_shared_experts: int = 0
  moe_d_ff: int = 0
  router: str = "softmax_topk"    # softmax_topk | soft_topk (paper)
  router_eps: float = 1.0
  capacity_factor: float = 1.25
  moe_group_size: int = 512       # routing-group tokens (bounds dispatch cost)

  # MLA (deepseek)
  kv_lora_rank: int = 0
  qk_nope_dim: int = 0
  qk_rope_dim: int = 0
  v_head_dim: int = 0

  # Recurrent (RG-LRU)
  lru_width: int = 0
  conv_width: int = 4

  # MLP / norm / embeddings
  mlp_variant: str = "swiglu"     # swiglu | geglu | gelu
  norm: str = "rmsnorm"           # rmsnorm | layernorm
  rope_theta: float = 10000.0
  tie_embeddings: bool = False
  logit_softcap: float = 0.0

  # Modality frontend stub
  frontend: str = "none"          # none | vision | audio
  num_codebooks: int = 0          # audio: parallel output heads
  num_patches: int = 0            # vision: patch-embedding prefix length

  # Numerics / training-step shape
  dtype: str = "bfloat16"
  remat: str = "full"             # none | dots | full
  grad_accum: int = 1
  grad_accum_dtype: str = "float32"  # bf16 for param-bound giants (grok)
  xent_chunk: int = 1024          # sequence chunking for the LM-head loss
  q_chunk: int = 512              # flash-attention query block
  kv_chunk: int = 1024            # flash-attention kv block

  # Paper-technique knobs
  loss_trim_fraction: float = 0.0   # soft-LTS token trimming (0 = off)
  loss_trim_eps: float = 1e-2

  # Sharding strategy
  fsdp: bool = False              # also shard weights/opt-state over data
  seq_shard_activations: bool = False
  supports_long_context: bool = False  # run long_500k? (sub-quadratic)

  @property
  def attn_dim(self) -> int:
    return self.num_heads * self.head_dim

  def layer_kinds(self) -> list[str]:
    cyc = self.block_cycle
    return [cyc[i % len(cyc)] for i in range(self.num_layers)]

  def plan_segments(self) -> list[tuple[tuple[str, ...], int]]:
    """Group layers into (cycle, repeats) segments for lax.scan stacking.

    The full cycle is scanned ``num_layers // len(cycle)`` times; any
    remainder layers form a trailing unrolled segment (repeats=1 each
    sub-cycle so params still stack uniformly).
    """
    kinds = self.layer_kinds()
    cyc = tuple(self.block_cycle)
    reps = len(kinds) // len(cyc)
    segments: list[tuple[tuple[str, ...], int]] = []
    if reps > 0:
      segments.append((cyc, reps))
    rem = kinds[reps * len(cyc):]
    if rem:
      segments.append((tuple(rem), 1))
    return segments


def register(cfg: ArchConfig) -> ArchConfig:
  if cfg.name in _REGISTRY:
    raise ValueError(f"config {cfg.name!r} is registered twice")
  _REGISTRY[cfg.name] = cfg
  return cfg


def get_config(name: str) -> ArchConfig:
  if name not in _REGISTRY:
    # Import the module of the same name to trigger registration.
    import importlib
    mod = name.replace("-", "_").replace(".", "_")
    try:
      importlib.import_module(f"repro_torch.configs.{mod}")
    except ModuleNotFoundError as err:
      raise ValueError(f"unknown config {name!r}: the port has every "
                       f"config of the reference ({', '.join(ASSIGNED)})"
                       ) from err
  return _REGISTRY[name]


def registered() -> list[str]:
  return sorted(_REGISTRY)


# The reference's assigned architectures (``repro.configs.base.
# all_assigned``), every one of them ported.
ASSIGNED = ("gemma3-12b", "stablelm-3b", "llama3.2-1b", "tinyllama-1.1b",
            "deepseek-v2-lite-16b", "grok-1-314b", "llava-next-mistral-7b",
            "recurrentgemma-2b", "xlstm-350m", "musicgen-large")


def all_assigned() -> list[str]:
  """The assigned architectures, ``ASSIGNED`` as a list, each registered
  (its module imported) on the way."""
  for name in ASSIGNED:
    get_config(name)
  return list(ASSIGNED)
