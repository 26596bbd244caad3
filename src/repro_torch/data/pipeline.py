"""Deterministic synthetic token pipeline.

Counterpart of ``repro.data.pipeline``: ``batch_at(step)`` is a pure
function of (seed, step, host slice), drawn with numpy's counter-based
Philox generator in the reference's order, so the port gets the very
arrays the JAX package gets, for each frontend: tokens and targets (the
token branch); for ``vision`` ``seq_len - num_patches`` text tokens, the
patch embeddings (B, num_patches, d) and the text targets; for ``audio``
frame embeddings (B, seq_len, d) and targets (B, seq_len, num_codebooks).
``corrupt_fraction`` replaces that share of the targets with noise (the
outliers of the soft-LTS loss, paper §6.4).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
  vocab_size: int
  global_batch: int
  seq_len: int
  seed: int = 0
  num_hosts: int = 1
  host_id: int = 0
  corrupt_fraction: float = 0.0
  num_codebooks: int = 0      # audio targets (B, S, K)
  d_model: int = 0            # frontend-stub embedding width
  frontend: str = "none"
  num_patches: int = 0


class TokenPipeline:
  """batch_at(step) -> dict of numpy arrays (host-local shard)."""

  def __init__(self, cfg: DataConfig):
    if cfg.global_batch % cfg.num_hosts:
      raise ValueError(f"global_batch {cfg.global_batch} does not split "
                       f"over {cfg.num_hosts} hosts")
    if cfg.frontend == "vision" and cfg.seq_len < cfg.num_patches:
      raise ValueError(f"seq_len {cfg.seq_len} is shorter than the "
                       f"{cfg.num_patches} patches it counts")
    self.cfg = cfg
    self.local_batch = cfg.global_batch // cfg.num_hosts

  def _rng(self, step: int, stream: int) -> np.random.Generator:
    c = self.cfg
    return np.random.Generator(np.random.Philox(
        key=c.seed, counter=[step, c.host_id, stream, 0]))

  def batch_at(self, step: int) -> dict[str, np.ndarray]:
    c = self.cfg
    b, s = self.local_batch, c.seq_len
    rng = self._rng(step, 0)
    out: dict[str, np.ndarray] = {}
    if c.frontend == "audio":
      out["embeds"] = rng.standard_normal((b, s, c.d_model),
                                          dtype=np.float32)
      out["targets"] = rng.integers(0, c.vocab_size,
                                    (b, s, c.num_codebooks), dtype=np.int32)
    elif c.frontend == "vision":
      tokens = rng.integers(0, c.vocab_size, (b, s - c.num_patches + 1),
                            dtype=np.int32)
      out["tokens"] = tokens[:, :-1]
      out["image_embeds"] = rng.standard_normal(
          (b, c.num_patches, c.d_model), dtype=np.float32)
      out["targets"] = tokens[:, 1:].copy()
    else:
      # Markov-ish stream: correlated tokens so the loss actually decreases.
      base = rng.integers(0, c.vocab_size, (b, s + 1), dtype=np.int32)
      drift = rng.integers(0, 7, (b, s + 1), dtype=np.int32)
      tokens = (np.cumsum(drift, axis=1) + base // 7) % c.vocab_size
      out["tokens"] = tokens[:, :-1].astype(np.int32)
      out["targets"] = tokens[:, 1:].astype(np.int32).copy()

    if c.corrupt_fraction > 0:
      rng2 = self._rng(step, 1)
      mask = rng2.random(out["targets"].shape) < c.corrupt_fraction
      noise = rng2.integers(0, c.vocab_size, out["targets"].shape,
                            dtype=np.int32)
      out["targets"] = np.where(mask, noise, out["targets"])
      out["corrupt_mask"] = mask
    return out


def pipeline_for_arch(arch_cfg, global_batch: int, seq_len: int,
                      seed: int = 0, **kw) -> TokenPipeline:
  return TokenPipeline(DataConfig(
      vocab_size=arch_cfg.vocab_size,
      global_batch=global_batch,
      seq_len=seq_len,
      seed=seed,
      num_codebooks=arch_cfg.num_codebooks,
      d_model=arch_cfg.d_model,
      frontend=arch_cfg.frontend,
      num_patches=arch_cfg.num_patches,
      **kw,
  ))
