"""Deterministic synthetic token pipeline (token branch).

Counterpart of ``repro.data.pipeline``: ``batch_at(step)`` is a pure
function of (seed, step, host slice), drawn with numpy's counter-based
Philox generator, so the port's server gets the very tokens the JAX
server gets.  Only the token branch is ported; the audio and vision
frontends raise.
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
    if cfg.frontend != "none":
      raise NotImplementedError(
          f"the {cfg.frontend} frontend is not ported (ROADMAP.md, queue 1: "
          "other layer kinds and frontends)")
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
    # Markov-ish stream: correlated tokens so the loss actually decreases.
    base = rng.integers(0, c.vocab_size, (b, s + 1), dtype=np.int32)
    drift = rng.integers(0, 7, (b, s + 1), dtype=np.int32)
    tokens = (np.cumsum(drift, axis=1) + base // 7) % c.vocab_size
    out = {"tokens": tokens[:, :-1].astype(np.int32),
           "targets": tokens[:, 1:].astype(np.int32).copy()}

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
