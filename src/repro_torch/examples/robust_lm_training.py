"""Robust LM pretraining with soft least-trimmed-squares token losses.

Counterpart of the reference's ``examples/robust_lm_training.py``: the
paper's §6.4 application lifted to language modeling.  A fraction of the
training targets is corrupted (label noise); the soft-LTS loss soft-sorts
per-token losses and down-weights the largest ones, so corrupted tokens
stop dominating the gradient.  The same llama-family model is trained
with and without trimming, and the loss ON CLEAN TOKENS compared (the
pipeline exposes the corruption mask, used for evaluation only).

Default (~20M f32 parameters):
  PYTHONPATH=src python -m repro_torch.examples.robust_lm_training

Full recipe (~100M f32 parameters, a few hundred steps):
  PYTHONPATH=src python -m repro_torch.examples.robust_lm_training \\
      --full --steps 300

``--device cpu`` runs either on the CPU.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import pipeline_for_arch
from repro_torch.examples import add_device_arg, device_of, synchronize
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as T
from repro_torch.optim import adamw


def make_cfg(full: bool, trim: float) -> ArchConfig:
  if full:
    dims = dict(num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
                head_dim=64, d_ff=2048, vocab_size=32000)   # ~100M params
  else:
    dims = dict(num_layers=4, d_model=256, num_heads=4, num_kv_heads=2,
                head_dim=64, d_ff=1024, vocab_size=8192)    # ~20M params
  return ArchConfig(
      name="robust-lm", family="dense", block_cycle=("dense",),
      mlp_variant="swiglu", dtype="float32", remat="none",
      loss_trim_fraction=trim, loss_trim_eps=1e-2,
      q_chunk=128, kv_chunk=128, xent_chunk=128, **dims)


def to_device(batch: dict, device) -> dict[str, torch.Tensor]:
  """A pipeline batch on ``device``, ids as int64."""
  return {k: torch.from_numpy(v).to(
      device=device, dtype=torch.int64 if v.dtype.kind in "iu" else None)
          for k, v in batch.items()}


def clean_loss(cfg, model, batch: dict, mask: torch.Tensor) -> float:
  """The mean token loss over the targets the pipeline left clean."""
  with torch.no_grad():
    tok, _ = T.forward_train(cfg, model, batch)
    keep = 1.0 - mask
    return float(torch.sum(tok * keep) / torch.clamp(torch.sum(keep), min=1))


def run(trim: float, args, model: T.Transformer | None = None,
        device="cpu") -> dict:
  """Train ``args.steps`` AdamW steps (lr 1e-3) at ``trim`` from ``model``
  (by default seeded weights, seed 0) on the pipeline's seed-0 batches:
  {"train": every step's loss, "clean": the clean-token loss at every
  ``args.eval_every``-th step and the last, "eval_steps": those steps}."""
  cfg = make_cfg(args.full, trim)
  pipe = pipeline_for_arch(cfg, args.batch, args.seq, seed=0,
                           corrupt_fraction=args.corrupt)
  if model is None:
    model = T.init_params(cfg, 0, device)
  model.requires_grad_(True)
  opt_cfg = adamw.AdamWConfig(lr=1e-3)
  opt = ST.init_opt_state(cfg, opt_cfg, dict(model.named_parameters()))
  train_step = ST.make_train_step(cfg, opt_cfg)
  out = {"train": [], "clean": [], "eval_steps": []}
  for step in range(args.steps):
    raw = pipe.batch_at(step)
    mask = torch.from_numpy(raw.pop("corrupt_mask").astype(np.float32)).to(
        device)
    batch = to_device(raw, device)
    model, opt, m = train_step(model, opt, batch)
    loss = float(m["loss"])
    out["train"].append(loss)
    if step % args.eval_every == 0 or step == args.steps - 1:
      cl = clean_loss(cfg, model, batch, mask)
      out["clean"].append(cl)
      out["eval_steps"].append(step)
      print(f"  step {step:4d}  train {loss:.4f}  clean-token {cl:.4f}")
  return out


def parser() -> argparse.ArgumentParser:
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--full", action="store_true")
  ap.add_argument("--steps", type=int, default=60)
  ap.add_argument("--batch", type=int, default=8)
  ap.add_argument("--seq", type=int, default=128)
  ap.add_argument("--corrupt", type=float, default=0.25)
  ap.add_argument("--trim", type=float, default=0.25)
  ap.add_argument("--eval-every", type=int, default=10)
  add_device_arg(ap)
  return ap


def main(argv=None) -> dict:
  args = parser().parse_args(argv)
  device = device_of(args.device)
  print(f"[robust-lm] corruption={args.corrupt:.0%}  "
        f"({'~100M' if args.full else '~20M'} params)")
  print("[robust-lm] baseline (no trimming):")
  t0 = time.perf_counter()
  base = run(0.0, args, device=device)
  print("[robust-lm] soft-LTS trimming "
        f"(trim={args.trim:.0%}, paper §6.4):")
  trimmed = run(args.trim, args, device=device)
  synchronize(device)
  seconds = time.perf_counter() - t0
  print(f"\nclean-token loss:  baseline {base['clean'][-1]:.4f}  "
        f"vs soft-LTS {trimmed['clean'][-1]:.4f}  "
        f"(lower is better; {seconds:.0f}s total)")
  return {"baseline": base, "soft_lts": trimmed,
          "params": T.count_params(T.init_params(make_cfg(args.full, 0.0), 0,
                                                 "meta")),
          "full": args.full, "steps": args.steps, "seconds": seconds}


if __name__ == "__main__":
  main()
