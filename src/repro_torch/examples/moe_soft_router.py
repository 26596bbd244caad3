"""MoE language model with the paper's soft-top-k router, end to end.

Counterpart of the reference's ``examples/moe_soft_router.py``: trains a
small MoE LM twice — once with the standard softmax-top-k router and once
with the projection-based soft-top-k router (dense gradients to every
expert logit) — then serves a few greedy generations from the
soft-routed model.  Reports loss and expert load balance (coefficient of
variation of expert loads; lower = better balanced).

  PYTHONPATH=src python -m repro_torch.examples.moe_soft_router \\
      [--device cpu]

On the card the soft router's training gates run on the PAV kernel
(``soft_topk_mask``), its generation on the gates kernel, and attention
(f32, head width 32, G = 2) on the CUDA-core attention kernel.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import pipeline_for_arch
from repro_torch.examples import add_device_arg, device_of, synchronize
from repro_torch.examples.robust_lm_training import to_device
from repro_torch.launch import steps as ST
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.moe import _dispatch_mask, _router_weights
from repro_torch.optim import adamw

PROMPT = (2, 16)     # the generation's zero prompt (batch, positions)
GENERATE = 8


def make_cfg(router: str) -> ArchConfig:
  return ArchConfig(
      name=f"moe-{router}", family="moe", num_layers=4, d_model=128,
      num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=4096,
      block_cycle=("moe",), num_experts=8, experts_per_token=2,
      moe_d_ff=128, router=router, router_eps=1.0, moe_group_size=64,
      dtype="float32", remat="none", q_chunk=64, kv_chunk=64,
      xent_chunk=64)


def expert_load_cv(cfg, model: T.Transformer, batch: dict) -> float:
  """Coefficient of variation of the first layer's expert dispatch counts
  (balance metric), with the example's capacity ceil(group * k * factor /
  E)."""
  with torch.no_grad():
    x = T.embed_inputs(cfg, model, batch)
    lp = model.layers[0].params.tree()
    h = L.norm_apply(lp["norm1"], x, cfg.norm)
    xg = h.reshape(-1, cfg.moe_group_size, cfg.d_model)
    logits = torch.einsum("gtd,de->gte", xg, lp["ffn"]["router"])
    w, _ = _router_weights(cfg, logits)
    capacity = int(np.ceil(cfg.moe_group_size * cfg.experts_per_token *
                           cfg.capacity_factor / cfg.num_experts))
    dispatch, _ = _dispatch_mask(w, cfg.experts_per_token, capacity)
    loads = torch.sum(dispatch, dim=(0, 1, 3))
    return float(torch.std(loads, correction=0)
                 / torch.clamp(torch.mean(loads), min=1e-9))


def train_one(router: str, steps: int, batch_size: int, seq: int,
              model: T.Transformer | None = None, device="cpu"):
  """(cfg, model, final loss, expert-load CV on the last batch, every
  step's loss) after ``steps`` AdamW steps (lr 1e-3) from ``model`` (by
  default seeded weights, seed 0) on the pipeline's seed-0 batches."""
  cfg = make_cfg(router)
  pipe = pipeline_for_arch(cfg, batch_size, seq, seed=0)
  if model is None:
    model = T.init_params(cfg, 0, device)
  model.requires_grad_(True)
  opt_cfg = adamw.AdamWConfig(lr=1e-3)
  opt = ST.init_opt_state(cfg, opt_cfg, dict(model.named_parameters()))
  step_fn = ST.make_train_step(cfg, opt_cfg)
  batch, losses = None, []
  for step in range(steps):
    batch = to_device(pipe.batch_at(step), device)
    model, opt, m = step_fn(model, opt, batch)
    losses.append(float(m["loss"]))
    if step % 10 == 0:
      print(f"  [{router}] step {step:3d} loss {losses[-1]:.4f} "
            f"aux {float(m['aux_loss']):.3f}")
  model.requires_grad_(False)
  cv = expert_load_cv(cfg, model, batch)
  return cfg, model, losses[-1], cv, losses


def generate(cfg, model: T.Transformer, device) -> list[list[int]]:
  """Greedy tokens (batch, GENERATE) from a zero prompt of PROMPT, through
  the prefill and decode steps, caches of 32 positions."""
  prompt = torch.zeros(PROMPT, dtype=torch.int64, device=device)
  with torch.no_grad():
    logits, caches = T.forward_prefill(
        cfg, model, {"tokens": prompt, "targets": prompt}, 32)
    tok = torch.argmax(logits, -1)
    toks = []
    for i in range(GENERATE):
      toks.append(tok)
      logits, caches = T.forward_decode(cfg, model, caches, tok,
                                        PROMPT[1] + i)
      tok = torch.argmax(logits, -1)
  return torch.stack(toks, 1).cpu().tolist()


def main(argv=None) -> dict:
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--steps", type=int, default=40)
  ap.add_argument("--batch", type=int, default=8)
  ap.add_argument("--seq", type=int, default=64)
  add_device_arg(ap)
  args = ap.parse_args(argv)
  device = device_of(args.device)
  t0 = time.perf_counter()
  results, out = {}, {}
  for router in ("softmax_topk", "soft_topk"):
    print(f"[moe] training with router={router}")
    cfg, model, loss, cv, losses = train_one(router, args.steps, args.batch,
                                             args.seq, device=device)
    results[router] = (loss, cv)
    out[router] = {"loss": loss, "cv": cv, "losses": losses}
    if router == "soft_topk":
      tokens = generate(cfg, model, device)
      out["tokens"] = tokens
      print("  [soft_topk] sample generation:", tokens[0])
  print("\nrouter comparison (lower is better):")
  for router, (loss, cv) in results.items():
    print(f"  {router:14s} final-loss {loss:.4f}   expert-load CV {cv:.3f}")
  synchronize(device)
  out["steps"] = args.steps
  out["seconds"] = time.perf_counter() - t0
  return out


if __name__ == "__main__":
  main()
