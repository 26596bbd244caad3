"""The reference's first training steps, from the seed's weights.

Plain AdamW in float32 (the configuration file's optimizer group: lr, the
two betas, eps, decoupled weight decay on every layer leaf and the 2-d
leaves outside the layers, clipping by the global gradient norm), the
gradients of each step summed over its microbatches by autograd and
divided by their count.  The loss of a microbatch is the soft trimmed
mean of its token NLLs (``softsort.soft_trimmed_mean``) plus 0.01 times
the layers' load-balance losses; the step's loss is the microbatches' mean
of the trimmed means, as the configuration states it.

``follow`` returns, for steps 1..n: each step's loss; after step 1 each
leaf's gradient norm as AdamW took it (clipped) and unclipped; after step
n each leaf's change from the seed's weights.  ``half_batch`` plants the
fault "half of the batch left out, the mean taken over the rest".
"""

from __future__ import annotations

import torch

from chipbench import weights as W
from chipbench.reference import model as M
from chipbench.reference.softsort import soft_trimmed_mean


def microbatch_loss(top, layers, tokens, targets, m, loss_cfg,
                    prec: M.Precision):
  """(trimmed loss, loss + 0.01 aux) of one microbatch (B, S)."""
  x = prec.q(top["embed"]["table"][tokens])
  positions = torch.arange(tokens.shape[1], device=tokens.device)
  aux = torch.zeros((), device=tokens.device)
  for lp in layers:
    x, a, _ = M.layer_seq(lp, x, positions, m, prec)
    aux = aux + a
  nll = M.token_nll(top, x, targets, m, prec)
  if loss_cfg["trim_fraction"] > 0:
    loss = soft_trimmed_mean(nll, loss_cfg["trim_fraction"], loss_cfg["eps"])
  else:
    loss = torch.mean(nll)
  return loss, loss + 0.01 * aux


def follow(m: dict, seed: int, batches: list, opt: dict, loss_cfg: dict,
           accum: int, device, prec: M.Precision = M.F32,
           half_batch: bool = False) -> dict:
  """The first ``len(batches)`` steps; ``batches`` are (tokens, targets)
  (B, S) int64 on ``device``."""
  M.no_tf32()
  top = W.build_group(m, seed, 0, device, torch.float32)
  layers = [W.build_group(m, seed, i + 1, device, torch.float32)
            for i in range(m["layers"])]
  params = W.named(top)
  for i, lp in enumerate(layers):
    params.update(W.named(lp, W.group_prefix(i + 1)))
  with torch.no_grad():
    for p in params.values():
      p.copy_(prec.q(p))
      p.requires_grad_(True)
  mom = {n: torch.zeros_like(p) for n, p in params.items()}
  vel = {n: torch.zeros_like(p) for n, p in params.items()}
  b1, b2 = opt["b1"], opt["b2"]
  out = {"loss": []}
  used = accum // 2 if half_batch else accum
  for step, (tokens, targets) in enumerate(batches, start=1):
    rows = tokens.shape[0] // accum
    losses = []
    for i in range(used):
      sl = slice(i * rows, (i + 1) * rows)
      loss, total = microbatch_loss(top, layers, tokens[sl], targets[sl], m,
                                    loss_cfg, prec)
      total.backward()
      losses.append(float(loss.detach()))
    out["loss"].append(sum(losses) / used)
    with torch.no_grad():
      grads = {n: p.grad.div_(used) for n, p in params.items()}
      gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
      scale = torch.clamp(opt["clip_norm"] / torch.clamp(gnorm, min=1e-12),
                          max=1.0)
      if step == 1:
        names = list(grads)
        raw = torch.stack([torch.linalg.vector_norm(grads[n]) for n in names])
        out["grad_raw"] = dict(zip(names, raw.tolist()))
        out["grad"] = dict(zip(names, (raw * scale).tolist()))
      bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
      for n, p in params.items():
        g = grads[n] * scale
        mom[n].mul_(b1).add_(g, alpha=1 - b1)
        vel[n].mul_(b2).addcmul_(g, g, value=1 - b2)
        upd = (mom[n] / bc1) / (torch.sqrt(vel[n] / bc2) + opt["eps"])
        if n.startswith("layers.") or p.dim() >= 2:
          upd = upd + opt["weight_decay"] * p
        p.sub_(opt["lr"] * upd)
        p.copy_(prec.q(p))
        p.grad = None
      del grads
  with torch.no_grad():
    change = {}
    for group in range(m["layers"] + 1):
      start = W.named(W.build_group(m, seed, group, device, torch.float32),
                      W.group_prefix(group))
      for name, p0 in start.items():
        change[name] = float(torch.linalg.vector_norm(params[name] - p0))
    out["change"] = change
  return out
