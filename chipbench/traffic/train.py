"""Training traffic: a closed loop of optimizer steps on the program's
``launch.steps.make_train_step``.

Parameters (the traffic file): ``batch`` sequences of ``seq`` tokens a
step, in ``grad_accum`` microbatches; a ``corrupt`` share of the targets
replaced by noise; the loss (``loss``: the soft-LTS trim and its eps) and
the optimizer (``optimizer``: AdamW's settings, a constant learning rate);
``recorded_steps`` steps taken in set-up and followed by the reference;
``trace_steps`` steps traced after the window.

The batches are a copy of the port's ``TokenPipeline`` stream (numpy's
Philox keyed by the seed, counter (step, 0, stream, 0): a Markov-ish
token stream, then the corruption), made here so that the reference gets
the benchmark's inputs, not the program's.  Set-up makes the first
``batches`` steps' batches and copies them to the device in one call;
the steps replay them in order, so no step waits on the host's numpy.

Set-up builds one trainer object (the model on the seed's weights, the
AdamW state, the step), drives it through the recorded steps and reads,
as they pass: each step's loss, after step 1 each leaf's gradient as
AdamW took it (its first moment / (1 - b1)), after the last recorded step
each leaf's change from the seed's weights.  The window goes on with the
same object.
"""

from __future__ import annotations

import gc
import math
import statistics
import sys
import time

import numpy as np
import torch

from chipbench import weights as W
from chipbench import yardstick as Y


def batch_at(seed: int, step: int, t: dict, vocab: int) -> dict:
  """The step's tokens and targets (batch, seq), int64 numpy."""
  b, s = t["batch"], t["seq"]

  def rng(stream):
    return np.random.Generator(np.random.Philox(
        key=seed, counter=[step, 0, stream, 0]))

  r = rng(0)
  base = r.integers(0, vocab, (b, s + 1), dtype=np.int32)
  drift = r.integers(0, 7, (b, s + 1), dtype=np.int32)
  tokens = (np.cumsum(drift, axis=1) + base // 7) % vocab
  targets = tokens[:, 1:].astype(np.int64)
  if t["corrupt"] > 0:
    r2 = rng(1)
    mask = r2.random(targets.shape) < t["corrupt"]
    noise = r2.integers(0, vocab, targets.shape, dtype=np.int32)
    targets = np.where(mask, noise, targets)
  return {"tokens": tokens[:, :-1].astype(np.int64), "targets": targets}


def device_batches(seed, first, n, t, vocab, device) -> dict:
  """Steps ``first`` to ``first + n - 1``'s batches, stacked (n, batch,
  seq) on the device."""
  got = [batch_at(seed, step, t, vocab) for step in range(first, first + n)]
  return {k: torch.from_numpy(np.stack([g[k] for g in got])).to(device)
          for k in got[0]}


class Cell:
  """One run of a training workload."""

  def __init__(self, env):
    self.env = env
    self.m = env.model
    self.t = env.traffic
    self.steps_done = 0

  def setup(self) -> None:
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw

    env = self.env
    loss = self.t["loss"]
    self.cfg = cfg = env.port_config(
        loss_trim_fraction=loss["trim_fraction"], loss_trim_eps=loss["eps"],
        grad_accum=self.t["grad_accum"])
    opt = self.t["optimizer"]
    self.opt_cfg = adamw.AdamWConfig(
        lr=opt["lr"], b1=opt["b1"], b2=opt["b2"], eps=opt["eps"],
        weight_decay=opt["weight_decay"], clip_norm=opt["clip_norm"])
    self.model = T.Transformer(cfg, W.build_params(self.m, env.seed,
                                                   env.device))
    env.mark("weights")
    self.model.requires_grad_(True)
    self.params = dict(self.model.named_parameters())
    self.opt_state = ST.init_opt_state(cfg, self.opt_cfg, self.params)
    self.step_fn = ST.make_train_step(cfg, self.opt_cfg)
    self.data = device_batches(env.seed, 1, self.t["batches"], self.t,
                               self.m["vocab"], env.device)
    rec = {"loss": []}
    for _ in range(self.t["recorded_steps"]):
      loss = self.one_step()
      rec["loss"].append(loss)
      if self.steps_done == 1:
        rec["grad"] = self.moment_norms()
    rec["change"] = self.change_norms()
    self.recorded = rec

  def one_step(self) -> float:
    i = self.steps_done % self.t["batches"]
    self.steps_done += 1
    batch = {k: v[i] for k, v in self.data.items()}
    _, self.opt_state, metrics = self.step_fn(self.model, self.opt_state,
                                              batch)
    return float(metrics["loss"])

  @torch.no_grad()
  def moment_norms(self) -> dict:
    b1 = self.opt_cfg.b1
    names = list(self.params)
    m = self.opt_state["adam"]["m"]
    norms = torch.stack([torch.linalg.vector_norm(m[n].float())
                         for n in names]) / (1 - b1)
    return dict(zip(names, norms.tolist()))

  @torch.no_grad()
  def change_norms(self) -> dict:
    out = {}
    for group in range(self.m["layers"] + 1):
      start = W.named(W.build_group(self.m, self.env.seed, group,
                                    self.env.device), W.group_prefix(group))
      for name, p0 in start.items():
        out[name] = float(torch.linalg.vector_norm(
            self.params[name].float() - p0.float()))
    return out

  def window(self, seconds: float) -> dict:
    env = self.env
    losses, ends = [], []
    env.sync()
    t0 = time.perf_counter()
    while True:
      losses.append(self.one_step())
      ends.append(time.perf_counter())
      if ends[-1] - t0 >= seconds:
        break
    wall = ends[-1] - t0
    steps = np.diff([t0] + ends) * 1e3
    print(f"window: {len(steps)} steps, ms min {steps.min():.1f} median "
          f"{np.median(steps):.1f} max {steps.max():.1f}; each: "
          + " ".join(f"{x:.0f}" for x in steps), file=sys.stderr)
    tokens = self.t["batch"] * self.t["seq"] * len(losses)
    self.window_steps, self.window_s = len(losses), wall
    failed = sum(1 for x in losses if not math.isfinite(x))
    return {"attempted": len(losses), "failed": failed,
            "metrics": {"train_tokens_per_s": tokens / wall}}

  def segment(self):
    """The traced segment's work and its count of steps."""
    n = self.t["trace_steps"]

    def run():
      for _ in range(n):
        self.one_step()
    return run, n

  def layer_facts(self) -> dict:
    """What the per-layer readers need besides the trace."""
    t = self.t
    flops = Y.train_step_flops(self.m, t["batch"], t["seq"])
    m = self.m
    accum = t["grad_accum"]
    rows = t["batch"] // accum
    return {"kind": "train", "step_flops": flops,
            "window_steps": self.window_steps, "window_s": self.window_s,
            # forward and remat's recompute: two launches a layer and
            # microbatch, each over the whole microbatch.
            "flash_launch_s": [Y.flash_least_s(
                rows, t["seq"], m["heads"], m["heads"],
                m["qk_nope_dim"] + m["qk_rope_dim"], m["v_head_dim"])]
            * (2 * m["layers"] * accum)}

  def release(self) -> None:
    del self.model, self.params, self.opt_state, self.step_fn, self.data
    gc.collect()
    if self.env.cuda:
      torch.cuda.empty_cache()

  def reference(self, prec, half_batch: bool = False) -> dict:
    from chipbench.reference import train as RT
    env = self.env
    b = device_batches(env.seed, 1, self.t["recorded_steps"], self.t,
                       self.m["vocab"], env.device)
    batches = list(zip(b["tokens"], b["targets"]))
    return RT.follow(self.m, env.seed, batches, self.t["optimizer"],
                     self.t["loss"],
                     self.t["grad_accum"],
                     env.device, prec, half_batch=half_batch)

  @staticmethod
  def compare(got: dict, ref: dict) -> dict:
    """The numbers compared: the worst step's loss gap over |reference
    loss|; the worst leaf's gap between the two gradient norms, and
    between the two norms of the change after the recorded steps, each
    over the larger of the reference's norm of that leaf and of the
    median leaf.  Leaves whose reference gradient is under a thousandth
    of the median leaf's are left out of the change (Adam moves them by
    round-off alone)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["loss"], ref["loss"]))
    gmed = statistics.median(ref["grad"].values())
    grad = max(abs(got["grad"][n] - g) / max(g, gmed)
               for n, g in ref["grad"].items())
    rawmed = statistics.median(ref["grad_raw"].values())
    moved = [n for n, g in ref["grad_raw"].items() if g >= 1e-3 * rawmed]
    cmed = statistics.median(ref["change"][n] for n in moved)
    change = max(abs(got["change"][n] - ref["change"][n])
                 / max(ref["change"][n], cmed) for n in moved)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}

  def readings(self) -> dict:
    from chipbench.reference import model as M
    return self.compare(self.recorded, self.reference(M.F32))
