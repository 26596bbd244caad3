"""Decode traffic: a batch of sequences decoded greedily, one position
counter for the batch, on the program's ``launch.steps`` prefill and
decode steps.

Parameters (the traffic file): ``batch`` prompts of
``prompt`` tokens, drawn uniformly from the vocabulary on the device from
the seed, prefilled ``prefill_chunk`` prompts a call in set-up into caches
of ``prompt + gen`` positions; then decode steps fill the window, each
giving every sequence a token.  A window that reaches the end of the
caches starts a new round: the next prompts are prefilled inside the
window (its time counted) and decoding starts again after them.
``check_steps`` decode steps of the last round, drawn from the seed with
its last step among them, and ``check_prompts`` of its prompts are
compared with the reference after the window; ``trace_steps`` steps are
traced after it.

Each step's time is read between CUDA events recorded on the stream
before and after it (device timestamps: a step of ~20 ms is too short for
the host's clock); the rate is the tokens of every step over the host's
time of the whole window, synchronised at its end.
"""

from __future__ import annotations

import gc
import random
import sys
import time

import numpy as np
import torch

from chipbench import weights as W
from chipbench import yardstick as Y


class Cell:
  """One run of a decode workload."""

  def __init__(self, env):
    self.env = env
    self.m = env.model
    self.t = env.traffic
    self.max_len = self.t["prompt"] + self.t["gen"]
    self.round = 0

  def prompts(self, round_: int) -> torch.Tensor:
    gen = torch.Generator(device=self.env.device)
    gen.manual_seed(W.group_seed(self.env.seed, 1000 + round_))
    return torch.randint(0, self.m["vocab"], (self.t["batch"],
                                              self.t["prompt"]),
                         generator=gen, device=self.env.device)

  def setup(self) -> None:
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T

    env = self.env
    self.cfg = cfg = env.port_config()
    self.model = T.Transformer(cfg, W.build_params(self.m, env.seed,
                                                   env.device))
    env.mark("weights")
    self.prefill = ST.make_prefill_step(cfg, self.max_len)
    self.decode = ST.make_decode_step(cfg)
    self.caches = T.init_cache(cfg, self.t["batch"], self.max_len,
                               env.device)
    self.tokens = torch.zeros((self.t["batch"], self.t["gen"] + 1),
                              dtype=torch.int64, device=env.device)
    self.fill()
    # Warm-up: two steps at the first positions; the window writes them
    # again before any step reads them.
    tok = self.tokens[:, 0]
    with torch.inference_mode():
      for i in range(2):
        logits, _ = self.decode(self.model, self.caches, tok,
                                self.t["prompt"] + i)
        tok = torch.argmax(logits, dim=-1)
    self.events = [torch.cuda.Event(enable_timing=True)
                   for _ in range(self.t["gen"] + 2)] if env.cuda else []
    env.sync()

  @torch.inference_mode()
  def fill(self) -> None:
    """Prefill this round's prompts into the caches, a chunk a call, and
    put each sequence's first token in ``tokens[:, 0]``."""
    prompts = self.prompts(self.round)
    c = self.t["prefill_chunk"]
    for lo in range(0, prompts.shape[0], c):
      logits, got = self.prefill(self.model, {"tokens": prompts[lo:lo + c]})
      for cache, part in zip(self.caches, got):
        for name, t in part.items():
          cache[name][lo:lo + c].copy_(t)
      del got
      self.tokens[lo:lo + c, 0] = torch.argmax(logits, dim=-1)

  def window(self, seconds: float) -> dict:
    env = self.env
    p0 = self.t["prompt"]
    itl = []
    steps = total = 0
    env.sync()
    t0 = time.perf_counter()
    with torch.inference_mode():
      while True:
        tok = self.tokens[:, 0]
        if env.cuda:
          self.events[0].record()
        i = 0
        while True:
          logits, _ = self.decode(self.model, self.caches, tok, p0 + i)
          tok = torch.argmax(logits, dim=-1)
          self.tokens[:, i + 1] = tok
          i += 1
          if env.cuda:
            self.events[i].record()
          if time.perf_counter() - t0 >= seconds or i == self.t["gen"]:
            break
        env.sync()
        if env.cuda:
          itl += [self.events[j].elapsed_time(self.events[j + 1])
                  for j in range(i)]
        steps += i
        total += i * self.t["batch"]
        if time.perf_counter() - t0 >= seconds:
          break
        self.round += 1
        self.fill()
    wall = time.perf_counter() - t0
    self.last_logits, self.last_steps = logits, i
    self.window_steps, self.window_s = steps, wall
    failed = int((~torch.isfinite(logits)).any(dim=-1).sum())
    metrics = {"decode_tokens_per_s": total / wall}
    if itl:
      print(f"window: {steps} steps, {self.round + 1} round(s), itl ms "
            f"median {np.median(itl):.3f} max {max(itl):.3f}",
            file=sys.stderr)
      metrics["itl_p95_ms"] = float(np.percentile(itl, 95))
    return {"attempted": total, "failed": failed, "metrics": metrics}

  def segment(self):
    n = self.t["trace_steps"]
    p0 = self.t["prompt"]

    @torch.inference_mode()
    def run():
      tok = self.tokens[:, 0]
      for i in range(n):
        logits, _ = self.decode(self.model, self.caches, tok, p0 + i)
        tok = torch.argmax(logits, dim=-1)
    return run, n

  def layer_facts(self) -> dict:
    m, t = self.m, self.t
    b, p0 = t["batch"], t["prompt"]
    # The window's steps run from position p0 on; the least time of each
    # step, summed over the steps of the window (the last round's counts
    # stand for any earlier round: the same positions).
    least = 0.0
    pos = p0
    for _ in range(self.window_steps):
      least += max(Y.decode_step_flops(m, b, pos) / Y.BF16_FLOPS,
                   Y.decode_step_bytes(m, b, pos) / Y.HBM_BYTES)
      pos = pos + 1 if pos + 1 < self.max_len else p0
    return {"kind": "decode", "least_s": least, "window_s": self.window_s}

  def release(self) -> None:
    del self.model, self.prefill, self.decode
    gc.collect()
    if self.env.cuda:
      torch.cuda.empty_cache()

  def check_plan(self):
    rng = random.Random(self.env.seed)
    n = self.last_steps
    k = min(self.t["check_steps"], n)
    steps = sorted(set(rng.sample(range(n - 1), k - 1)) | {n - 1})
    seqs = sorted(rng.sample(range(self.t["batch"]), self.t["check_prompts"]))
    return steps, seqs

  def reference(self, precs) -> tuple:
    from chipbench.reference import serve as RS
    env = self.env
    steps, seqs = self.check_plan()
    prompts = self.prompts(self.round)
    pre = RS.prefill(self.m, env.seed, [prompts[j] for j in seqs],
                     env.device, precs, keep_kv=True)
    dec = RS.decode(self.m, env.seed, self.caches, self.tokens,
                    self.t["prompt"], steps, env.device, precs)
    return steps, seqs, pre, dec

  def readings(self, control: bool = False) -> dict:
    """The readings, each summarised over the checked tokens (largest,
    mean, median): how far a served token's logit lies below the
    reference's best (the checked prompts' first tokens and every sequence
    at the checked steps); the relative error of each token's k and v the
    program wrote into the cache, at the checked steps and, apart, at the
    checked prompts' positions, a layer at a time; the largest |logit -
    reference| of each sequence at the last step.  With ``control``, {"program": those, "control": the
    same numbers of the reference in float8 put in the program's place},
    from one pass of the reference."""
    from chipbench.reference import model as M
    from chipbench.reference import serve as RS
    precs = [M.F32, M.FP8] if control else [M.F32]
    steps, seqs, pre, dec = self.reference(precs)
    p0 = self.t["prompt"]
    mine = {"first": [self.tokens[j, 0] for j in seqs],
            "chosen": [self.tokens[:, i + 1] for i in steps],
            "last": self.last_logits,
            "pre_kv": [[(c["k"][s:s + 1, :p0], c["v"][s:s + 1, :p0])
                        for s in seqs] for c in self.caches],
            "dec_kv": [[(c["k"][:, p0 + i], c["v"][:, p0 + i])
                        for i in steps] for c in self.caches]}
    out = {"program": self.numbers(pre[0], dec[0], mine)}
    if control:
      out["control"] = self.numbers(pre[0], dec[0], {
          "first": [torch.argmax(x) for x in pre[1]["logits"]],
          "chosen": [torch.argmax(x, dim=-1) for x in dec[1]["logits"]],
          "last": dec[1]["logits"][-1], "pre_kv": pre[1]["kv"],
          "dec_kv": dec[1]["kv"]})
      return out
    return out["program"]

  @staticmethod
  def numbers(ref_pre: dict, ref_dec: dict, got: dict) -> dict:
    from chipbench.reference import serve as RS
    gaps = [RS.gaps(r, t) for r, t in zip(ref_pre["logits"], got["first"])]
    gaps += [RS.gaps(r, t) for r, t in zip(ref_dec["logits"], got["chosen"])]
    errs = {}
    for kind in ("pre_kv", "dec_kv"):
      ref = ref_pre["kv"] if kind == "pre_kv" else ref_dec["kv"]
      errs[kind] = torch.cat([
          RS.token_err(g, r, 2)
          for layer_ref, layer_got in zip(ref, got[kind])
          for pair_ref, pair_got in zip(layer_ref, layer_got)
          for g, r in zip(pair_got, pair_ref)])
    last = got["last"].float() - ref_dec["logits"][-1]
    return {**RS.stats("token_gap", torch.cat(gaps)),
            **RS.stats("prompt_cache_err", errs["pre_kv"]),
            **RS.stats("cache_err", errs["dec_kv"]),
            **RS.stats("logit_err", last.abs().amax(dim=-1))}
