"""Prefill traffic: one client in a closed loop, each request one prompt
whose first token is the answer, on the program's
``launch.steps.make_prefill_step``.

Parameters (the traffic file): ``lengths`` prompt
lengths spread log-uniformly over [``min_len``, ``max_len``] (the
quantiles (j + 1/2) / lengths, so every seed gets the same set of sizes);
the seed orders them, and the list is replayed while the window lasts.
Each request's tokens are a slice of one pool of ``pool`` tokens drawn
uniformly from the vocabulary on the device from the seed, at an offset
that the request's index sets, so no two requests of a run send the same
prompt.  Set-up prefills every length once.  A request's time to first
token runs from its start on the host to its first token on the host
(``.item()``, which waits for the card).  ``trace_requests`` are traced
after the window.

The check: ``check_requests`` places in the list of lengths, drawn from
the seed with the longest among them; the window keeps, for each, the
answer of the last request served there (its first token, its logits and
the caches the prefill wrote), and after the window the reference runs
over those prompts.  The numbers compared: the lower quartile over the
requests of the largest |logit - reference|, and, over every token of
those prompts, each token's worst relative error of its k or v in any
layer: the median of each block of ``check_block`` positions of a prompt,
and the largest of these over the blocks.  Routing flips (a token whose
experts lie within rounding of each other goes elsewhere than in the
reference) move a sixth of the tokens far, scattered, and with some seeds'
weights the last token of nearly half the prompts: a median over a block
passes the first over, the lower quartile the second, and a fault that
hits some positions or some prompts moves the medians of their blocks.
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


def lengths(t: dict) -> list[int]:
  lo, hi, n = t["min_len"], t["max_len"], t["lengths"]
  return [int(round(lo * (hi / lo) ** ((j + 0.5) / n))) for j in range(n)]


class Cell:
  """One run of a prefill workload."""

  def __init__(self, env):
    self.env = env
    self.m = env.model
    self.t = env.traffic
    self.order = lengths(self.t)
    rng = random.Random(env.seed)
    rng.shuffle(self.order)
    n = len(self.order)
    longest = max(range(n), key=self.order.__getitem__)
    k = min(self.t["check_requests"], n)
    self.check_places = set(rng.sample(
        [i for i in range(n) if i != longest], k - 1)) | {longest}

  def pool_tokens(self) -> torch.Tensor:
    gen = torch.Generator(device=self.env.device)
    gen.manual_seed(W.group_seed(self.env.seed, 2000))
    return torch.randint(0, self.m["vocab"], (self.t["pool"],),
                         generator=gen, device=self.env.device)

  def request(self, r: int) -> torch.Tensor:
    """Request ``r``'s prompt (1, L)."""
    n = self.order[r % len(self.order)]
    span = self.t["pool"] - self.t["max_len"]
    off = (r * 7919 + 104729 * (r // len(self.order))) % span
    return self.pool[off:off + n][None]

  def setup(self) -> None:
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T

    env = self.env
    self.cfg = cfg = env.port_config()
    self.model = T.Transformer(cfg, W.build_params(self.m, env.seed,
                                                   env.device))
    env.mark("weights")
    self.prefill = ST.make_prefill_step(cfg)
    self.pool = self.pool_tokens()
    with torch.inference_mode():
      for r in range(len(self.order)):
        logits, _ = self.prefill(self.model, {"tokens": self.request(r)})
        int(torch.argmax(logits[0]))

  def window(self, seconds: float) -> dict:
    env = self.env
    ttft, logits_all, self.kept = [], [], {}
    env.sync()
    t0 = time.perf_counter()
    with torch.inference_mode():
      r = 0
      while time.perf_counter() - t0 < seconds:
        start = time.perf_counter()
        logits, caches = self.prefill(self.model,
                                      {"tokens": self.request(r)})
        tok = int(torch.argmax(logits[0]))
        ttft.append(time.perf_counter() - start)
        logits_all.append(logits[0])
        place = r % len(self.order)
        if place in self.check_places:
          self.kept[place] = (r, tok, logits[0], caches)
        r += 1
    wall = time.perf_counter() - t0
    self.window_s, self.window_requests = wall, r
    print(f"window: {r} requests, ttft ms median "
          f"{np.median(ttft) * 1e3:.2f} max {max(ttft) * 1e3:.2f}",
          file=sys.stderr)
    failed = sum(1 for lg in logits_all if not bool(torch.isfinite(lg).all()))
    return {"attempted": r, "failed": failed,
            "metrics": {"ttft_p95_ms": float(np.percentile(ttft, 95)) * 1e3}}

  def segment(self):
    n = self.t["trace_requests"]

    @torch.inference_mode()
    def run():
      for r in range(n):
        logits, _ = self.prefill(self.model, {"tokens": self.request(r)})
        int(torch.argmax(logits[0]))
    return run, n

  def layer_facts(self) -> dict:
    m = self.m
    flops = sum(Y.prefill_flops(m, self.order[r % len(self.order)])
                for r in range(self.window_requests))
    flash = [Y.flash_least_s(1, self.order[r % len(self.order)], m["heads"],
                             m["kv_heads"], m["head_dim"], m["head_dim"])
             for r in range(self.t["trace_requests"])
             for _ in range(m["layers"])]
    return {"kind": "prefill", "flops": flops, "window_s": self.window_s,
            "flash_launch_s": flash}

  def release(self) -> None:
    del self.model, self.prefill
    gc.collect()
    if self.env.cuda:
      torch.cuda.empty_cache()

  def readings(self, control: bool = False) -> dict:
    """The numbers compared, and beside them the widest readings and the
    gaps of the first tokens below the reference's best.  With
    ``control``, {"program": those, "control": the same of the reference
    in float8 put in the program's place}, from one pass of the reference.
    ``self.detail`` keeps each request's readings."""
    from chipbench.reference import model as M
    from chipbench.reference import serve as RS
    # The kept answers (request, first token, logits, caches), by request.
    picks = sorted(self.kept.values(), key=lambda a: a[0])
    prompts = [self.request(r)[0] for r, *_ in picks]
    precs = [M.F32, M.FP8] if control else [M.F32]
    got = RS.prefill(self.m, self.env.seed, prompts, self.env.device, precs,
                     keep_kv=True)
    ref = got[0]
    block = self.t["check_block"]

    def numbers(logits, toks, kv):
      gaps = torch.cat([RS.gaps(r, torch.as_tensor(t, device=r.device))
                        for r, t in zip(ref["logits"], toks)])
      errs = torch.stack([(a.float() - b).abs().max()
                          for a, b in zip(logits, ref["logits"])])
      # Each token's worst relative error of its k or v over the layers.
      tok = [torch.stack([RS.token_err(g, r, 2)
                          for layer_got, layer_ref in zip(kv, ref["kv"])
                          for g, r in zip(layer_got[j], layer_ref[j])]
                         ).amax(dim=0) for j in range(len(picks))]
      blocks = [torch.stack([b.median() for b in torch.tensor_split(
          e, max(1, e.shape[0] // block))]) for e in tok]
      flat = torch.cat(tok)
      return ({**RS.stats("token_gap", gaps), **RS.stats("logit_err", errs),
               "logit_err_q25": float(torch.quantile(errs, 0.25)),
               **RS.stats("cache_err", flat),
               "cache_err_block_max": float(torch.cat(blocks).max())},
              {"length": [int(p.shape[0]) for p in prompts],
               "logit_err": errs.tolist(),
               "cache_err_block_max": [float(b.max()) for b in blocks]})

    mine_kv = [[(a[3][layer]["k"], a[3][layer]["v"]) for a in picks]
               for layer in range(self.m["layers"])]
    program, detail = numbers([a[2] for a in picks], [a[1] for a in picks],
                              mine_kv)
    self.detail = {"program": detail}
    if not control:
      return program
    fp8 = got[1]
    out = {"program": program}
    out["control"], self.detail["control"] = numbers(
        fp8["logits"], [torch.argmax(x) for x in fp8["logits"]], fp8["kv"])
    return out
