"""Serving drivers: the soft-op engine and the LM prefill/decode loop.

Counterpart of ``repro.launch.serve``.  Two modes share this entry point:

* ``--engine``: the ``repro_torch.serving`` micro-batching engine for the
  soft-sort/rank op family.  A mixed-size synthetic request stream (from
  ``--engine-seed``) runs through warm-up of every (op, rows, bucket)
  cell, shape-bucketed dynamic batching and admission control, and the
  engine prints warm-up cells and seconds, served/shed, req/s, p50/p95/p99
  latency and ``aot_cache_miss``.  ``--arch`` is not needed:

    python -m repro_torch.launch.serve --engine \
        --engine-requests 500 --engine-max-batch 32

* LM mode (the default, ``--arch`` required):

    python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b \
        --batch 8 --prompt-len 512 --gen 32

  builds the model with random weights from ``--seed`` directly on the
  card in the config's dtype (``--set key=value``, repeatable, overrides a
  config field first: ``--set num_layers=6`` serves grok-1-314b cut to 6
  of its 64 layers on one card), takes the prompts from the port's
  ``TokenPipeline`` (the tokens the JAX server gets), prefills them once
  and decodes ``--gen - 1`` more tokens greedily with one position counter
  for the batch.  For the vision frontend (llava-next-mistral-7b) a
  prompt is the pipeline's patch embeddings and then its tokens, and
  ``--prompt-len`` counts both, as the pipeline's ``seq_len`` does (1088 is
  576 patches and 512 tokens; it must exceed the patches); decode starts
  at the prefill's length, not at the reference's ``prompt_len +
  num_patches``, which counts the patches twice (fault R6, ROADMAP.md §3).
  The audio frontend (musicgen-large) decodes frame embeddings, not
  tokens: as in the reference, this loop refuses it, and its steps are
  ``repro_torch.launch.steps.make_prefill_step`` / ``make_decode_step``.
  It prints the layer and parameter counts, the prefill time, the decode
  rate, the weights' bytes and the peak device memory (while building the
  weights, and while serving).

Both modes run on the card (``--device cuda``, the default, which raises
where there is none).  ``--device cpu`` runs the kernels' plain versions:
for the engine, and for ``--smoke`` LM configs only.  ``--plan FILE``
installs an execution plan (``repro_torch.plan`` JSON) for every dispatch
decision; ``--bench-json FILE`` writes a schema-v1 BENCH artifact of the
run (``python -m repro_torch.obs FILE`` validates it).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import plan as repro_plan
from repro_torch.configs.base import get_config
from repro_torch.configs.smoke import smoke_config
from repro_torch.data.pipeline import pipeline_for_arch
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as T
from repro_torch.obs import artifacts as obs_artifacts
from repro_torch.obs import metrics
from repro_torch.obs.timing import percentiles


def greedy(logits: torch.Tensor) -> torch.Tensor:
  return torch.argmax(logits, dim=-1)


def _sync(device: torch.device) -> None:
  if device.type == "cuda":
    torch.cuda.synchronize(device)


def parse_overrides(pairs) -> dict:
  """``key=value`` strings as config overrides: int, float, bool or str."""
  out = {}
  for pair in pairs or []:
    k, v = pair.split("=", 1)
    for cast in (int, float):
      try:
        out[k] = cast(v)
        break
      except ValueError:
        continue
    else:
      if v in ("True", "False"):
        out[k] = v == "True"
      else:
        out[k] = v
  return out


def resolve_device(name: str, smoke: bool,
                   program: str = "the server") -> torch.device:
  """The device of ``--device``: the card, raising where there is none;
  the CPU only for ``--smoke`` configs."""
  device = torch.device(name)
  if device.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError(f"CUDA is not available: {program} runs on the card "
                       "(pass --device cpu with --smoke to run the plain "
                       "versions on the CPU)")
  if device.type == "cpu" and not smoke:
    raise ValueError("--device cpu is for --smoke configs: a full-size "
                     "model is built on the card only")
  if device.type not in ("cpu", "cuda"):
    raise ValueError(f"unknown device {name!r}")
  return device


@torch.inference_mode()
def generate(cfg, model, prompts, gen: int) -> dict:
  """Prefill ``prompts`` (token ids (B, S), or a batch dict: tokens and,
  for vision, ``image_embeds``), then decode ``gen - 1`` steps greedily
  from the prefill's length on (for vision, patches and tokens).

  Returns the generated tokens (B, gen), the prefill logits (B, V), the
  last step's logits, and the prefill and decode wall times in seconds
  (the device synchronised around each).
  """
  batch = prompts if isinstance(prompts, dict) else {"tokens": prompts}
  if cfg.frontend == "audio":
    raise ValueError("generate decodes token ids; the audio frontend "
                     "decodes frame embeddings (launch.steps' "
                     "make_decode_step)")
  s = ST.prefill_length(cfg, batch)
  prefill = ST.make_prefill_step(cfg, s + gen)
  decode = ST.make_decode_step(cfg)
  device = batch["tokens"].device
  _sync(device)
  t0 = time.perf_counter()
  prefill_logits, caches = prefill(model, batch)
  tok = greedy(prefill_logits)
  _sync(device)
  t_prefill = time.perf_counter() - t0
  out = [tok]
  logits = prefill_logits
  t0 = time.perf_counter()
  for i in range(gen - 1):
    logits, caches = decode(model, caches, tok, s + i)
    tok = greedy(logits)
    out.append(tok)
  _sync(device)
  t_decode = time.perf_counter() - t0
  return {"tokens": torch.stack(out, dim=1), "prefill_logits": prefill_logits,
          "logits": logits, "prefill_s": t_prefill, "decode_s": t_decode}


def _mean(hists: dict) -> float:
  count = sum(h["count"] for h in hists.values())
  return sum(h["sum"] for h in hists.values()) / max(count, 1)


def run_engine(args) -> dict:
  """Drive the serving engine over a synthetic mixed-n stream.

  Returns the engine, the requests, their results in submission order and
  the numbers printed.
  """
  from repro_torch.serving import EngineConfig, ServingEngine, \
      synthetic_stream

  ops = tuple(args.engine_ops.split(","))
  cfg = EngineConfig(
      ops=ops,
      min_bucket=args.engine_min_n,
      max_bucket=args.engine_max_n,
      max_batch=args.engine_max_batch,
      max_wait_ms=args.engine_max_wait_ms,
      queue_capacity=args.engine_queue,
      default_deadline_ms=args.engine_deadline_ms,
      impl=args.impl,
      device=args.device,
  )
  engine = ServingEngine(cfg, plan=repro_plan.get_active_plan())
  t0 = time.perf_counter()
  cells = engine.warmup()
  t_warm = time.perf_counter() - t0
  print(f"[engine] warmed {cells} cells over {len(engine.policy.sizes)} "
        f"n-buckets x {len(engine.policy.row_sizes)} row-buckets on "
        f"{engine.device} in {t_warm:.2f}s")

  requests = synthetic_stream(
      args.engine_requests, seed=args.engine_seed, ops=ops,
      n_min=args.engine_min_n, n_max=args.engine_max_n,
      deadline_ms=args.engine_deadline_ms)
  misses_before = sum(metrics.counters("aot_cache_miss").values())
  t0 = time.perf_counter()
  results = engine.serve(requests)
  wall = time.perf_counter() - t0
  ok = [r for r in results if r.ok]
  shed = [r for r in results if not r.ok]
  lat = sorted(r.latency_us for r in ok) if ok else [0.0]
  p50, p95, p99 = percentiles(lat, (50, 95, 99))
  misses = sum(metrics.counters("aot_cache_miss").values()) - misses_before
  rate = len(ok) / max(wall, 1e-9)
  occupancy = _mean(metrics.histograms("serving_batch_occupancy"))
  waste = _mean(metrics.histograms("serving_padding_waste"))
  print(f"[engine] served {len(ok)}/{len(results)} requests "
        f"({len(shed)} shed) in {wall:.3f}s ({rate:.0f} req/s); "
        f"p50/p95/p99 latency {p50:.0f}/{p95:.0f}/{p99:.0f} us; "
        f"aot_cache_miss={misses}")
  print(f"[engine] mean batch occupancy {occupancy:.1f}%, mean padding "
        f"waste {waste:.1f}%")
  summary = {"warm_cells": cells, "warm_s": t_warm, "wall_s": wall,
             "req_per_s": rate, "p50_us": p50, "p95_us": p95,
             "p99_us": p99, "ok": len(ok), "shed": len(shed),
             "aot_cache_miss": misses, "occupancy_pct": occupancy,
             "padding_waste_pct": waste}

  if args.bench_json:
    obs_artifacts.write_bench_artifact(
        args.bench_json, [{
            "name": "serve/engine_stream",
            "wall_us": wall * 1e6,
            "warmup_us": t_warm * 1e6,
            "req_per_s": rate,
            "requests": len(results), "ok": len(ok), "shed": len(shed),
            "p50_us": p50, "p95_us": p95, "p99_us": p99,
            "aot_cache_miss_after_warmup": misses,
        }],
        obs_artifacts.collect_meta(
            device=engine.device, suite="serve-engine", ops=",".join(ops),
            requests=args.engine_requests, max_batch=cfg.max_batch,
            max_wait_ms=cfg.max_wait_ms, **repro_plan.plan_provenance()))
  return {"engine": engine, "requests": requests, "results": results,
          **summary}


def run_lm(args, model=None) -> dict:
  """Build (or take) the model, serve one prompt batch, print the numbers.

  Returns ``generate``'s result with the config, the model and the
  prompts added.
  """
  cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
  over = parse_overrides(args.overrides)
  if over:
    cfg = dataclasses.replace(cfg, **over)
  if cfg.frontend == "audio":
    raise SystemExit(
        "audio decode takes frame embeddings, not tokens: serve musicgen "
        "through repro_torch.launch.steps.make_prefill_step / "
        "make_decode_step (models.transformer.forward_prefill / "
        "forward_decode)")
  if cfg.frontend == "vision" and args.prompt_len <= cfg.num_patches:
    raise ValueError(
        f"--prompt-len {args.prompt_len} counts the {cfg.num_patches} "
        f"patches of {cfg.name}'s prompts: it must exceed them (e.g. "
        f"{cfg.num_patches + 512} for 512 tokens)")
  device = resolve_device(args.device, args.smoke)
  init_peak = None
  if model is None:
    if device.type == "cuda":
      torch.cuda.reset_peak_memory_stats(device)
    model = T.init_params(cfg, args.seed, device)
    if device.type == "cuda":
      # The serving peak below is then the weights plus what serving adds.
      init_peak = torch.cuda.max_memory_allocated(device)
      torch.cuda.reset_peak_memory_stats(device)
  weights = sum(p.numel() * p.element_size() for p in model.parameters())
  pipe = pipeline_for_arch(cfg, args.batch, args.prompt_len, seed=args.seed)
  arrays = pipe.batch_at(0)
  batch = {"tokens": torch.from_numpy(arrays["tokens"]).to(
      device=device, dtype=torch.int64)}
  if cfg.frontend == "vision":
    batch["image_embeds"] = torch.from_numpy(arrays["image_embeds"]).to(
        device)
  res = generate(cfg, model, batch, args.gen)
  steps = args.gen - 1
  rate = steps * args.batch / max(res["decode_s"], 1e-9)
  print(f"[serve] {cfg.name} on {device}: {cfg.num_layers} layers, "
        f"{T.count_params(model):,} parameters in {cfg.dtype}")
  parts = (f" ({cfg.num_patches} patches + "
           f"{args.prompt_len - cfg.num_patches} tokens)"
           if cfg.frontend == "vision" else "")
  print(f"[serve] prefill {args.batch}x{args.prompt_len}{parts} in "
        f"{res['prefill_s'] * 1e3:.1f} ms; {steps} decode steps in "
        f"{res['decode_s'] * 1e3:.1f} ms ({rate:.1f} tok/s)")
  print(f"[serve] weights {weights / 2**30:.2f} GiB" + (
      "" if init_peak is None else
      f"; peak {init_peak / 2**30:.2f} GiB while building them"))
  serve_peak = None
  if device.type == "cuda":
    serve_peak = torch.cuda.max_memory_allocated(device)
    print(f"[serve] max memory allocated {serve_peak / 2**30:.2f} GiB")
  print("[serve] sample generations (first 2 rows):")
  for row in res["tokens"][:2].tolist():
    print("  ", row)
  if args.bench_json:
    decode_steps = max(steps, 1)
    obs_artifacts.write_bench_artifact(
        args.bench_json, [
            {"name": "serve/prefill", "wall_us": res["prefill_s"] * 1e6,
             "batch": args.batch, "prompt_len": args.prompt_len},
            {"name": "serve/decode_step",
             "wall_us": res["decode_s"] / decode_steps * 1e6,
             "batch": args.batch, "decode_steps": decode_steps,
             "tok_per_s": rate}],
        obs_artifacts.collect_meta(
            device=device, suite="serve", arch=args.arch,
            smoke=bool(args.smoke), batch=args.batch,
            prompt_len=args.prompt_len, gen=args.gen,
            **repro_plan.plan_provenance()))
  res.update(cfg=cfg, model=model, prompts=batch["tokens"], batch=batch,
             weights_bytes=weights,
             init_peak_bytes=init_peak, serve_peak_bytes=serve_peak)
  return res


def parser() -> argparse.ArgumentParser:
  ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  ap.add_argument("--arch", default=None,
                  help="LM architecture (required unless --engine)")
  ap.add_argument("--smoke", action="store_true",
                  help="the reduced same-family config")
  ap.add_argument("--batch", type=int, default=4)
  ap.add_argument("--prompt-len", type=int, default=32,
                  help="positions a prompt fills: its tokens, and for the "
                       "vision frontend the patches before them")
  ap.add_argument("--gen", type=int, default=16)
  ap.add_argument("--seed", type=int, default=0,
                  help="seed of the random weights and the prompts")
  ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
  ap.add_argument("--set", action="append", dest="overrides",
                  metavar="KEY=VALUE",
                  help="override a config field in LM mode (repeatable), "
                       "e.g. --set num_layers=6")
  ap.add_argument("--bench-json", default=None, metavar="PATH",
                  help="write a schema-v1 BENCH artifact of the run")
  ap.add_argument("--plan", default=None, metavar="PLAN_JSON",
                  help="install an ExecutionPlan (repro_torch.plan JSON) as "
                       "the active plan for every dispatch decision")
  # The soft-op serving engine (repro_torch.serving).
  ap.add_argument("--engine", action="store_true",
                  help="serve the soft-op family through the "
                       "repro_torch.serving micro-batching engine instead "
                       "of the LM loop")
  ap.add_argument("--engine-ops",
                  default="soft_rank/l2/desc,soft_sort/l2/desc",
                  help="comma-separated repro_torch.serving.SERVING_OPS "
                       "keys")
  ap.add_argument("--engine-requests", type=int, default=500)
  ap.add_argument("--engine-seed", type=int, default=0)
  ap.add_argument("--engine-min-n", type=int, default=64)
  ap.add_argument("--engine-max-n", type=int, default=4096)
  ap.add_argument("--engine-max-batch", type=int, default=32)
  ap.add_argument("--engine-max-wait-ms", type=float, default=2.0)
  ap.add_argument("--engine-queue", type=int, default=1024)
  ap.add_argument("--engine-deadline-ms", type=float, default=None)
  ap.add_argument("--impl", default=None,
                  help="pin the isotonic backend for --engine mode")
  return ap


def main(argv=None) -> dict:
  args = parser().parse_args(argv)
  if args.plan:
    repro_plan.set_active_plan(repro_plan.load_plan(args.plan))
  if args.engine:
    return run_engine(args)
  if not args.arch:
    raise SystemExit("--arch is required unless --engine is given")
  if args.gen < 1:
    raise ValueError("--gen must be at least 1")
  return run_lm(args)


if __name__ == "__main__":
  main()
