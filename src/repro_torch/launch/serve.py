"""LM server: prefill a prompt batch, then decode greedily.

Counterpart of ``repro.launch.serve`` in LM mode (the default there):

    python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b \
        --batch 8 --prompt-len 512 --gen 32

builds the model with random weights from ``--seed`` directly on the card
in the config's dtype, takes the prompts from the port's ``TokenPipeline``
(the tokens the JAX server gets), prefills them once and decodes
``--gen - 1`` more tokens greedily with one position counter for the
batch.  It prints the prefill time, the decode rate, the parameter count
and the peak device memory.  The model runs on the card (``--device
cuda``, the default, which raises where there is none); ``--device cpu``
runs the plain versions of the kernels and is for ``--smoke`` configs
only.  The reference's ``--engine`` mode (the soft-op serving engine) is
not ported yet.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import get_config
from repro_torch.configs.smoke import smoke_config
from repro_torch.data.pipeline import pipeline_for_arch
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as T


def greedy(logits: torch.Tensor) -> torch.Tensor:
  return torch.argmax(logits, dim=-1)


def _sync(device: torch.device) -> None:
  if device.type == "cuda":
    torch.cuda.synchronize(device)


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
def generate(cfg, model, tokens: torch.Tensor, gen: int) -> dict:
  """Prefill ``tokens`` (B, S), then decode ``gen - 1`` steps greedily.

  Returns the generated tokens (B, gen), the prefill logits (B, V), the
  last step's logits, and the prefill and decode wall times in seconds
  (the device synchronised around each).
  """
  b, s = tokens.shape
  prefill = ST.make_prefill_step(cfg, s + gen)
  decode = ST.make_decode_step(cfg)
  device = tokens.device
  _sync(device)
  t0 = time.perf_counter()
  prefill_logits, caches = prefill(model, {"tokens": tokens})
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


def run_lm(args, model=None) -> dict:
  """Build (or take) the model, serve one prompt batch, print the numbers.

  Returns ``generate``'s result with the config, the model and the
  prompts added.
  """
  cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
  device = resolve_device(args.device, args.smoke)
  if model is None:
    if device.type == "cuda":
      torch.cuda.reset_peak_memory_stats(device)
    model = T.init_params(cfg, args.seed, device)
  pipe = pipeline_for_arch(cfg, args.batch, args.prompt_len, seed=args.seed)
  tokens = torch.from_numpy(pipe.batch_at(0)["tokens"]).to(
      device=device, dtype=torch.int64)
  res = generate(cfg, model, tokens, args.gen)
  steps = args.gen - 1
  rate = steps * args.batch / max(res["decode_s"], 1e-9)
  print(f"[serve] {cfg.name} on {device}: {T.count_params(model):,} "
        f"parameters in {cfg.dtype}")
  print(f"[serve] prefill {args.batch}x{args.prompt_len} in "
        f"{res['prefill_s'] * 1e3:.1f} ms; {steps} decode steps in "
        f"{res['decode_s'] * 1e3:.1f} ms ({rate:.1f} tok/s)")
  if device.type == "cuda":
    print(f"[serve] max memory allocated "
          f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
  print("[serve] sample generations (first 2 rows):")
  for row in res["tokens"][:2].tolist():
    print("  ", row)
  res.update(cfg=cfg, model=model, prompts=tokens)
  return res


def parser() -> argparse.ArgumentParser:
  ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  ap.add_argument("--arch", required=True, help="LM architecture")
  ap.add_argument("--smoke", action="store_true",
                  help="the reduced same-family config")
  ap.add_argument("--batch", type=int, default=4)
  ap.add_argument("--prompt-len", type=int, default=32)
  ap.add_argument("--gen", type=int, default=16)
  ap.add_argument("--seed", type=int, default=0,
                  help="seed of the random weights and the prompts")
  ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
  ap.add_argument("--engine", action="store_true",
                  help="the soft-op serving engine (not ported yet)")
  return ap


def main(argv=None) -> dict:
  args = parser().parse_args(argv)
  if args.engine:
    raise NotImplementedError("--engine (the soft-op serving engine) is not "
                              "ported yet (ROADMAP.md, queue 1: --engine "
                              "serving)")
  if args.gen < 1:
    raise ValueError("--gen must be at least 1")
  return run_lm(args)


if __name__ == "__main__":
  main()
