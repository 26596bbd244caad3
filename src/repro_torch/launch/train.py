"""Training driver with checkpoints, preemption handling and straggler flags.

Counterpart of ``repro.launch.train``:

    python -m repro_torch.launch.train --arch deepseek-v2-lite-16b \
        --set num_layers=4 --batch 8 --seq 2048 --trim-frac 0.1 \
        --corrupt 0.1 --steps 4

builds the model with random weights from ``--seed`` on the card in the
config's dtype and takes AdamW steps (cosine schedule with warm-up) on the
port's ``TokenPipeline`` batches, eagerly.  ``--trim-frac`` turns on the
soft least-trimmed-squares token loss (paper §6.4, on the PAV kernel),
``--corrupt`` the pipeline's label noise, ``--compress-grads`` the int8
error-feedback round trip, ``--set key=value`` any config field (so
``--set num_layers=4`` cuts the depth).  With ``--ckpt-dir`` it saves
asynchronously every ``--ckpt-every`` steps and synchronously at the end
(also on SIGTERM or SIGINT), and resumes from the latest checkpoint on
start.  Steps slower than twice the rolling median are flagged as
stragglers.  The model runs on the card (``--device cuda``, the default,
which raises where there is none); ``--device cpu`` runs the kernels'
plain versions and is for ``--smoke`` configs only.  ``--plan FILE``
installs an execution plan (``repro_torch.plan`` JSON) for every dispatch
decision; ``--bench-json FILE`` writes a schema-v1 BENCH artifact of the
step times (``Trainer.bench_results``) at the end.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import signal
import statistics
import time

import torch
from torch.profiler import record_function

from repro_torch import plan as repro_plan
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs.base import get_config
from repro_torch.configs.smoke import smoke_config
from repro_torch.data.pipeline import pipeline_for_arch
from repro_torch.launch import steps as ST
from repro_torch.launch.serve import resolve_device
from repro_torch.models import transformer as T
from repro_torch.obs import artifacts as obs_artifacts
from repro_torch.obs import metrics as obs_metrics
from repro_torch.optim import adamw
from repro_torch.optim.schedule import cosine_with_warmup


@dataclasses.dataclass
class TrainerState:
  model: T.Transformer
  opt_state: dict
  step: int


def _sync(device: torch.device) -> None:
  if device.type == "cuda":
    torch.cuda.synchronize(device)


class Trainer:

  def __init__(self, cfg, opt_cfg, *, batch: int, seq: int,
               ckpt_dir: str | None = None, ckpt_every: int = 50,
               compress_grads: bool = False, total_steps: int = 1000,
               corrupt_fraction: float = 0.0, seed: int = 0,
               device: str = "cuda", smoke: bool = False):
    """``device`` as ``--device`` reads it: the card by default, raising
    where there is none; the CPU only where ``smoke`` says ``cfg`` is a
    smoke config."""
    self.device = resolve_device(str(device), smoke, "the trainer")
    self.cfg = cfg
    self.opt_cfg = opt_cfg
    self.seed = seed
    self.pipeline = pipeline_for_arch(
        cfg, batch, seq, seed=seed, corrupt_fraction=corrupt_fraction)
    self.ckpt_dir = ckpt_dir
    self.ckpt_every = ckpt_every
    self.async_ckpt = (ckpt.AsyncCheckpointer(ckpt_dir)
                       if ckpt_dir else None)
    self.total_steps = total_steps
    sched = functools.partial(
        cosine_with_warmup, warmup=min(100, total_steps // 10 + 1),
        total=total_steps)
    self.train_step = ST.make_train_step(
        cfg, opt_cfg, lr_schedule=sched, compress_grads=compress_grads)
    self.compress_grads = compress_grads
    self._preempted = False
    self._step_times: list[float] = []
    self.straggler_factor = 2.0
    self.straggler_events = 0

  # -- lifecycle ----------------------------------------------------------

  def _tree(self, state: TrainerState) -> dict:
    return {"params": dict(state.model.named_parameters()),
            "opt": state.opt_state}

  def init_or_restore(self) -> TrainerState:
    """A fresh model and optimizer state, or the latest checkpoint's."""
    model = T.init_params(self.cfg, self.seed, self.device)
    model.requires_grad_(True)
    opt_state = ST.init_opt_state(self.cfg, self.opt_cfg,
                                  dict(model.named_parameters()),
                                  compress_grads=self.compress_grads)
    state = TrainerState(model, opt_state, 0)
    if self.ckpt_dir and ckpt.latest_step(self.ckpt_dir) is not None:
      restored, meta = ckpt.restore(self.ckpt_dir, self._tree(state),
                                    map_location=self.device)
      with torch.no_grad():
        for name, p in model.named_parameters():
          p.copy_(restored["params"][name])
      state = TrainerState(model, restored["opt"], int(meta["step"]))
      print(f"[train] resumed from step {state.step}")
    return state

  def install_preemption_handler(self) -> dict:
    """SIGTERM and SIGINT end the run after the current step, with a final
    checkpoint.  Returns the handlers replaced, by signal."""
    def handler(signum, frame):
      print(f"[train] caught signal {signum}: checkpoint-and-exit")
      self._preempted = True
    return {sig: signal.signal(sig, handler)
            for sig in (signal.SIGTERM, signal.SIGINT)}

  def maybe_flag_straggler(self, dt: float):
    self._step_times.append(dt)
    window = self._step_times[-32:]
    if len(window) >= 8:
      med = statistics.median(window)
      if dt > self.straggler_factor * med:
        self.straggler_events += 1
        print(f"[train] straggler step: {dt*1e3:.0f} ms vs median "
              f"{med*1e3:.0f} ms (event #{self.straggler_events})")

  @property
  def step_times(self) -> list[float]:
    """Seconds of each step taken, in order."""
    return list(self._step_times)

  # -- main loop ----------------------------------------------------------

  def batch_at(self, step: int) -> dict[str, torch.Tensor]:
    """The pipeline's batch of ``step`` on the device, ids as int64."""
    return {k: torch.from_numpy(v).to(device=self.device, dtype=torch.int64)
            for k, v in self.pipeline.batch_at(step).items()
            if k != "corrupt_mask"}

  def run(self, state: TrainerState, num_steps: int):
    metrics = {}
    for step in range(state.step, min(state.step + num_steps,
                                      self.total_steps)):
      if self._preempted:
        break
      batch = self.batch_at(step)
      _sync(self.device)
      t0 = time.perf_counter()
      with record_function("repro_train_step"):
        _, state.opt_state, metrics = self.train_step(
            state.model, state.opt_state, batch)
        loss = float(metrics["loss"])
      dt = time.perf_counter() - t0
      obs_metrics.observe("train_step_us", dt * 1e6)
      self.maybe_flag_straggler(dt)
      state.step = step + 1
      print(f"[train] step {step:5d} loss {loss:.4f} "
            f"gnorm {float(metrics['grad_norm']):.3f} ({dt*1e3:.0f} ms)")
      if self.async_ckpt and state.step % self.ckpt_every == 0:
        self.async_ckpt.save(state.step, self._tree(state),
                             {"step": state.step})
    # final (synchronous) checkpoint, also the preemption path
    if self.async_ckpt:
      self.async_ckpt.wait()
      ckpt.save(self.ckpt_dir, state.step, self._tree(state),
                {"step": state.step})
    return state, metrics

  def bench_results(self, final_metrics) -> list[dict]:
    """The run's step times as schema-v1 BENCH results."""
    times = sorted(self._step_times)
    if not times:
      return []
    median = times[len(times) // 2]
    return [{
        "name": "train/step",
        "median_step_us": median * 1e6,
        "p90_step_us": times[min(len(times) - 1,
                                 int(len(times) * 0.9))] * 1e6,
        "steps_timed": len(times),
        "straggler_events": self.straggler_events,
        "final_loss": float(final_metrics.get("loss", float("nan"))),
    }]


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


def parser() -> argparse.ArgumentParser:
  ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  ap.add_argument("--arch", required=True)
  ap.add_argument("--smoke", action="store_true",
                  help="the reduced same-family config")
  ap.add_argument("--steps", type=int, default=100)
  ap.add_argument("--batch", type=int, default=8)
  ap.add_argument("--seq", type=int, default=128)
  ap.add_argument("--lr", type=float, default=3e-4)
  ap.add_argument("--trim-frac", type=float, default=0.0)
  ap.add_argument("--router", default=None)
  ap.add_argument("--corrupt", type=float, default=0.0)
  ap.add_argument("--compress-grads", action="store_true")
  ap.add_argument("--ckpt-dir", default=None)
  ap.add_argument("--ckpt-every", type=int, default=50)
  ap.add_argument("--seed", type=int, default=0,
                  help="seed of the random weights and the batches")
  ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
  ap.add_argument("--bench-json", default=None, metavar="PATH",
                  help="write a schema-v1 BENCH artifact (step-time "
                       "distribution + dispatch metrics) on exit")
  ap.add_argument("--plan", default=None, metavar="PLAN_JSON",
                  help="install an ExecutionPlan (repro_torch.plan JSON) as "
                       "the active plan for every dispatch decision")
  ap.add_argument("--set", action="append", dest="overrides")
  return ap


def main(argv=None) -> dict:
  """Run the trainer; returns the config, the trainer, its final state and
  the last step's metrics."""
  args = parser().parse_args(argv)
  if args.plan:
    repro_plan.set_active_plan(repro_plan.load_plan(args.plan))
  cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
  over = parse_overrides(args.overrides)
  if args.trim_frac:
    over["loss_trim_fraction"] = args.trim_frac
  if args.router:
    over["router"] = args.router
  if over:
    cfg = dataclasses.replace(cfg, **over)
  opt_cfg = adamw.AdamWConfig(lr=args.lr)
  trainer = Trainer(cfg, opt_cfg, batch=args.batch, seq=args.seq,
                    ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                    compress_grads=args.compress_grads,
                    total_steps=args.steps, corrupt_fraction=args.corrupt,
                    seed=args.seed, device=args.device, smoke=args.smoke)
  device = trainer.device
  replaced = trainer.install_preemption_handler()
  try:
    if device.type == "cuda":
      torch.cuda.reset_peak_memory_stats(device)
    state = trainer.init_or_restore()
    print(f"[train] {cfg.name} on {device}: "
          f"{T.count_params(state.model):,} parameters in {cfg.dtype}, "
          f"{cfg.num_layers} layers, remat {cfg.remat}, grad_accum "
          f"{cfg.grad_accum}")
    state, metrics = trainer.run(state, args.steps)
  finally:
    for sig, previous in replaced.items():
      signal.signal(sig, previous)
  print(f"[train] done at step {state.step}; "
        f"final loss {float(metrics.get('loss', float('nan'))):.4f}; "
        f"stragglers {trainer.straggler_events}")
  if device.type == "cuda":
    print(f"[train] max memory allocated "
          f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
  if args.bench_json:
    obs_artifacts.write_bench_artifact(
        args.bench_json, trainer.bench_results(metrics),
        obs_artifacts.collect_meta(
            device=device, suite="train", arch=args.arch,
            smoke=bool(args.smoke), batch=args.batch, seq=args.seq,
            steps=state.step, **repro_plan.plan_provenance()))
  return {"cfg": cfg, "trainer": trainer, "state": state,
          "metrics": metrics}


if __name__ == "__main__":
  main()
