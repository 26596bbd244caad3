"""The port's spans and device-side counters (``obs/tracing.py``,
``obs/metrics.py``): a span is one shared null context with no profiler
recording and a profiler range under one, in an ``autograd.Function``'s
backward too; a CPU-profiled train step, prefill and decode step of the
MoE smoke configurations emit every span that a per-layer reader of the
benchmark (``chipbench/metrics/``) reads, by the names held here; and the
MoE layer's slot counters equal the counts of its own dispatch tensor,
counted only while a profiler records."""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs.smoke import smoke_config  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.obs import metrics, tracing  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# The spans each step must emit: every name (or prefix) a reader in
# chipbench/metrics/ reads, by the step whose cell it is read in.
READ_SPANS = {
    "train": ("repro_optimizer_update", "repro_projection_",
              "repro_isotonic_", "repro_soft_lts_loss",
              "repro_attention_bwd", "repro_grad_accumulate"),
    "prefill": ("repro_moe_dispatch", "repro_moe_experts",
                "repro_moe_combine"),
    "decode": ("repro_decode_attention", "repro_moe_experts"),
}


@pytest.fixture
def registry(monkeypatch):
  monkeypatch.delenv(metrics.ENV_VAR, raising=False)
  metrics.set_enabled(None)
  metrics.reset()
  yield
  metrics.reset()


def _names(prof) -> set[str]:
  return {e.name for e in prof.events()}


class _Scaled(torch.autograd.Function):
  @staticmethod
  def forward(ctx, x):
    with tracing.span("repro_test_fwd"):
      return x * 2.0

  @staticmethod
  def backward(ctx, g):
    with tracing.span("repro_test_bwd"):
      return g * 2.0


@pytest.mark.parametrize("make", [
    lambda: tracing.span("repro_test"),
    lambda: tracing.backend_scope("isotonic", "l2", "stack"),
    lambda: tracing.trace_annotation("repro_test"),
], ids=["span", "backend_scope", "trace_annotation"])
def test_span_off_is_one_shared_null_context(make):
  assert not tracing.recording()
  assert make() is tracing.span("repro_other")
  with make() as entered:
    assert entered is None
  with profile(activities=[ProfilerActivity.CPU]):
    assert tracing.recording()
    assert make() is not tracing.span("repro_other")


def test_span_records_under_a_profiler_in_forward_and_backward():
  x = torch.randn(8, requires_grad=True)
  _Scaled.apply(x).sum().backward()          # nothing recording
  with profile(activities=[ProfilerActivity.CPU]) as prof:
    with tracing.span("repro_test_outer"):
      y = _Scaled.apply(x).sum()
    y.backward()
    with tracing.backend_scope("isotonic", "l2", "stack"):
      pass
  names = _names(prof)
  assert {"repro_test_outer", "repro_test_fwd", "repro_test_bwd",
          "repro_isotonic_l2_stack"} <= names
  assert torch.equal(x.grad, torch.full((8,), 4.0))


def test_held_names_are_the_readers():
  """Every repro_* name a reader reads is held above, and no other."""
  read = set()
  for path in (ROOT / "chipbench" / "metrics").glob("*.py"):
    read |= set(re.findall(r'"(repro_[a-z0-9_]*)"', path.read_text()))
  assert read == {n for names in READ_SPANS.values() for n in names}


def _tokens(cfg, shape, seed):
  gen = torch.Generator().manual_seed(seed)
  return torch.randint(0, cfg.vocab_size, shape, generator=gen)


def _train(monkeypatch):
  # The attention kernel's autograd route (forward, then
  # flash_attention_bwd), its forward the plain version: the card's path.
  monkeypatch.setattr(FA, "KERNEL_DEVICES", {"cuda", "cpu"})
  monkeypatch.setattr(FA, "_launch", lambda q, k, v, causal, window,
                      softcap, q_offset: FA.flash_attention_plain(
                          q, k, v, causal=causal, window=window,
                          softcap=softcap, q_offset=q_offset))
  cfg = dataclasses.replace(smoke_config("deepseek-v2-lite-16b"),
                            grad_accum=2, loss_trim_fraction=0.1)
  model = T.init_params(cfg, 0, "cpu").requires_grad_(True)
  opt = adamw.AdamWConfig()
  state = steps.init_opt_state(cfg, opt, dict(model.named_parameters()))
  step = steps.make_train_step(cfg, opt)
  tokens = _tokens(cfg, (4, 17), 1)
  batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
  return lambda: step(model, state, batch)


def _serve(kind):
  cfg = smoke_config("grok-1-314b")
  model = T.init_params(cfg, 0, "cpu")
  prompt = _tokens(cfg, (2, 12), 2)
  prefill = steps.make_prefill_step(cfg, 16)
  if kind == "prefill":
    return lambda: prefill(model, {"tokens": prompt})
  decode = steps.make_decode_step(cfg)
  with torch.inference_mode():
    logits, caches = prefill(model, {"tokens": prompt})
  return lambda: decode(model, caches, torch.argmax(logits, -1), 12)


@pytest.mark.parametrize("kind", sorted(READ_SPANS))
def test_profiled_step_emits_every_read_span(monkeypatch, kind):
  run = _train(monkeypatch) if kind == "train" else _serve(kind)
  with profile(activities=[ProfilerActivity.CPU]) as prof:
    if kind == "train":
      run()
    else:
      with torch.inference_mode():
        run()
  names = _names(prof)
  missing = [n for n in READ_SPANS[kind]
             if not any(m.startswith(n) for m in names)]
  assert missing == []


def test_moe_slot_counters_count_the_dispatch(monkeypatch, registry):
  cfg = dataclasses.replace(smoke_config("grok-1-314b"), moe_group_size=8)
  model = T.init_params(cfg, 0, "cpu")
  p = model.layers[0].params.tree()["ffn"]
  x = torch.randn(3, 7, cfg.d_model, generator=torch.Generator()
                  .manual_seed(3))
  got = []
  real = moe._dispatch_mask

  def kept(*args):
    out = real(*args)
    got.append(out[0])
    return out
  monkeypatch.setattr(moe, "_dispatch_mask", kept)
  with torch.no_grad():
    moe.moe_apply(p, x, cfg)                 # nothing recording
    assert metrics.counters("moe_slots") == {}
    with profile(activities=[ProfilerActivity.CPU]):
      moe.moe_apply(p, x, cfg)
      moe.moe_apply(p, x[:1], cfg)
  # Added on the device; read as ints.
  assert isinstance(metrics._counters["moe_slots_filled"], torch.Tensor)
  dispatch = got[1:]
  slots = sum(d.shape[0] * d.shape[2] * d.shape[3] for d in dispatch)
  filled = sum(int(torch.count_nonzero(d)) for d in dispatch)
  # Each taken slot holds one token: the fills, capped at capacity.
  assert filled == sum(int(d.sum()) for d in dispatch)
  assert 0 < filled < slots
  assert metrics.counters("moe_slots") == {"moe_slots": slots,
                                           "moe_slots_filled": filled}
  assert metrics.counter_value("moe_slots_filled") == filled
