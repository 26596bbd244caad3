"""tinyllama-1.1b against the reference: its full config's parameter
count, a narrow model with the real attention heads, and the entries of
``chip_smoke.py`` that serve and train it whole on the card.

The narrow model is the config with 2 layers, d_model 256, d_ff 256 and a
vocabulary of 512, in f32, and the real 32 query heads over 4 kv heads of
64 (G = 8, the grouping the card's tensor-core kernel runs at full size).
The reference's own random weights are carried across by
``convert.from_jax_params``; the same numpy token batches go to both.
Tolerances as in ``test_torch_dense.py``: 1e-5 * (1 + max|ref|) for
logits, caches and every gradient leaf; train-step metrics within 1e-4
relative.  The reference runs jitted, with ``REPRO_PROJECTION=composed``
(``composed_ref``).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_common import assert_close, composed_ref  # noqa: E402,F401

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.data.pipeline import pipeline_for_arch as jpipeline  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

ARCH = "tinyllama-1.1b"
PARAMS = 1_100_048_384
NARROW = dict(num_layers=2, d_model=256, d_ff=256, vocab_size=512,
              dtype="float32")
BATCH, SEQ, PROMPT, GEN, TRIM = 2, 64, 59, 5, 0.1
ROOT = Path(__file__).resolve().parents[1]
pytestmark = pytest.mark.usefixtures("composed_ref")


@pytest.fixture(scope="module")
def narrow():
  """(JAX config, port config, JAX params as numpy, port model)."""
  jcfg = dataclasses.replace(jget_config(ARCH), **NARROW)
  cfg = dataclasses.replace(get_config(ARCH), **NARROW)
  params = jax.tree.map(np.asarray,
                        jtransformer.init_params(jcfg, jax.random.PRNGKey(9)))
  return jcfg, cfg, params, convert.from_jax_params(cfg, params)


def _port_leaves(cfg, tree) -> dict:
  return dict(T.Transformer(cfg, convert.port_tree(
      cfg, jax.tree.map(np.asarray, tree))).named_parameters())


def _batch(jcfg, rows: int, step: int = 0):
  """Tokens and targets with 10% of the targets corrupted, as the trainer's
  ``--corrupt 0.1`` makes them."""
  b = jpipeline(jcfg, rows, SEQ, seed=8, corrupt_fraction=0.1).batch_at(step)
  b = {k: b[k] for k in ("tokens", "targets")}
  return ({k: jnp.asarray(v) for k, v in b.items()},
          {k: torch.from_numpy(v).long() for k, v in b.items()})


def test_full_config_parameter_count_is_the_references():
  """1,100,048,384: 22 layers of 44,044,288 (attention 9,437,184, SwiGLU
  34,603,008, two norm scales), the table and the untied head of 32000 x
  2048 each, the final norm; the port's on the meta device, the
  reference's from ``jax.eval_shape`` of its init."""
  cfg = get_config(ARCH)
  model = T.init_params(cfg, 0, "meta")
  assert T.count_params(model) == PARAMS
  assert hasattr(model, "lm_head") and not cfg.tie_embeddings
  shapes = jax.eval_shape(lambda: jtransformer.init_params(
      jget_config(ARCH), jax.random.PRNGKey(0)))
  assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes)) == \
      PARAMS
  layer = sum(p.numel() for p in model.layers[0].parameters())
  assert layer == 44_044_288
  assert 22 * layer + 2 * 32000 * 2048 + 2048 == PARAMS


def test_narrow_model_keeps_the_real_heads(narrow):
  _, cfg, params, model = narrow
  assert (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) == (32, 4, 64)
  assert T.count_params(model) == sum(a.size for a in
                                      jax.tree.leaves(params))
  wq = model.layers[0].params.tree()["attn"]["wq"]
  assert tuple(wq.shape) == (256, 32, 64) and wq.dtype == torch.float32


def test_prefill_and_decode_match_the_reference(narrow):
  """The prefill's last-position logits and caches, then 4 greedy decode
  steps to position 63: logits at every step, the tokens, the caches."""
  jcfg, cfg, params, model = narrow
  tokens = jpipeline(jcfg, BATCH, PROMPT, seed=3).batch_at(0)["tokens"]
  prefill = jax.jit(jsteps.make_prefill_step(jcfg, PROMPT + GEN))
  decode = jax.jit(jsteps.make_decode_step(jcfg))
  logits, jcaches = prefill(params, {"tokens": jnp.asarray(tokens)})
  want_caches = jax.tree.map(np.asarray, jcaches)
  tok = jnp.argmax(logits, -1)
  want = [np.asarray(logits)]
  want_tokens = [np.asarray(tok)]
  for i in range(GEN - 1):
    logits, jcaches = decode(params, jcaches, tok, jnp.int32(PROMPT + i))
    tok = jnp.argmax(logits, -1)
    want.append(np.asarray(logits))
    want_tokens.append(np.asarray(tok))
  with torch.inference_mode():
    got, caches = steps.make_prefill_step(cfg, PROMPT + GEN)(
        model, {"tokens": torch.from_numpy(tokens)})
    for i, cache in enumerate(caches):
      for key in ("k", "v"):
        w = want_caches[0]["l0_dense"][key][i]
        assert tuple(cache[key].shape) == w.shape == (BATCH, SEQ, 4, 64)
        assert_close(cache[key], w, w)
    got_logits, got_tokens = [got], [serve.greedy(got)]
    step = steps.make_decode_step(cfg)
    for i in range(GEN - 1):
      got, caches = step(model, caches, got_tokens[-1], PROMPT + i)
      got_logits.append(got)
      got_tokens.append(serve.greedy(got))
  for g, w in zip(got_logits, want):
    assert g.shape == w.shape == (BATCH, 512)
    assert_close(g, w, w)
  np.testing.assert_array_equal(torch.stack(got_tokens, 1).numpy(),
                                np.stack(want_tokens, 1))


def test_trimmed_loss_gradients_match_the_reference(narrow):
  """The soft-LTS token loss (trim 0.1) over a batch of 2 x 64 and its
  gradient on every leaf, against ``jax.grad`` of the reference's
  ``loss_from_batch``."""
  jcfg, cfg, params, _ = narrow
  jcfg = dataclasses.replace(jcfg, loss_trim_fraction=TRIM)
  cfg = dataclasses.replace(cfg, loss_trim_fraction=TRIM)
  jb, tb = _batch(jcfg, BATCH)
  (want_total, _), want_g = jax.jit(jax.value_and_grad(
      lambda p: jsteps.loss_from_batch(jcfg, p, jb), has_aux=True))(params)
  model = convert.from_jax_params(cfg, params).requires_grad_(True)
  total, _ = steps.loss_from_batch(cfg, model, tb)
  np.testing.assert_allclose(float(total.detach()), float(want_total),
                             rtol=1e-5)
  names, leaves = zip(*model.named_parameters())
  grads = dict(zip(names, torch.autograd.grad(total, leaves)))
  want = _port_leaves(cfg, want_g)
  assert sorted(want) == sorted(grads) and "lm_head.w" in grads
  for name, g in grads.items():
    assert bool(torch.any(g != 0)), name
    assert_close(g, want[name], want[name])


def test_train_step_at_the_configs_accumulation_matches_the_reference(
    narrow):
  """One train step as the card takes it, grad_accum 4 and remat "full"
  (the config's), trim 0.1, on 4 x 64: loss, grad norm and clip scale
  against the reference's jitted step within 1e-4 relative."""
  jcfg, cfg, params, _ = narrow
  assert (cfg.grad_accum, cfg.remat) == (4, "full")
  jcfg = dataclasses.replace(jcfg, loss_trim_fraction=TRIM)
  cfg = dataclasses.replace(cfg, loss_trim_fraction=TRIM)
  jopt, opt = jadamw.AdamWConfig(lr=1e-3), adamw.AdamWConfig(lr=1e-3)
  jb, tb = _batch(jcfg, 4, step=1)
  _, _, want = jax.jit(jsteps.make_train_step(jcfg, jopt))(
      params, jsteps.init_opt_state(jcfg, jopt, params), jb)
  model = convert.from_jax_params(cfg, params).requires_grad_(True)
  state = steps.init_opt_state(cfg, opt, dict(model.named_parameters()))
  _, _, got = steps.make_train_step(cfg, opt)(model, state, tb)
  for key in ("loss", "grad_norm", "clip_scale"):
    np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-4,
                               atol=0, err_msg=key)
  assert math.isfinite(float(got["loss"]))


def _chip_smoke():
  spec = importlib.util.spec_from_file_location("chip_smoke_entries",
                                                ROOT / "chip_smoke.py")
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def test_chip_smoke_entries_agree_with_the_config():
  """The serve run: the config's shape, the untied head, the parameter
  count, the error key of (64, 64) at G 8, and phase 3's cases at its
  prefill and training shapes; the train run: the config, the attention
  shapes of a microbatch and the launches a step (176 flash, 4 pav_l2)."""
  cs = _chip_smoke()
  cfg = get_config(ARCH)
  run = cs.FULL_SERVE_RUNS[ARCH]
  assert run["shape"] == (cfg.num_layers, cfg.d_model, cfg.num_heads,
                          cfg.num_kv_heads, cfg.head_dim, cfg.d_ff,
                          cfg.vocab_size, cfg.window_size, cfg.mlp_variant,
                          cfg.norm, cfg.tie_embeddings)
  assert run["params"] == PARAMS and run["prompt"] == cs.SERVE_PROMPT
  assert run["err_key"] == "flash_attention 64x64 G8"
  cases = {c[:5] for c in cs.TINYLLAMA_ATTN_CASES}
  assert (cs.SERVE_BATCH, cs.SERVE_PROMPT, cs.SERVE_PROMPT, 32, 4) in cases
  micro = cs.TRAIN_BATCH // cfg.grad_accum
  assert (micro, cs.TRAIN_SEQ, cs.TRAIN_SEQ, 32, 4) in cases
  train = cs.TRAIN_RUNS[ARCH]
  assert train["config"] == (cfg.num_layers, cfg.d_model, cfg.grad_accum,
                             cfg.remat, cfg.dtype)
  assert train["attn"] == ((micro, cs.TRAIN_SEQ, 32, 64),
                           (micro, cs.TRAIN_SEQ, 4, 64))
  trimmed = dataclasses.replace(cfg, loss_trim_fraction=0.1)
  assert cs.train_launches_per_step(trimmed) == {
      "pav_l2": 4, "pav_kl": 0, "soft_topk_gates": 0,
      "flash_attention": 22 * 4 * 2, "flash_attention_simt": 0,
      "decode_attention": 0}
