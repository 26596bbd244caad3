"""stablelm-3b (LayerNorm, the GELU MLP, attention at G = 1) against the
reference.

``smoke_config("stablelm-3b")`` (2 ``dense`` layers of 4 heads over 4 kv
heads, LayerNorm with a bias, the non-gated GELU MLP, an untied head) in
f32, with the reference's own random weights carried across by
``from_jax_params`` and the same numpy inputs and token batches:
LayerNorm (a row with a large mean among them, where PyTorch's default
n - 1 variance would show), the GELU MLP, the attention layer and one
decode step, a whole layer, the training pass (per-token loss and the
gradient of every leaf against ``jax.grad``), prefill and 6 greedy decode
steps.  Also the configs, the parameter counts (at smoke size, and at full
width from the reference's ``eval_shape``: 2,229,212,160), the seeded
init's leaves and the command lines.  The reference runs jitted, with
``REPRO_PROJECTION=composed`` (``composed_ref``).  Tolerance: 1e-5 * (1 +
max|ref|) (``test_torch_common.assert_close`` scaled by the wanted value).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_common import (  # noqa: E402
    as_torch,
    assert_close,
    composed_ref,  # noqa: F401
)

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.smoke import smoke_config as jsmoke_config  # noqa: E402
from repro.data.pipeline import pipeline_for_arch as jpipeline  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.configs.smoke import smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve, steps, train  # noqa: E402
from repro_torch.models import convert, layers  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCH = "stablelm-3b"
BATCH, SEQ, PROMPT, GEN = 2, 24, 19, 7
pytestmark = pytest.mark.usefixtures("composed_ref")


@pytest.fixture(scope="module")
def smoke():
  """(JAX config, port config, JAX params as numpy, port model)."""
  jcfg, cfg = jsmoke_config(ARCH), smoke_config(ARCH)
  params = jax.tree.map(np.asarray,
                        jtransformer.init_params(jcfg, jax.random.PRNGKey(5)))
  return jcfg, cfg, params, convert.from_jax_params(cfg, params)


def _layer(params, i):
  """Layer i of the reference's one segment of ``dense`` layers."""
  return jax.tree.map(lambda a: jnp.asarray(a[i]), params["seg0"]["l0_dense"])


def _port_leaves(cfg, tree) -> dict:
  """A pytree in the reference's layout, by the port's parameter names."""
  return dict(T.Transformer(cfg, convert.port_tree(
      cfg, jax.tree.map(np.asarray, tree))).named_parameters())


@pytest.mark.parametrize("smoke_", [False, True], ids=["full", "smoke"])
def test_configs_are_the_references(smoke_):
  want = jsmoke_config(ARCH) if smoke_ else jget_config(ARCH)
  got = smoke_config(ARCH) if smoke_ else get_config(ARCH)
  assert dataclasses.asdict(got) == dataclasses.asdict(want)
  assert got.plan_segments() == want.plan_segments()
  assert (got.norm, got.mlp_variant, got.tie_embeddings) == (
      "layernorm", "gelu", False)
  assert (got.head_dim, got.num_heads, got.num_kv_heads) == (
      (16, 4, 4) if smoke_ else (80, 32, 32))


def test_smoke_has_the_references_parameter_count(smoke):
  """The port's seeded smoke model and the reference's tree hold the same
  parameters, LayerNorm biases and the untied head among them."""
  _, cfg, params, _ = smoke
  model = T.init_params(cfg, 0)
  assert T.count_params(model) == jtransformer.count_params(params) == 98_944
  assert hasattr(model, "lm_head") and "lm_head" in params


def test_full_width_parameter_count_is_the_references():
  """The port's shapes on the meta device against the reference's
  ``eval_shape``: 32 layers, the untied head, f32 norm leaves."""
  want = 2_229_212_160
  shapes = jax.eval_shape(lambda: jtransformer.init_params(
      jget_config(ARCH), jax.random.PRNGKey(0)))
  assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes)) == want
  model = T.init_params(get_config(ARCH), 0, "meta")
  assert T.count_params(model) == want
  assert {p.dtype for n, p in model.named_parameters()
          if "norm" not in n} == {torch.bfloat16}
  assert {p.dtype for n, p in model.named_parameters()
          if "norm" in n} == {torch.float32}


def test_seeded_init_has_the_layernorm_and_gelu_leaves():
  """``init_params`` builds LayerNorm's scale (ones) and bias (zeros) in
  f32 for both norms of every layer and the final norm, and the GELU MLP's
  two matrices (no gate), with the reference's scales."""
  cfg = smoke_config(ARCH)
  model = T.init_params(cfg, 0)
  for layer in model.layers:
    tree = layer.params.tree()
    assert sorted(tree) == ["attn", "ffn", "norm1", "norm2"]
    assert sorted(tree["ffn"]) == ["w_in", "w_out"]
    for norm in ("norm1", "norm2"):
      assert torch.equal(tree[norm]["scale"], torch.ones(cfg.d_model))
      assert torch.equal(tree[norm]["bias"], torch.zeros(cfg.d_model))
    assert abs(float(tree["ffn"]["w_in"].std()) * cfg.d_model**0.5 - 1) < 0.1
    assert abs(float(tree["ffn"]["w_out"].std()) * cfg.d_ff**0.5 - 1) < 0.1
  assert sorted(model.final_norm.tree()) == ["bias", "scale"]


def test_convert_carries_the_layernorm_biases(smoke):
  _, cfg, params, model = smoke
  assert len(model.layers) == cfg.num_layers == 2
  for i, layer in enumerate(model.layers):
    tree = layer.params.tree()
    want = _layer(params, i)
    for norm in ("norm1", "norm2"):
      for leaf in ("scale", "bias"):
        np.testing.assert_array_equal(tree[norm][leaf].numpy(),
                                      np.asarray(want[norm][leaf]))
    assert sorted(tree["ffn"]) == sorted(want["ffn"]) == ["w_in", "w_out"]
  np.testing.assert_array_equal(model.final_norm.bias.numpy(),
                                params["final_norm"]["bias"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
  """(x - mean) * rsqrt(var + eps) * scale + bias in f32, returned in the
  input's dtype, over random rows and a row with a mean of 1000 and a
  spread of 1, where the sample variance (n - 1) would move the output by
  far more than the tolerance; random scale and bias."""
  rng = np.random.default_rng(81)
  x = rng.normal(size=(3, 5, 64))
  x[1, 2] = 1000.0 + rng.normal(size=64)
  p = {"scale": rng.normal(size=64), "bias": rng.normal(size=64)}
  jd, td = getattr(jnp, dtype), getattr(torch, dtype)
  want = jax.jit(lambda q, a: jlayers.norm_apply(q, a, "layernorm"))(
      {k: jnp.asarray(v, jnp.float32) for k, v in p.items()},
      jnp.asarray(x, jd))
  got = layers.norm_apply({k: as_torch(v) for k, v in p.items()},
                          as_torch(x, td), "layernorm")
  assert got.dtype == td
  assert_close(got, want, want, contract=1e-5 if dtype == "float32" else 1e-2)
  if dtype == "float32":
    xf = as_torch(x)
    sample = ((xf - xf.mean(-1, keepdim=True))
              * torch.rsqrt(xf.var(-1, keepdim=True) + 1e-6)
              * as_torch(p["scale"]) + as_torch(p["bias"]))
    assert float((sample - got).abs().max()) > 1e-3


def test_gelu_mlp_matches_reference(smoke):
  """gelu_tanh(x w_in) w_out, over a sequence and a decode batch."""
  _, cfg, params, model = smoke
  rng = np.random.default_rng(82)
  p = model.layers[1].params.tree()["ffn"]
  for shape in ((2, 7), (3,)):
    x = rng.normal(size=shape + (cfg.d_model,))
    want = jax.jit(lambda q, a: jlayers.mlp_apply(q, a, "gelu"))(
        _layer(params, 1)["ffn"], jnp.asarray(x, jnp.float32))
    got = layers.mlp_apply(p, as_torch(x), "gelu")
    assert_close(got, want, want)


def test_attention_layer_and_decode_match_reference(smoke):
  """Attention at G = 1 over a sequence (k after RoPE and v, the cache,
  too) and one decode step at position 13 of a 24-position cache."""
  jcfg, cfg, params, model = smoke
  rng = np.random.default_rng(83)
  x = rng.normal(size=(2, SEQ, cfg.d_model))
  p = model.layers[0].params.tree()["attn"]
  want, (want_k, want_v) = jax.jit(lambda q, a: jlayers.attn_apply_seq(
      q, a, jnp.arange(SEQ), jcfg, return_kv=True))(
          _layer(params, 0)["attn"], jnp.asarray(x, jnp.float32))
  got, (got_k, got_v) = layers.attn_apply_seq(
      p, as_torch(x), torch.arange(SEQ), cfg, return_kv=True)
  for g, w in ((got, want), (got_k, want_k), (got_v, want_v)):
    assert_close(g, w, w)
  shape = (2, SEQ, cfg.num_kv_heads, cfg.head_dim)
  cache = {"k": rng.normal(size=shape), "v": rng.normal(size=shape)}
  xd = rng.normal(size=(2, cfg.d_model))
  want, want_cache = jax.jit(lambda q, a, c: jlayers.attn_apply_decode(
      q, a, c, jnp.int32(13), jcfg))(
          _layer(params, 0)["attn"], jnp.asarray(xd, jnp.float32),
          jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), cache))
  got, got_cache = layers.attn_apply_decode(
      p, as_torch(xd), {k: as_torch(a) for k, a in cache.items()}, 13, cfg)
  assert_close(got, want, want)
  for key in cache:
    assert_close(got_cache[key], want_cache[key], want_cache[key])


def test_layer_matches_reference(smoke):
  """A whole block (LayerNorm, attention, LayerNorm, GELU MLP, residuals)
  over the sequence with its cache, and one decode step, with non-trivial
  norm scales and biases."""
  jcfg, cfg, params, model = smoke
  rng = np.random.default_rng(84)
  lp = jax.tree.map(np.array, _layer(params, 1))
  for norm in ("norm1", "norm2"):
    lp[norm]["scale"] = rng.normal(size=cfg.d_model).astype(np.float32)
    lp[norm]["bias"] = rng.normal(size=cfg.d_model).astype(np.float32)
  layer = T.Layer(cfg, jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                                    lp), "dense")
  x = rng.normal(size=(2, SEQ, cfg.d_model))
  want, _, want_cache = jax.jit(lambda q, a: jtransformer._layer_apply_seq(
      q, a, jnp.arange(SEQ), jcfg, "dense", collect_cache=True))(
          lp, jnp.asarray(x, jnp.float32))
  got, aux, got_cache = layer.apply_seq(as_torch(x), torch.arange(SEQ),
                                        collect_cache=True)
  assert float(aux) == 0.0
  assert_close(got, want, want)
  for key in ("k", "v"):
    assert_close(got_cache[key], want_cache[key], want_cache[key])
  shape = (2, SEQ + 4, cfg.num_kv_heads, cfg.head_dim)
  cache = {"k": rng.normal(size=shape), "v": rng.normal(size=shape)}
  xd = rng.normal(size=(2, cfg.d_model))
  want, _ = jax.jit(lambda q, a, c: jtransformer._layer_apply_decode(
      q, a, c, jnp.int32(SEQ), jcfg, "dense"))(
          lp, jnp.asarray(xd, jnp.float32),
          jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), cache))
  got, _ = layer.apply_decode(as_torch(xd),
                              {k: as_torch(a) for k, a in cache.items()}, SEQ)
  assert_close(got, want, want)


def test_forward_train_and_gradients_match_reference(smoke):
  """The per-token loss over 2 x 24 tokens and the gradient of its mean
  on every leaf, LayerNorm biases and the untied head among them, against
  ``jax.grad`` of the reference's."""
  jcfg, cfg, params, _ = smoke
  b = jpipeline(jcfg, BATCH, SEQ, seed=4, corrupt_fraction=0.1).batch_at(0)
  jb = {k: jnp.asarray(b[k]) for k in ("tokens", "targets")}
  tb = {k: torch.from_numpy(b[k]).long() for k in ("tokens", "targets")}

  def mean_loss(p):
    tl, aux = jtransformer.forward_train(jcfg, p, jb)
    return jnp.mean(tl) + 0.01 * aux, tl

  (_, want_tl), want_g = jax.jit(jax.value_and_grad(mean_loss,
                                                    has_aux=True))(params)
  model = convert.from_jax_params(cfg, params).requires_grad_(True)
  loss, aux = T.forward_train(cfg, model, tb)
  assert loss.shape == (BATCH, SEQ) and float(aux) == 0.0
  assert_close(loss, want_tl, want_tl)
  names, leaves = zip(*model.named_parameters())
  grads = dict(zip(names, torch.autograd.grad(torch.mean(loss), leaves)))
  want = _port_leaves(cfg, want_g)
  assert sorted(want) == sorted(grads)
  assert "lm_head.w" in grads and "final_norm.bias" in grads
  for name, g in grads.items():
    assert bool(torch.any(g != 0)), name
    assert_close(g, want[name], want[name])


def test_train_step_with_trim_matches_reference(smoke):
  """One trimmed step (trim 0.1) of both train steps from the same weights
  on the same batch: the loss, grad norm and clip scale."""
  jcfg, cfg, params, _ = smoke
  jcfg = dataclasses.replace(jcfg, loss_trim_fraction=0.1)
  cfg = dataclasses.replace(cfg, loss_trim_fraction=0.1)
  from repro.optim import adamw as jadamw
  from repro_torch.optim import adamw

  jopt, opt = jadamw.AdamWConfig(lr=1e-3), adamw.AdamWConfig(lr=1e-3)
  b = jpipeline(jcfg, BATCH, SEQ, seed=6, corrupt_fraction=0.1).batch_at(0)
  jb = {k: jnp.asarray(b[k]) for k in ("tokens", "targets")}
  tb = {k: torch.from_numpy(b[k]).long() for k in ("tokens", "targets")}
  _, _, want = jax.jit(jsteps.make_train_step(jcfg, jopt))(
      params, jsteps.init_opt_state(jcfg, jopt, params), jb)
  model = convert.from_jax_params(cfg, params).requires_grad_(True)
  state = steps.init_opt_state(cfg, opt, dict(model.named_parameters()))
  _, _, got = steps.make_train_step(cfg, opt)(model, state, tb)
  for key in ("loss", "grad_norm", "clip_scale"):
    np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-4,
                               atol=0, err_msg=key)


def _reference_serve(jcfg, params, tokens):
  """The reference server's loop: jitted prefill, then greedy decode."""
  prefill = jax.jit(jsteps.make_prefill_step(jcfg, PROMPT + GEN))
  decode = jax.jit(jsteps.make_decode_step(jcfg))
  logits, caches = prefill(params, {"tokens": jnp.asarray(tokens)})
  prefill_caches = jax.tree.map(np.asarray, caches)
  tok = jnp.argmax(logits, -1)
  all_logits, all_tokens = [np.asarray(logits)], [np.asarray(tok)]
  for i in range(GEN - 1):
    logits, caches = decode(params, caches, tok, jnp.int32(PROMPT + i))
    tok = jnp.argmax(logits, -1)
    all_logits.append(np.asarray(logits))
    all_tokens.append(np.asarray(tok))
  return all_logits, np.stack(all_tokens, axis=1), prefill_caches


def test_prefill_and_decode_match_the_reference_server(smoke):
  """Prefill of 19 tokens (logits and each layer's k / v cache, zeros past
  the prompt) and 6 greedy decode steps: logits at every step and the
  tokens."""
  jcfg, cfg, params, model = smoke
  tokens = jpipeline(jcfg, BATCH, PROMPT, seed=3).batch_at(0)["tokens"]
  want_logits, want_tokens, want_caches = _reference_serve(jcfg, params,
                                                           tokens)
  prefill = steps.make_prefill_step(cfg, PROMPT + GEN)
  decode = steps.make_decode_step(cfg)
  with torch.inference_mode():
    logits, caches = prefill(model, {"tokens": torch.from_numpy(tokens)})
    for i, cache in enumerate(caches):
      for key in ("k", "v"):
        want = want_caches[0]["l0_dense"][key][i]
        assert_close(cache[key], want, want)
    got_logits, got_tokens = [logits], [serve.greedy(logits)]
    for i in range(GEN - 1):
      logits, caches = decode(model, caches, got_tokens[-1], PROMPT + i)
      got_logits.append(logits)
      got_tokens.append(serve.greedy(logits))
  for got, want in zip(got_logits, want_logits):
    assert got.dtype == torch.float32
    assert_close(got, want, want)
  np.testing.assert_array_equal(torch.stack(got_tokens, 1).numpy(),
                                want_tokens)


def test_decay_mask_follows_the_reference_layouts(smoke):
  """Every layer leaf (LayerNorm biases too), the table and the untied
  head decay; the final norm's scale and bias do not."""
  _, _, _, model = smoke
  mask = T.decay_mask(model)
  assert mask["layers.0.params.norm1.bias"] and mask["lm_head.w"]
  assert mask["embed.table"]
  assert not mask["final_norm.scale"] and not mask["final_norm.bias"]


@pytest.mark.parametrize("entry", ["serve", "train"])
def test_command_line_smoke_on_cpu(entry, capsys):
  """Both entry points at smoke size, ``--set`` included; the CPU runs the
  plain versions and launches nothing."""
  before = ops.all_launches()
  if entry == "serve":
    res = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", str(PROMPT), "--gen",
                      "3", "--set", "num_layers=3"])
    assert res["cfg"].num_layers == len(res["model"].layers) == 3
    assert tuple(res["tokens"].shape) == (2, 3)
    assert bool(torch.isfinite(res["logits"]).all())
    assert f"prefill 2x{PROMPT}" in capsys.readouterr().out
  else:
    res = train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--steps", "2", "--trim-frac", "0.1", "--batch", "2",
                      "--seq", str(SEQ), "--corrupt", "0.1"])
    assert res["state"].step == 2
    assert np.isfinite(float(res["metrics"]["loss"]))
    assert "done at step 2" in capsys.readouterr().out
  assert ops.all_launches() == before
