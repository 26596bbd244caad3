"""The port's ``local`` / ``global`` layer kinds (gemma3-12b) against the
reference.

``smoke_config("gemma3-12b")`` (12 layers in two 5:1 cycles of ``local``
and ``global``, GQA attention at G = 2, the GeGLU MLP, tied embeddings,
window 32) in f32, with the reference's own random weights carried across
by ``from_jax_params`` and the same numpy inputs and token batches, at 48
positions so that the window binds: the GeGLU MLP, the attention layer
over a sequence and one decode step with and without the window,
``decode_attention`` with the cache filled below and past the window, a
whole ``local`` and ``global`` layer, the training pass (per-token loss
and the gradient of every leaf against ``jax.grad``), prefill (logits and
the full-length caches) and 8 greedy decode steps.  Also the configs and
the parameter counts (at smoke size, and at full width from the reference's
``eval_shape``), the serving caches' length at the full config, and the
command lines.

The reference's windowed chunked attention counts its last key chunk twice
at the smoke config's chunks (16; fault R4, ``test_torch_flash_attention.
py::test_window_fault_r4_of_the_reference``), so the reference runs at the
full config's chunks (512 and 1024: one chunk at 48 positions, where it is
right); the port keeps the smoke chunks.  The reference runs jitted, with
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

ARCH = "gemma3-12b"
BATCH, SEQ, PROMPT, GEN = 2, 48, 48, 9
CYCLE = ("local",) * 5 + ("global",)
# The reference at the full config's chunks (fault R4; module docstring).
REF_CHUNKS = dict(q_chunk=512, kv_chunk=1024)
pytestmark = pytest.mark.usefixtures("composed_ref")


@pytest.fixture(scope="module")
def smoke():
  """(JAX config, port config, JAX params as numpy, port model)."""
  jcfg = dataclasses.replace(jsmoke_config(ARCH), **REF_CHUNKS)
  cfg = smoke_config(ARCH)
  params = jax.tree.map(np.asarray,
                        jtransformer.init_params(jcfg, jax.random.PRNGKey(9)))
  return jcfg, cfg, params, convert.from_jax_params(cfg, params)


def _layer(params, i):
  """Layer i of the reference's one segment (two reps of the cycle)."""
  j = i % len(CYCLE)
  return jax.tree.map(lambda a: jnp.asarray(a[i // len(CYCLE)]),
                      params["seg0"][f"l{j}_{CYCLE[j]}"])


def _port_leaves(cfg, tree) -> dict:
  """A pytree in the reference's layout, by the port's parameter names."""
  return dict(T.Transformer(cfg, convert.port_tree(
      cfg, jax.tree.map(np.asarray, tree))).named_parameters())


@pytest.mark.parametrize("smoke_", [False, True], ids=["full", "smoke"])
def test_configs_are_the_references(smoke_):
  want = jsmoke_config(ARCH) if smoke_ else jget_config(ARCH)
  got = smoke_config(ARCH) if smoke_ else get_config(ARCH)
  assert dataclasses.asdict(got) == dataclasses.asdict(want)
  assert got.plan_segments() == want.plan_segments() == [(CYCLE, 2 if smoke_
                                                          else 8)]
  assert got.layer_kinds() == list(CYCLE) * (2 if smoke_ else 8)
  assert (got.window_size, got.mlp_variant, got.head_dim) == (
      (32, "geglu", 16) if smoke_ else (1024, "geglu", 256))


def test_smoke_has_the_references_parameter_count(smoke):
  """The port's seeded smoke model and the reference's tree (the
  fixture's) hold 460,352 parameters, the tied table once."""
  _, cfg, params, _ = smoke
  model = T.init_params(cfg, 0)
  assert T.count_params(model) == jtransformer.count_params(params) == \
      460_352
  assert not hasattr(model, "lm_head") and "lm_head" not in params


def test_full_width_parameter_count_is_the_references():
  """The port's shapes on the meta device against the reference's
  ``eval_shape``: 48 layers, the tied 262144 x 3840 table once."""
  want = 11_765_395_200
  shapes = jax.eval_shape(lambda: jtransformer.init_params(
      jget_config(ARCH), jax.random.PRNGKey(0)))
  assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes)) == want
  model = T.init_params(get_config(ARCH), 0, "meta")
  assert T.count_params(model) == want
  assert {p.dtype for n, p in model.named_parameters()
          if "norm" not in n} == {torch.bfloat16}


def test_serving_caches_are_full_length_at_the_full_config():
  """``--batch 8 --prompt-len 2048 --gen 32`` prefills into caches of
  max_len 2080 for every layer, ``local`` ones too, as the reference keeps
  them: 48 x k and v of (8, 2080, 8, 256), 6.09 GiB in bf16."""
  cfg = get_config(ARCH)
  caches = T.init_cache(cfg, 8, 2048 + 32, "meta")
  assert len(caches) == 48
  assert {(key, tuple(c[key].shape), c[key].dtype) for c in caches
          for key in c} == {(key, (8, 2080, 8, 256), torch.bfloat16)
                            for key in ("k", "v")}
  gib = sum(t.numel() * t.element_size() for c in caches
            for t in c.values()) / 2**30
  assert round(gib, 2) == 6.09


def test_convert_splits_the_local_and_global_layers(smoke):
  _, cfg, params, model = smoke
  assert len(model.layers) == cfg.num_layers == 12
  for i, layer in enumerate(model.layers):
    kind = CYCLE[i % len(CYCLE)]
    assert (layer.kind, layer.mixer) == (kind, "attn")
    assert layer.window == (32 if kind == "local" else 0)
    tree = layer.params.tree()
    assert sorted(tree) == ["attn", "ffn", "norm1", "norm2"]
    assert sorted(tree["ffn"]) == ["w_gate", "w_in", "w_out"]
    want = _layer(params, i)
    for group, leaf in (("attn", "wq"), ("ffn", "w_gate")):
      np.testing.assert_array_equal(tree[group][leaf].numpy(),
                                    np.asarray(want[group][leaf]))
  assert T.count_params(model) == sum(a.size
                                      for a in jax.tree.leaves(params))


def test_geglu_mlp_matches_reference(smoke):
  """(gelu_tanh(x w_gate) * x w_in) w_out, over a sequence and a decode
  batch."""
  _, cfg, params, model = smoke
  rng = np.random.default_rng(91)
  p = model.layers[2].params.tree()["ffn"]
  for shape in ((2, 7), (3,)):
    x = rng.normal(size=shape + (cfg.d_model,))
    want = jax.jit(lambda q, a: jlayers.mlp_apply(q, a, "geglu"))(
        _layer(params, 2)["ffn"], jnp.asarray(x, jnp.float32))
    got = layers.mlp_apply(p, as_torch(x), "geglu")
    assert_close(got, want, want)
    # Not the SwiGLU of the same weights.
    other = layers.mlp_apply(p, as_torch(x), "swiglu")
    assert float((other - got).abs().max()) > 1e-3


@pytest.mark.parametrize("window", [32, 0], ids=["local", "global"])
def test_attention_layer_matches_reference(smoke, window):
  """48 positions, so that under the window of 32 the later queries drop
  their first keys; k after RoPE and v, the cache, too."""
  jcfg, cfg, params, model = smoke
  rng = np.random.default_rng(92)
  x = rng.normal(size=(2, SEQ, cfg.d_model))
  pos = np.arange(SEQ)
  want, (want_k, want_v) = jax.jit(lambda p, a: jlayers.attn_apply_seq(
      p, a, jnp.asarray(pos), jcfg, window=window, return_kv=True))(
          _layer(params, 5)["attn"], jnp.asarray(x, jnp.float32))
  p = model.layers[5].params.tree()["attn"]
  got, (got_k, got_v) = layers.attn_apply_seq(
      p, as_torch(x), torch.arange(SEQ), cfg, window=window, return_kv=True)
  for g, w in ((got, want), (got_k, want_k), (got_v, want_v)):
    assert_close(g, w, w)
  if window:   # the window binds: without it the output moves
    full = layers.attn_apply_seq(p, as_torch(x), torch.arange(SEQ), cfg)
    assert float((full - got)[:, window:].abs().max()) > 1e-3
    np.testing.assert_allclose(full[:, :window].numpy(),
                               got[:, :window].numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("window, pos", [(32, 40), (32, 20), (0, 40)],
                         ids=["local_past_window", "local_below_window",
                              "global"])
def test_attention_decode_matches_reference(smoke, window, pos):
  jcfg, cfg, params, model = smoke
  rng = np.random.default_rng(93)
  shape = (2, 56, cfg.num_kv_heads, cfg.head_dim)
  cache = {"k": rng.normal(size=shape), "v": rng.normal(size=shape)}
  x = rng.normal(size=(2, cfg.d_model))
  want, want_cache = jax.jit(lambda p, a, c: jlayers.attn_apply_decode(
      p, a, c, jnp.int32(pos), jcfg, window=window))(
          _layer(params, 0)["attn"], jnp.asarray(x, jnp.float32),
          jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), cache))
  tcache = {key: as_torch(a) for key, a in cache.items()}
  got, got_cache = layers.attn_apply_decode(
      model.layers[0].params.tree()["attn"], as_torch(x), tcache, pos, cfg,
      window=window)
  assert got_cache is tcache   # written in place
  assert_close(got, want, want)
  for key in cache:
    assert_close(got_cache[key], want_cache[key], want_cache[key])


@pytest.mark.parametrize("cache_len", [20, 32, 33, 45])
def test_decode_attention_with_window_matches_reference(cache_len):
  """Window 32 over a cache of 48 filled to 20 and 32 (every key inside the
  window) and to 33 and 45 (the first keys outside it), G = 2; the keys
  below the window and at or past ``cache_len`` are not read."""
  rng = np.random.default_rng(94)
  q = rng.normal(size=(3, 4, 16))
  k, v = (rng.normal(size=(3, 48, 2, 16)) for _ in range(2))
  want = jax.jit(lambda a, b, c: jlayers.decode_attention(
      a, b, c, jnp.int32(cache_len), window=32))(
          *(jnp.asarray(t, jnp.float32) for t in (q, k, v)))
  got = layers.decode_attention(as_torch(q), as_torch(k), as_torch(v),
                                cache_len, 32)
  assert_close(got, want, want)
  v2 = v.copy()
  v2[:, :max(cache_len - 32, 0)] = 1e6
  v2[:, cache_len:] = 1e6
  again = layers.decode_attention(as_torch(q), as_torch(k), as_torch(v2),
                                  cache_len, 32)
  np.testing.assert_array_equal(again.numpy(), got.numpy())


@pytest.mark.parametrize("i", [1, 5], ids=["local", "global"])
def test_layer_matches_reference(smoke, i):
  """A whole block, norm to residual, over 48 positions (with its cache)
  and one decode step at position 40 of a 56-position cache."""
  jcfg, cfg, params, model = smoke
  kind = CYCLE[i]
  layer = model.layers[i]
  assert layer.kind == kind
  rng = np.random.default_rng(95)
  x = rng.normal(size=(2, SEQ, cfg.d_model))
  want, _, want_cache = jax.jit(
      lambda p, a: jtransformer._layer_apply_seq(
          p, a, jnp.arange(SEQ), jcfg, kind, collect_cache=True))(
              _layer(params, i), jnp.asarray(x, jnp.float32))
  got, aux, got_cache = layer.apply_seq(as_torch(x), torch.arange(SEQ),
                                        collect_cache=True)
  assert float(aux) == 0.0
  assert_close(got, want, want)
  for key in ("k", "v"):
    assert_close(got_cache[key], want_cache[key], want_cache[key])
  shape = (2, 56, cfg.num_kv_heads, cfg.head_dim)
  cache = {"k": rng.normal(size=shape), "v": rng.normal(size=shape)}
  xd = rng.normal(size=(2, cfg.d_model))
  want, _ = jax.jit(lambda p, a, c: jtransformer._layer_apply_decode(
      p, a, c, jnp.int32(40), jcfg, kind))(
          _layer(params, i), jnp.asarray(xd, jnp.float32),
          jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), cache))
  got, _ = layer.apply_decode(as_torch(xd),
                              {key: as_torch(a) for key, a in cache.items()},
                              40)
  assert_close(got, want, want)


def test_forward_train_and_gradients_match_reference(smoke):
  """The per-token loss over 2 x 48 tokens (the window binding in the
  ``local`` layers) and the gradient of its mean on every leaf, the tied
  table's through both of its uses, against ``jax.grad`` of the
  reference's, split per layer by ``port_tree``."""
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
  assert sorted(want) == sorted(grads) and "lm_head.w" not in grads
  for name, g in grads.items():
    if "norm" not in name:
      assert bool(torch.any(g != 0)), name
    assert_close(g, want[name], want[name])


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
  return all_logits, np.stack(all_tokens, axis=1), prefill_caches, caches


def _cache_of(caches, i):
  j = i % len(CYCLE)
  return caches[0][f"l{j}_{CYCLE[j]}"], i // len(CYCLE)


def test_prefill_and_decode_match_the_reference_server(smoke):
  """Prefill of 48 tokens (the window binding) and its full-length caches
  (k after RoPE and v of the prompt, zeros to ``max_len`` 56, ``local``
  layers too), then 8 greedy decode steps past the window: logits at every
  step, the tokens, and the caches after the last step."""
  jcfg, cfg, params, model = smoke
  tokens = jpipeline(jcfg, BATCH, PROMPT, seed=3).batch_at(0)["tokens"]
  want_logits, want_tokens, want_pcaches, want_caches = _reference_serve(
      jcfg, params, tokens)
  prefill = steps.make_prefill_step(cfg, PROMPT + GEN)
  decode = steps.make_decode_step(cfg)
  with torch.inference_mode():
    logits, caches = prefill(model, {"tokens": torch.from_numpy(tokens)})
    for i, cache in enumerate(caches):
      stack, rep = _cache_of(want_pcaches, i)
      for key in ("k", "v"):
        want = stack[key][rep]
        assert tuple(cache[key].shape) == want.shape == (
            BATCH, PROMPT + GEN, cfg.num_kv_heads, cfg.head_dim)
        assert_close(cache[key], want, want)
        assert not bool(cache[key][:, PROMPT:].any())
    got_logits, got_tokens = [logits], [serve.greedy(logits)]
    for i in range(GEN - 1):
      logits, caches = decode(model, caches, got_tokens[-1], PROMPT + i)
      got_logits.append(logits)
      got_tokens.append(serve.greedy(logits))
  for got, want in zip(got_logits, want_logits):
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert_close(got, want, want)
  np.testing.assert_array_equal(torch.stack(got_tokens, 1).numpy(),
                                want_tokens)
  for i, cache in enumerate(caches):
    stack, rep = _cache_of(want_caches, i)
    for key in ("k", "v"):
      want = np.asarray(stack[key][rep])
      assert_close(cache[key], want, want)


@pytest.mark.parametrize("entry", ["serve", "train"])
def test_command_line_smoke_on_cpu(entry, capsys):
  """Both entry points at smoke size past the window (48 positions); the
  CPU runs the plain versions and launches nothing."""
  before = ops.all_launches()
  if entry == "serve":
    res = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", str(PROMPT), "--gen",
                      "3"])
    assert res["cfg"].num_layers == len(res["model"].layers) == 12
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
