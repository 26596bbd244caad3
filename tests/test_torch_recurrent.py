"""The RG-LRU block and the ``rg`` layer kind (recurrentgemma-2b) against
the reference.

``repro_torch.models.recurrent`` against ``repro.models.recurrent`` on the
same numpy inputs and the reference's own weights: the causal conv, the
block over a sequence in f32 and in bf16 with its returned state, decode
steps after a prefill against the sequence pass, and the log-depth scan at
S = 4096 against an f64 sequential loop.  Then ``smoke_config(
"recurrentgemma-2b")`` (6 layers in two cycles of ``rg``, ``rg``,
``local``: the RG-LRU block of width 64 and MQA at G = 4 under a window
of 32, each with the GeGLU MLP; tied embeddings) in f32, with the
reference's weights carried across by ``from_jax_params``: one layer of
each kind, the training pass (per-token loss and the gradient of every
leaf against ``jax.grad``), prefill (logits, the attention caches and the
RG states) and 8 greedy decode steps at 48 positions, so that the window
binds; ``convert`` of a depth whose last segment is the trailing
(``rg``, ``rg``); the configs, the parameter counts (at smoke size, and at
full width from the reference's ``eval_shape``: 2,894,435,840) and the
command lines.

The reference's windowed attention counts its last key chunk twice at the
smoke config's chunks (fault R4, ``test_torch_flash_attention.py::
test_window_fault_r4_of_the_reference``), so the reference runs at one
query and one key chunk (512 and 1024) and the port keeps the smoke
chunks.  The reference runs jitted, with ``REPRO_PROJECTION=composed``
(``composed_ref``).  Tolerance: 1e-5 * (1 + max|ref|)
(``test_torch_common.assert_close`` scaled by the wanted value); bf16 at
``CONTRACT_BF16``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_common import (  # noqa: E402
    CONTRACT_BF16,
    as_torch,
    assert_close,
    composed_ref,  # noqa: F401
)

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.smoke import smoke_config as jsmoke_config  # noqa: E402
from repro.data.pipeline import pipeline_for_arch as jpipeline  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import recurrent as jrg  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.configs.smoke import smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve, steps, train  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import recurrent as rg  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCH = "recurrentgemma-2b"
BATCH, SEQ, PROMPT, GEN = 2, 48, 48, 9
CYCLE = ("rg", "rg", "local")
# The reference at one query and one key chunk (fault R4; module docstring).
REF_CHUNKS = dict(q_chunk=512, kv_chunk=1024)
pytestmark = pytest.mark.usefixtures("composed_ref")


@pytest.fixture(scope="module")
def smoke():
  """(JAX config, port config, JAX params as numpy, port model)."""
  jcfg = dataclasses.replace(jsmoke_config(ARCH), **REF_CHUNKS)
  cfg = smoke_config(ARCH)
  params = jax.tree.map(np.asarray,
                        jtransformer.init_params(jcfg, jax.random.PRNGKey(7)))
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


def _rg_params(params, i=0, dtype=np.float32):
  """Layer i's RG-LRU weights (numpy), the matrices in ``dtype``, a_param
  in f32."""
  p = jax.tree.map(np.asarray, _layer(params, i)["rg"])
  return {k: v if k == "a_param" else v.astype(dtype) for k, v in p.items()}


@pytest.mark.parametrize("smoke_", [False, True], ids=["full", "smoke"])
def test_configs_are_the_references(smoke_):
  want = jsmoke_config(ARCH) if smoke_ else jget_config(ARCH)
  got = smoke_config(ARCH) if smoke_ else get_config(ARCH)
  assert dataclasses.asdict(got) == dataclasses.asdict(want)
  assert got.plan_segments() == want.plan_segments() == (
      [(CYCLE, 2)] if smoke_ else [(CYCLE, 8), (("rg", "rg"), 1)])
  assert (got.lru_width, got.conv_width, got.window_size) == (
      (64, 4, 32) if smoke_ else (2560, 4, 2048))
  assert (got.num_heads, got.num_kv_heads) == ((4, 1) if smoke_ else (10, 1))


def test_smoke_has_the_references_parameter_count(smoke):
  _, cfg, params, _ = smoke
  model = T.init_params(cfg, 0)
  assert T.count_params(model) == jtransformer.count_params(params) == \
      268_352
  assert not hasattr(model, "lm_head") and "lm_head" not in params


def test_full_width_parameter_count_is_the_references():
  """The port's shapes on the meta device against the reference's
  ``eval_shape``: 26 layers (8 cycles and the trailing (rg, rg)), the tied
  256000 x 2560 table once; ``a_param`` and the norms in f32."""
  want = 2_894_435_840
  shapes = jax.eval_shape(lambda: jtransformer.init_params(
      jget_config(ARCH), jax.random.PRNGKey(0)))
  assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes)) == want
  model = T.init_params(get_config(ARCH), 0, "meta")
  assert T.count_params(model) == want
  assert [layer.kind for layer in model.layers] == list(CYCLE) * 8 + [
      "rg", "rg"]
  f32 = {n for n, p in model.named_parameters() if p.dtype == torch.float32}
  assert f32 == {n for n, _ in model.named_parameters()
                 if "norm" in n or n.endswith("a_param")}


def test_seeded_init_follows_the_references_distributions():
  """``rg_init``: a = exp(-8 softplus(a_param)) in U(0.9, 0.999), f32;
  the matrices and conv taps at the reference's scales."""
  cfg = get_config(ARCH)
  cfg = dataclasses.replace(cfg, d_model=256, lru_width=512)
  gen = torch.Generator().manual_seed(0)
  p = rg.rg_init(cfg, gen, torch.float32, "cpu")
  assert p["a_param"].dtype == torch.float32
  a = torch.exp(-8.0 * torch.nn.functional.softplus(p["a_param"]))
  assert 0.9 <= float(a.min()) and float(a.max()) <= 0.999
  assert abs(float(a.mean()) - 0.9495) < 0.01
  for name, fan_in in (("w_x", 256), ("w_gate", 256), ("gate_w_r", 256),
                       ("gate_w_i", 256), ("w_out", 512), ("conv_w", 4)):
    assert abs(float(p[name].std()) * math.sqrt(fan_in) - 1) < 0.1, name


def test_conv1d_causal_matches_reference():
  rng = np.random.default_rng(71)
  x, w = rng.normal(size=(2, 9, 6)), rng.normal(size=(4, 6))
  want = jax.jit(jrg._conv1d_causal)(jnp.asarray(x, jnp.float32),
                                     jnp.asarray(w, jnp.float32))
  assert_close(rg._conv1d_causal(as_torch(x), as_torch(w)), want, want)


def test_log_depth_scan_at_4096_matches_a_sequential_f64_loop():
  """``linear_scan`` in f32 (12 passes at S = 4096) against h_t = a_t
  h_{t-1} + b_t run position by position in f64, on the block's own
  ranges: a in (0.5, 0.999), b of unit size."""
  rng = np.random.default_rng(72)
  a = rng.uniform(0.5, 0.999, size=(2, 4096, 8))
  b = rng.normal(size=(2, 4096, 8))
  want = np.empty_like(b)
  h = np.zeros((2, 8))
  for t in range(4096):
    h = a[:, t] * h + b[:, t]
    want[:, t] = h
  got = rg.linear_scan(as_torch(a), as_torch(b))
  assert got.dtype == torch.float32
  assert_close(got, want, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rg_apply_seq_and_state_match_reference(smoke, dtype):
  """The block over 37 positions and its state (h after the cast to the
  activation dtype, and the last 3 conv inputs, both f32), in f32 and in
  bf16 weights and activations."""
  jcfg, cfg, params, _ = smoke
  rng = np.random.default_rng(73)
  x = rng.normal(size=(2, 37, cfg.d_model))
  jd, td = getattr(jnp, dtype), getattr(torch, dtype)
  p = _rg_params(params, 0)
  want, want_state = jax.jit(lambda q, a: jrg.rg_apply_seq(
      q, a, jcfg, return_state=True))(
          {k: jnp.asarray(v, jnp.float32 if k == "a_param" else jd)
           for k, v in p.items()}, jnp.asarray(x, jd))
  got, got_state = rg.rg_apply_seq(
      {k: as_torch(v, torch.float32 if k == "a_param" else td)
       for k, v in p.items()}, as_torch(x, td), cfg, return_state=True)
  contract = 1e-5 if dtype == "float32" else CONTRACT_BF16
  assert got.dtype == td
  assert_close(got, want, want, contract=contract)
  assert sorted(got_state) == ["conv", "h"]
  for key in ("h", "conv"):
    assert got_state[key].dtype == torch.float32
    assert got_state[key].shape == want_state[key].shape
    assert_close(got_state[key], want_state[key], want_state[key],
                 contract=contract)


def test_decode_steps_after_a_prefill_match_the_sequence(smoke):
  """The state after a 30-position prefill, then 6 decode steps, give the
  sequence pass's outputs at positions 30-35 (f32), the reference's decode
  steps too; the state is written in place.  A prefill shorter than the
  conv's history (2 positions) continues as the sequence pass does."""
  jcfg, cfg, params, _ = smoke
  rng = np.random.default_rng(74)
  x = rng.normal(size=(2, 36, cfg.d_model))
  p = {k: as_torch(v) for k, v in _rg_params(params, 3).items()}
  jp = {k: jnp.asarray(v) for k, v in _rg_params(params, 3).items()}
  full = rg.rg_apply_seq(p, as_torch(x), cfg)
  for start in (30, 2):
    _, state = rg.rg_apply_seq(p, as_torch(x[:, :start]), cfg,
                               return_state=True)
    _, jstate = jrg.rg_apply_seq(jp, jnp.asarray(x[:, :start], jnp.float32),
                                 jcfg, return_state=True)
    if start < cfg.conv_width - 1:
      jstate = jrg.rg_init_state(jcfg, 2, jnp.float32)
      for t in range(start):
        _, jstate = jrg.rg_apply_decode(jp, jnp.asarray(x[:, t], jnp.float32),
                                        jstate, jcfg)
    for t in range(start, start + 6):
      y, same = rg.rg_apply_decode(p, as_torch(x[:, t]), state, cfg)
      assert same is state
      want, jstate = jax.jit(lambda q, a, s: jrg.rg_apply_decode(
          q, a, s, jcfg))(jp, jnp.asarray(x[:, t], jnp.float32), jstate)
      assert_close(y, full[:, t], full[:, t])
      assert_close(y, want, want)
      for key in ("h", "conv"):
        assert_close(state[key], jstate[key], jstate[key])


@pytest.mark.parametrize("i", [1, 2], ids=["rg", "local"])
def test_layer_matches_reference(smoke, i):
  """A whole block of each kind, norm to residual, over 48 positions with
  its cache (the RG state, or k and v), and one decode step."""
  jcfg, cfg, params, model = smoke
  kind = CYCLE[i]
  layer = model.layers[i]
  assert (layer.kind, layer.mixer) == (kind, "rg" if kind == "rg" else "attn")
  rng = np.random.default_rng(75)
  x = rng.normal(size=(2, SEQ, cfg.d_model))
  want, _, want_cache = jax.jit(
      lambda p, a: jtransformer._layer_apply_seq(
          p, a, jnp.arange(SEQ), jcfg, kind, collect_cache=True))(
              _layer(params, i), jnp.asarray(x, jnp.float32))
  got, aux, got_cache = layer.apply_seq(as_torch(x), torch.arange(SEQ),
                                        collect_cache=True)
  assert float(aux) == 0.0
  assert_close(got, want, want)
  assert sorted(got_cache) == sorted(want_cache)
  for key in got_cache:
    assert_close(got_cache[key], want_cache[key], want_cache[key])
  if kind == "rg":
    cache = {"h": rng.normal(size=(2, cfg.lru_width)),
             "conv": rng.normal(size=(2, cfg.conv_width - 1, cfg.lru_width))}
  else:
    shape = (2, 56, cfg.num_kv_heads, cfg.head_dim)
    cache = {"k": rng.normal(size=shape), "v": rng.normal(size=shape)}
  xd = rng.normal(size=(2, cfg.d_model))
  want, want_cache = jax.jit(lambda p, a, c: jtransformer._layer_apply_decode(
      p, a, c, jnp.int32(40), jcfg, kind))(
          _layer(params, i), jnp.asarray(xd, jnp.float32),
          jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), cache))
  got_cache = {k: as_torch(a) for k, a in cache.items()}
  got, _ = layer.apply_decode(as_torch(xd), got_cache, 40)
  assert_close(got, want, want)
  for key in cache:
    assert_close(got_cache[key], want_cache[key], want_cache[key])


def test_forward_train_and_gradients_match_reference(smoke):
  """The per-token loss over 2 x 48 tokens (the window binding in the
  ``local`` layers, the scan over every position in the ``rg`` ones) and
  the gradient of its mean on every leaf, ``a_param`` and the conv taps
  among them, against ``jax.grad`` of the reference's."""
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
  assert "layers.0.params.rg.a_param" in grads
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
  """Prefill of 48 tokens: the logits, every ``local`` layer's full-length
  k / v cache and every ``rg`` layer's state; then 8 greedy decode steps:
  logits at every step, the tokens, and the states and caches after the
  last step."""
  jcfg, cfg, params, model = smoke
  tokens = jpipeline(jcfg, BATCH, PROMPT, seed=3).batch_at(0)["tokens"]
  want_logits, want_tokens, want_pcaches, want_caches = _reference_serve(
      jcfg, params, tokens)
  prefill = steps.make_prefill_step(cfg, PROMPT + GEN)
  decode = steps.make_decode_step(cfg)

  def check_caches(caches, wanted):
    for i, cache in enumerate(caches):
      stack, rep = _cache_of(wanted, i)
      assert sorted(cache) == sorted(stack)
      for key in cache:
        want = np.asarray(stack[key][rep])
        assert tuple(cache[key].shape) == want.shape
        assert_close(cache[key], want, want)

  with torch.inference_mode():
    logits, caches = prefill(model, {"tokens": torch.from_numpy(tokens)})
    check_caches(caches, want_pcaches)
    assert [sorted(c) for c in caches] == [
        ["conv", "h"] if kind == "rg" else ["k", "v"]
        for kind in cfg.layer_kinds()]
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
  check_caches(caches, want_caches)


def test_convert_carries_the_trailing_rg_segment():
  """At 8 layers the plan is two (rg, rg, local) cycles and a trailing
  (rg, rg) segment (``seg1``): ``from_jax_params`` takes all 8 layers in
  scan order, the trailing ones' ``a_param`` (f32) and conv taps too, and
  the model's logits equal the reference's."""
  jcfg = dataclasses.replace(jsmoke_config(ARCH), num_layers=8, **REF_CHUNKS)
  cfg = dataclasses.replace(smoke_config(ARCH), num_layers=8)
  assert cfg.plan_segments() == [(CYCLE, 2), (("rg", "rg"), 1)]
  params = jax.tree.map(np.asarray,
                        jtransformer.init_params(jcfg, jax.random.PRNGKey(8)))
  model = convert.from_jax_params(cfg, params)
  assert [layer.kind for layer in model.layers] == list(CYCLE) * 2 + [
      "rg", "rg"]
  for i, j in ((6, 0), (7, 1)):
    tree = model.layers[i].params.tree()["rg"]
    want = params["seg1"][f"l{j}_rg"]["rg"]
    assert tree["a_param"].dtype == torch.float32
    for leaf in ("a_param", "conv_w", "w_x"):
      np.testing.assert_array_equal(tree[leaf].numpy(), want[leaf][0])
  assert T.count_params(model) == jtransformer.count_params(params)
  tokens = jpipeline(jcfg, BATCH, 20, seed=5).batch_at(0)["tokens"]
  want, _ = jax.jit(jsteps.make_prefill_step(jcfg, 24))(
      params, {"tokens": jnp.asarray(tokens)})
  with torch.inference_mode():
    got, _ = T.forward_prefill(cfg, model,
                               {"tokens": torch.from_numpy(tokens)}, 24)
  assert_close(got, want, want)


def test_init_cache_holds_the_rg_state():
  """The full config's caches at 8 x (4096 + 32): the 18 ``rg`` layers a
  state of h (8, 2560) and conv (8, 3, 2560) in f32, whatever max_len; the
  8 ``local`` layers k and v of (8, 4128, 1, 256) in bf16."""
  cfg = get_config(ARCH)
  caches = T.init_cache(cfg, 8, 4096 + 32, "meta")
  kinds = cfg.layer_kinds()
  assert len(caches) == 26 and kinds.count("rg") == 18
  for kind, cache in zip(kinds, caches):
    if kind == "rg":
      assert {k: (tuple(t.shape), t.dtype) for k, t in cache.items()} == {
          "h": ((8, 2560), torch.float32),
          "conv": ((8, 3, 2560), torch.float32)}
    else:
      assert {k: (tuple(t.shape), t.dtype) for k, t in cache.items()} == {
          k: ((8, 4128, 1, 256), torch.bfloat16) for k in ("k", "v")}


@pytest.mark.parametrize("entry", ["serve", "train"])
def test_command_line_smoke_on_cpu(entry, capsys):
  """Both entry points at smoke size past the window (48 positions), a
  trailing (rg, rg) segment through ``--set num_layers=8``; the CPU runs
  the plain versions and launches nothing."""
  before = ops.all_launches()
  if entry == "serve":
    res = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", str(PROMPT), "--gen",
                      "3", "--set", "num_layers=8"])
    assert res["cfg"].num_layers == len(res["model"].layers) == 8
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
