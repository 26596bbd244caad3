"""The xLSTM blocks (mLSTM, sLSTM) and their per-kind FFN against the
reference.

``repro_torch.models.xlstm`` against ``repro.models.xlstm`` on the same
numpy inputs and the reference's own weights (``smoke_config(
"xlstm-350m")``: 4 heads of 16 over d_model 64, query and key chunks of
16): the mLSTM over 48 positions (three 16-wide query and key chunks,
the causal blocks skipped) and over a ragged 45 (chunks of 15), with and
without the prefill state; mLSTM and sLSTM decode steps after a prefill,
against the sequence pass and the reference's own decode steps; the sLSTM
over a sequence, its final state and the gradients of x, ``w``, ``r``,
``b`` and ``w_out`` against ``jax.grad`` through the reference's
``custom_vjp`` (in f32 and with bf16 weights); the sLSTM backward
(``SLSTMScan``) in f64 at S = 2048 against torch autograd through an
unrolled loop of the cell, where n stays above 1e-6 so that h does not
depend on the stabilizer m; one whole layer of each kind with its state
and a decode step; and the per-kind FFN at the full config (the GELU MLP of
2048 in ``mlstm`` layers, GeGLU of 1344 in ``slstm`` layers, against the
reference's ``_ffn_variant`` / ``_ffn_init``).  The reference runs
jitted.  Tolerance: 1e-5 * (1 + max|ref|) for values
(``test_torch_common.assert_close`` scaled by the wanted value), the
gradients scaled by the largest gradient; bf16 at ``CONTRACT_BF16``; the
f64 backward at ``CONTRACT_F64``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_common import (  # noqa: E402
    CONTRACT_BF16,
    CONTRACT_F64,
    as_torch,
    assert_close,
)

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.smoke import smoke_config as jsmoke_config  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.models import xlstm as jxl  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.configs.smoke import smoke_config  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models import xlstm as xl  # noqa: E402

ARCH = "xlstm-350m"
CYCLE = ("mlstm",) * 7 + ("slstm",)


@pytest.fixture(scope="module")
def smoke():
  """(JAX config, port config, JAX params as numpy, port model)."""
  jcfg, cfg = jsmoke_config(ARCH), smoke_config(ARCH)
  params = jax.tree.map(np.asarray,
                        jtransformer.init_params(jcfg, jax.random.PRNGKey(9)))
  return jcfg, cfg, params, convert.from_jax_params(cfg, params)


def _layer(params, i):
  """Layer i of the reference's one segment (two reps of the cycle)."""
  j = i % len(CYCLE)
  return jax.tree.map(lambda a: np.asarray(a[i // len(CYCLE)]),
                      params["seg0"][f"l{j}_{CYCLE[j]}"])


# The leaves kept in f32 whatever the model dtype, as the reference keeps
# them: the mLSTM's gate weights and the sLSTM's biases.
F32_LEAVES = ("w_i", "w_f", "b_f", "b")


def _block(params, i):
  """Layer i's mixer weights (numpy f32)."""
  return _layer(params, i)[CYCLE[i % len(CYCLE)]]


def _t(p, dtype=torch.float32):
  """The weights as tensors, in ``dtype`` but ``F32_LEAVES``."""
  return {k: as_torch(v, torch.float32 if k in F32_LEAVES else dtype)
          for k, v in p.items()}


def _j(p, dtype=jnp.float32):
  """The weights as JAX arrays, in ``dtype`` but ``F32_LEAVES``."""
  return {k: jnp.asarray(v, jnp.float32 if k in F32_LEAVES else dtype)
          for k, v in p.items()}


@pytest.mark.parametrize("smoke_", [False, True], ids=["full", "smoke"])
def test_configs_are_the_references(smoke_):
  want = jsmoke_config(ARCH) if smoke_ else jget_config(ARCH)
  got = smoke_config(ARCH) if smoke_ else get_config(ARCH)
  assert dataclasses.asdict(got) == dataclasses.asdict(want)
  assert got.plan_segments() == want.plan_segments() == [
      (CYCLE, 2 if smoke_ else 3)]
  assert (got.d_ff, got.norm, got.tie_embeddings) == (0, "layernorm", False)


def test_ffn_widths_at_the_full_config():
  """The per-kind FFN: ``mlstm`` the GELU MLP at 2 x 1024 = 2048, ``slstm``
  GeGLU at round(1024 * 4 / 3 / 64) * 64 = 1344, as the reference's
  ``_ffn_variant`` and ``_ffn_init`` build them (its ``eval_shape``); the
  config's d_ff (0) nowhere."""
  cfg, jcfg = get_config(ARCH), jget_config(ARCH)
  assert (T.ffn_variant(cfg, "mlstm"), T.ffn_width(cfg, "mlstm")) == (
      "gelu", 2048)
  assert (T.ffn_variant(cfg, "slstm"), T.ffn_width(cfg, "slstm")) == (
      "geglu", 1344)
  assert T.ffn_variant(cfg, "dense") == cfg.mlp_variant
  shapes = jax.eval_shape(lambda: jtransformer.init_params(
      jcfg, jax.random.PRNGKey(0)))["seg0"]
  model = T.init_params(cfg, 0, "meta")
  for layer in model.layers:
    want = shapes[f"l{CYCLE.index(layer.kind)}_{layer.kind}"]["ffn"]
    assert jtransformer._ffn_variant(jcfg, layer.kind) == T.ffn_variant(
        cfg, layer.kind)
    got = layer.params.tree()["ffn"]
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape[1:]) for k, v in want.items()}
  assert tuple(model.layers[0].params.tree()["ffn"]["w_in"].shape) == (
      1024, 2048)
  assert tuple(model.layers[7].params.tree()["ffn"]["w_gate"].shape) == (
      1024, 1344)


@pytest.mark.parametrize("s", [48, 45], ids=["chunks16", "ragged45"])
@pytest.mark.parametrize("state", [False, True], ids=["seq", "with_state"])
def test_mlstm_apply_seq_matches_reference(smoke, s, state):
  """The parallel form over several query and key chunks (48 = 3 x 16;
  45 = 3 x 15, the largest divisor not above 16) and, with
  ``return_state``, the (C, n, m) a prefill leaves."""
  jcfg, cfg, params, _ = smoke
  rng = np.random.default_rng(81)
  x = rng.normal(size=(2, s, cfg.d_model))
  p = _block(params, 2)
  fn = jax.jit(lambda q, a: jxl.mlstm_apply_seq(q, a, jcfg,
                                                return_state=state))
  want = fn(_j(p), jnp.asarray(x, jnp.float32))
  got = xl.mlstm_apply_seq(_t(p), as_torch(x), cfg, return_state=state)
  if not state:
    assert_close(got, want, want)
    return
  assert_close(got[0], want[0], want[0])
  assert sorted(got[1]) == ["c", "m", "n"]
  for key in ("c", "n", "m"):
    assert got[1][key].dtype == torch.float32
    assert_close(got[1][key], want[1][key], want[1][key])


def test_mlstm_in_bf16_matches_reference(smoke):
  """bf16 projections and activations (the served dtype): q / k / v and
  the score in bf16, the gates and sums in f32, as in the reference."""
  jcfg, cfg, params, _ = smoke
  rng = np.random.default_rng(82)
  x = rng.normal(size=(2, 32, cfg.d_model))
  p = _block(params, 1)
  want = jax.jit(lambda q, a: jxl.mlstm_apply_seq(q, a, jcfg))(
      _j(p, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16))
  got = xl.mlstm_apply_seq(_t(p, torch.bfloat16), as_torch(x, torch.bfloat16),
                           cfg)
  assert got.dtype == torch.bfloat16
  assert_close(got, want, want, contract=CONTRACT_BF16)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_steps_after_a_prefill_match_the_sequence(smoke, kind):
  """The state a 30-position prefill leaves, then 6 decode steps: the
  sequence pass's outputs at positions 30-35 and the reference's decode
  steps (from its own prefill state), the state written in place."""
  jcfg, cfg, params, _ = smoke
  i = 3 if kind == "mlstm" else 7
  rng = np.random.default_rng(83)
  x = rng.normal(size=(2, 36, cfg.d_model))
  p, jp = _t(_block(params, i)), _j(_block(params, i))
  seq = getattr(xl, f"{kind}_apply_seq")
  dec = getattr(xl, f"{kind}_apply_decode")
  jseq = getattr(jxl, f"{kind}_apply_seq")
  jdec = jax.jit(lambda q, a, st: getattr(jxl, f"{kind}_apply_decode")(
      q, a, st, jcfg))
  full = seq(p, as_torch(x), cfg)
  _, state = seq(p, as_torch(x[:, :30]), cfg, return_state=True)
  _, jstate = jax.jit(lambda q, a: jseq(q, a, jcfg, return_state=True))(
      jp, jnp.asarray(x[:, :30], jnp.float32))
  for t in range(30, 36):
    y, same = dec(p, as_torch(x[:, t]), state, cfg)
    assert same is state
    want, jstate = jdec(jp, jnp.asarray(x[:, t], jnp.float32), jstate)
    assert_close(y, full[:, t], full[:, t])
    assert_close(y, want, want)
    for key in state:
      assert_close(state[key], jstate[key], jstate[key])


def test_init_states_are_the_references(smoke):
  jcfg, cfg, _, _ = smoke
  for kind, got in (("mlstm", xl.mlstm_init_state(cfg, 3)),
                    ("slstm", xl.slstm_init_state(cfg, 3))):
    want = getattr(jxl, f"{kind}_init_state")(jcfg, 3)
    assert sorted(got) == sorted(want)
    for key in got:
      assert got[key].dtype == torch.float32
      np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
  state = xl.slstm_init_state(cfg, 2)
  assert len({t.data_ptr() for t in state.values()}) == 4   # no aliases


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_seq_state_and_gradients_match_reference(smoke, dtype):
  """The sLSTM over 40 positions: its output, its final (c, n, m, h), and
  the gradients of x and every weight (``w``, ``r``, ``b``, ``w_out``) of
  a loss on the output and on c, n and h after the last step (m's
  cotangent is ignored by both), against ``jax.grad`` through the
  reference's ``custom_vjp``; with the weights and x in bf16 (``r`` and
  its gradient in bf16, the scan in f32) at ``CONTRACT_BF16``."""
  jcfg, cfg, params, _ = smoke
  rng = np.random.default_rng(84)
  x = rng.normal(size=(2, 40, cfg.d_model))
  p = _block(params, 7)
  g_y = rng.normal(size=x.shape)
  g_state = {k: rng.normal(size=(2, cfg.num_heads, cfg.head_dim))
             for k in ("c", "n", "h")}
  jd = getattr(jnp, dtype)

  def jloss(q, a):
    y, st = jxl.slstm_apply_seq(q, a, jcfg, return_state=True)
    out = jnp.sum(y.astype(jnp.float32) * g_y)
    for k, g in g_state.items():
      out = out + jnp.sum(st[k] * g)
    return out, (y, st)

  (_, (want_y, want_st)), want_g = jax.jit(jax.value_and_grad(
      jloss, argnums=(0, 1), has_aux=True))(_j(p, jd), jnp.asarray(x, jd))

  td = getattr(torch, dtype)
  tp = {k: v.requires_grad_(True) for k, v in _t(p, td).items()}
  tx = as_torch(x, td, grad=True)
  y, st = xl.slstm_apply_seq(tp, tx, cfg, return_state=True)
  loss = torch.sum(y.to(torch.float32) * as_torch(g_y)) + sum(
      torch.sum(st[k] * as_torch(g)) for k, g in g_state.items())
  names = sorted(tp)
  grads = torch.autograd.grad(loss, [tp[k] for k in names] + [tx])
  contract = 1e-5 if dtype == "float32" else CONTRACT_BF16
  assert y.dtype == td
  assert_close(y, want_y, want_y, contract=contract)
  for k in ("c", "n", "m", "h"):
    assert st[k].dtype == torch.float32
    assert_close(st[k], want_st[k], want_st[k], contract=contract)
  wants = [want_g[0][k] for k in names] + [want_g[1]]
  scale = max(float(np.max(np.abs(np.asarray(w, np.float32))))
              for w in wants)
  for name, g, w in zip(names + ["x"], grads, wants):
    assert g.dtype == (torch.float32 if name == "b" else td), name
    assert bool(torch.any(g != 0)), name
    assert_close(g, np.asarray(w, np.float32), scale, contract=contract)


def _cell_loop_f64(u, r):
  """The sLSTM cell position by position in f64, plain ops, autograd
  through every step (m included).  u (S, H, B, 4, dh), r (H, dh, 4, dh)."""
  s, hh, b, _, dh = u.shape
  c = torch.zeros((hh, b, dh), dtype=torch.float64)
  n, m, h = c + 1e-6, c - 10.0, c
  hs, ns = [], []
  for t in range(s):
    pre = u[t] + torch.einsum("hbk,hkgv->hbgv", h, r)
    i_p, f_p, z_p, o_p = pre.unbind(2)
    m_new = torch.maximum(m + torch.nn.functional.logsigmoid(f_p), i_p)
    a = torch.exp(m + torch.nn.functional.logsigmoid(f_p) - m_new)
    bgt = torch.exp(i_p - m_new)
    c = c * a + bgt * torch.tanh(z_p)
    n = n * a + bgt
    h = torch.sigmoid(o_p) * c / torch.clamp_min(n, 1e-6)
    m = m_new
    hs.append(h)
    ns.append(n)
  return torch.stack(hs), (c, n, m, h), torch.stack(ns)


def test_slstm_backward_matches_autograd_of_an_f64_loop_at_2048():
  """``SLSTMScan``'s hand-written backward (m gradient-transparent, the
  dn guard, dL/dr one einsum after the loop) against autograd through
  the cell unrolled over 2048 positions, both in f64: the gradients of
  the input projections and of ``r`` for a loss on every h and on the
  final h.  n stays above 1e-6 throughout (checked), so h does not depend
  on m and the two backwards differ by rounding only.  (c and n do depend
  on m, which scales both: a loss on them has a gradient through m that
  the reference's backward leaves out by design, so it is held to the
  reference alone, in ``test_slstm_seq_state_and_gradients_match_
  reference``.)"""
  rng = np.random.default_rng(85)
  s, hh, b, dh = 2048, 2, 2, 4
  u_np = rng.normal(size=(s, hh, b, 4, dh))
  r_np = rng.normal(size=(hh, dh, 4, dh)) / 2.0
  g_hs = rng.normal(size=(s, hh, b, dh))
  g_h = rng.normal(size=(hh, b, dh))

  def loss_of(hs, h):
    return (torch.sum(hs * as_torch(g_hs, torch.float64))
            + torch.sum(h * as_torch(g_h, torch.float64)))

  u = as_torch(u_np, torch.float64, grad=True)
  r = as_torch(r_np, torch.float64, grad=True)
  hs, c, n, m, h = xl.SLSTMScan.apply(u, r)
  got = torch.autograd.grad(loss_of(hs, h), (u, r))

  u2 = as_torch(u_np, torch.float64, grad=True)
  r2 = as_torch(r_np, torch.float64, grad=True)
  hs2, fin2, ns = _cell_loop_f64(u2, r2)
  assert float(ns.detach().min()) > 1e-6
  want = torch.autograd.grad(loss_of(hs2, fin2[3]), (u2, r2))
  assert_close(hs, hs2.detach(), hs2.detach(), contract=CONTRACT_F64)
  for g, w in zip(got, want):
    assert g.dtype == torch.float64
    assert_close(g, w, float(w.abs().max()), contract=CONTRACT_F64)


@pytest.mark.parametrize("i", [0, 7], ids=["mlstm", "slstm"])
def test_layer_matches_reference(smoke, i):
  """A whole block of each kind, LayerNorm to residual, over 32 positions
  with its state, then one decode step from a random state."""
  jcfg, cfg, params, model = smoke
  kind = CYCLE[i]
  layer = model.layers[i]
  assert (layer.kind, layer.mixer) == (kind, kind)
  rng = np.random.default_rng(86)
  x = rng.normal(size=(2, 32, cfg.d_model))
  jp = jax.tree.map(jnp.asarray, _layer(params, i))
  want, _, want_cache = jax.jit(
      lambda p, a: jtransformer._layer_apply_seq(
          p, a, jnp.arange(32), jcfg, kind, collect_cache=True))(
              jp, jnp.asarray(x, jnp.float32))
  got, aux, got_cache = layer.apply_seq(as_torch(x), torch.arange(32),
                                        collect_cache=True)
  assert float(aux) == 0.0
  assert_close(got, want, want)
  assert sorted(got_cache) == sorted(want_cache)
  for key in got_cache:
    assert_close(got_cache[key], want_cache[key], want_cache[key])
  xd = rng.normal(size=(2, cfg.d_model))
  want, want_cache = jax.jit(lambda p, a, c: jtransformer._layer_apply_decode(
      p, a, c, jnp.int32(32), jcfg, kind))(
          jp, jnp.asarray(xd, jnp.float32), want_cache)
  got, got_cache = layer.apply_decode(as_torch(xd), got_cache, 32)
  assert_close(got, want, want)
  for key in got_cache:
    assert_close(got_cache[key], want_cache[key], want_cache[key])
