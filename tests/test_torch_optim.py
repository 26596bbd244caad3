"""Port of ``repro.optim`` against the reference: AdamW, the schedules and
the int8 error-feedback round trip, on the same numpy parameters and
gradients.

AdamW runs three updates in a row (with a changing ``lr_scale``), on
leaves of ndim 1, 2 and 3 (weight decay by ndim, as the reference decides
it), with clipping active and not, bf16 moments, and the soft-quantile
clip.  f32 results within 1e-6 * (1 + max|p|); bf16 results (moments,
leaves) within one bf16 rounding of the reference's (2**-7 relative):
the two sum the global norm in different orders, which can move a value
across a bf16 rounding boundary.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_common import (  # noqa: E402
    as_np,
    as_torch,
    assert_close,
    composed_ref,  # noqa: F401
    cuda_device,  # noqa: F401
)

from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compression as jcompression  # noqa: E402
from repro.optim import schedule as jschedule  # noqa: E402
from repro_torch.optim import adamw, compression, schedule  # noqa: E402

pytestmark = pytest.mark.usefixtures("composed_ref")
SHAPES = {"w": (6, 5), "b": (5,), "e": (2, 3, 4), "s": (1,)}
BF16_REL = 2.0**-7


def _tree(rng, scale=1.0):
  return {k: rng.normal(size=shape) * scale for k, shape in SHAPES.items()}


def _close_bf16(got, want):
  np.testing.assert_allclose(as_np(got), as_np(want), rtol=BF16_REL,
                             atol=1e-30)


CASES = {
    "clipped": dict(cfg={}, grad_scale=3.0),
    "unclipped": dict(cfg=dict(clip_norm=100.0), grad_scale=0.1),
    "no_decay_no_clip": dict(cfg=dict(weight_decay=0.0, clip_norm=1e9),
                             grad_scale=1.0),
    "bf16_moments": dict(cfg=dict(moment_dtype="bfloat16"), grad_scale=1.0),
    "quantile_clip": dict(cfg=dict(quantile_clip=0.5, quantile_window=8),
                          grad_scale=2.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_adamw_update_matches_reference(case):
  rng = np.random.default_rng(91)
  opts = CASES[case]
  jcfg = jadamw.AdamWConfig(lr=1e-2, **opts["cfg"])
  cfg = adamw.AdamWConfig(lr=1e-2, **opts["cfg"])
  p_np = _tree(rng)
  jp = {k: jnp.asarray(v, jnp.float32) for k, v in p_np.items()}
  jstate = jadamw.init(jcfg, jp)
  params = {k: as_torch(v) for k, v in p_np.items()}
  state = adamw.init(cfg, params)
  jupdate = jax.jit(lambda g, s, p, lr: jadamw.update(jcfg, g, s, p, lr))
  for lr_scale in (1.0, 0.5, 0.25):
    g_np = _tree(rng, opts["grad_scale"])
    jp, jstate, want = jupdate({k: jnp.asarray(v, jnp.float32)
                                for k, v in g_np.items()}, jstate, jp,
                               jnp.float32(lr_scale))
    out, state, got = adamw.update(cfg, {k: as_torch(v)
                                         for k, v in g_np.items()},
                                   state, params, lr_scale)
    assert out is params
    for key in ("grad_norm", "clip_scale", "clip_at"):
      assert_close(got[key], want[key], want[key], contract=1e-6)
    for k in SHAPES:
      assert_close(params[k], jp[k], jp[k], contract=1e-6)
      for mom in ("m", "v"):
        if cfg.moment_dtype == "bfloat16":
          assert state[mom][k].dtype == torch.bfloat16
          _close_bf16(state[mom][k], jstate[mom][k])
        else:
          assert_close(state[mom][k], jstate[mom][k], jstate[mom][k],
                       contract=1e-6)
  assert int(state["step"]) == int(jstate["step"]) == 3
  if cfg.quantile_clip:
    assert_close(state["norm_history"], jstate["norm_history"],
                 jstate["norm_history"], contract=1e-6)


def test_adamw_decays_by_ndim_unless_told():
  cfg = adamw.AdamWConfig(lr=1.0, weight_decay=0.5, clip_norm=1e9)
  zeros = {"w": torch.zeros(2, 2), "b": torch.zeros(2)}
  for decay, moved in ((None, {"w": True, "b": False}),
                       ({"w": False, "b": True}, {"w": False, "b": True})):
    params = {"w": torch.ones(2, 2), "b": torch.ones(2)}
    adamw.update(cfg, zeros, adamw.init(cfg, params), params, decay=decay)
    for k, want in moved.items():
      assert bool(torch.all(params[k] != 1.0)) == want, (decay, k)


def test_adamw_bf16_leaf_is_the_cast_of_the_f32_update():
  rng = np.random.default_rng(92)
  cfg = adamw.AdamWConfig(lr=1e-2)
  p = as_torch(rng.normal(size=(8, 8))).to(torch.bfloat16)
  g = as_torch(rng.normal(size=(8, 8))).to(torch.bfloat16)
  params = {"p": p.clone()}
  state = adamw.init(cfg, params)
  _, _, metrics = adamw.update(cfg, {"p": g}, state, params)
  one = torch.ones((), dtype=torch.float32)
  want, m32, _ = adamw.update_leaf(
      cfg, p, g, torch.zeros(8, 8), torch.zeros(8, 8),
      metrics["clip_scale"], cfg.lr * one, 1.0 - cfg.b1 * one,
      1.0 - cfg.b2 * one, True)
  assert params["p"].dtype == torch.bfloat16
  assert torch.equal(params["p"], want.to(torch.bfloat16))
  assert torch.equal(state["m"]["p"], m32)


def _sqrt_inputs() -> torch.Tensor:
  """f32 values over the exponent range, subnormals, 0, exact squares,
  the largest f32 and inf."""
  rng = np.random.default_rng(93)
  x = np.concatenate([
      rng.random(4096) * 10.0 ** rng.integers(-38, 38, 4096),
      np.array([0.0, 1e-45, 1e-40, 1.0, 4.0, 2.25, 3.4028235e38, np.inf]),
  ]).astype(np.float32)
  return torch.from_numpy(x)


def test_sqrt_rn_is_the_correctly_rounded_root():
  """Bit for bit the f64 root rounded once to f32 (correctly rounded),
  in f32, on the CPU."""
  x = _sqrt_inputs()
  got = adamw.sqrt_rn(x)
  want = np.sqrt(x.numpy().astype(np.float64)).astype(np.float32)
  assert got.dtype == torch.float32
  np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.requires_cuda
def test_sqrt_rn_on_the_card_equals_the_cpu(cuda_device):
  x = _sqrt_inputs()
  got = adamw.sqrt_rn(x.to(cuda_device))
  assert got.dtype == torch.float32 and got.device.type == "cuda"
  assert torch.equal(got.cpu(), adamw.sqrt_rn(x))


@pytest.mark.parametrize("step", [0, 3, 10, 40, 100, 150])
def test_schedules_match_reference(step):
  for kw in (dict(warmup=10, total=100), dict(warmup=0, total=50),
             dict(warmup=10, total=100, min_frac=0.3)):
    want = jschedule.cosine_with_warmup(step, **kw)
    got = schedule.cosine_with_warmup(step, **kw)
    assert got.dtype == torch.float32
    assert_close(got, want, 1.0, contract=1e-7)
    got_t = schedule.cosine_with_warmup(torch.tensor(step, dtype=torch.int32),
                                        **kw)
    assert torch.equal(got, got_t)
  assert float(schedule.constant(step, value=0.3)) == float(
      jschedule.constant(step, value=0.3))


def test_ef_int8_roundtrip_matches_reference():
  """Two rounds with the residual carried, f32 and bf16 leaves."""
  rng = np.random.default_rng(93)
  dtypes = {"w": (jnp.float32, torch.float32),
            "b": (jnp.bfloat16, torch.bfloat16)}
  shapes = {"w": (16, 9), "b": (33,)}
  jres = jcompression.init_residual(
      {k: jnp.zeros(shapes[k], dtypes[k][0]) for k in shapes})
  res = compression.init_residual(
      {k: torch.zeros(shapes[k], dtype=dtypes[k][1]) for k in shapes})
  for _ in range(2):
    g_np = {k: rng.normal(size=shapes[k]) * 3 for k in shapes}
    jdec, jres = jcompression.ef_int8_roundtrip(
        {k: jnp.asarray(v, dtypes[k][0]) for k, v in g_np.items()}, jres)
    dec, res = compression.ef_int8_roundtrip(
        {k: as_torch(v).to(dtypes[k][1]) for k, v in g_np.items()}, res)
    for k in shapes:
      assert dec[k].dtype == res[k].dtype == dtypes[k][1]
      if k == "w":
        assert_close(dec[k], jdec[k], g_np[k], contract=1e-6)
        assert_close(res[k], jres[k], g_np[k], contract=1e-6)
      else:
        _close_bf16(dec[k], jdec[k])
        np.testing.assert_allclose(as_np(res[k]), as_np(jres[k]),
                                   rtol=BF16_REL, atol=1e-6)
  # The residual is what the int8 grid lost: g + r = dec + new r.
  assert float(res["w"].abs().max()) <= float(
      (as_torch(g_np["w"]).abs().max() + 1) / 127)
