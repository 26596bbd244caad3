"""Port of flash attention: the plain version against the reference.

``repro_torch.kernels.flash_attention.flash_attention_plain`` (and the
CPU route of the wrapper ``flash_attention``, which the models call) against
the reference's chunked attention ``repro.models.layers.flash_attention``
on the same numpy inputs, in f32: causal and not, GQA, the MLA smoke
widths (D = 24, Dv = 16), chunks that do not divide S, and the sliding
window, soft-cap and query offset the reference also has.  Tolerance
1e-5 * (1 + max|input|) (``test_torch_common``).  The kernel itself runs
only on the card (``requires_cuda``).
"""

from __future__ import annotations

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_common import (  # noqa: E402
    as_torch,
    assert_close,
    cuda_device,  # noqa: F401
)

from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

rng = np.random.default_rng(37)

CASES = {
    # name: (B, Sq, Skv, H, Hkv, D, Dv, options)
    "causal_mla_widths": (2, 32, 32, 4, 4, 24, 16, dict(q_chunk=16,
                                                        kv_chunk=16)),
    "causal_gqa_ragged_chunks": (2, 30, 30, 4, 2, 24, 16,
                                 dict(q_chunk=16, kv_chunk=7)),
    "noncausal_gqa": (1, 12, 20, 6, 2, 8, 8, dict(causal=False,
                                                  kv_chunk=6)),
    "window": (1, 40, 40, 2, 1, 8, 8, dict(window=9, q_chunk=8,
                                           kv_chunk=4)),
    "softcap_offset": (2, 6, 18, 4, 2, 8, 4, dict(softcap=5.0,
                                                  q_offset=12)),
}


def _inputs(b, sq, skv, h, hkv, d, dv):
  return (rng.normal(size=(b, sq, h, d)), rng.normal(size=(b, skv, hkv, d)),
          rng.normal(size=(b, skv, hkv, dv)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_reference(case):
  *shape, opts = CASES[case]
  q, k, v = _inputs(*shape)
  want = jax.jit(lambda a, b, c: jlayers.flash_attention(a, b, c, **opts))(
      *(jnp.asarray(x, jnp.float32) for x in (q, k, v)))
  got = fa.flash_attention_plain(*(as_torch(x) for x in (q, k, v)), **opts)
  assert got.shape == want.shape
  assert_close(got, want, v)
  got_wrapper = fa.flash_attention(*(as_torch(x) for x in (q, k, v)),
                                   **opts)
  np.testing.assert_array_equal(got_wrapper.numpy(), got.numpy())


@pytest.mark.parametrize("causal", [True, False])
def test_wrapper_on_cpu_is_the_plain_version(causal):
  q, k, v = _inputs(2, 21, 21, 4, 2, 8, 6)
  args = [as_torch(x) for x in (q, k, v)]
  before = fa.LAUNCHES["flash_attention"]
  got = fa.flash_attention(*args, causal=causal)
  np.testing.assert_array_equal(
      got.numpy(), fa.flash_attention_plain(*args, causal=causal).numpy())
  assert fa.LAUNCHES["flash_attention"] == before


def test_plain_version_keeps_bf16_rounding_of_the_reference():
  """In bf16 the plain version rounds where the reference rounds (scores
  and block outputs in bf16): held at bf16 precision."""
  q, k, v = _inputs(1, 16, 16, 2, 2, 8, 8)
  want = jlayers.flash_attention(
      *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), q_chunk=8,
      kv_chunk=8)
  got = fa.flash_attention_plain(
      *(as_torch(x, torch.bfloat16) for x in (q, k, v)), q_chunk=8,
      kv_chunk=8)
  assert got.dtype == torch.bfloat16
  assert_close(got, np.asarray(want, np.float32), v, contract=2e-2)


def test_scale_uses_the_qk_width():
  """One query, two keys: the softmax weights are exp(q.k / sqrt(D))."""
  q = np.zeros((1, 1, 1, 4))
  q[..., 0] = 2.0
  k = np.zeros((1, 2, 1, 4))
  k[0, 1, 0, 0] = 1.0
  v = np.array([0.0, 1.0]).reshape(1, 2, 1, 1)
  got = fa.flash_attention_plain(*(as_torch(x) for x in (q, k, v)),
                                 causal=False)
  w = math.exp(2.0 / math.sqrt(4))
  np.testing.assert_allclose(got.numpy().ravel(), [w / (1 + w)], rtol=1e-6)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape", [(2, 512, 512, 16, 16, 192, 128, True),
                                   (2, 300, 300, 16, 4, 192, 128, True),
                                   (1, 77, 130, 8, 8, 192, 128, False),
                                   (1, 100, 100, 4, 1, 192, 128, True)])
def test_cuda_kernel_matches_plain_version(shape, cuda_device):
  """On the card: the kernel (bf16 in and out, f32 softmax state) against
  the plain version in f32 on the same bf16 inputs, by the kernel's error
  model (``compare_with_plain``): every element within 2 * 2**-8 * (|ref|
  + A), A the attention over |v|, and the relative Frobenius error within
  ``REL_FROB_LIMIT`` (2**-7)."""
  b, sq, skv, h, hkv, d, dv, causal = shape
  q, k, v = (as_torch(x, torch.bfloat16).to(cuda_device)
             for x in _inputs(b, sq, skv, h, hkv, d, dv))
  got = fa.flash_attention(q, k, v, causal)
  torch.cuda.synchronize()
  cmp = fa.compare_with_plain(got, q, k, v, causal)
  assert cmp["finite"]
  assert cmp["tol_ratio"] <= 1.0, cmp
  assert cmp["rel_frob"] <= fa.REL_FROB_LIMIT, cmp


def test_wrapper_on_cpu_takes_every_option():
  """The CPU route passes the window, soft-cap and query offset on."""
  q, k, v = (as_torch(x) for x in _inputs(1, 8, 12, 2, 2, 8, 8))
  opts = dict(window=3, softcap=2.0, q_offset=4, kv_chunk=4)
  np.testing.assert_array_equal(
      fa.flash_attention(q, k, v, **opts).numpy(),
      fa.flash_attention_plain(q, k, v, **opts).numpy())
  with pytest.raises(ValueError, match="CPU or CUDA"):
    fa.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("opts", [dict(window=4), dict(softcap=2.0),
                                  dict(q_offset=1)])
def test_cuda_wrapper_refuses_options_the_kernel_lacks(opts, cuda_device):
  q, k, v = (as_torch(x, torch.bfloat16).to(cuda_device)
             for x in _inputs(1, 8, 8, 2, 2, 192, 128))
  with pytest.raises(NotImplementedError, match="ROADMAP"):
    fa.flash_attention(q, k, v, **opts)


def _bf16_kernel_model(q, k, v, causal, extra_key=False):
  """What the kernel computes, in plain f32 arithmetic: P rounded to bf16
  for the P V product, the sum l from unrounded P, the output rounded to
  bf16.  ``extra_key`` lets every query see one key past the causal limit
  (a mask one key off)."""
  s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
  sq, skv = s.shape[-2:]
  if causal:
    allowed = torch.ones(sq, skv, dtype=torch.bool).tril(int(extra_key))
    s = s.masked_fill(~allowed, -1e30)
  p = torch.exp(s - s.amax(-1, keepdim=True))
  l = p.sum(-1).permute(0, 2, 1)[..., None]
  o = torch.einsum("bhqk,bkhd->bqhd", p.to(torch.bfloat16).float(), v)
  return (o / l).to(torch.bfloat16)


def test_error_model_holds_rounding_and_catches_a_mask_error():
  """``compare_with_plain`` on the CPU: the kernel's roundings, applied in
  plain arithmetic, stay inside both limits at a fraction of them; the same
  output with a mask one key off in the later half of the rows, where each
  output averages over more than a hundred keys, breaks both."""
  q, k, v = (as_torch(x, torch.bfloat16).float()
             for x in _inputs(1, 256, 256, 4, 4, 64, 32))
  good = _bf16_kernel_model(q, k, v, True)
  cmp = fa.compare_with_plain(good, q, k, v, True)
  assert cmp["finite"]
  assert cmp["tol_ratio"] <= 0.75, cmp
  assert cmp["rel_frob"] <= fa.REL_FROB_LIMIT / 2, cmp
  bad = good.clone()
  bad[:, 128:] = _bf16_kernel_model(q, k, v, True, extra_key=True)[:, 128:]
  cmp = fa.compare_with_plain(bad, q, k, v, True)
  assert cmp["tol_ratio"] > 1.0, cmp
  assert cmp["rel_frob"] > fa.REL_FROB_LIMIT, cmp
