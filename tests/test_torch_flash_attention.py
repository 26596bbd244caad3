"""Port of flash attention: the plain version against the reference.

``repro_torch.kernels.flash_attention.flash_attention_plain`` (and the
CPU route of the wrapper ``flash_attention``, which the models call) against
the reference's chunked attention ``repro.models.layers.flash_attention``
on the same numpy inputs, in f32: causal and not, GQA, the MLA smoke
widths (D = 24, Dv = 16), the kernel's dense widths D = Dv = 64 at G = 4
(llama3.2-1b) and G = 8 (tinyllama-1.1b) with a ragged S and D = Dv = 128
at G = 6 (grok-1, a G that does not divide the kernel's 128-row tile),
D = Dv = 256 at G = 2 (gemma3-12b) with and without its sliding window,
D = Dv = 256 at G = 10 (recurrentgemma-2b's MQA) under a window, D = Dv =
80 (stablelm-3b), chunks that do not divide S, and the sliding window, soft-cap and query offset the
reference also has.  Tolerance 1e-5 * (1 + max|input|)
(``test_torch_common``).  A width the kernel is not built for raises in
``_check``, before any launch.  The backward
``flash_attention_bwd`` against ``jax.vjp`` of the same reference and
against the plain version's autograd, with and without a window.  The
kernel itself runs only on the card (``requires_cuda``), at every built
width, with windows that bind and do not.
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
    jax_vjp,
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
    "causal_dense_width_g4": (2, 40, 40, 8, 2, 64, 64, dict(q_chunk=16,
                                                           kv_chunk=16)),
    "causal_dense_width_g8_ragged": (1, 37, 37, 16, 2, 64, 64,
                                     dict(q_chunk=16, kv_chunk=16)),
    "causal_grok_width_g6_ragged": (1, 23, 23, 12, 2, 128, 128,
                                    dict(q_chunk=8, kv_chunk=8)),
    "window_gemma_width_g2_ragged": (1, 45, 45, 4, 2, 256, 256,
                                     dict(window=16, q_chunk=8,
                                          kv_chunk=8)),
    "window_rg_width_g10_ragged": (1, 45, 45, 10, 1, 256, 256,
                                   dict(window=16, q_chunk=12, kv_chunk=8)),
    "causal_stablelm_width_80_ragged": (2, 37, 37, 4, 4, 80, 80,
                                        dict(q_chunk=16, kv_chunk=16)),
    # The f32 widths that the CUDA-core kernel takes on the card: the smoke
    # configs' 16 (G 2, and under their window of 32), the MoE example's
    # 32 (G 2) and a width no tensor-core instantiation has, 96 (G 4).
    "causal_smoke_width_16_g2": (2, 48, 48, 4, 2, 16, 16,
                                 dict(q_chunk=16, kv_chunk=16)),
    "window_smoke_width_16_g2": (2, 48, 48, 4, 2, 16, 16,
                                 dict(window=20, q_chunk=16, kv_chunk=16)),
    "causal_moe_example_width_32_g2": (2, 64, 64, 4, 2, 32, 32,
                                       dict(q_chunk=64, kv_chunk=64)),
    "causal_width_96_g4_ragged": (1, 45, 45, 8, 2, 96, 96,
                                  dict(q_chunk=16, kv_chunk=16)),
}


def _inputs(b, sq, skv, h, hkv, d, dv):
  return (rng.normal(size=(b, sq, h, d)), rng.normal(size=(b, skv, hkv, d)),
          rng.normal(size=(b, skv, hkv, dv)))


def _reference_opts(opts, sq, skv):
  """The reference's options; under a window, one query and one key chunk,
  the one chunking at which its windowed attention visits each key chunk
  once where the window is not a multiple of Skv (fault R4: otherwise it
  counts the last twice)."""
  if not opts.get("window"):
    return opts
  assert opts["window"] % skv
  return {**opts, "q_chunk": sq, "kv_chunk": skv}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_reference(case):
  """Window cases: the port at the case's chunks against the reference at
  one chunk each (``_reference_opts``)."""
  *shape, opts = CASES[case]
  q, k, v = _inputs(*shape)
  ref_opts = _reference_opts(opts, shape[1], shape[2])
  want = jax.jit(lambda a, b, c: jlayers.flash_attention(a, b, c,
                                                         **ref_opts))(
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


@pytest.mark.parametrize("d, g", [(64, 4), (64, 8), (64, 3), (128, 6),
                                  (128, 3), (128, 128), (80, 1), (256, 10)])
def test_check_takes_the_dense_width(d, g):
  """``_check`` on bf16 tensors accepts D = Dv = 64 at G = 4 and 8,
  D = Dv = 128 at G = 6 (grok-1), D = Dv = 80 at G = 1 (stablelm-3b),
  D = Dv = 256 at G = 10 (recurrentgemma-2b), and G = 3 and 128 too: every
  G up to the 128-row tile, whether it divides 128 or not."""
  q = torch.zeros((1, 5, 8 * g, d), dtype=torch.bfloat16)
  kv = torch.zeros((1, 5, 8, d), dtype=torch.bfloat16)
  fa._check(q, kv, kv)


def test_check_refuses_more_query_heads_a_kv_head_than_rows():
  """G = 129 puts more rows than the tile holds at one query position."""
  q = torch.zeros((1, 5, 129, 128), dtype=torch.bfloat16)
  kv = torch.zeros((1, 5, 1, 128), dtype=torch.bfloat16)
  with pytest.raises(ValueError, match="at most 128"):
    fa._check(q, kv, kv)


def test_check_refuses_an_unbuilt_width():
  """D = Dv = 96 is not built: ``_check`` raises before any launch, so the
  card never falls back to the plain version."""
  x = torch.zeros((1, 5, 4, 96), dtype=torch.bfloat16)
  with pytest.raises(ValueError, match="not built"):
    fa._check(x, x, x)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape", [(2, 512, 512, 16, 16, 192, 128, True),
                                   (2, 300, 300, 16, 4, 192, 128, True),
                                   (1, 77, 130, 8, 8, 192, 128, False),
                                   (1, 100, 100, 4, 1, 192, 128, True),
                                   (2, 512, 512, 32, 8, 64, 64, True),
                                   (2, 333, 333, 32, 4, 64, 64, True),
                                   (1, 77, 130, 16, 2, 64, 64, False),
                                   (2, 333, 333, 24, 8, 64, 64, True),
                                   (8, 512, 512, 48, 8, 128, 128, True),
                                   (3, 333, 333, 48, 8, 128, 128, True),
                                   (1, 77, 130, 48, 8, 128, 128, False),
                                   (1, 200, 200, 96, 1, 128, 128, True),
                                   (2, 512, 512, 16, 8, 256, 256, True),
                                   (3, 333, 333, 16, 8, 256, 256, True),
                                   (1, 77, 130, 16, 8, 256, 256, False),
                                   (1, 200, 200, 48, 8, 256, 256, True),
                                   (8, 512, 512, 32, 32, 80, 80, True),
                                   (1, 2048, 2048, 32, 32, 80, 80, True),
                                   (3, 333, 333, 32, 32, 80, 80, True),
                                   (2, 300, 450, 32, 32, 80, 80, True),
                                   (1, 77, 130, 32, 32, 80, 80, False),
                                   (2, 301, 301, 10, 1, 256, 256, True)])
def test_cuda_kernel_matches_plain_version(shape, cuda_device):
  """On the card: the kernel (bf16 in and out, f32 softmax state) against
  the plain version in f32 on the same bf16 inputs, by the kernel's error
  model (``compare_with_plain``): every element within 2 * 2**-8 * (|ref|
  + A), A the attention over |v|, and the relative Frobenius error within
  ``REL_FROB_LIMIT`` (2**-7).  G = 3, 6, 10 and 96 do not divide the
  128-row tile: 2, 2, 8 and 32 rows of each tile are never loaded nor
  written.  D = Dv = 80 runs padded to 128 columns inside the kernel."""
  b, sq, skv, h, hkv, d, dv, causal = shape
  q, k, v = (as_torch(x, torch.bfloat16).to(cuda_device)
             for x in _inputs(b, sq, skv, h, hkv, d, dv))
  got = fa.flash_attention(q, k, v, causal)
  torch.cuda.synchronize()
  cmp = fa.compare_with_plain(got, q, k, v, causal)
  assert cmp["finite"]
  assert cmp["tol_ratio"] <= 1.0, cmp
  assert cmp["rel_frob"] <= fa.REL_FROB_LIMIT, cmp


def _dense_window(q, k, v, window):
  """Sliding-window causal attention as one masked softmax (numpy, f64):
  query i sees keys i - window + 1 .. i."""
  g = q.shape[2] // k.shape[2]
  k, v = (np.repeat(x, g, axis=2) for x in (k, v))
  s = np.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
  i = np.arange(q.shape[1])[:, None]
  j = np.arange(k.shape[1])[None]
  s = np.where((j <= i) & (j > i - window), s, -np.inf)
  p = np.exp(s - s.max(-1, keepdims=True))
  return np.einsum("bhqk,bkhd->bqhd", p / p.sum(-1, keepdims=True), v)


@pytest.mark.parametrize("sq, window, q_chunk, kv_chunk",
                         [(48, 32, 16, 16), (64, 16, 16, 16),
                          (40, 9, 8, 4)])
def test_window_fault_r4_of_the_reference(sq, window, q_chunk, kv_chunk):
  """Fault R4: at these chunkings (the first is the gemma smoke config's
  window and chunks at its 48-token prompts) the reference's windowed
  attention counts its last key chunk twice or misses one, and is off the
  one masked softmax by more than 1e-2; the plain version at the same
  chunks is within 1e-5 of it, as at every other chunking."""
  q, k, v = _inputs(1, sq, sq, 4, 2, 8, 8)
  want = _dense_window(q, k, v, window)
  ref = np.asarray(jax.jit(lambda a, b, c: jlayers.flash_attention(
      a, b, c, window=window, q_chunk=q_chunk, kv_chunk=kv_chunk))(
          *(jnp.asarray(x, jnp.float32) for x in (q, k, v))))
  assert np.abs(ref - want).max() > 1e-2
  for qc, kc in ((q_chunk, kv_chunk), (sq, sq), (5, 3), (8, 16)):
    got = fa.flash_attention_plain(*(as_torch(x) for x in (q, k, v)),
                                   window=window, q_chunk=qc, kv_chunk=kc)
    assert_close(got, want, v)


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
def test_cuda_wrapper_refuses_an_unbuilt_width(cuda_device):
  """bf16 at (96, 96), which the tensor-core kernel is not built for, runs
  the CUDA-core kernel once and the tensor-core kernel never (``route``);
  a width that is no multiple of 8 raises before any launch."""
  x = torch.zeros((1, 8, 4, 96), dtype=torch.bfloat16, device=cuda_device)
  before = dict(fa.LAUNCHES)
  out = fa.flash_attention(x, x, x)
  torch.cuda.synchronize()
  assert out.shape == x.shape and out.dtype == torch.bfloat16
  assert fa.LAUNCHES["flash_attention"] == before["flash_attention"]
  assert (fa.LAUNCHES["flash_attention_simt"]
          == before["flash_attention_simt"] + 1)
  y = torch.zeros((1, 8, 4, 20), dtype=torch.bfloat16, device=cuda_device)
  with pytest.raises(ValueError, match="multiples of 8"):
    fa.flash_attention(y, y, y)
  assert fa.LAUNCHES == {**before, "flash_attention_simt":
                         before["flash_attention_simt"] + 1}


# (dtype, D, Dv) -> the kernel ``route`` picks on the card, or None where
# it raises: bf16 at each built width -> the tensor-core kernel; f32 at
# those widths and at the smoke, MLA-smoke and example widths, and bf16 at
# unbuilt multiples of 8 -> the CUDA-core kernel; widths past 256, widths
# that are no multiple of 8, and other dtypes -> ValueError.
ROUTES = [
    *((torch.bfloat16, d, dv, "wgmma") for d, dv in fa.KERNEL_WIDTHS),
    *((torch.float32, d, dv, "simt") for d, dv in fa.KERNEL_WIDTHS),
    (torch.float32, 16, 16, "simt"), (torch.float32, 24, 16, "simt"),
    (torch.float32, 32, 32, "simt"), (torch.float32, 8, 256, "simt"),
    (torch.bfloat16, 96, 96, "simt"), (torch.bfloat16, 16, 16, "simt"),
    (torch.bfloat16, 128, 64, "simt"), (torch.bfloat16, 256, 8, "simt"),
    (torch.float32, 264, 264, None), (torch.bfloat16, 264, 264, None),
    (torch.float32, 20, 20, None), (torch.bfloat16, 64, 20, None),
    (torch.float32, 0, 16, None), (torch.float16, 64, 64, None),
    (torch.float64, 16, 16, None),
]


@pytest.mark.parametrize("dtype, d, dv, want", ROUTES,
                         ids=[f"{str(r[0])[6:]}-{r[1]}x{r[2]}"
                              for r in ROUTES])
def test_route_picks_the_kernel_by_dtype_and_width(dtype, d, dv, want):
  if want is None:
    with pytest.raises(ValueError, match="multiples of 8"):
      fa.route(dtype, d, dv)
  else:
    assert fa.route(dtype, d, dv) == want


def test_check_simt_takes_any_g_and_refuses_mixed_dtypes():
  """The CUDA-core kernel's check: any G (here 200 query heads over one kv
  head, past the tensor-core kernel's 128), f32 or bf16, one dtype."""
  q = torch.zeros((1, 3, 200, 16))
  kv = torch.zeros((1, 5, 1, 16))
  fa._check_simt(q, kv, kv)
  with pytest.raises(ValueError, match="at most 128"):
    fa._check(q.bfloat16(), kv.bfloat16(), kv.bfloat16())
  with pytest.raises(TypeError, match="is torch.bfloat16"):
    fa._check_simt(q, kv.bfloat16(), kv)
  with pytest.raises(TypeError, match="f32 or bf16"):
    fa._check_simt(q.double(), kv.double(), kv.double())
  with pytest.raises(ValueError, match="sees none"):
    fa._check_simt(q, kv, kv, window=2, q_offset=4)


def test_check_refuses_queries_without_a_key():
  """A negative query offset (queries before every key under the causal
  mask) and a window that the last query's position leaves with no key
  raise in ``_check``, before any launch; the last query seeing one key
  passes."""
  x = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
  kv = torch.zeros((1, 12, 2, 64), dtype=torch.bfloat16)
  with pytest.raises(ValueError, match="q_offset"):
    fa._check(x, kv, kv, q_offset=-1)
  with pytest.raises(ValueError, match="sees none"):
    fa._check(x, kv, kv, window=3, q_offset=7)   # last position 14
  fa._check(x, kv, kv, window=3, q_offset=6)     # position 13 sees key 11


# (B, Sq, Skv, H, Hkv, D, Dv, options): the options the models do not use
# on a path, at every built width: a soft-cap of 30 (the
# scores made large enough by ``HOT_Q`` that it binds), queries that
# continue a cache (Sq < Skv, q_offset = Skv - Sq), a window without
# ``causal`` (the causal windowed kernel), and all three together.
OPTION_CUDA_SHAPES = [
    (2, 64, 64, 8, 2, 64, 64, dict(softcap=30.0)),
    (2, 200, 333, 32, 8, 64, 64, dict(q_offset=133)),
    (2, 128, 128, 48, 8, 128, 128, dict(window=50, causal=False)),
    (1, 256, 700, 16, 8, 256, 256, dict(softcap=30.0, q_offset=444,
                                        window=300, causal=False)),
    (1, 300, 500, 10, 1, 256, 256, dict(softcap=30.0, q_offset=150)),
    (2, 77, 200, 16, 16, 192, 128, dict(softcap=30.0, q_offset=123,
                                        window=64)),
    (1, 100, 260, 32, 32, 80, 80, dict(softcap=30.0, q_offset=160,
                                       causal=False)),
]
# Scale of q in those cases: scores of ~N(0, 10^2), so that c * tanh(s / c)
# at c = 30 departs from s.
HOT_Q = 10.0


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape", OPTION_CUDA_SHAPES)
def test_cuda_kernel_takes_softcap_offset_and_window(shape, cuda_device):
  """On the card: the kernel with a soft-cap, a query offset and a window
  without ``causal`` against the plain version with the same options, by
  the error model, forward and backward, one launch each."""
  b, sq, skv, h, hkv, d, dv, opts = shape
  causal = opts.get("causal", True)
  kw = {key: val for key, val in opts.items() if key != "causal"}
  q, k, v = _inputs(b, sq, skv, h, hkv, d, dv)
  xs = [as_torch(x, torch.bfloat16).to(cuda_device).requires_grad_(True)
        for x in (q * HOT_Q, k, v)]
  before = fa.LAUNCHES["flash_attention"]
  out = fa.flash_attention(*xs, causal, **kw)
  assert fa.LAUNCHES["flash_attention"] == before + 1
  do = as_torch(rng.normal(size=out.shape), torch.bfloat16).to(cuda_device)
  grads = torch.autograd.grad(out, xs, do)
  torch.cuda.synchronize()
  causal = causal or kw.get("window", 0) > 0
  cmp = fa.compare_with_plain(out.detach(), *(x.detach() for x in xs),
                              causal, **kw)
  assert cmp["finite"]
  assert cmp["tol_ratio"] <= 1.0, cmp
  assert cmp["rel_frob"] <= fa.REL_FROB_LIMIT, cmp
  for name, c in fa.compare_bwd_with_plain(
      grads, *(x.detach() for x in xs), do, causal, **kw).items():
    assert c["finite"] and c["tol_ratio"] <= 1.0, (name, c)
    assert c["rel_frob"] <= fa.REL_FROB_LIMIT, (name, c)


def _bf16_kernel_model(q, k, v, causal, extra_key=False, window=0):
  """What the kernel computes, in plain f32 arithmetic: P rounded to bf16
  for the P V product, the sum l from unrounded P, the output rounded to
  bf16.  ``extra_key`` lets every query see one key past the causal limit
  (a mask one key off); with a ``window``, one key past its lower edge
  instead."""
  s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
  sq, skv = s.shape[-2:]
  if causal:
    allowed = torch.ones(sq, skv, dtype=torch.bool).tril(
        0 if window else int(extra_key))
    if window:
      allowed = allowed.triu(1 - window - int(extra_key))
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


def test_error_model_holds_rounding_and_catches_a_window_edge_error():
  """With a window of 16 the same holds at the window's lower edge: the
  kernel's roundings pass, and an output whose rows past the 128th each
  see one key below their window (17 keys for 16) breaks both limits."""
  q, k, v = (as_torch(x, torch.bfloat16).float()
             for x in _inputs(1, 256, 256, 4, 2, 64, 32))
  k, v = (x.repeat_interleave(2, dim=2) for x in (k, v))   # G = 2 as MHA
  good = _bf16_kernel_model(q, k, v, True, window=16)
  cmp = fa.compare_with_plain(good, q, k, v, True, window=16)
  assert cmp["finite"]
  assert cmp["tol_ratio"] <= 0.75, cmp
  assert cmp["rel_frob"] <= fa.REL_FROB_LIMIT / 2, cmp
  bad = good.clone()
  bad[:, 128:] = _bf16_kernel_model(q, k, v, True, extra_key=True,
                                    window=16)[:, 128:]
  cmp = fa.compare_with_plain(bad, q, k, v, True, window=16)
  assert cmp["tol_ratio"] > 1.0, cmp
  assert cmp["rel_frob"] > fa.REL_FROB_LIMIT, cmp
  # Held without the window, the windowed output fails too.
  cmp = fa.compare_with_plain(good, q, k, v, True)
  assert cmp["tol_ratio"] > 1.0 and cmp["rel_frob"] > fa.REL_FROB_LIMIT


@pytest.mark.parametrize("shape", [(2, 48, 4, 2, 16, 16, 0),
                                   (2, 48, 4, 2, 16, 16, 32),
                                   (8, 128, 12, 4, 64, 64, 0)])
def test_f32_error_model_holds_rounding_and_catches_a_mask_error(shape):
  """The f32 model of ``compare_with_plain`` on the CPU: the plain version
  at 64-key chunks (the CUDA-core kernel's tiles, ``SIMT_KEYS``, f32
  throughout) and the f64 result rounded to f32 both pass at a small
  fraction of the limits; the output with a window one key wider, or
  without the causal mask, breaks both."""
  b, s_, h, hkv, d, dv, window = shape
  q, k, v = (as_torch(x) for x in _inputs(b, s_, s_, h, hkv, d, dv))
  for good in (fa.flash_attention_plain(q, k, v, window=window,
                                        q_chunk=fa.SIMT_KEYS,
                                        kv_chunk=fa.SIMT_KEYS),
               fa.flash_attention_plain(q.double(), k.double(), v.double(),
                                        window=window).float()):
    cmp = fa.compare_with_plain(good, q, k, v, True, window=window)
    assert cmp["finite"] and cmp["rel_frob_limit"] == fa.F32_REL_FROB_LIMIT
    assert cmp["tol_ratio"] <= 0.1, cmp
    assert cmp["rel_frob"] <= fa.F32_REL_FROB_LIMIT / 10, cmp
  bad = (fa.flash_attention_plain(q, k, v, window=window + 1) if window
         else fa.flash_attention_plain(q, k, v, causal=False))
  cmp = fa.compare_with_plain(bad, q, k, v, True, window=window)
  assert cmp["tol_ratio"] > 1.0, cmp
  assert cmp["rel_frob"] > fa.F32_REL_FROB_LIMIT, cmp


# (B, Sq, Skv, H, Hkv, D, Dv, window): every built width under a window
# that binds, gemma's (256, 256) at G = 2 with windows not a multiple of
# the kernel's 64-key tile (100), of one key, of exactly a tile, and past
# Skv (where the result must be the causal one), ragged S at G = 6;
# recurrentgemma's (256, 256) at G = 10 (12 positions, 120 rows a tile)
# at its window of 2048 over 4096 positions, a window of one key, past
# Skv, and an Sq that is no multiple of 12 (301).
WINDOW_CUDA_SHAPES = [(2, 512, 512, 16, 8, 256, 256, 100),
                      (1, 2048, 2048, 16, 8, 256, 256, 1024),
                      (3, 333, 333, 16, 8, 256, 256, 1),
                      (2, 300, 300, 16, 8, 256, 256, 64),
                      (2, 300, 300, 16, 8, 256, 256, 4096),
                      (2, 333, 333, 32, 8, 64, 64, 100),
                      (2, 333, 333, 48, 8, 128, 128, 77),
                      (2, 333, 333, 16, 16, 192, 128, 130),
                      (2, 333, 333, 32, 32, 80, 80, 100),
                      (1, 4096, 4096, 10, 1, 256, 256, 2048),
                      (2, 301, 301, 10, 1, 256, 256, 100),
                      (2, 301, 301, 10, 1, 256, 256, 1),
                      (2, 301, 301, 10, 1, 256, 256, 4096)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape", WINDOW_CUDA_SHAPES)
def test_cuda_kernel_takes_the_window(shape, cuda_device):
  """On the card, under a sliding window: the kernel against the plain
  version with the same window by the error model; with a window at least
  Skv, bit for bit the causal kernel's output."""
  b, sq, skv, h, hkv, d, dv, window = shape
  q, k, v = (as_torch(x, torch.bfloat16).to(cuda_device)
             for x in _inputs(b, sq, skv, h, hkv, d, dv))
  before = fa.LAUNCHES["flash_attention"]
  got = fa.flash_attention(q, k, v, True, window=window)
  torch.cuda.synchronize()
  assert fa.LAUNCHES["flash_attention"] == before + 1
  cmp = fa.compare_with_plain(got, q, k, v, True, window=window)
  assert cmp["finite"]
  assert cmp["tol_ratio"] <= 1.0, cmp
  assert cmp["rel_frob"] <= fa.REL_FROB_LIMIT, cmp
  if window >= skv:
    assert torch.equal(got, fa.flash_attention(q, k, v, True))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape", [(1, 300, 300, 16, 8, 256, 256, 100),
                                   (2, 200, 200, 32, 8, 64, 64, 33),
                                   (1, 301, 301, 10, 1, 256, 256, 100)])
def test_cuda_windowed_gradients(shape, cuda_device):
  """The windowed forward on the card under autograd: q, k and v get
  finite, non-zero gradients within the backward's error model of the
  plain version's windowed autograd in f32."""
  b, sq, skv, h, hkv, d, dv, window = shape
  xs = [as_torch(x, torch.bfloat16).to(cuda_device).requires_grad_(True)
        for x in _inputs(b, sq, skv, h, hkv, d, dv)]
  out = fa.flash_attention(*xs, True, window=window)
  assert out.grad_fn is not None
  do = as_torch(rng.normal(size=out.shape), torch.bfloat16).to(cuda_device)
  grads = torch.autograd.grad(out, xs, do)
  torch.cuda.synchronize()
  for g in grads:
    assert bool(torch.isfinite(g).all()) and bool((g != 0).any())
  for name, cmp in fa.compare_bwd_with_plain(
      grads, *(x.detach() for x in xs), do, True, window).items():
    assert cmp["tol_ratio"] <= 1.0, (name, cmp)
    assert cmp["rel_frob"] <= fa.REL_FROB_LIMIT, (name, cmp)


# ---------------------------------------------------------------------------
# Backward.
# ---------------------------------------------------------------------------

BWD_CASES = {
    # name: (B, Sq, Skv, H, Hkv, D, Dv, causal, q_chunk, kv_chunk)
    "causal_mla_widths": (2, 32, 32, 4, 4, 24, 16, True, 16, 16),
    "causal_gqa_ragged": (2, 37, 37, 6, 2, 24, 16, True, 16, 7),
    "noncausal_gqa": (1, 12, 20, 6, 3, 8, 8, False, 5, 6),
    "causal_one_chunk": (1, 9, 9, 2, 1, 8, 4, True, 512, 1024),
}


def _plain_grads(q, k, v, do, causal):
  """The autograd of the plain version: (out, dq, dk, dv)."""
  xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
  out = fa.flash_attention_plain(*xs, causal=causal)
  return (out.detach(), *torch.autograd.grad(out, xs, do))


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_backward_matches_plain_autograd_f32(case):
  """f32 in, f32 out: within 1e-5 * (1 + max|want|) of the autograd of the
  plain version (the same sums in another order)."""
  b, sq, skv, h, hkv, d, dv, causal, qc, kc = BWD_CASES[case]
  q, k, v = (as_torch(x) for x in _inputs(b, sq, skv, h, hkv, d, dv))
  do = as_torch(rng.normal(size=(b, sq, h, dv)))
  out, *want = _plain_grads(q, k, v, do, causal)
  got = fa.flash_attention_bwd(q, k, v, out, do, causal, q_chunk=qc,
                               kv_chunk=kc)
  for g, w, x in zip(got, want, (q, k, v)):
    assert g.dtype == torch.float32 and g.shape == x.shape
    assert_close(g, w, w)


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_backward_matches_reference_vjp(case):
  """f32: dq, dk, dv within 1e-5 * (1 + max|want|) of ``jax.vjp`` of the
  reference's chunked attention (its training attention) on the same
  inputs and cotangent, O being the reference's forward output."""
  b, sq, skv, h, hkv, d, dv, causal, qc, kc = BWD_CASES[case]
  q, k, v = _inputs(b, sq, skv, h, hkv, d, dv)
  do = rng.normal(size=(b, sq, h, dv))
  out, want = jax_vjp(
      lambda a, b_, c: jlayers.flash_attention(
          a, b_, c, causal=causal, q_chunk=qc, kv_chunk=kc),
      (q, k, v), do)
  got = fa.flash_attention_bwd(*(as_torch(x) for x in (q, k, v)),
                               as_torch(out), as_torch(do), causal,
                               q_chunk=qc, kv_chunk=kc)
  for g, w in zip(got, want):
    assert_close(g, w, w)


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_backward_bf16_within_error_model(case):
  """bf16 in and out, O rounded to bf16 as the kernel gives it: every
  gradient within the error model of ``compare_bwd_with_plain``."""
  b, sq, skv, h, hkv, d, dv, causal, qc, kc = BWD_CASES[case]
  q, k, v = (as_torch(x, torch.bfloat16)
             for x in _inputs(b, sq, skv, h, hkv, d, dv))
  do = as_torch(rng.normal(size=(b, sq, h, dv)), torch.bfloat16)
  out = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                 causal=causal).to(torch.bfloat16)
  got = fa.flash_attention_bwd(q, k, v, out, do, causal, q_chunk=qc,
                               kv_chunk=kc)
  assert [g.dtype for g in got] == [torch.bfloat16] * 3
  for name, cmp in fa.compare_bwd_with_plain(got, q, k, v, do,
                                             causal).items():
    assert cmp["finite"], name
    assert cmp["tol_ratio"] <= 1.0, (name, cmp)
    assert cmp["rel_frob"] <= fa.REL_FROB_LIMIT, (name, cmp)


# (B, Sq, Skv, H, Hkv, D, Dv, window, q_chunk, kv_chunk): windows that
# bind, below and across chunk edges (ragged), a window of one key, one
# past S; the backward at these chunks, the reference at one chunk each
# (``_reference_opts``).
WINDOW_BWD_CASES = {
    "window_gqa_ragged": (2, 37, 37, 4, 2, 16, 8, 9, 8, 5),
    "window_one_key": (1, 20, 20, 2, 1, 8, 8, 1, 7, 6),
    "window_past_s": (1, 19, 19, 4, 2, 8, 4, 40, 8, 8),
}


@pytest.mark.parametrize("case", sorted(WINDOW_BWD_CASES))
def test_windowed_backward_matches_plain_autograd_and_reference(case):
  """f32: the windowed backward within 1e-5 * (1 + max|want|) of the
  autograd of the plain version with the same window and of ``jax.vjp`` of
  the reference's windowed chunked attention (one chunk each: fault R4),
  on the same inputs and cotangent; the chunks skipped below the window
  change nothing."""
  b, sq, skv, h, hkv, d, dv, window, qc, kc = WINDOW_BWD_CASES[case]
  ref_opts = _reference_opts(dict(window=window), sq, skv)
  q, k, v = _inputs(b, sq, skv, h, hkv, d, dv)
  do = rng.normal(size=(b, sq, h, dv))
  xs = [as_torch(x).requires_grad_(True) for x in (q, k, v)]
  out = fa.flash_attention_plain(*xs, window=window)
  want_plain = torch.autograd.grad(out, xs, as_torch(do))
  got = fa.flash_attention_bwd(*(as_torch(x) for x in (q, k, v)),
                               out.detach(), as_torch(do), True,
                               window=window, q_chunk=qc, kv_chunk=kc)
  jout, want_ref = jax_vjp(
      lambda a, b_, c: jlayers.flash_attention(a, b_, c, **ref_opts),
      (q, k, v), do)
  assert_close(out, jout, v)
  for g, w, r in zip(got, want_plain, want_ref):
    assert_close(g, w, w)
    assert_close(g, r, r)


def test_windowed_backward_bf16_within_error_model_and_catches_no_window():
  """bf16, O rounded as the kernel gives it: the windowed gradients within
  ``compare_bwd_with_plain``'s model with the window; the same gradients
  computed without the window fail it."""
  q, k, v = (as_torch(x, torch.bfloat16)
             for x in _inputs(1, 64, 64, 4, 2, 32, 16))
  do = as_torch(rng.normal(size=(1, 64, 4, 16)), torch.bfloat16)
  out = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                 window=8).to(torch.bfloat16)
  got = fa.flash_attention_bwd(q, k, v, out, do, True, window=8)
  for name, cmp in fa.compare_bwd_with_plain(got, q, k, v, do, True,
                                             8).items():
    assert cmp["finite"], name
    assert cmp["tol_ratio"] <= 1.0, (name, cmp)
    assert cmp["rel_frob"] <= fa.REL_FROB_LIMIT, (name, cmp)
  bad = fa.flash_attention_bwd(q, k, v, out, do, True)
  for name, cmp in fa.compare_bwd_with_plain(bad, q, k, v, do, True,
                                             8).items():
    assert cmp["tol_ratio"] > 1.0 and cmp["rel_frob"] > fa.REL_FROB_LIMIT, (
        name, cmp)


@pytest.mark.parametrize("n, skv, want", [
    (1, 512, 2), (63, 512, 2), (64, 512, 3), (512, 512, 10),
    (512, 2048, 10), (100, 1031, 102), (7, 48, 2), (48, 48, 3)])
def test_f32_models_count_the_tiles_of_the_kernel_and_the_chunks(n, skv,
                                                                 want):
  """t = n // c + 2 rescales of a row's running max: c the CUDA-core
  kernel's 64-key tiles, or the plain version's key chunk where that is
  shorter (1031 keys, prime, are chunked one by one; 48 keys in one)."""
  assert fa.SIMT_KEYS == 64
  t = fa._f32_tiles(torch.tensor([float(n)]), skv)
  assert float(t) == want


def _dense_attention(q, k, v, mask):
  """Attention in f32 under a boolean (Sq, Skv) mask, as one softmax."""
  g = q.shape[2] // k.shape[2]
  kh, vh = (x.repeat_interleave(g, dim=2) for x in (k, v))
  s = torch.einsum("bqhd,bkhd->bhqk", q, kh) / math.sqrt(q.shape[-1])
  p = torch.softmax(s.masked_fill(~mask, -1e30), dim=-1)
  return torch.einsum("bhqk,bkhc->bqhc", p, vh)


def test_f32_backward_model_catches_a_one_key_mask_error():
  """At the f32 llama3.2-1b prefill's n (512 positions, G 4, D 64; one
  sequence and 4 heads here): ``flash_attention_bwd``'s f32 gradients
  pass the f32 backward model at a small fraction of it; gradients of the
  same attention with one key (the first) hidden from the last query row,
  which sees 512, fail it, and pass the bf16 model that held every dtype
  before (2 * BF16_U * (|ref| + A))."""
  q, k, v = (as_torch(x) for x in _inputs(1, 512, 512, 4, 1, 64, 64))
  do = as_torch(rng.normal(size=(1, 512, 4, 64)))
  out = fa.flash_attention_plain(q, k, v)
  good = fa.flash_attention_bwd(q, k, v, out, do, True)
  for name, cmp in fa.compare_bwd_with_plain(good, q, k, v, do,
                                             True).items():
    assert cmp["rel_frob_limit"] == fa.F32_REL_FROB_LIMIT
    assert cmp["tol_ratio"] <= 0.1, (name, cmp)
    assert cmp["rel_frob"] <= fa.F32_REL_FROB_LIMIT / 10, (name, cmp)
  mask = torch.ones(512, 512).tril().bool()
  mask[511, 0] = False
  xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
  bad = torch.autograd.grad(_dense_attention(*xs, mask), xs, do)
  cmps = fa.compare_bwd_with_plain(bad, q, k, v, do, True)
  assert max(c["tol_ratio"] for c in cmps.values()) > 1.0, cmps
  xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
  refs = torch.autograd.grad(fa.flash_attention_plain(*xs), xs, do)
  for got, want, a in zip(bad, refs, fa._magnitudes(q, k, v, do, True)):
    old = (got - want).abs() / (2 * fa.BF16_U * (want.abs() + a))
    assert float(old.max()) <= 1.0
    assert float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want)) <= fa.REL_FROB_LIMIT


def test_backward_error_model_catches_a_mask_error():
  """The gradients of non-causal attention held as causal ones fail."""
  q, k, v = (as_torch(x, torch.bfloat16)
             for x in _inputs(1, 64, 64, 4, 2, 32, 16))
  do = as_torch(rng.normal(size=(1, 64, 4, 16)), torch.bfloat16)
  out = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                 causal=False).to(torch.bfloat16)
  bad = fa.flash_attention_bwd(q, k, v, out, do, False)
  for name, cmp in fa.compare_bwd_with_plain(bad, q, k, v, do,
                                             True).items():
    assert cmp["tol_ratio"] > 1.0 and cmp["rel_frob"] > fa.REL_FROB_LIMIT, (
        name, cmp)


# (B, Sq, Skv, H, Hkv, D, Dv, causal, options, q_chunk, kv_chunk): a
# soft-cap that binds (scores ~N(0, 1) against c = 1.5 or 2), a query
# offset (Sq < Skv: queries that continue a cache), both together, and both
# with a window without ``causal``; ragged chunks.
OPTION_BWD_CASES = {
    "softcap": (2, 33, 33, 4, 2, 16, 8, True, dict(softcap=2.0), 8, 5),
    "q_offset": (1, 20, 45, 6, 2, 8, 8, True, dict(q_offset=25), 7, 6),
    "softcap_q_offset": (2, 17, 40, 4, 1, 8, 4, True,
                         dict(softcap=1.5, q_offset=23), 5, 8),
    "softcap_q_offset_window_not_causal": (
        2, 17, 40, 4, 1, 8, 4, False,
        dict(softcap=1.5, q_offset=20, window=9), 5, 8),
}


def _option_case(case, dtype):
  b, sq, skv, h, hkv, d, dv, causal, opts, qc, kc = OPTION_BWD_CASES[case]
  q, k, v = (as_torch(x, dtype) for x in _inputs(b, sq, skv, h, hkv, d, dv))
  do = as_torch(rng.normal(size=(b, sq, h, dv)), dtype)
  return q, k, v, do, causal, opts, qc, kc


@pytest.mark.parametrize("case", sorted(OPTION_BWD_CASES))
def test_backward_with_options_matches_plain_autograd_f64(case):
  """With a soft-cap, a query offset, both, and both under a window
  without ``causal`` (which is causal), the backward on f64 inputs within
  1e-5 * (1 + max|want|) of the autograd of the plain version in f64 with
  the same options: the backward computes in f32 inside, so it is held at
  f32's contract against the exact gradient, in f64 out."""
  q, k, v, do, causal, opts, qc, kc = _option_case(case, torch.float64)
  xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
  out = fa.flash_attention_plain(*xs, causal=causal, **opts)
  want = torch.autograd.grad(out, xs, do)
  got = fa.flash_attention_bwd(q, k, v, out.detach(), do, causal, **opts,
                               q_chunk=qc, kv_chunk=kc)
  for g, w, x in zip(got, want, (q, k, v)):
    assert g.dtype == torch.float64 and g.shape == x.shape
    assert_close(g, w, w)


@pytest.mark.parametrize("case", sorted(OPTION_BWD_CASES))
def test_backward_with_options_matches_reference_vjp(case):
  """f32: the same cases against ``jax.vjp`` of the reference's chunked
  attention with the same options (one chunk each under a window: fault
  R4), within 1e-5 * (1 + max|want|)."""
  b, sq, skv, h, hkv, d, dv, causal, opts, qc, kc = OPTION_BWD_CASES[case]
  q, k, v = _inputs(b, sq, skv, h, hkv, d, dv)
  do = rng.normal(size=(b, sq, h, dv))
  ref_opts = {**opts, "q_chunk": sq, "kv_chunk": skv}
  out, want = jax_vjp(lambda a, b_, c: jlayers.flash_attention(
      a, b_, c, causal=causal, **ref_opts), (q, k, v), do)
  got = fa.flash_attention_bwd(*(as_torch(x) for x in (q, k, v)),
                               as_torch(out), as_torch(do), causal, **opts,
                               q_chunk=qc, kv_chunk=kc)
  for g, w in zip(got, want):
    assert_close(g, w, w)


def test_backward_with_options_bf16_within_error_model_and_catches_errors():
  """bf16, O rounded as the kernel gives it: the gradients with a soft-cap
  and a query offset within ``compare_bwd_with_plain``'s model with both;
  the same gradients computed without the soft-cap's derivative, or
  without the offset, fail it."""
  q, k, v, do, causal, opts, _, _ = _option_case("softcap_q_offset",
                                                 torch.bfloat16)
  out = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                 **opts).to(torch.bfloat16)
  got = fa.flash_attention_bwd(q, k, v, out, do, causal, **opts)
  for name, cmp in fa.compare_bwd_with_plain(got, q, k, v, do, causal,
                                             **opts).items():
    assert cmp["finite"], name
    assert cmp["tol_ratio"] <= 1.0, (name, cmp)
    assert cmp["rel_frob"] <= fa.REL_FROB_LIMIT, (name, cmp)
  for wrong in (dict(opts, softcap=0.0), dict(opts, q_offset=0)):
    bad = fa.flash_attention_bwd(q, k, v, out, do, causal, **wrong)
    worst = max(c["tol_ratio"] for c in fa.compare_bwd_with_plain(
        bad, q, k, v, do, causal, **opts).values())
    assert worst > 1.0, wrong


def test_error_model_holds_the_options_and_catches_a_missing_softcap():
  """``compare_with_plain`` with a soft-cap and a query offset: the plain
  output at those options, rounded to bf16, passes; the output without
  the soft-cap fails."""
  q, k, v, _, causal, opts, _, _ = _option_case("softcap_q_offset",
                                                torch.bfloat16)
  good = fa.flash_attention_plain(q.float(), k.float(), v.float(), **opts)
  cmp = fa.compare_with_plain(good.to(torch.bfloat16), q, k, v, causal,
                              **opts)
  assert cmp["tol_ratio"] <= 1.0 and cmp["rel_frob"] <= fa.REL_FROB_LIMIT
  bad = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                 q_offset=opts["q_offset"])
  cmp = fa.compare_with_plain(bad.to(torch.bfloat16), q, k, v, causal,
                              **opts)
  assert cmp["tol_ratio"] > 1.0


def test_autograd_function_takes_every_option(monkeypatch):
  """The card's route without the card, with the options: the Function
  hands the window, soft-cap and query offset to the launch and to
  ``flash_attention_bwd``, which give the plain version's autograd."""
  q, k, v, do, _, opts, _, _ = _option_case(
      "softcap_q_offset_window_not_causal", torch.float32)
  calls = []

  def plain_launch(q, k, v, causal, window=0, softcap=0.0, q_offset=0):
    calls.append((causal, window, softcap, q_offset))
    return fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                    softcap=softcap, q_offset=q_offset)

  monkeypatch.setattr(fa, "_launch", plain_launch)
  xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
  out = fa._FlashAttention.apply(*xs, True, opts["window"], opts["softcap"],
                                 opts["q_offset"])
  assert calls == [(True, opts["window"], opts["softcap"], opts["q_offset"])]
  got = torch.autograd.grad(out, xs, do)
  ys = [x.clone().requires_grad_(True) for x in (q, k, v)]
  want = torch.autograd.grad(
      fa.flash_attention_plain(*ys, causal=False, **opts), ys, do)
  for g, w in zip(got, want):
    assert_close(g, w, w)


def test_autograd_function_saves_and_differentiates(monkeypatch):
  """The card's route without the card: the autograd Function around the
  forward launch, with the launch replaced by the plain version, gives
  the plain version's autograd gradients through flash_attention_bwd."""
  q, k, v = (as_torch(x) for x in _inputs(2, 20, 20, 4, 2, 24, 16))
  do = as_torch(rng.normal(size=(2, 20, 4, 16)))
  calls = []

  def plain_launch(q, k, v, causal, window=0, softcap=0.0, q_offset=0):
    calls.append(causal)
    return fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                    softcap=softcap, q_offset=q_offset)

  monkeypatch.setattr(fa, "_launch", plain_launch)
  xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
  out = fa._FlashAttention.apply(*xs, True, 0, 0.0, 0)
  assert out.grad_fn is not None and calls == [True]
  got = torch.autograd.grad(out, xs, do)
  _, *want = _plain_grads(q, k, v, do, True)
  for g, w in zip(got, want):
    assert_close(g, w, w)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape", [(1, 256, 256, 16, 16, 192, 128, True),
                                   (2, 100, 100, 8, 2, 192, 128, True),
                                   (1, 77, 130, 4, 4, 192, 128, False),
                                   (2, 200, 200, 32, 8, 64, 64, True),
                                   (1, 300, 300, 32, 32, 80, 80, True)])
def test_cuda_gradients_reach_q_k_and_v(shape, cuda_device):
  """On the card the kernel's output carries a grad_fn: q, k and v each
  get a finite, non-zero gradient, within the backward's error model of
  the plain version's autograd in f32."""
  b, sq, skv, h, hkv, d, dv, causal = shape
  xs = [as_torch(x, torch.bfloat16).to(cuda_device).requires_grad_(True)
        for x in _inputs(b, sq, skv, h, hkv, d, dv)]
  before = fa.LAUNCHES["flash_attention"]
  out = fa.flash_attention(*xs, causal)
  assert out.grad_fn is not None
  assert fa.LAUNCHES["flash_attention"] == before + 1
  do = as_torch(rng.normal(size=out.shape), torch.bfloat16).to(cuda_device)
  grads = torch.autograd.grad(out, xs, do)
  torch.cuda.synchronize()
  for g in grads:
    assert bool(torch.isfinite(g).all()) and bool((g != 0).any())
  for name, cmp in fa.compare_bwd_with_plain(
      grads, *(x.detach() for x in xs), do, causal).items():
    assert cmp["tol_ratio"] <= 1.0, (name, cmp)
    assert cmp["rel_frob"] <= fa.REL_FROB_LIMIT, (name, cmp)


# (B, Sq, Skv, H, Hkv, D, Dv, dtype, options): the CUDA-core kernel at the
# smoke configs' f32 shapes (G 2, causal and under their window of 32), the
# MLA smoke widths (24, 16), the MoE example's (32, 32) at G 2, the robust
# LM example's --full shape (64, 64) at G 3, bf16 at (96, 96) with G 4 and
# a ragged S, causal and not, the soft-cap with q x 10, a query offset and
# a window without ``causal``, and G = 200 (past the tensor-core kernel's
# 128); then the edges of the kernel's tiles (64 keys; f32 blocks of 16, 32
# or 64 rows, bf16 of 16 to 128 whose warps split the keys below 64 rows):
# Sq * G no multiple of the row block over Skv != Sq, G 3 and 6, D = 8 and
# (256, 256) in f32, bf16 at (40, 40) and (24, 16) (multiples of 8, not of
# 16) and (96, 64), the window, soft-cap and query offset on the bf16 path,
# and the two prefill shapes (f32 at llama3.2-1b's heads, bf16 (96, 96) in
# 128-row blocks).
SIMT_CUDA_SHAPES = [
    (2, 48, 48, 4, 2, 16, 16, torch.float32, dict()),
    (2, 48, 48, 4, 2, 16, 16, torch.float32, dict(window=32)),
    (2, 48, 48, 4, 4, 24, 16, torch.float32, dict()),
    (8, 64, 64, 4, 2, 32, 32, torch.float32, dict()),
    (8, 128, 128, 12, 4, 64, 64, torch.float32, dict()),
    (1, 333, 333, 4, 1, 96, 96, torch.bfloat16, dict()),
    (1, 333, 333, 4, 1, 96, 96, torch.bfloat16, dict(causal=False)),
    (2, 40, 90, 4, 2, 64, 64, torch.float32,
     dict(softcap=30.0, q_offset=50)),
    (2, 40, 90, 4, 2, 64, 64, torch.float32,
     dict(window=25, causal=False, q_offset=50)),
    (1, 50, 50, 200, 1, 8, 256, torch.float32, dict()),
    (2, 100, 164, 8, 2, 64, 64, torch.float32, dict(q_offset=64)),
    (2, 77, 90, 6, 2, 32, 32, torch.float32, dict(causal=False)),
    (1, 90, 120, 12, 2, 64, 64, torch.float32, dict(q_offset=30)),
    (2, 70, 70, 4, 4, 8, 8, torch.float32, dict()),
    (1, 200, 200, 8, 4, 256, 256, torch.float32, dict()),
    (1, 100, 100, 4, 1, 40, 40, torch.bfloat16, dict()),
    (2, 48, 48, 4, 4, 24, 16, torch.bfloat16, dict()),
    (1, 120, 120, 4, 2, 96, 64, torch.bfloat16, dict()),
    (1, 333, 400, 4, 1, 96, 96, torch.bfloat16,
     dict(window=100, q_offset=60)),
    (1, 100, 160, 8, 2, 40, 40, torch.bfloat16,
     dict(softcap=30.0, q_offset=60)),
    (2, 64, 192, 12, 4, 96, 96, torch.bfloat16, dict(q_offset=128)),
    (2, 512, 512, 32, 8, 64, 64, torch.float32, dict()),
    (2, 512, 512, 32, 8, 96, 96, torch.bfloat16, dict()),
]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape", SIMT_CUDA_SHAPES)
def test_cuda_simt_kernel_matches_plain_version(shape, cuda_device):
  """On the card: the CUDA-core kernel (one launch, none of the tensor-core
  kernel) against the plain version in f32 on the same inputs, by the
  error model of the output's dtype (``compare_with_plain``)."""
  b, sq, skv, h, hkv, d, dv, dtype, opts = shape
  q, k, v = (as_torch(x, dtype).to(cuda_device)
             for x in _inputs(b, sq, skv, h, hkv, d, dv))
  if opts.get("softcap"):
    q = q * 10
  before = dict(fa.LAUNCHES)
  got = fa.flash_attention(q, k, v, **opts)
  torch.cuda.synchronize()
  assert got.dtype == dtype
  assert fa.LAUNCHES == {**before, "flash_attention_simt":
                         before["flash_attention_simt"] + 1}
  causal = opts.pop("causal", True)
  cmp = fa.compare_with_plain(got, q, k, v, causal, **opts)
  assert cmp["finite"]
  assert cmp["tol_ratio"] <= 1.0, cmp
  assert cmp["rel_frob"] <= cmp["rel_frob_limit"], cmp


@pytest.mark.requires_cuda
def test_cuda_simt_entry_refuses_a_plan_it_cannot_run(cuda_device):
  """The C entry point recounts the plan's shared bytes and refuses one
  that differs, a row block its path lacks, or a fourth stage, with
  cudaErrorInvalidValue (1) and no launch; the plan ``simt_plan`` gives
  runs.  Misaligned tensors raise in the wrapper before any launch."""
  import ctypes

  from repro_torch.kernels import _build
  q, k, v = (as_torch(x).to(cuda_device)
             for x in _inputs(1, 64, 64, 4, 2, 32, 32))
  out = torch.empty_like(q)
  launch = _build.entry(
      "flash_attention_simt", "flash_attention_simt_launch",
      [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_float] * 2
      + [ctypes.c_int] * 4 + [ctypes.c_void_p])
  plan = fa.simt_plan(q.dtype, 1, 64, 4, 2, 32, 32)

  def run(rows, keys, stages, smem):
    return launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  0, 1, 64, 64, 4, 2, 32, 32, 1, 0, 0, 32 ** -0.5, 0.0,
                  rows, keys, stages, smem,
                  _build.current_stream(q.device))

  good = (plan["rows"], plan["keys"], plan["stages"], plan["smem"])
  assert run(*good) == 0
  torch.cuda.synchronize()
  for bad in ((good[0], good[1], good[2], good[3] + 16),
              (128, good[1], good[2],
               fa.simt_smem_bytes("ffma", 128, good[2], 32, 32)),
              (good[0], 32, good[2], good[3]),
              (good[0], good[1], 3,
               fa.simt_smem_bytes("ffma", good[0], 3, 32, 32))):
    assert run(*bad) == 1, bad
  flat = torch.zeros(q.numel() + 1, device=cuda_device)
  shifted = flat[1:].view(q.shape)
  before = dict(fa.LAUNCHES)
  with pytest.raises(ValueError, match="16-byte aligned"):
    fa.flash_attention(shifted, k, v)
  assert fa.LAUNCHES == before


@pytest.mark.requires_cuda
def test_cuda_simt_gradients_within_the_backward_model(cuda_device):
  """f32 under autograd on the card: the CUDA-core kernel's forward and
  ``flash_attention_bwd``, held to the backward's error model."""
  xs = [as_torch(x).to(cuda_device).requires_grad_(True)
        for x in _inputs(2, 100, 100, 4, 2, 32, 32)]
  out = fa.flash_attention(*xs, True)
  do = as_torch(rng.normal(size=out.shape)).to(cuda_device)
  grads = torch.autograd.grad(out, xs, do)
  torch.cuda.synchronize()
  for name, cmp in fa.compare_bwd_with_plain(
      grads, *(x.detach() for x in xs), do, True).items():
    assert cmp["finite"] and cmp["tol_ratio"] <= 1.0, (name, cmp)
