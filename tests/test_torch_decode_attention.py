"""Decode attention's split-KV kernel (``kernels/decode_attention.py``).

Here: the launch plan (every valid position in exactly one part, for
windows, ``cache_len`` 1 and full, a sharded block's offset and an empty
local range; its shared bytes within the card's), the plain version's
log-sum-exp against ``torch.logsumexp`` of the masked f32 scores and its
empty block, the custom op's fake implementation, and the checks that
refuse a dtype or width the kernel lacks.  On the card
(``requires_cuda``): the kernel against the plain version in f32 by its
error model (``compare_with_plain``) at grok-1's decode shape, under a
window and a soft-cap, in f32, at every head width and G the port's
models use, on a non-contiguous q and strided caches, on an all-masked
block, its refusals, the model path's launch count, and the decode
position's cached rope angles bit for bit the uncached ones.
"""

from __future__ import annotations

import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from test_torch_common import cuda_device  # noqa: E402,F401

from repro_torch.kernels import decode_attention as da  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32


# ---------------------------------------------------------------------------
# The plan.
# ---------------------------------------------------------------------------

# (dtype, B, H, Hkv, D, S, lo, cache_len, window)
PLAN_CASES = [
    (BF16, 32, 48, 8, 128, 6144, 0, 1, 0),        # grok, first position
    (BF16, 32, 48, 8, 128, 6144, 0, 2048, 0),
    (BF16, 32, 48, 8, 128, 6144, 0, 2049, 0),
    (BF16, 32, 48, 8, 128, 6144, 0, 3300, 0),
    (BF16, 32, 48, 8, 128, 6144, 0, 6144, 0),     # full
    (BF16, 8, 16, 8, 256, 2080, 0, 2000, 1024),   # gemma's local layers
    (BF16, 8, 16, 8, 256, 2080, 0, 700, 1024),    # window not yet binding
    (BF16, 8, 10, 1, 256, 4096, 0, 4096, 2048),   # recurrentgemma, G 10
    (BF16, 1, 32, 32, 80, 17, 0, 17, 0),          # stablelm, one tile
    (BF16, 2, 40, 2, 64, 64, 0, 64, 0),           # G 20: two row groups
    (F32, 2, 4, 2, 16, 48, 0, 33, 32),            # smoke, window
    (F32, 2, 20, 2, 256, 300, 0, 299, 0),         # f32, G 10, D 256
    (BF16, 4, 8, 2, 128, 100, 100, 130, 0),       # sharded block [100, 200)
    (BF16, 4, 8, 2, 128, 100, 100, 90, 0),        # block past cache_len
    (BF16, 4, 8, 2, 128, 100, 0, 300, 50),        # block before the window
]


def _part_ranges(plan, start: int, length: int) -> list[tuple[int, int]]:
  """The positions [begin, end) of each part, as the kernel's warps take
  them (``warp_range`` in csrc/decode_attention.cu)."""
  end = start + length
  out = []
  for i in range(plan["parts"]):
    k0 = min(end, start + i * plan["part_keys"])
    out.append((k0, min(end, k0 + plan["part_keys"])))
  return out


@pytest.mark.parametrize("case", PLAN_CASES)
def test_split_plan_covers_every_valid_position_once(case):
  dtype, b, h, hkv, d, s, lo, cache_len, window = case
  start, length = da.valid_range(lo, s, cache_len, window)
  first = max(cache_len - window, 0) if window > 0 else 0
  want = [p - lo for p in range(lo, lo + s) if first <= p < cache_len]
  assert list(range(start, start + length)) == want
  plan = da.split_plan(dtype, b, h, hkv, d, length)
  assert plan["part_keys"] % da.TILE_KEYS == 0
  assert plan["part_keys"] >= da.MIN_PART_TILES * da.TILE_KEYS
  assert plan["row_groups"] * plan["rows"] >= h // hkv
  assert (plan["row_groups"] - 1) * plan["rows"] < h // hkv
  assert plan["grid"] == (-(-plan["parts"] // da.WARPS),
                          hkv * plan["row_groups"], b)
  assert 1 <= plan["stages"] <= da.MAX_STAGES
  assert plan["smem"] == da.smem_bytes(dtype, d, plan["stages"])
  assert plan["smem"] <= da.SMEM_LIMIT
  covered = []
  for k0, k1 in _part_ranges(plan, start, length):
    assert k0 < k1 or length == 0
    covered.extend(range(k0, k1))
  assert covered == want
  if length == 0:
    assert plan["parts"] == 1


def test_split_plan_fills_the_card_at_grok_decode():
  """At grok's decode shape the parts bring ~4 waves of warps and keep
  some hundreds of keys (at least 128) a part."""
  for cache_len in (2048, 3300, 6144):
    plan = da.split_plan(BF16, 32, 48, 8, 128, cache_len)
    warps = plan["parts"] * 32 * 8
    assert 0.5 * da.TARGET_WARPS <= warps <= 1.5 * da.TARGET_WARPS
    assert plan["part_keys"] >= 128 and plan["stages"] == 3


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_every_width_has_a_plan_that_fits(dtype):
  for d in range(8, 257, 8):
    plan = da.split_plan(dtype, 1, 8, 1, d, 1000)
    assert plan["smem"] <= da.SMEM_LIMIT


# ---------------------------------------------------------------------------
# The plain version.
# ---------------------------------------------------------------------------


def _masked_scores(q, k, lo, cache_len, window, softcap):
  b, h, d = q.shape
  s, hkv = k.shape[1:3]
  kh = k.float().repeat_interleave(h // hkv, dim=2)
  scores = torch.einsum("bhd,bkhd->bhk", q.float(), kh) / math.sqrt(d)
  if softcap > 0:
    scores = torch.tanh(scores / softcap) * softcap
  pos = torch.arange(lo, lo + s)
  valid = pos < cache_len
  if window > 0:
    valid &= pos >= cache_len - window
  return scores.masked_fill(~valid, -math.inf)


@pytest.mark.parametrize("lo,cache_len,window,softcap",
                         [(0, 1, 0, 0.0), (0, 10, 0, 0.0), (0, 24, 0, 0.0),
                          (0, 20, 6, 0.0), (0, 15, 0, 5.0), (8, 12, 0, 0.0),
                          (8, 30, 20, 5.0)])
def test_plain_lse_is_the_masked_scores_logsumexp(lo, cache_len, window,
                                                  softcap):
  g = torch.Generator().manual_seed(3)
  q = torch.randn(2, 6, 16, generator=g)
  k, v = (torch.randn(2, 24, 2, 16, generator=g) for _ in range(2))
  o, lse = da.decode_block_plain(q, k, v, lo, cache_len, window, softcap)
  scores = _masked_scores(q, k, lo, cache_len, window, softcap)
  torch.testing.assert_close(lse, torch.logsumexp(scores, -1), rtol=1e-6,
                             atol=1e-6)
  p = torch.softmax(scores, -1)
  want = torch.einsum("bhk,bkhd->bhd", p,
                      v.repeat_interleave(3, dim=2))
  torch.testing.assert_close(o, want, rtol=1e-5, atol=1e-6)
  # The device dispatch takes the CPU to the plain version.
  o2, lse2 = da.decode_block(q, k, v, lo, cache_len, window, softcap)
  assert torch.equal(o, o2) and torch.equal(lse, lse2)


def test_plain_empty_block_gives_zero_and_minus_inf():
  q = torch.randn(2, 4, 8)
  k, v = torch.randn(2, 10, 2, 8), torch.randn(2, 10, 2, 8)
  for lo, cache_len, window in ((10, 5, 0), (0, 40, 8)):
    o, lse = da.decode_block_plain(q, k, v, lo, cache_len, window)
    assert torch.equal(o, torch.zeros_like(o))
    assert bool(torch.isneginf(lse).all()) and lse.dtype == F32


# ---------------------------------------------------------------------------
# The launch op's fake implementation and the checks.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_fake_implementation_gives_the_shapes(dtype):
  from torch._subclasses.fake_tensor import FakeTensorMode

  with FakeTensorMode():
    q = torch.empty(4, 12, 64, dtype=dtype)
    k = torch.empty(4, 100, 2, 64, dtype=dtype)
    o, lse = torch.ops.repro_torch.decode_attention(q, k, k, 3, 50, 0.0)
  assert tuple(o.shape) == (4, 12, 64) and o.dtype == dtype
  assert tuple(lse.shape) == (4, 12) and lse.dtype == F32


@pytest.mark.parametrize("what", ["f16", "f64", "int", "width_12",
                                  "width_264", "dv", "dtypes", "heads",
                                  "strides", "q_rank"])
def test_check_refuses_what_the_kernel_lacks(what):
  b, h, hkv, s, d = 2, 8, 2, 32, 64
  dtype, dv = BF16, d
  if what in ("f16", "f64"):
    dtype = {"f16": torch.float16, "f64": torch.float64}[what]
  if what == "width_12":
    d = dv = 12
  if what == "width_264":
    d = dv = 264
  if what == "dv":
    dv = 32
  q = torch.zeros(b, h, d, dtype=dtype)
  if what == "int":
    q = q.to(torch.int32)
  k = torch.zeros(b, s, hkv, d, dtype=dtype)
  v = torch.zeros(b, s, hkv, dv, dtype=dtype)
  if what == "dtypes":
    v = v.float()
  if what == "heads":
    k = v = torch.zeros(b, s, 3, d, dtype=dtype)
  if what == "strides":
    k = torch.zeros(b, s, hkv, d + 4, dtype=dtype)[..., :d]
  if what == "q_rank":
    q = q[:, None]
  err = TypeError if what in ("f16", "f64", "int", "dtypes") else ValueError
  with pytest.raises(err):
    da._check(q, k, v)


def test_launch_op_refuses_cpu_and_dispatch_refuses_other_devices():
  q = torch.zeros(1, 2, 8)
  k = torch.zeros(1, 4, 1, 8)
  with pytest.raises(ValueError, match="CUDA tensors"):
    da._launch(q, k, k, 0, 4, 0.0)
  with pytest.raises(ValueError, match="CPU or CUDA"):
    da.decode_block(q.to("meta"), k.to("meta"), k.to("meta"), 0, 4)


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------


def _inputs(dev, b, h, hkv, d, s, dtype, seed=0, scale=1.0):
  g = torch.Generator(device=dev).manual_seed(seed)
  q = torch.randn(b, h, d, generator=g, device=dev, dtype=F32) * scale
  k = torch.randn(b, s, hkv, d, generator=g, device=dev, dtype=F32)
  v = torch.randn(b, s, hkv, d, generator=g, device=dev, dtype=F32)
  return q.to(dtype), k.to(dtype), v.to(dtype)


def _held(dev, q, k, v, lo=0, cache_len=None, window=0, softcap=0.0):
  cache_len = k.shape[1] if cache_len is None else cache_len
  before = da.LAUNCHES["decode_attention"]
  o, lse = da.decode_block(q, k, v, lo, cache_len, window, softcap)
  torch.cuda.synchronize(dev)
  assert da.LAUNCHES["decode_attention"] == before + 1
  assert o.dtype == q.dtype and lse.dtype == F32
  assert tuple(o.shape) == tuple(q.shape) and tuple(lse.shape) == q.shape[:2]
  cmp = da.compare_with_plain(o, lse, q, k, v, lo, cache_len, window,
                              softcap)
  assert cmp["finite"] and cmp["empty_ok"], cmp
  assert cmp["tol_ratio"] <= 1.0 and cmp["lse_ratio"] <= 1.0, cmp
  assert cmp["rel_frob"] <= cmp["rel_frob_limit"], cmp
  return cmp


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cache_len", [1, 2048, 2049, 6144])
def test_cuda_kernel_at_grok_decode(cache_len, cuda_device):
  q, k, v = _inputs(cuda_device, 32, 48, 8, 128, 6144, BF16)
  _held(cuda_device, q, k, v, cache_len=cache_len)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("d,window,softcap,cache_len",
                         [(256, 1024, 0.0, 2000), (256, 1024, 0.0, 700),
                          (128, 0, 30.0, 1500), (128, 300, 30.0, 1500)])
def test_cuda_kernel_window_and_softcap(d, window, softcap, cache_len,
                                        cuda_device):
  q, k, v = _inputs(cuda_device, 4, 16, 8, d, 2080, BF16, scale=10.0)
  _held(cuda_device, q, k, v, cache_len=cache_len, window=window,
        softcap=softcap)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("d,g", [(16, 2), (64, 4), (80, 1), (128, 6),
                                 (256, 10), (64, 8), (32, 20)])
def test_cuda_kernel_f32(d, g, cuda_device):
  q, k, v = _inputs(cuda_device, 3, 2 * g, 2, d, 333, F32)
  _held(cuda_device, q, k, v, cache_len=301)
  _held(cuda_device, q, k, v, cache_len=301, window=100, softcap=5.0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("d", [64, 80, 256])
@pytest.mark.parametrize("g", [1, 2, 4, 6, 8, 10])
def test_cuda_kernel_widths_and_groups(d, g, cuda_device):
  q, k, v = _inputs(cuda_device, 4, 2 * g, 2, d, 1000, BF16)
  _held(cuda_device, q, k, v, cache_len=777)


@pytest.mark.requires_cuda
def test_cuda_kernel_many_row_groups_and_small_widths(cuda_device):
  """G past one row group (16 heads), and widths 8 to 48 (an odd D / 8 and
  a D that is no multiple of 16)."""
  q, k, v = _inputs(cuda_device, 2, 40, 2, 128, 500, BF16)
  _held(cuda_device, q, k, v, cache_len=450)
  for d in (8, 24, 40, 48):
    q, k, v = _inputs(cuda_device, 2, 8, 2, d, 200, BF16)
    _held(cuda_device, q, k, v, cache_len=199)


@pytest.mark.requires_cuda
def test_cuda_kernel_non_contiguous_q_and_strided_caches(cuda_device):
  q, k, v = _inputs(cuda_device, 4, 24, 4, 128, 600, BF16)
  qt = q.transpose(0, 1).contiguous().transpose(0, 1)
  assert not qt.is_contiguous()
  _held(cuda_device, qt, k, v, cache_len=555)
  # The first 4 of 8 kv heads of a wider cache: read in place.
  _, kw, vw = _inputs(cuda_device, 4, 24, 8, 128, 600, BF16, seed=1)
  ks, vs = kw[:, :, :4], vw[:, :, :4]
  assert not ks.is_contiguous()
  _held(cuda_device, q, ks, vs, cache_len=555)


@pytest.mark.requires_cuda
def test_cuda_kernel_on_sharded_and_all_masked_blocks(cuda_device):
  """A block of positions [lo, lo + S) as a rank of a sequence-sharded
  cache holds it: partly valid, and all masked (past cache_len, before the
  window), which gives o = 0 and lse = -inf."""
  q, k, v = _inputs(cuda_device, 4, 12, 2, 128, 256, BF16)
  _held(cuda_device, q, k, v, lo=256, cache_len=400)
  for lo, cache_len, window in ((512, 400, 0), (0, 1000, 300)):
    cmp = _held(cuda_device, q, k, v, lo=lo, cache_len=cache_len,
                window=window)
    assert cmp["empty_ok"]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("what", ["f16", "width_12", "dv"])
def test_cuda_call_outside_the_kernel_raises(what, cuda_device):
  d, dv, dtype = 64, 64, BF16
  if what == "f16":
    dtype = torch.float16
  if what == "width_12":
    d = dv = 12
  if what == "dv":
    dv = 32
  q = torch.zeros(2, 4, d, dtype=dtype, device=cuda_device)
  k = torch.zeros(2, 16, 2, d, dtype=dtype, device=cuda_device)
  v = torch.zeros(2, 16, 2, dv, dtype=dtype, device=cuda_device)
  before = da.LAUNCHES["decode_attention"]
  with pytest.raises((TypeError, ValueError)):
    da.decode_block(q, k, v, 0, 10)
  assert da.LAUNCHES["decode_attention"] == before


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch,dtype", [("grok-1-314b", "bfloat16"),
                                        ("llama3.2-1b", "float32")])
def test_model_decode_step_launches_once_an_attention_layer(arch, dtype,
                                                            cuda_device):
  from repro_torch.configs.smoke import smoke_config
  from repro_torch.kernels import ops
  from repro_torch.launch import steps
  from repro_torch.models import transformer as T

  cfg = dataclasses.replace(smoke_config(arch), dtype=dtype)
  model = T.init_params(cfg, 0, cuda_device)
  tokens = torch.randint(0, cfg.vocab_size, (2, 8), device=cuda_device)
  prefill = steps.make_prefill_step(cfg, 16)
  decode = steps.make_decode_step(cfg)
  with torch.inference_mode():
    ops.reset_all_launches()
    logits, caches = prefill(model, {"tokens": tokens})
    assert ops.all_launches()["decode_attention"] == 0
    for i in range(3):
      tok = torch.argmax(logits, -1)
      logits, caches = decode(model, caches, tok, 8 + i)
      assert ops.all_launches()["decode_attention"] == (i + 1) * cfg.num_layers
  assert bool(torch.isfinite(logits).all())


@pytest.mark.requires_cuda
def test_cuda_rope_at_a_decode_position_is_the_uncached_formula(cuda_device):
  """A decode step's rope on the card takes its cos and sin from a table
  made once a position (``layers._rope_angles``): bit for bit the angles
  ``rope`` computes for a position tensor, in and out of inference mode."""
  from repro_torch.models import layers

  g = torch.Generator(device=cuda_device).manual_seed(5)
  for dtype in (BF16, F32):
    x = torch.randn(4, 6, 128, generator=g, device=cuda_device).to(dtype)
    for pos in (0, 1, 2047, 3300):
      want = layers.rope(x[:, None], torch.tensor([pos], device=cuda_device),
                         10000.0)[:, 0]
      assert torch.equal(layers.rope(x, pos, 10000.0), want)
      with torch.inference_mode():
        assert torch.equal(layers.rope(x, pos, 10000.0), want)
