"""The CUDA-core attention kernel's launch plan, chosen on the host.

``repro_torch.kernels.flash_attention.simt_plan`` picks, for every (dtype,
D, Dv) that ``route`` sends to ``csrc/flash_attention_simt.cu``, the path
(FFMA for f32, mma.sync for bf16), the query rows a block, the keys a tile,
the stages of the K/V ring and the shared bytes, and the block count.  The
kernel's entry point recounts the shared bytes and refuses a plan that
differs or does not fit; that check runs on the card
(``test_torch_flash_attention.py``).  Here, at every width that is a
multiple of 8 up to 256, in both dtypes and on a few grids: the plan fits
in the 227 KB a block may take, its path follows the dtype, its row block
is the largest that fits and fills the card's 132 SMs, a small grid gets a
smaller row block than a large one, and the route is the one it was.
"""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402

WIDTHS = tuple(range(8, fa.SIMT_MAX_WIDTH + 1, 8))
# (B, Sq, H, Hkv): the smoke configs' attention (a small grid), the robust
# LM example's --full layers, llama3.2-1b's prefill (a large grid), and one
# position of 200 query heads over one kv head (G past 128).
GRIDS = ((2, 48, 4, 2), (8, 128, 12, 4), (8, 512, 32, 8), (1, 1, 200, 1))
SMALL, LARGE = GRIDS[0], GRIDS[2]


def _fits(path, d, dv):
  """(rows, stages) of each row block of the path that fits, largest
  first, with two stages where they fit."""
  out = []
  for rows in fa.simt_row_blocks(path, dv):
    for stages in (2, 1):
      if fa.simt_smem_bytes(path, rows, stages, d, dv) <= fa.SIMT_SMEM_LIMIT:
        out.append((rows, stages))
        break
  return out


def _blocks(rows, b, sq, h, hkv):
  return -(-sq * (h // hkv) // rows) * b * hkv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", WIDTHS)
def test_simt_plan_at_every_width(dtype, d):
  for dv in WIDTHS:
    if dtype == torch.bfloat16 and (d, dv) in fa.KERNEL_WIDTHS:
      assert fa.route(dtype, d, dv) == "wgmma"
      with pytest.raises(ValueError, match="tensor-core kernel"):
        fa.simt_plan(dtype, *LARGE, d, dv)
      continue
    assert fa.route(dtype, d, dv) == "simt"
    path = "mma" if dtype == torch.bfloat16 else "ffma"
    fits = _fits(path, d, dv)
    assert fits, (d, dv)
    plans = {}
    for grid in GRIDS:
      plan = fa.simt_plan(dtype, *grid, d, dv)
      plans[grid] = plan
      assert plan["path"] == path
      assert plan["keys"] == fa.SIMT_KEYS == 64
      assert (plan["rows"], plan["stages"]) in fits, (grid, d, dv, plan)
      assert plan["smem"] == fa.simt_smem_bytes(
          path, plan["rows"], plan["stages"], d, dv)
      assert plan["smem"] <= 232_448
      assert plan["blocks"] == _blocks(plan["rows"], *grid)
      # The largest row block that still fills the card, else the smallest.
      filling = [r for r, _ in fits if _blocks(r, *grid) >= fa.SIMT_SMS]
      assert plan["rows"] == (filling[0] if filling else fits[-1][0])
    assert plans[SMALL]["rows"] <= plans[LARGE]["rows"]
    if len(fits) > 1:
      assert plans[SMALL]["rows"] < plans[LARGE]["rows"], (d, dv, plans)


def test_simt_row_blocks_hold_the_o_registers():
  """The largest row block of each path only up to Dv = 128."""
  assert fa.simt_row_blocks("ffma", 128) == (64, 32, 16)
  assert fa.simt_row_blocks("ffma", 136) == (32, 16)
  assert fa.simt_row_blocks("mma", 128) == (128, 64, 32, 16)
  assert fa.simt_row_blocks("mma", 136) == (64, 32, 16)


@pytest.mark.parametrize("dtype, grid, d, dv, want", [
    # robust LM --full: 64 rows give 192 blocks, 128 would not fill the card.
    (torch.float32, (8, 128, 12, 4), 64, 64,
     dict(path="ffma", rows=64, stages=2, smem=102_400, blocks=192)),
    # MLA smoke widths: 24 blocks at the smallest row block.
    (torch.float32, (2, 48, 4, 4), 24, 16,
     dict(path="ffma", rows=16, stages=2, smem=28_672, blocks=24)),
    # llama3.2-1b's prefill under --set dtype=float32.
    (torch.float32, (8, 512, 32, 8), 64, 64,
     dict(path="ffma", rows=64, stages=2, smem=102_400, blocks=2048)),
    # bf16 (96, 96), G 4, one kv head: 16 rows a block, the 4 warps split
    # the keys 4 ways.
    (torch.bfloat16, (1, 333, 4, 1), 96, 96,
     dict(path="mma", rows=16, stages=2, smem=216_336, blocks=84)),
    # Two m16 tiles a warp, 128 rows a block.
    (torch.bfloat16, (8, 512, 32, 8), 96, 96,
     dict(path="mma", rows=128, stages=2, smem=79_888, blocks=1024)),
    # The widest f32 width: 32 rows (no 64 past Dv 128), one stage.
    (torch.float32, (1, 2048, 8, 8), 256, 256,
     dict(path="ffma", rows=32, stages=1, smem=174_080, blocks=512)),
])
def test_simt_plan_at_the_timed_shapes(dtype, grid, d, dv, want):
  assert fa.simt_plan(dtype, *grid, d, dv) == {"keys": 64, **want}


def test_simt_plan_refuses_what_route_refuses():
  for dtype, d, dv in ((torch.float32, 264, 264), (torch.bfloat16, 20, 20),
                       (torch.float16, 64, 64)):
    with pytest.raises(ValueError, match="multiples of 8"):
      fa.simt_plan(dtype, 1, 8, 4, 4, d, dv)
