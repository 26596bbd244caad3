"""How far the f32 PAV solves drift from f64 (``repro_torch.analysis.
pav_precision``), and the port's f64 solve, which the measurement takes
as exact, against the reference's.

The measurement's own run is at 2^20 positions (minutes on one CPU core);
here the same rows at 8195 and 2^14 positions: the port's f64 divide and
conquer within 1e-10 * (1 + max|input|) of the reference's ``pav_l2_scan`` under
``jax.enable_x64(True)``, and both f32 solvers within the cross-backend
contract, 1e-5 * (1 + max|f64|), of it.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_common import CONTRACT_F64, assert_close  # noqa: E402

from repro.kernels import pav_scan as jscan  # noqa: E402
from repro_torch.analysis import pav_precision  # noqa: E402
from repro_torch.kernels import pav_scan  # noqa: E402


@pytest.mark.parametrize("n", [2**13 + 3, 2**14])
@pytest.mark.parametrize("row", ["two_ramps", "random"])
def test_f64_solve_is_the_references(row, n):
  y = pav_precision.rows(n)[row]
  with jax.enable_x64(True):
    want = np.asarray(jax.jit(jscan.pav_l2_scan)(jnp.asarray(y)))
  got = pav_scan.pav_l2_scan(torch.from_numpy(y))
  assert got.dtype == torch.float64
  assert_close(got, want, y, contract=CONTRACT_F64)
  if row == "two_ramps":
    np.testing.assert_allclose(got.numpy(), np.full_like(y, y.mean()),
                               rtol=1e-14)


def test_both_f32_solvers_stay_within_the_contract_of_f64(capsys):
  out = pav_precision.main(["--n", str(2**14)])
  assert sorted(out) == ["random", "two_ramps"]
  assert out["two_ramps"]["blocks_f64"] == 1
  for res in out.values():
    for solver in ("stack", "divide_and_conquer"):
      r = res[solver]
      assert r["rel_to_max"] <= 1e-5 and r["blocks"] == res["blocks_f64"]
  lines = capsys.readouterr().out.splitlines()
  assert len(lines) == 2 and all("nearer f64:" in line for line in lines)
