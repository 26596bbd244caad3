"""Shared helpers for the PyTorch port's parity tests (holds no tests).

Every parity test feeds the same numpy inputs, made from a fixed seed, to a
function of the JAX reference (``repro``) and to its counterpart in the port
(``repro_torch``), and compares values and VJPs (``jax.vjp`` against
``torch.autograd.grad``).

Tolerances: the reference's own cross-backend contract,
|a - b| <= 1e-5 * (1 + max|input|) (``CONTRACT``).  A value compared in
``assert_vjp_parity`` is held to 1e-5 * (1 + max(|input|, |want|)): a loss
can be far larger than its inputs (a sum over a batch), and f32 cannot
hold it closer than a few ulp of its own size; its gradients stay scaled
by the inputs and the cotangent.  float64 runs must agree
far tighter (``CONTRACT_F64``), which also shows the port keeps f64 in f64.
bf16 results are held at bf16 precision (``CONTRACT_BF16``: 8 bits of
mantissa, so a few units of 2^-8 relative to the output's scale).

Reference calls are jitted (an eager reference VJP recompiles every
primitive per shape and costs seconds) and run with
``REPRO_PROJECTION=composed``: the reference's fused path calls
``jax.experimental.enable_x64``, which the installed JAX no longer has.
"""

from __future__ import annotations

import concurrent.futures
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

CONTRACT = 1e-5
CONTRACT_F64 = 1e-10
CONTRACT_BF16 = 5e-2
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def composed_ref(monkeypatch):
  """Route the reference's projections through its composed path, and its
  isotonic solves that take no ``impl=`` (the losses) through minimax,
  the backend whose jitted VJP compiles fastest."""
  monkeypatch.setenv("REPRO_PROJECTION", "composed")
  monkeypatch.setenv("REPRO_BACKEND", "minimax")
  monkeypatch.delenv("REPRO_TORCH_BACKEND", raising=False)
  monkeypatch.delenv("REPRO_TORCH_PROJECTION", raising=False)


@pytest.fixture
def packaged_plan(monkeypatch):
  """Isolate the chain's packaged plan: ``use(path)`` makes the file at
  ``path`` the packaged plan (None: no packaged plan) and drops the cached
  one; the cache is dropped again after the test, so later tests load the
  shipped file."""
  from repro_torch import plan as plan_mod
  shipped = plan_mod.DEFAULT_PLAN_PATH

  def use(path):
    monkeypatch.setattr(plan_mod, "DEFAULT_PLAN_PATH", str(
        path if path is not None else ROOT / "tests" / "no_such_plan.json"))
    plan_mod.invalidate_default_plan_cache()

  yield use
  monkeypatch.setattr(plan_mod, "DEFAULT_PLAN_PATH", shipped)
  plan_mod.invalidate_default_plan_cache()


@pytest.fixture
def no_packaged_plan(packaged_plan):
  """The chain without a packaged plan: the active and built-in plans
  only."""
  packaged_plan(None)


@pytest.fixture
def cuda_device():
  """The first CUDA device; skips where there is none."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device (the kernels run only on the card)")
  return torch.device("cuda", 0)


def rows_with_ties(rng, rows: int, n: int) -> np.ndarray:
  """A (rows, n) batch: random rows, a row of ties, a constant row."""
  x = rng.normal(size=(rows, n))
  if rows > 1:
    x[1] = np.round(x[1] * 2) / 2
  if rows > 2:
    x[2] = 0.75
  return x


def sorted_desc(x: np.ndarray) -> np.ndarray:
  return np.ascontiguousarray(np.sort(x, axis=-1)[..., ::-1])


def as_torch(x, dtype=torch.float32, grad: bool = False) -> torch.Tensor:
  return torch.tensor(np.asarray(x), dtype=dtype, requires_grad=grad)


def as_np(x) -> np.ndarray:
  if isinstance(x, torch.Tensor):
    return x.detach().to(torch.float64).numpy()
  return np.asarray(x, np.float64)


def assert_close(got, want, *inputs, contract: float = CONTRACT) -> None:
  """|got - want| <= contract * (1 + max|input|), elementwise."""
  got, want = as_np(got), as_np(want)
  assert got.shape == want.shape, (got.shape, want.shape)
  scale = max([float(np.max(np.abs(as_np(x)), initial=0.0))
               for x in inputs] + [0.0])
  np.testing.assert_allclose(got, want, rtol=0,
                             atol=contract * (1.0 + scale))


def jax_vjp(fn, args, cot, dtype=np.float32):
  """Jitted reference: (output, grads of every arg) for cotangent ``cot``."""

  def run(*a):
    out, pullback = jax.vjp(fn, *a)
    return out, pullback(jnp.asarray(cot, out.dtype))

  out, grads = jax.jit(run)(*[jnp.asarray(a, dtype) for a in args])
  return np.asarray(out), [np.asarray(g) for g in grads]


def torch_vjp(fn, args, cot, dtype=torch.float32):
  """Port: (output, grads of every arg) for cotangent ``cot``."""
  xs = [as_torch(a, dtype, grad=True) for a in args]
  out = fn(*xs)
  grads = torch.autograd.grad(out, xs, as_torch(cot, out.dtype))
  return out, grads


def assert_vjp_parity(jax_fn, torch_fns, args, cot, *, f64: bool = False):
  """Values and VJPs of the reference function and of each port function
  (one, or a sequence sharing one reference call) agree within the
  contract; values are scaled by the larger of the inputs and the wanted
  value, gradients by the inputs and the cotangent.  Returns the last
  port function's (output, grads)."""
  if callable(torch_fns):
    torch_fns = (torch_fns,)
  dtype, contract = ((torch.float64, CONTRACT_F64) if f64
                     else (torch.float32, CONTRACT))
  if f64:
    with jax.enable_x64(True):
      want, want_g = jax_vjp(jax_fn, args, cot, np.float64)
  else:
    want, want_g = jax_vjp(jax_fn, args, cot)
  for fn in torch_fns:
    got, got_g = torch_vjp(fn, args, cot, dtype)
    assert got.dtype == dtype
    assert_close(got, want, *args, want, contract=contract)
    for g, wg in zip(got_g, want_g):
      assert_close(g, wg, *args, cot, contract=contract)
  return got, got_g


@pytest.fixture
def reference_bench(composed_ref, monkeypatch):
  """A loader of the reference's ``benchmarks/<name>.py`` as a module, run
  unchanged: on the composed projection (fault R1) with the ``lax``
  backend (the reference's stack machine, the quickest to compile here),
  and with the repo's root on ``sys.path`` for its ``from
  benchmarks.common import emit``."""
  monkeypatch.setenv("REPRO_BACKEND", "lax")
  monkeypatch.syspath_prepend(str(ROOT))

  def load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

  return load


@pytest.fixture
def one_thread():
  """PyTorch on one CPU thread for the test.  The port's eager training
  loops run thousands of small ops, and a thread pool in each of several
  worker processes spins them against each other: a 150-step top-k
  training at 10 classes took 80 s instead of 1 s beside three such
  processes on 8 cores."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


@pytest.fixture
def port_scan(one_thread):
  """The port's isotonic solves on the CPU by the divide and conquer
  (``scan``), on one thread: the kernels' plain version, which the card's
  l2 kernel equals bit for bit, and which does not drift in f32 where the
  stack machine can (``tests/test_torch_pav_precision.py``)."""
  from repro_torch.core import use_impl
  with use_impl("scan"):
    yield


def reference_topk_train(ref, kind: str, n_classes: int, xtr, ytr,
                         steps: int):
  """``benchmarks/bench_topk.py::run``'s training of one loss, from its
  ``mlp_init(PRNGKey(0))``: (initial, final) weights as numpy."""
  loss_fn = ref.losses(n_classes)[kind]
  params = ref.mlp_init(jax.random.PRNGKey(0), n_classes)

  @jax.jit
  def step(p, lr=0.05):
    g = jax.grad(lambda q: loss_fn(ref.mlp_apply(q, xtr), ytr))(p)
    return jax.tree.map(lambda a, b: a - lr * b, p, g)

  final = params
  for _ in range(steps):
    final = step(final)
  return ({k: np.asarray(v) for k, v in params.items()},
          {k: np.asarray(v) for k, v in final.items()})


def lts_datasets(ref):
  """``benchmarks/bench_lts.py``'s datasets, Fig. 6's and the five outlier
  fractions', each as (the reference's, the port's), from one
  ``default_rng(0)`` each in the scripts' order."""
  from repro_torch.experiments import bench_lts
  rr, rp = np.random.default_rng(0), np.random.default_rng(0)
  return [(ref.make_data(rr, frac), bench_lts.make_data(rp, frac))
          for frac in (0.2, *bench_lts.OUTLIER_FRACS)]


def topk_datasets(ref):
  """(n_classes, the reference's (x, y), the port's), in the script's
  order from one rng each."""
  from repro_torch.experiments import bench_topk
  rr, rp = np.random.default_rng(0), np.random.default_rng(0)
  return [(n, ref.make_data(rr, n), bench_topk.make_data(rp, n))
          for n in bench_topk.CLASSES]


def full_length_accuracy(ref, kind: str, n_classes: int) -> None:
  """Both trainings of ``kind`` at ``n_classes`` for the full 150 steps
  from the reference's initial weights: accuracy within one test sample,
  both weights within their band."""
  from repro_torch.experiments import band, bench_topk, weights_apart
  (_, (jx, jy), (x, y)), = [d for d in topk_datasets(ref)
                            if d[0] == n_classes]
  n = int(len(x) * 0.8)
  init, _ = reference_topk_train(ref, kind, n_classes, jx[:n], jy[:n], 0)
  # The reference's training runs in a thread beside the port's (XLA lets
  # go of the interpreter while it computes): the test takes the longer
  # of the two, not their sum.
  with concurrent.futures.ThreadPoolExecutor(1) as pool:
    job = pool.submit(reference_topk_train, ref, kind, n_classes, jx[:n],
                      jy[:n], ref.STEPS)
    params = bench_topk.train(bench_topk.losses()[kind],
                              bench_topk.mlp_from_numpy(**init), x[:n],
                              y[:n])
    _, final = job.result()
  want = float(ref.topk_accuracy(ref.mlp_apply(final, jx[n:]), jy[n:], 1))
  got = float(bench_topk.topk_accuracy(bench_topk.mlp_apply(params, x[n:]),
                                       y[n:], 1))
  assert abs(got - want) <= band("test_acc", want, len(x) - n), (kind, got,
                                                                 want)
  err, tol = weights_apart(params, final)
  assert err <= tol, (kind, err, tol)
