"""The port's serving slice as a whole, against the reference's server.

``smoke_config("deepseek-v2-lite-16b")`` in f32 with the reference's own
random weights (``from_jax_params``): a prefill of (2, 32) prompt tokens
from the token pipeline and 4 greedy decode steps, through the reference's
jitted step functions and the port's ``serve.generate``.  Logits agree
within 1e-5 * (1 + max|logits|) at every step and the greedy tokens are
identical.  Also the command line: ``--smoke --device cpu`` runs, the
default device raises where there is no card, and what is not ported
raises.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_common import (  # noqa: E402
    assert_close,
    composed_ref,  # noqa: F401
)

from repro.configs.smoke import smoke_config as jsmoke_config  # noqa: E402
from repro.data.pipeline import pipeline_for_arch as jpipeline  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch.configs.smoke import smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import convert  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
BATCH, PROMPT, GEN = 2, 32, 5
pytestmark = pytest.mark.usefixtures("composed_ref")


def _reference_run(jcfg, params, tokens):
  """The reference server's loop (launch/serve.py::run_lm): jitted
  prefill, then greedy decode steps."""
  prefill = jax.jit(jsteps.make_prefill_step(jcfg, PROMPT + GEN))
  decode = jax.jit(jsteps.make_decode_step(jcfg))
  logits, caches = prefill(params, {"tokens": jnp.asarray(tokens)})
  tok = jnp.argmax(logits, -1)
  all_logits, all_tokens = [np.asarray(logits)], [np.asarray(tok)]
  for i in range(GEN - 1):
    logits, caches = decode(params, caches, tok, jnp.int32(PROMPT + i))
    tok = jnp.argmax(logits, -1)
    all_logits.append(np.asarray(logits))
    all_tokens.append(np.asarray(tok))
  return all_logits, np.stack(all_tokens, axis=1), caches


def test_prefill_and_decode_match_the_reference_server():
  jcfg, cfg = jsmoke_config(ARCH), smoke_config(ARCH)
  params = jtransformer.init_params(jcfg, jax.random.PRNGKey(0))
  tokens = jpipeline(jcfg, BATCH, PROMPT).batch_at(0)["tokens"]
  want_logits, want_tokens, want_caches = _reference_run(jcfg, params,
                                                         tokens)

  model = convert.from_jax_params(cfg, jax.tree.map(np.asarray, params))
  prefill = serve.ST.make_prefill_step(cfg, PROMPT + GEN)
  decode = serve.ST.make_decode_step(cfg)
  with torch.inference_mode():
    logits, caches = prefill(model, {"tokens": torch.from_numpy(tokens)})
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
  # The caches after the last step: latents of every written position.
  for i, cache in enumerate(caches):
    for key in ("c_kv", "k_rope"):
      want = np.asarray(want_caches[0]["l0_mla_moe"][key][i])
      assert_close(cache[key], want, want)

  # serve.generate, the server's loop, gives the same tokens.
  res = serve.generate(cfg, model, torch.from_numpy(tokens), GEN)
  np.testing.assert_array_equal(res["tokens"].numpy(), want_tokens)


def test_command_line_smoke_on_cpu(capsys):
  before = ops.all_launches()
  res = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "8", "--gen", "3"])
  out = capsys.readouterr().out
  assert "prefill 2x8" in out and "tok/s" in out and "parameters" in out
  assert tuple(res["tokens"].shape) == (2, 3)
  assert bool(torch.isfinite(res["logits"]).all())
  assert ops.all_launches() == before    # the CPU runs no kernel


def test_default_device_is_the_card():
  if torch.cuda.is_available():
    pytest.skip("a card is present: the default device runs")
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    serve.main(["--arch", ARCH, "--smoke"])


@pytest.mark.parametrize("argv, exc", [
    (["--arch", ARCH, "--device", "cpu"], ValueError),   # full size on CPU
    (["--arch", "llama3.2-1b", "--smoke", "--device", "cpu"],
     NotImplementedError),
])
def test_what_is_not_served_raises(argv, exc):
  with pytest.raises(exc):
    serve.main(argv)
