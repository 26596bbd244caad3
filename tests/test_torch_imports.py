"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or anything of the ``repro`` package."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
  top = name.split(".")[0]
  return top in ("jax", "jaxlib", "repro")


def _imports(path: Path):
  for node in ast.walk(ast.parse(path.read_text(), str(path))):
    if isinstance(node, ast.Import):
      yield from (a.name for a in node.names)
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
      yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_source_imports_no_jax_or_reference(path):
  bad = [name for name in _imports(path) if _forbidden(name)]
  assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax_or_reference():
  code = (
      "import sys\n"
      "import repro_torch, repro_torch.core, repro_torch.kernels.ops\n"
      "import repro_torch.core.baselines\n"
      "import repro_torch.kernels.dispatch, repro_torch.obs.tracing\n"
      "import repro_torch.kernels.soft_topk, repro_torch.kernels.flash_attention\n"
      "import repro_torch.configs.deepseek_v2_lite_16b, repro_torch.configs.smoke\n"
      "import repro_torch.configs.llama3_2_1b, repro_torch.configs.tinyllama_1_1b\n"
      "import repro_torch.configs.stablelm_3b, repro_torch.models.recurrent\n"
      "import repro_torch.configs.recurrentgemma_2b\n"
      "import repro_torch.configs.xlstm_350m, repro_torch.models.xlstm\n"
      "import repro_torch.configs.llava_next_mistral_7b\n"
      "import repro_torch.configs.musicgen_large\n"
      "import repro_torch.data.pipeline, repro_torch.models.convert\n"
      "import repro_torch.launch.serve, repro_torch.launch.steps\n"
      "import repro_torch.launch.train, repro_torch.optim.adamw\n"
      "import repro_torch.optim.schedule, repro_torch.optim.compression\n"
      "import repro_torch.checkpoint.checkpointer, repro_torch.obs.metrics\n"
      "import repro_torch.plan, repro_torch.obs.artifacts\n"
      "import repro_torch.obs.timing, repro_torch.serving.ops\n"
      "import repro_torch.serving.bucketing, repro_torch.serving.admission\n"
      "import repro_torch.serving.aot_cache, repro_torch.serving.engine\n"
      "import repro_torch.serving, repro_torch.kernels.segment_vjp\n"
      "import repro_torch.launch.mesh, repro_torch.launch.shapes\n"
      "import repro_torch.launch.dryrun, repro_torch.sharding.specs\n"
      "import repro_torch.sharding.local, repro_torch.analysis.roofline\n"
      "import repro_torch.analysis.cost, repro_torch.analysis.report\n"
      "import repro_torch.examples, repro_torch.examples.quickstart\n"
      "import repro_torch.examples.label_ranking\n"
      "import repro_torch.examples.robust_lm_training\n"
      "import repro_torch.examples.moe_soft_router\n"
      "import repro_torch.experiments, repro_torch.experiments.bench_lts\n"
      "import repro_torch.experiments.bench_label_ranking\n"
      "import repro_torch.experiments.bench_topk\n"
      "import repro_torch.experiments.__main__\n"
      "import repro_torch.tools, repro_torch.tools.sweeps\n"
      "import repro_torch.tools.autotune, repro_torch.tools.check_backends\n"
      "bad = sorted(m for m in sys.modules\n"
      "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
      "print(bad)\n"
      "sys.exit(1 if bad else 0)\n")
  env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
  proc = subprocess.run([sys.executable, "-c", code], env=env,
                        capture_output=True, text=True, timeout=120)
  assert proc.returncode == 0, proc.stdout + proc.stderr
