"""The paper's three quality experiments in the reference's order (Figure 4
top-k, Table 1 label ranking, Figures 6-7 soft LTS): the counterpart of
the reference's ``python -m benchmarks.run --only
fig4_topk,table1_label_ranking,fig6_fig7_lts``, without its artifact.

  PYTHONPATH=src python -m repro_torch.experiments [--device cpu]
"""

from __future__ import annotations

import argparse

from repro_torch.examples import add_device_arg, device_of
from repro_torch.experiments import (
    HEADER, bench_label_ranking, bench_lts, bench_topk)

ORDER = (bench_topk, bench_label_ranking, bench_lts)


def main(argv=None) -> list[dict]:
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  add_device_arg(ap)
  args = ap.parse_args(argv)
  device_of(args.device)   # refuse before the header where there is no card
  print(HEADER)
  rows: list[dict] = []
  for mod in ORDER:
    rows += mod.main(["--device", args.device])
  return rows


if __name__ == "__main__":
  main()
