"""CLI: validate BENCH artifacts, ``python -m repro_torch.obs FILE...``."""

from repro_torch.obs.artifacts import main

raise SystemExit(main())
