"""Core: fast differentiable sorting and ranking (Blondel et al., ICML 2020).

Counterpart of ``repro.core`` in PyTorch.  O(n log n) soft sort/rank via
projection onto the permutahedron, reduced to isotonic optimization solved
exactly by PAV (a CUDA kernel on the GPU), with O(n) exact Jacobian
products (no differentiation through solver iterates).
"""

from repro_torch.core.isotonic import (
    isotonic_kl,
    isotonic_l2,
    set_default_impl,
    use_impl,
)
from repro_torch.core.losses import (
    hard_rank,
    soft_lts_loss,
    soft_spearman_loss,
    soft_topk_loss,
    soft_trimmed_token_loss,
    spearman_correlation,
    topk_accuracy,
)
from repro_torch.core.operators import (
    eps_max,
    eps_min,
    soft_quantile,
    soft_rank,
    soft_rank_kl_direct,
    soft_sort,
    soft_topk_mask,
)
from repro_torch.core.permutations import SortContext
from repro_torch.core.projection import projection_permutahedron
from repro_torch.plan import (
    ExecutionPlan,
    PlanRule,
    load_plan,
    set_active_plan,
    use_plan,
)

__all__ = [
    "SortContext",
    "ExecutionPlan",
    "PlanRule",
    "load_plan",
    "set_active_plan",
    "use_plan",
    "set_default_impl",
    "use_impl",
    "isotonic_kl",
    "isotonic_l2",
    "projection_permutahedron",
    "soft_sort",
    "soft_rank",
    "soft_rank_kl_direct",
    "soft_topk_mask",
    "soft_quantile",
    "eps_min",
    "eps_max",
    "soft_spearman_loss",
    "spearman_correlation",
    "hard_rank",
    "soft_topk_loss",
    "topk_accuracy",
    "soft_lts_loss",
    "soft_trimmed_token_loss",
]
