"""Serializable execution plans: every dispatch decision in one object.

Counterpart of ``repro.plan``, a copy in the standard library (the port
imports nothing of the JAX package).  An :class:`ExecutionPlan` is an
ordered table of :class:`PlanRule` entries, each mapping a
``(kind, op, regularization, platform, dtype, shape-bucket)`` regime to a
concrete backend, where ``kind`` is ``"forward"`` (isotonic solver),
``"backward"`` (Lemma 2 VJP formulation) or ``"projection"`` (fused or
composed pipeline).  Plans round-trip through JSON under schema
``repro.plan/v1`` with strict unknown-field and version rejection, and a
content hash (:meth:`ExecutionPlan.plan_hash`) names the plan in BENCH
artifacts.  A plan file of the reference parses here to the same rules and
the same hash.

``platform`` is the tensor's device type, ``"cuda"`` or ``"cpu"``; ``dtype``
is its dtype without the ``torch.`` prefix (``"float32"``), the spelling of
the reference.

Resolution (``repro_torch.kernels.dispatch``) walks one chain for all three
kinds::

    explicit argument  >  environment variable  >  active plan
                       >  packaged default plan  >  built-in plan

The active plan is installed per process (:func:`set_active_plan`, the
``--plan plan.json`` launch flag) or per scope (:func:`use_plan`).  The
packaged default plan is ``src/repro_torch/plan/default_plan.json``; none
ships yet (a ``platform="cuda"`` plan derived from H100 sweeps waits for a
port of ``tools/autotune.py``), so :func:`default_plan` returns None.  The
built-in plan is total and encodes the port's own choices (see
:func:`builtin_plan`).  Dispatch memoizes decisions per query and drops
the memo whenever the active or default plan changes
(:func:`on_plan_change`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
from typing import Callable, Iterable

from repro_torch.obs import metrics as _metrics

SCHEMA_VERSION = "repro.plan/v1"

KINDS = ("forward", "backward", "projection")

_RULE_FIELDS = ("kind", "backend", "op", "regularization", "platform",
                "dtype", "min_n", "max_n", "min_rows", "max_rows",
                "max_elems", "evidence")
_PLAN_FIELDS = ("schema", "name", "rules", "meta")


@dataclasses.dataclass(frozen=True)
class PlanRule:
  """One regime -> backend entry of an execution plan.

  A rule *matches* a decision query when every constraint holds; ``"*"``
  (the default for the categorical keys) matches anything.  The shape
  bucket is expressed as optional inclusive bounds on ``n`` (last-axis
  problem size), ``rows`` (flattened batch rows) and ``rows * n^2``
  (``max_elems``, the minimax memory bill).  A rule with any shape
  constraint never matches a shapeless query — so a plan can never route
  an unknown-size problem to a size-gated backend (the old
  shape=None -> minimax bug class is unrepresentable).
  """

  kind: str
  backend: str
  op: str = "*"
  regularization: str = "*"
  platform: str = "*"
  dtype: str = "*"
  min_n: int | None = None
  max_n: int | None = None
  min_rows: int | None = None
  max_rows: int | None = None
  max_elems: int | None = None
  evidence: tuple[str, ...] = ()

  def __post_init__(self):
    if self.kind not in KINDS:
      raise ValueError(f"rule kind must be one of {KINDS}, got {self.kind!r}")
    if not self.backend or not isinstance(self.backend, str):
      raise ValueError(f"rule backend must be a non-empty string, "
                       f"got {self.backend!r}")
    object.__setattr__(self, "evidence", tuple(self.evidence))

  def shape_constrained(self) -> bool:
    return any(v is not None for v in (self.min_n, self.max_n,
                                       self.min_rows, self.max_rows,
                                       self.max_elems))

  def matches(self, kind: str, op: str, regularization: str, *,
              platform: str, dtype: str,
              shape: tuple[int, ...] | None) -> bool:
    if self.kind != kind:
      return False
    for want, have in ((self.op, op), (self.regularization, regularization),
                       (self.platform, platform), (self.dtype, dtype)):
      if want != "*" and have is not None and want != have:
        return False
    if not self.shape_constrained():
      return True
    if shape is None:
      # Unknown shape must not satisfy a size-gated rule.
      return False
    n = shape[-1]
    rows = 1
    for d in shape[:-1]:
      rows *= d
    if self.min_n is not None and n < self.min_n:
      return False
    if self.max_n is not None and n > self.max_n:
      return False
    if self.min_rows is not None and rows < self.min_rows:
      return False
    if self.max_rows is not None and rows > self.max_rows:
      return False
    if self.max_elems is not None and rows * n * n > self.max_elems:
      return False
    return True

  def to_dict(self) -> dict:
    out = {"kind": self.kind, "backend": self.backend}
    for k in ("op", "regularization", "platform", "dtype"):
      v = getattr(self, k)
      if v != "*":
        out[k] = v
    for k in ("min_n", "max_n", "min_rows", "max_rows", "max_elems"):
      v = getattr(self, k)
      if v is not None:
        out[k] = v
    if self.evidence:
      out["evidence"] = list(self.evidence)
    return out

  @classmethod
  def from_dict(cls, d: dict) -> "PlanRule":
    if not isinstance(d, dict):
      raise ValueError(f"plan rule must be an object, got {type(d).__name__}")
    unknown = sorted(set(d) - set(_RULE_FIELDS))
    if unknown:
      raise ValueError(f"plan rule has unknown field(s) {unknown}; "
                       f"known fields: {sorted(_RULE_FIELDS)}")
    for k in ("kind", "backend"):
      if k not in d:
        raise ValueError(f"plan rule missing required field {k!r}")
    kwargs = dict(d)
    if "evidence" in kwargs:
      ev = kwargs["evidence"]
      if (not isinstance(ev, (list, tuple))
          or not all(isinstance(e, str) for e in ev)):
        raise ValueError("plan rule 'evidence' must be a list of strings")
      kwargs["evidence"] = tuple(ev)
    return cls(**kwargs)


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
  """An ordered, serializable backend-selection table (first match wins).

  Hashable (``meta`` is excluded from equality/hash), so a plan can key
  dispatch's memo of decisions and ride through an autograd Function.
  """

  name: str = "unnamed"
  rules: tuple[PlanRule, ...] = ()
  meta: dict = dataclasses.field(default_factory=dict, compare=False)

  def __post_init__(self):
    object.__setattr__(self, "rules", tuple(self.rules))

  def decide(self, kind: str, op: str, regularization: str, *,
             platform: str, dtype: str = "*",
             shape: tuple[int, ...] | None = None) -> PlanRule | None:
    """First rule matching the query, or None when the plan is silent."""
    for rule in self.rules:
      if rule.matches(kind, op, regularization, platform=platform,
                      dtype=dtype, shape=shape):
        return rule
    return None

  # -- serialization --------------------------------------------------------

  def to_dict(self) -> dict:
    return {
        "schema": SCHEMA_VERSION,
        "name": self.name,
        "rules": [r.to_dict() for r in self.rules],
        "meta": dict(self.meta),
    }

  def to_json(self, indent: int | None = 2) -> str:
    return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

  @classmethod
  def from_dict(cls, d: dict) -> "ExecutionPlan":
    if not isinstance(d, dict):
      raise ValueError(f"plan must be an object, got {type(d).__name__}")
    schema = d.get("schema")
    if schema != SCHEMA_VERSION:
      raise ValueError(f"plan schema mismatch: expected {SCHEMA_VERSION!r}, "
                       f"got {schema!r}")
    unknown = sorted(set(d) - set(_PLAN_FIELDS))
    if unknown:
      raise ValueError(f"plan has unknown field(s) {unknown}; "
                       f"known fields: {sorted(_PLAN_FIELDS)}")
    rules = d.get("rules", [])
    if not isinstance(rules, list):
      raise ValueError("plan 'rules' must be a list")
    meta = d.get("meta", {})
    if not isinstance(meta, dict):
      raise ValueError("plan 'meta' must be an object")
    return cls(name=d.get("name", "unnamed"),
               rules=tuple(PlanRule.from_dict(r) for r in rules),
               meta=dict(meta))

  @classmethod
  def from_json(cls, text: str) -> "ExecutionPlan":
    try:
      d = json.loads(text)
    except json.JSONDecodeError as e:
      raise ValueError(f"plan is not valid JSON: {e}") from e
    return cls.from_dict(d)

  def save(self, path: str) -> None:
    with open(path, "w") as f:
      f.write(self.to_json())
      f.write("\n")

  def plan_hash(self) -> str:
    """Content hash over (schema, name, rules) — stable across re-emits
    with identical decisions (``meta`` provenance is excluded)."""
    canonical = json.dumps(
        {"schema": SCHEMA_VERSION, "name": self.name,
         "rules": [r.to_dict() for r in self.rules]},
        sort_keys=True, separators=(",", ":"))
    return hashlib.sha1(canonical.encode()).hexdigest()[:12]


def load_plan(path: str) -> ExecutionPlan:
  """Load and strictly validate a plan file (raises ValueError on any
  schema/shape problem, OSError if unreadable)."""
  with open(path) as f:
    return ExecutionPlan.from_json(f.read())


# ---------------------------------------------------------------------------
# Built-in plan: the safety net (total coverage).
# ---------------------------------------------------------------------------


def builtin_plan() -> ExecutionPlan:
  """The fallback plan, matching every possible query.

  It encodes the port's choices, in order: an f64 solve on the card goes
  to ``scan`` (PyTorch ops, which keep f64; the kernels solve in f32 only);
  any other solve on the card to the ``cuda`` kernels; everything else (the
  CPU) to the ``stack`` machine.  The backward is ``scatter`` on the card,
  where ``chip_smoke.py`` measures ``segscan``'s log2(n) passes of eager
  ops slower at the trainer's and the operators' shapes, and the
  reference's ``segscan`` elsewhere.  The projection is ``fused``.  Unlike
  the reference's built-in plan, no rule routes small n to ``minimax``.
  """
  return _BUILTIN


_BUILTIN = ExecutionPlan(
    name="builtin",
    rules=(
        PlanRule("forward", "scan", op="isotonic", platform="cuda",
                 dtype="float64"),
        PlanRule("forward", "cuda", op="isotonic", platform="cuda"),
        PlanRule("forward", "stack", op="isotonic"),
        PlanRule("backward", "scatter", platform="cuda"),
        PlanRule("backward", "segscan"),
        PlanRule("projection", "fused", op="projection"),
    ),
)


# ---------------------------------------------------------------------------
# Packaged default plan.
# ---------------------------------------------------------------------------

DEFAULT_PLAN_PATH = os.path.join(os.path.dirname(__file__),
                                 "default_plan.json")

_default_cache: list = []  # [plan-or-None] once loaded
_listeners: list[Callable[[], None]] = []


def on_plan_change(fn: Callable[[], None]) -> None:
  """Call ``fn`` whenever the active plan is set or the default plan's
  cache is dropped (dispatch clears its memo of decisions)."""
  _listeners.append(fn)


def _changed() -> None:
  for fn in _listeners:
    fn()


def default_plan() -> ExecutionPlan | None:
  """The packaged plan, or None when absent or invalid (loaded once)."""
  if not _default_cache:
    try:
      _default_cache.append(load_plan(DEFAULT_PLAN_PATH))
    except (OSError, ValueError):
      _default_cache.append(None)
  return _default_cache[0]


def invalidate_default_plan_cache() -> None:
  """Forget the cached packaged plan (tests, or after a new one is
  written)."""
  _default_cache.clear()
  _changed()


# ---------------------------------------------------------------------------
# Active plan: process-wide slot + scoped override.
# ---------------------------------------------------------------------------

_ACTIVE: list[ExecutionPlan | None] = [None]


def get_active_plan() -> ExecutionPlan | None:
  return _ACTIVE[0]


def set_active_plan(plan: ExecutionPlan | None) -> None:
  """Install ``plan`` as the process-wide active plan (None clears it).

  This is what ``launch/{train,serve}.py --plan plan.json`` calls; every
  dispatch after it consults the plan (eager: every call, not every
  trace).
  """
  if plan is not None and not isinstance(plan, ExecutionPlan):
    raise TypeError(f"expected ExecutionPlan or None, got {type(plan)}")
  _ACTIVE[0] = plan
  _changed()


@contextlib.contextmanager
def use_plan(plan: ExecutionPlan | None):
  """Scoped :func:`set_active_plan`.  A backward pass that runs after the
  scope has exited is governed by the plan active then; pass ``plan=`` to
  the operator to pin both passes."""
  prev = _ACTIVE[0]
  set_active_plan(plan)
  try:
    yield
  finally:
    set_active_plan(prev)


def _chain(plan: ExecutionPlan | None):
  """The plan chain as consulted right now, most specific first."""
  return (("plan", plan if plan is not None else get_active_plan()),
          ("default_plan", default_plan()),
          ("builtin", builtin_plan()))


def resolve_via_plans(
    kind: str, op: str, regularization: str, *, platform: str,
    dtype: str = "*", shape: tuple[int, ...] | None = None,
    plan: ExecutionPlan | None = None,
) -> tuple[str, str, PlanRule]:
  """Walk the plan chain for one decision: (backend, source, rule).

  Chain: the explicit per-call ``plan`` (else the active plan, source
  ``"plan"``) > the packaged default plan (``"default_plan"``) > the
  built-in plan (``"builtin"``).  The built-in plan is total, so this
  always returns.  Records ``plan_decide{kind,backend,source,plan}``.
  """
  backend, source, rule, name = decide(kind, op, regularization,
                                       platform=platform, dtype=dtype,
                                       shape=shape, plan=plan)
  _metrics.counter_inc("plan_decide", kind=kind, backend=backend,
                       source=source, plan=name)
  return backend, source, rule


def decide(kind: str, op: str, regularization: str, *, platform: str,
           dtype: str = "*", shape: tuple[int, ...] | None = None,
           plan: ExecutionPlan | None = None
           ) -> tuple[str, str, PlanRule, str]:
  """:func:`resolve_via_plans` without the counter: (backend, source,
  rule, plan name)."""
  for source, candidate in _chain(plan):
    if candidate is None:
      continue
    rule = candidate.decide(kind, op, regularization, platform=platform,
                            dtype=dtype, shape=shape)
    if rule is not None:
      return rule.backend, source, rule, candidate.name
  raise AssertionError(
      f"builtin plan failed to cover kind={kind!r} op={op!r} "
      f"regularization={regularization!r} platform={platform!r}")


def shape_breakpoints(plan: ExecutionPlan | None = None) -> tuple[int, ...]:
  """Sorted unique n-edges at which some rule's applicability flips.

  For every shape-constrained rule in the governing plan chain, the
  inclusive bounds ``max_n`` and ``min_n - 1`` are bucket edges: a
  serving bucket whose width crosses one would pad requests from one
  backend regime into another.  ``repro_torch.serving.BucketPolicy.
  from_plan`` splices these into its size ladder.
  """
  edges: set[int] = set()
  for _, candidate in _chain(plan):
    for rule in (candidate.rules if candidate is not None else ()):
      if rule.max_n is not None:
        edges.add(rule.max_n)
      if rule.min_n is not None and rule.min_n > 1:
        edges.add(rule.min_n - 1)
  return tuple(sorted(e for e in edges if e >= 1))


def resolve_grid(
    kind: str,
    ops: Iterable[str],
    regularizations: Iterable[str],
    shapes: Iterable[tuple[int, ...]],
    *,
    platform: str,
    dtype: str = "*",
    plan: ExecutionPlan | None = None,
) -> list[dict]:
  """Enumerate plan decisions over an (op x regularization x shape) grid:
  one ``{kind, op, regularization, shape, backend, source, plan}`` entry a
  cell.  The serving engine labels its warmed cells with it.  Records no
  ``plan_decide`` counter (an enumeration, not a dispatch decision)."""
  shapes = [tuple(s) for s in shapes]
  out: list[dict] = []
  for op in ops:
    for reg in regularizations:
      for shape in shapes:
        backend, source, _, name = decide(kind, op, reg, platform=platform,
                                          dtype=dtype, shape=shape,
                                          plan=plan)
        out.append({"kind": kind, "op": op, "regularization": reg,
                    "shape": shape, "backend": backend, "source": source,
                    "plan": name})
  return out


def plan_provenance(plan: ExecutionPlan | None = None) -> dict:
  """Attribution block for BENCH artifact ``meta``: which plan governs
  dispatch right now (explicit > active > packaged default > builtin) and
  its content hash."""
  for source, candidate in (
      ("arg", plan), ("plan", get_active_plan()),
      ("default_plan", default_plan()), ("builtin", builtin_plan())):
    if candidate is not None:
      return {"plan_name": candidate.name,
              "plan_hash": candidate.plan_hash(),
              "plan_source": source}
  raise AssertionError("builtin plan is always available")


__all__ = [
    "SCHEMA_VERSION",
    "KINDS",
    "DEFAULT_PLAN_PATH",
    "PlanRule",
    "ExecutionPlan",
    "load_plan",
    "builtin_plan",
    "default_plan",
    "invalidate_default_plan_cache",
    "get_active_plan",
    "set_active_plan",
    "use_plan",
    "on_plan_change",
    "decide",
    "resolve_via_plans",
    "resolve_grid",
    "shape_breakpoints",
    "plan_provenance",
]
