"""metricslint collective-schedule pass — rank/data-independent emission order
(counterpart of ``metrics_tpu/analysis/schedule_pass.py``, retargeted at
``torch.distributed``: the vocabulary lives in the tables below).

The whole fault-tolerance stack (``parallel/health.py``'s one-header
protocol, the bucketed payload planner, compute-group dedup) rests on ONE
invariant: **every rank emits the same collectives in the same order**, no
matter what its local data looks like. A collective emitted under a branch
that only some ranks take pairs with the wrong peer collective and returns
garbage without erroring — the failure mode the channel-suspect latch
exists to paper over, and the property statically-planned redistribution
schedules simply assume (PAPERS.md: "Memory-efficient array redistribution
through portable collective communication"). This pass checks the invariant
at lint time instead of discovering it as a cross-rank hang.

Model (deliberately simple enough to be sound *for this codebase's
conventions* rather than for arbitrary Python):

- **Collective primitives**: the ``torch.distributed`` collectives, the
  functional collectives (``all_reduce``/``all_gather_tensor``/
  ``wait_tensor``) and the port's two seams, ``parallel/sync.py::_gather``
  (the host sync's watchdog-guarded gather) and ``_program_collective``
  (the in-program one). A function that (transitively,
  within its module) calls one of these is *collective-emitting*; calling
  it counts as emitting. The cross-module host-sync entry points and the
  async overlapped-round API (:data:`KNOWN_EMITTING_CALLS` —
  ``host_sync_state``, ``launch_round``/``resolve_round``/``drain_round``,
  …) count the same way: launching a background round schedules its
  collectives at the launch point, so launch/resolve/drain ordering is
  checked exactly as rank/data-independent as a direct gather.
- **Symmetric values** (safe to branch on): literal/config values, world
  size (``get_world_size``, the port's ``_sync_world``), env knobs other
  than ``RANK``/``LOCAL_RANK``, schema (``.shape``/``.dtype``/``.ndim``/
  ``.device``/``.is_cuda`` and ``numel()``/``dim()``/``size()``/
  ``element_size()``/``is_floating_point()`` — the sync-header protocol
  verifies schema equality before any payload), the key set of a per-rank
  state dict (``set(state)``, ``state.keys()`` in a guard: the header
  verifies the key set), function parameters (the caller owns their
  symmetry; parameters that by convention carry per-rank data are the
  exception below), and — crucially — **the result of any collective**:
  a gather returns the same world-stacked value on every rank, so
  branching on it is symmetric by construction.
- **Asymmetric (local) values**: ``get_rank()`` and the port's rank
  helpers, and a read of the ``RANK``/``LOCAL_RANK`` environment variables
  (rank taint: in torch those variables *are* the rank), per-rank data
  parameters (``state``/``value``/``values``/``result``/
  ``x``/``word``/``update_count`` — the naming convention of
  ``parallel/{sync,health,bucketing}.py``), ``len()`` of local data,
  ``channel_is_suspect()`` (a per-process latch), and anything derived
  from these by assignment.

Findings: a collective (or collective-emitting call) governed by a
rank-tainted guard (``rank-dependent-collective``), by a local-data guard
(``data-dependent-collective``), emitted from an ``except``/``finally``
block (``collective-in-handler``), or emitted while iterating an unordered
``set`` (``nondeterministic-collective-order``). Early ``raise``/``return``
under a local guard counts as governing every later collective in the
function — skipping is as asymmetric as emitting. The adaptive controller's
``commit_schedule_decision`` (``parallel/resilience.py``) gets the same
treatment one level up (``asymmetric-schedule-decision``): a sync-cadence /
staleness-policy / timeout decision committed under — or computed from —
rank/local taint changes which collectives ranks later emit, so it must
derive from symmetric inputs only.
"""
import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from metrics_tpu_torch.analysis.report import Finding

#: call names that ARE a cross-rank collective: ``torch.distributed``'s,
#: the functional collectives' (``torch.distributed._functional_collectives``)
#: and the port's two seams (``parallel/sync.py``)
COLLECTIVE_CALLS = frozenset(
    {
        # torch.distributed
        "all_gather",
        "all_gather_into_tensor",
        "all_reduce",
        "broadcast",
        "reduce_scatter_tensor",
        "all_to_all_single",
        "barrier",
        "all_gather_object",
        "broadcast_object_list",
        # functional collectives (all_reduce above too)
        "all_gather_tensor",
        "wait_tensor",
        # the port's seams
        "_gather",
        "_program_collective",
    }
)

#: cross-module calls that emit (or schedule/consume) collectives by module
#: contract: the host-sync entry points and the async overlapped-round API
#: (``parallel/async_sync.py``). The intra-module fixpoint cannot see across
#: files, so these names are collective-emitting wherever they appear —
#: launching a round schedules its collectives at the launch point's program
#: order, and resolving/draining one completes them, so launch/resolve/drain
#: call sites must be exactly as rank/data-independent as a direct
#: ``process_allgather``. (Deliberately first-order: a local wrapper around
#: one of these is not itself propagated — the wrapper's own body is checked
#: instead.)
KNOWN_EMITTING_CALLS = frozenset(
    {
        "host_sync_state",
        "host_sync_leaf",
        "host_sync_state_bucketed",
        "launch_round",
        "resolve_round",
        "drain_round",
    }
)

#: the observability recorder's emit calls (``observability/journal.py``).
#: Known NON-collective: calling one never emits, schedules or consumes a
#: cross-rank collective, so it must never be flagged as one — and, unlike
#: :data:`_SYMMETRIC_CALLS`, its result must never WASH taint (``record``
#: returns ``None``; treating it as symmetric would silently launder any
#: tainted value routed through an emission expression). Emission sites in
#: ``parallel/`` hot paths have their own contract instead: they must be
#: guard-free — an "emit only on this rank / only for this data" branch
#: would skew per-rank journals, breaking the cross-rank trace correlation
#: the exporter keys on ``sync_epoch`` (rule ``guarded-telemetry-emit``).
RECORDER_CALLS = frozenset({"record"})

#: parameter names that carry per-rank data by module convention
LOCAL_DATA_PARAMS = frozenset(
    {"state", "value", "values", "result", "x", "word", "update_count", "local_value"}
)

#: calls whose results are per-rank local no matter the arguments
#: (``channel_gate`` reads the per-process probation state machine —
#: rank-local by construction, like the suspect latch it generalizes)
_LOCAL_CALLS = frozenset(
    {"channel_is_suspect", "channel_gate", "build_health_word"}
)

#: calls that return this process's rank: ``torch.distributed.get_rank`` and
#: the port's own rank helpers (``observability/journal.py::_default_rank``,
#: ``parallel/tiering.py::_current_rank``, ``utils/prints.py::_rank``,
#: ``core/checkpoint.py::_default_coordinates``, whose ``(rank, world)``
#: pair carries the rank)
RANK_CALLS = frozenset(
    {"get_rank", "_default_rank", "_current_rank", "_rank", "_default_coordinates"}
)

#: environment variables that are the rank under torchrun
RANK_ENV_VARS = frozenset({"RANK", "LOCAL_RANK"})

#: the collective-affecting commit points: every sync-cadence /
#: staleness-policy / timeout decision that can change WHICH collectives
#: ranks emit flows through ``commit_schedule_decision``
#: (``parallel/resilience.py``), and every execution-plan invalidation —
#: which retraces fused programs and re-keys the bucketed sync layout —
#: flows through ``plan_invalidate`` (``core/plan.py``). The
#: ``asymmetric-schedule-decision`` rule checks their inputs are symmetric —
#: a decision derived from rank- or data-tainted values would legally
#: desynchronize the fleet one config knob (or one rank's plan generation)
#: at a time.
SCHEDULE_DECISION_CALLS = frozenset({"commit_schedule_decision", "plan_invalidate"})

#: calls whose results are symmetric no matter the arguments (collective
#: results are world-replicated; verify_health_words raises symmetrically
#: from symmetric input and returns nothing asymmetric; a resolved round's
#: gathered state is a collective result like any other)
_SYMMETRIC_CALLS = COLLECTIVE_CALLS | KNOWN_EMITTING_CALLS | frozenset(
    {
        "verify_health_words",
        "header_cat_lengths",
        "gather_all_arrays",
        "get_world_size",
        "_sync_world",
        "jit_distributed_available",
        "fused_sync_enabled",
        "get_sync_timeout",
        # type/shape predicates are schema, which the header verifies equal
        "isinstance",
        "callable",
        # the sync plan is a pure function of the (header-verified) schema,
        # and the canonical schema string it is keyed on is itself verified
        # equal across ranks by the header CRC before any payload moves
        "build_sync_plan",
        "_classify",
        "state_schema_parts",
        # quorum membership (``parallel/resilience.py``) is agreed by a
        # symmetric negotiation (every survivor runs the same
        # max-of-proposals round) and re-verified by the header's
        # membership-epoch/live-count columns before any payload moves —
        # its readers are world-replicated over the survivor set, and the
        # negotiation entry points re-establish symmetry by contract
        "effective_world",
        "membership_epoch",
        "live_count",
        "live_ranks",
        "current_membership",
        "negotiate_quorum",
        "maybe_rejoin",
        "negotiate_allgather",
        "subset_allgather",
        "active_subset_transport",
        # the adaptive timeout is committed through
        # commit_schedule_decision, whose inputs this pass verifies
        # symmetric — so reading it back is symmetric
        "adaptive_sync_timeout",
        # pure classification of an already-symmetric typed failure
        "is_missing_rank_error",
        # the tier topology (``parallel/tiering.py``) is NEGOTIATED, not
        # ad hoc: a pure function of the agreed live set and the (config-
        # identical-by-contract) tier map, re-verified by the health word's
        # tier + precision columns before any payload collective. Its
        # readers — and the plan-layer schedule derived from them — are
        # therefore world-replicated and wash taint to schema. A raw
        # ``get_rank()``-gated hop does NOT go through these and stays
        # a rank-tainted finding (the ``violating_tier_hop`` fixture).
        "tier_topology",
        "active_topology",
        "tier_of_rank",
        "expected_tier_column",
        "my_tier_id",
        "tiering_configured",
        "active_tier_transport",
        "tier_schedule_for",
        "validate_sync_precision",
        "precision_code",
        "encoded_size",
    }
)

#: attribute reads that are schema, not data (header-verified cross-rank);
#: the tensor methods among them (``numel()``, ``dim()``, ``size()``,
#: ``element_size()``, ``is_floating_point()``) are schema called as well
_SCHEMA_ATTRS = frozenset(
    {
        "shape", "dtype", "ndim", "size", "capacity", "item_size", "item_shape", "kind", "fx", "name",
        "cat_index", "numel", "dim", "element_size", "is_floating_point", "device", "is_cuda",
    }
)

#: the per-rank state dict, whose key set (not its values) is schema
_KEYED_PARAMS = frozenset({"state"})


def _is_rank_env_read(node: ast.Call) -> bool:
    """``os.environ.get("RANK")``/``os.getenv("LOCAL_RANK")``."""
    name = _call_name(node.func)
    if name not in ("get", "getenv") or not node.args:
        return False
    key = node.args[0]
    if not (isinstance(key, ast.Constant) and key.value in RANK_ENV_VARS):
        return False
    return name == "getenv" or (
        isinstance(node.func, ast.Attribute) and _call_name(node.func.value) == "environ"
    )


def _is_key_set_read(node: ast.Call) -> bool:
    """``set(state)``/``frozenset(state)``/``state.keys()``: the key set of
    the per-rank state dict."""
    name = _call_name(node.func)
    if name in ("set", "frozenset") and len(node.args) == 1 and not node.keywords:
        arg = node.args[0]
        return isinstance(arg, ast.Name) and arg.id in _KEYED_PARAMS
    return (
        name == "keys"
        and isinstance(node.func, ast.Attribute)
        and isinstance(node.func.value, ast.Name)
        and node.func.value.id in _KEYED_PARAMS
    )


@dataclass
class _FnInfo:
    name: str
    node: ast.FunctionDef
    emits_direct: bool = False
    records_direct: bool = False
    calls: Set[str] = field(default_factory=set)
    emits: bool = False    # transitive, filled by fixpoint
    records: bool = False  # transitive recorder emission, same fixpoint


def _call_name(func: ast.expr) -> Optional[str]:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _module_functions(tree: ast.Module) -> Dict[str, _FnInfo]:
    """Top-level (and class-nested) function table with direct-emission and
    local-call-graph facts."""
    out: Dict[str, _FnInfo] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.FunctionDef):
            continue
        info = _FnInfo(node.name, node)
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                name = _call_name(sub.func)
                if name in COLLECTIVE_CALLS:
                    info.emits_direct = True
                elif name:
                    if name in RECORDER_CALLS:
                        info.records_direct = True
                    info.calls.add(name)
        out.setdefault(node.name, info)
    # transitive emission fixpoint over the intra-module call graph — one
    # fixpoint each for collective emission and recorder emission (a local
    # helper wrapping record() must not defeat guarded-telemetry-emit any
    # more than a wrapper around a gather defeats the collective rules)
    changed = True
    for info in out.values():
        info.emits = info.emits_direct
        info.records = info.records_direct
    while changed:
        changed = False
        for info in out.values():
            if not info.emits and any(c in out and out[c].emits for c in info.calls):
                info.emits = True
                changed = True
            if not info.records and any(c in out and out[c].records for c in info.calls):
                info.records = True
                changed = True
    return out


class _GuardTaint:
    """Per-function taint classification of expressions: 'rank', 'local' or
    None (symmetric). Forward propagation through assignments, with
    collective results washing taint (their output is world-replicated)."""

    def __init__(self, fn: ast.FunctionDef) -> None:
        self.local_names: Set[str] = set()
        self.rank_names: Set[str] = set()
        args = fn.args
        for a in list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs):
            if a.arg in LOCAL_DATA_PARAMS:
                self.local_names.add(a.arg)
        self._propagate(fn)

    def _propagate(self, fn: ast.FunctionDef) -> None:
        for _ in range(3):
            changed = False
            for node in ast.walk(fn):
                targets: List[ast.expr] = []
                value: Optional[ast.expr] = None
                if isinstance(node, ast.Assign):
                    targets, value = node.targets, node.value
                elif isinstance(node, ast.AnnAssign) and node.value is not None:
                    targets, value = [node.target], node.value
                elif isinstance(node, ast.AugAssign):
                    targets, value = [node.target], node.value
                elif isinstance(node, ast.For):
                    # dict.items() over local data: the KEY is schema (the
                    # header verifies the key set), only the VALUE is local
                    if (
                        isinstance(node.iter, ast.Call)
                        and _call_name(node.iter.func) == "items"
                        and isinstance(node.target, ast.Tuple)
                        and len(node.target.elts) == 2
                    ):
                        targets, value = [node.target.elts[1]], node.iter
                    else:
                        targets, value = [node.target], node.iter
                if value is None:
                    continue
                taint = self.classify(value)
                if taint is None:
                    continue
                bucket = self.rank_names if taint == "rank" else self.local_names
                for t in targets:
                    for n in self._target_names(t):
                        if n not in bucket:
                            bucket.add(n)
                            changed = True
            if not changed:
                break

    @staticmethod
    def _target_names(t: ast.expr) -> List[str]:
        if isinstance(t, ast.Name):
            return [t.id]
        if isinstance(t, (ast.Tuple, ast.List)):
            out: List[str] = []
            for el in t.elts:
                out.extend(_GuardTaint._target_names(el))
            return out
        if isinstance(t, ast.Starred):
            return _GuardTaint._target_names(t.value)
        return []

    def classify(self, expr: ast.expr, iteration: bool = False) -> Optional[str]:
        """Worst taint anywhere in ``expr``: 'rank' > 'local' > None.
        Symmetric-call results stop the descent (washing their arguments).

        ``iteration=True`` classifies a ``for`` iterable for *loop shape*
        (count/order of iterations) rather than element values: iterating
        ``state.items()``/``.keys()`` is schema-ordered (the key set and
        insertion order are part of the verified schema) even though the
        yielded *values* are per-rank data — the element taint still flows
        to the loop targets via ``_propagate``'s full descent.
        """
        worst: Optional[str] = None

        def visit(node: ast.AST) -> None:
            nonlocal worst
            if worst == "rank":
                return
            if isinstance(node, ast.Subscript) and _call_name(node.value) == "environ":
                key = node.slice
                if isinstance(key, ast.Constant) and key.value in RANK_ENV_VARS:
                    worst = "rank"  # os.environ["RANK"]
                    return
            if isinstance(node, ast.Call):
                name = _call_name(node.func)
                if name in RANK_CALLS or _is_rank_env_read(node):
                    worst = "rank"
                    return
                if not iteration and _is_key_set_read(node):
                    return  # a guard on the state dict's key set is schema
                if name in _LOCAL_CALLS:
                    worst = worst or "local"
                    # arguments cannot raise severity past 'local' except rank
                if name in _SYMMETRIC_CALLS:
                    return  # result is world-replicated; do not descend
                if iteration and name in ("items", "keys"):
                    return  # dict iteration order is schema, not data
                if name == "len":
                    # len() of local data is local; of symmetric data symmetric
                    for arg in node.args:
                        visit(arg)
                    return
            if isinstance(node, ast.Attribute):
                if node.attr in _SCHEMA_ATTRS:
                    return  # schema read — header-verified symmetric
            if isinstance(node, ast.Name):
                if node.id in self.rank_names:
                    worst = "rank"
                elif node.id in self.local_names:
                    worst = worst or "local"
                return
            for child in ast.iter_child_nodes(node):
                visit(child)

        visit(expr)
        return worst


@dataclass
class _Ctx:
    guards: Tuple[Tuple[str, int], ...] = ()  # (taint, guard line)
    handler: Optional[int] = None             # line of enclosing except/finally
    set_loop: Optional[int] = None            # line of enclosing for-over-set


def _is_set_iterable(expr: ast.expr) -> bool:
    if isinstance(expr, (ast.Set, ast.SetComp)):
        return True
    if isinstance(expr, ast.Call) and _call_name(expr.func) == "set":
        return True
    return False


def check_function(
    fns: Dict[str, _FnInfo], info: _FnInfo, path: str
) -> List[Finding]:
    findings: List[Finding] = []
    taint = _GuardTaint(info.node)
    #: taint of early-exit guards seen so far, in source order: a local raise
    #: /return before a collective conditions every later collective
    early_exits: List[Tuple[str, int]] = []

    def emits(node: ast.Call) -> bool:
        name = _call_name(node.func)
        if name in COLLECTIVE_CALLS or name in KNOWN_EMITTING_CALLS:
            return True
        return name in fns and fns[name].emits and name != info.name

    def records(node: ast.Call) -> bool:
        # direct record() calls AND calls of local helpers that (transitively)
        # record — wrapping the emission in a one-line helper must not
        # silently defeat the guard-free contract
        name = _call_name(node.func)
        if name in RECORDER_CALLS:
            return True
        return name in fns and fns[name].records and name != info.name

    def has_early_exit(body: Sequence[ast.stmt]) -> bool:
        for stmt in body:
            if isinstance(stmt, (ast.Raise, ast.Return, ast.Continue, ast.Break)):
                return True
        return False

    def walk(stmts: Sequence[ast.stmt], ctx: _Ctx) -> None:
        for stmt in stmts:
            if isinstance(stmt, ast.If):
                t = taint.classify(stmt.test)
                inner = ctx
                if t is not None:
                    inner = _Ctx(ctx.guards + ((t, stmt.lineno),), ctx.handler, ctx.set_loop)
                    if has_early_exit(stmt.body) or has_early_exit(stmt.orelse):
                        early_exits.append((t, stmt.lineno))
                walk(stmt.body, inner)
                walk(stmt.orelse, inner)
            elif isinstance(stmt, ast.While):
                t = taint.classify(stmt.test)
                inner = _Ctx(ctx.guards + (((t, stmt.lineno),) if t else ()), ctx.handler, ctx.set_loop)
                walk(stmt.body, inner)
                walk(stmt.orelse, inner)
            elif isinstance(stmt, ast.For):
                t = taint.classify(stmt.iter, iteration=True)
                set_loop = stmt.lineno if _is_set_iterable(stmt.iter) else ctx.set_loop
                inner = _Ctx(ctx.guards + (((t, stmt.lineno),) if t else ()), ctx.handler, set_loop)
                walk(stmt.body, inner)
                walk(stmt.orelse, inner)
            elif isinstance(stmt, ast.Try):
                walk(stmt.body, ctx)
                for handler in stmt.handlers:
                    walk(handler.body, _Ctx(ctx.guards, handler.lineno, ctx.set_loop))
                walk(stmt.orelse, ctx)
                if stmt.finalbody:
                    walk(stmt.finalbody, _Ctx(ctx.guards, stmt.finalbody[0].lineno, ctx.set_loop))
            elif isinstance(stmt, ast.With):
                walk(stmt.body, ctx)
            elif isinstance(stmt, ast.FunctionDef):
                continue  # nested defs analyzed via their own _FnInfo
            else:
                for node in ast.walk(stmt):
                    if isinstance(node, ast.Call) and emits(node):
                        report(node, ctx, stmt)
                    elif isinstance(node, ast.Call) and records(node):
                        report_recorder(node, ctx)
                    elif (
                        isinstance(node, ast.Call)
                        and _call_name(node.func) in SCHEDULE_DECISION_CALLS
                    ):
                        report_schedule_decision(node, ctx)
                    elif isinstance(node, ast.IfExp) and taint.classify(node.test) is not None:
                        t = taint.classify(node.test)
                        inner = _Ctx(ctx.guards + ((t, node.lineno),), ctx.handler, ctx.set_loop)
                        for sub in ast.walk(node):
                            if isinstance(sub, ast.Call) and emits(sub):
                                report(sub, inner, stmt)
                            elif isinstance(sub, ast.Call) and records(sub):
                                report_recorder(sub, inner)
                            elif (
                                isinstance(sub, ast.Call)
                                and _call_name(sub.func) in SCHEDULE_DECISION_CALLS
                            ):
                                report_schedule_decision(sub, inner)

    def report(node: ast.Call, ctx: _Ctx, stmt: ast.stmt) -> None:
        name = _call_name(node.func) or "<collective>"
        what = (
            f"collective {name}()"
            if name in COLLECTIVE_CALLS
            else f"call to collective-emitting {name}()"
        )
        governing = list(ctx.guards) + early_exits
        for t, line in governing:
            rule = "rank-dependent-collective" if t == "rank" else "data-dependent-collective"
            findings.append(
                Finding(
                    rule, path, node.lineno, node.col_offset,
                    f"{info.name}: {what} is governed by a "
                    f"{'rank' if t == 'rank' else 'per-rank data'}-dependent branch "
                    f"(line {line}) — ranks taking different sides emit different "
                    "collective schedules and the gathers pair wrong",
                    owner=info.name,
                )
            )
        if ctx.handler is not None:
            findings.append(
                Finding(
                    "collective-in-handler", path, node.lineno, node.col_offset,
                    f"{info.name}: {what} inside an except/finally block (line "
                    f"{ctx.handler}) — only provably symmetric failures may be "
                    "followed by more collectives",
                    owner=info.name,
                )
            )
        if ctx.set_loop is not None:
            findings.append(
                Finding(
                    "nondeterministic-collective-order", path, node.lineno, node.col_offset,
                    f"{info.name}: {what} inside iteration over an unordered set "
                    f"(line {ctx.set_loop}) — emission order must be deterministic "
                    "and identical on every rank",
                    owner=info.name,
                )
            )

    def report_schedule_decision(node: ast.Call, ctx: _Ctx) -> None:
        """A controller schedule decision (sync cadence, staleness policy,
        adaptive timeout) committed under — or computed from — rank/local
        taint: the committed value changes which collectives ranks later
        emit, so an asymmetric decision desynchronizes the fleet exactly
        like an asymmetric gather, one config knob removed."""
        name = _call_name(node.func) or "commit_schedule_decision"
        for t, line in list(ctx.guards) + early_exits:
            findings.append(
                Finding(
                    "asymmetric-schedule-decision", path, node.lineno, node.col_offset,
                    f"{info.name}: schedule decision {name}() is governed by a "
                    f"{'rank' if t == 'rank' else 'per-rank data'}-dependent branch "
                    f"(line {line}) — ranks taking different sides commit different "
                    "collective-affecting decisions and their schedules diverge",
                    owner=info.name,
                )
            )
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            t = taint.classify(arg)
            if t is not None:
                findings.append(
                    Finding(
                        "asymmetric-schedule-decision", path, node.lineno, node.col_offset,
                        f"{info.name}: schedule decision {name}() derives from a "
                        f"{'rank' if t == 'rank' else 'per-rank data'}-tainted value — "
                        "collective-affecting decisions must be computed from "
                        "symmetric inputs only (collective results, config, schema)",
                        owner=info.name,
                    )
                )

    def report_recorder(node: ast.Call, ctx: _Ctx) -> None:
        """Telemetry emission under a rank/data-dependent guard: the journal
        would record the event on some ranks only, skewing the cross-rank
        event sequences the trace exporter correlates. (Guards on symmetric
        config — ``journal.ACTIVE``, env knobs — are fine and unflagged.)"""
        name = _call_name(node.func) or "record"
        for t, line in list(ctx.guards) + early_exits:
            findings.append(
                Finding(
                    "guarded-telemetry-emit", path, node.lineno, node.col_offset,
                    f"{info.name}: telemetry emission {name}() is governed by a "
                    f"{'rank' if t == 'rank' else 'per-rank data'}-dependent branch "
                    f"(line {line}) — ranks taking different sides record different "
                    "journals, breaking cross-rank trace correlation",
                    owner=info.name,
                )
            )

    walk(info.node.body, _Ctx())
    # deduplicate (the same call can be reported once per governing guard —
    # keep that — but identical (rule, line, col, message) entries collapse)
    seen: Set[Tuple] = set()
    unique: List[Finding] = []
    for f in findings:
        key = (f.rule, f.line, f.col, f.message)
        if key not in seen:
            seen.add(key)
            unique.append(f)
    return unique


def run_schedule_pass(tree: ast.Module, path: str) -> List[Finding]:
    fns = _module_functions(tree)
    findings: List[Finding] = []
    for info in fns.values():
        if not (
            info.emits_direct
            or any(c in fns and fns[c].emits for c in info.calls)
            or any(c in KNOWN_EMITTING_CALLS for c in info.calls)
            # functions that only EMIT TELEMETRY are checked too (including
            # via local record()-wrapping helpers): their emission sites
            # must be guard-free of per-rank branches
            or info.records
            # functions that COMMIT SCHEDULE DECISIONS are checked for the
            # asymmetric-schedule-decision rule even when they emit nothing
            or any(c in SCHEDULE_DECISION_CALLS for c in info.calls)
        ):
            continue
        findings.extend(check_function(fns, info, path))
    return findings
