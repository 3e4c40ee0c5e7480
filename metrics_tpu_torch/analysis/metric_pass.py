"""metricslint metric-class pass — static contracts of ``Metric`` subclasses
(counterpart of ``metrics_tpu/analysis/metric_pass.py``, retargeted at torch).

Every contract this pass checks is one the runtime currently enforces late
(or not at all):

- ``update()``/``compute()`` may mutate **only** ``add_state``-declared
  attributes (plus declared ``_group_shared_attrs`` latches). The runtime
  discovers violations via the FakeTensorMode probe
  (``core/compiled.py::probe_traceable``) at the first compiled dispatch
  (step ~17 with the default warm-up) and falls back to eager; here the
  undeclared latch is a definition-time finding naming the attribute and
  line (``undeclared-state`` / ``unshared-latch``). Tensors are mutable, so
  a write is also an in-place one: a method whose name ends in a single
  ``_`` (``add_``, ``index_add_``, ``copy_``, ``zero_``, ``fill_``), an
  ``out=`` argument, item assignment into a tensor. ``setattr`` (or
  ``nn.Module.__setattr__``) with a name that is not a literal is a dynamic
  write: the scan stays unresolved.
- hot-path host syncs stall the dispatch pipeline every step and cannot be
  captured in a CUDA graph (``host-sync-in-update``): ``float()``/
  ``int()``/``bool()``/``.item()``/``np.asarray`` on device values,
  ``.cpu()``/``.tolist()``/``.numpy()``/``.to("cpu")``,
  ``torch.cuda.synchronize()``, and the ops whose output shape depends on
  the data (``nonzero``, ``unique``, ``masked_select``, one-argument
  ``torch.where``, ``repeat_interleave`` without ``output_size``), which
  read a count back from the device.
- declaration hygiene: overriding ``update`` without re-declaring
  ``update_identity`` silently drops the inherited compute-group key
  (``Metric._effective_update_identity``); ``add_state`` declarations with
  statically-wrong defaults fail at construction or sync time
  (``update-identity-redeclare`` / ``state-default``).

The pass is pure AST — nothing is imported or executed — so it runs on any
source tree, including fixture files that would not survive an import. Name
resolution is therefore *textual*: a class's ancestry is resolved by base
class name within the analyzed file set, and anything unresolvable degrades
to "unknown" rather than a false finding (``ClassInfo.update_resolved`` is
how the runtime integration distinguishes "verified clean" from "cannot
tell" — only the former skips the runtime probe).
"""
import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from metrics_tpu_torch.analysis.report import Finding

#: Runtime-bookkeeping attributes the Metric base machinery (``core/metric.py``,
#: ``nn.Module``) mutates around update/compute — never evidence of a user
#: side-effect latch. Must stay a superset of
#: ``metrics_tpu_torch.core.compiled._PROBE_EXEMPT`` (pinned by
#: ``tests/test_torch_metric_pass.py``); kept as a literal copy so the AST
#: passes import nothing of torch.
RUNTIME_EXEMPT_ATTRS = frozenset(
    {
        "_state",
        "_defaults",
        "_computed",
        "_update_called",
        "_forward_cache",
        "_update_count",
        "_pure_mode",
        "_grad_batch",
        "_donation_ready",
        "_slot_owner",
        "_compiled",
        "_plan_binding",
        "_cache",
        "_update_kwarg_names",
        "_ckpt_suppress",
        "_to_sync",
        "_telemetry",
        "_reductions",
        "_persistent",
        "_is_synced",
        "_sync_degraded",
        "_inflight",
        "_compute_group",
        "_device",
        "_dtype",
        "_buffers",
    }
)

_ALLOWED_FX = {"sum", "mean", "cat", "max", "min"}

#: method calls that mutate their receiver in place (one container level,
#: matching the runtime probe's shallow-container snapshot). ``.update()``
#: is deliberately absent: ``self.metric_a.update(...)`` — nested-metric
#: delegation — is overwhelmingly more common than a dict-latch
#: ``self.d.update(...)`` and indistinguishable from it statically.
_MUTATING_METHODS = {
    "append", "extend", "insert", "add", "discard", "remove", "clear",
    "setdefault", "pop", "popitem", "appendleft",
}

#: annotation text fragments that mark a parameter as a device tensor input
_ARRAY_ANNOTATIONS = ("Tensor", "Array", "ndarray", "ArrayLike")

_NUMPY_MODULE_NAMES = {"np", "numpy", "onp"}
_TORCH_MODULE_NAMES = {"torch"}


def _is_inplace_method(name: str) -> bool:
    """torch's in-place convention: one trailing underscore (``add_``,
    ``index_add_``, ``copy_``), never a dunder or a private name."""
    return name.endswith("_") and not name.endswith("__") and not name.startswith("_")


# ---------------------------------------------------------------------------
# class harvesting
# ---------------------------------------------------------------------------

@dataclass
class AddStateCall:
    node: ast.Call
    names: Tuple[str, ...]          # () when the name expression is dynamic
    default: Optional[ast.expr]
    fx: Optional[ast.expr]
    fx_given: bool
    #: declared under an if/else (e.g. list-vs-array depending on a ctor
    #: arg): two conditional declarations of one name are alternatives,
    #: not duplicates
    conditional: bool = False


@dataclass
class ClassInfo:
    name: str
    qualname: str
    path: str
    node: ast.ClassDef
    base_names: List[str] = field(default_factory=list)
    methods: Dict[str, ast.FunctionDef] = field(default_factory=dict)
    add_state_calls: List[AddStateCall] = field(default_factory=list)
    state_names: Set[str] = field(default_factory=set)
    #: UPPERCASE name references used as add_state names (imported module
    #: constants, e.g. ``NONFINITE_STATE``) — resolved against
    #: ``Universe.constants`` at check time
    state_name_refs: Set[str] = field(default_factory=set)
    dynamic_state_names: bool = False
    shared_attrs: Optional[Set[str]] = None   # None = not declared here
    shared_dynamic: bool = False              # declared, but not a literal
    defines_identity: bool = False
    identity_nontrivial: bool = False

    @property
    def defines_update(self) -> bool:
        return "update" in self.methods


def _base_name(expr: ast.expr) -> Optional[str]:
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        return expr.attr
    if isinstance(expr, ast.Subscript):  # Generic[...] style
        return _base_name(expr.value)
    return None


def _literal_names(expr: ast.expr, env: Dict[str, ast.expr]) -> Optional[Tuple[str, ...]]:
    """Constant-name extraction for an add_state first argument: a string
    literal, a loop variable bound to a literal tuple/list of strings, or a
    module-level string constant (``NONFINITE_STATE``-style)."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return (expr.value,)
    if isinstance(expr, ast.Name) and expr.id in env:
        try:
            value = ast.literal_eval(env[expr.id])
        except (ValueError, SyntaxError):
            return None
        if isinstance(value, str):
            return (value,)
        if isinstance(value, (tuple, list)) and all(isinstance(v, str) for v in value):
            return tuple(value)
    return None


def _call_kwarg(call: ast.Call, name: str, pos: int) -> Tuple[Optional[ast.expr], bool]:
    if len(call.args) > pos:
        return call.args[pos], True
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value, True
    return None, False


def _harvest_add_state(ci: ClassInfo, fn: ast.FunctionDef, module_env: Dict[str, ast.expr]) -> None:
    """Collect ``self.add_state(...)`` calls in ``fn``, resolving loop-bound
    name tuples (``for s in ("tp", "fp"): self.add_state(s, ...)``) and
    module-level constants."""
    if not any(
        isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and node.func.attr == "add_state"
        for node in ast.walk(fn)
    ):
        return  # most methods declare nothing: skip the conditional-scope walk
    env: Dict[str, ast.expr] = dict(module_env)
    conditional_ids: set = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.For) and isinstance(node.target, ast.Name):
            env[node.target.id] = node.iter
        if isinstance(node, (ast.If, ast.Try)):
            for sub in ast.walk(node):
                if sub is not node:
                    conditional_ids.add(id(sub))
    for node in ast.walk(fn):
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "add_state"
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "self"
            and node.args
        ):
            continue
        names = _literal_names(node.args[0], env)
        default, _ = _call_kwarg(node, "default", 1)
        fx, fx_given = _call_kwarg(node, "dist_reduce_fx", 2)
        call = AddStateCall(node, names or (), default, fx, fx_given, id(node) in conditional_ids)
        ci.add_state_calls.append(call)
        if names is not None:
            ci.state_names.update(names)
        elif (
            isinstance(node.args[0], ast.Name) and node.args[0].id.isupper()
        ):
            # an imported module constant by convention (NONFINITE_STATE);
            # resolved against the cross-file constant table at check time
            ci.state_name_refs.add(node.args[0].id)
        else:
            ci.dynamic_state_names = True


def _identity_nontrivial(fn: ast.FunctionDef) -> bool:
    """False when the body is the default ``return None`` (docstring aside)."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Return):
            if node.value is None:
                continue
            if isinstance(node.value, ast.Constant) and node.value.value is None:
                continue
            return True
    return False


def harvest_classes(tree: ast.Module, path: str) -> List[ClassInfo]:
    """All classes in a module (top-level and nested), with their contracts."""
    out: List[ClassInfo] = []
    # module-level string constants (NONFINITE_STATE = "_nonfinite" style)
    module_env: Dict[str, ast.expr] = {}
    for item in tree.body:
        if isinstance(item, ast.Assign) and len(item.targets) == 1:
            t = item.targets[0]
            if isinstance(t, ast.Name):
                module_env[t.id] = item.value

    def visit(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                qual = f"{prefix}{child.name}"
                ci = ClassInfo(child.name, qual, path, child)
                for b in child.bases:
                    name = _base_name(b)
                    if name:
                        ci.base_names.append(name)
                for item in child.body:
                    if isinstance(item, ast.FunctionDef):
                        ci.methods.setdefault(item.name, item)
                    elif isinstance(item, (ast.Assign, ast.AnnAssign)):
                        targets = item.targets if isinstance(item, ast.Assign) else [item.target]
                        for t in targets:
                            if isinstance(t, ast.Name) and t.id == "_group_shared_attrs":
                                try:
                                    val = ast.literal_eval(item.value) if item.value else ()
                                    ci.shared_attrs = set(val)
                                except (ValueError, SyntaxError):
                                    ci.shared_dynamic = True
                for fn in ci.methods.values():
                    _harvest_add_state(ci, fn, module_env)
                if "update_identity" in ci.methods:
                    ci.defines_identity = True
                    ci.identity_nontrivial = _identity_nontrivial(ci.methods["update_identity"])
                out.append(ci)
                visit(child, qual + ".")
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(child, prefix + child.name + ".")

    visit(tree, "")
    return out


class Universe:
    """Name-indexed class registry across every analyzed file, with textual
    ancestry resolution (first registration of a simple name wins — the
    package has no metric-class name collisions, and a miss only widens
    "unknown", never produces a finding)."""

    def __init__(self) -> None:
        self.by_name: Dict[str, ClassInfo] = {}
        self.all: List[ClassInfo] = []
        #: UPPERCASE module-level string constants across every analyzed
        #: file (resolves imported add_state name constants)
        self.constants: Dict[str, str] = {}

    def add_module(self, tree: ast.Module, path: str, infos: Optional[List[ClassInfo]] = None) -> List[ClassInfo]:
        """Register a module's classes (``infos``: its harvest, when the
        caller parsed it already)."""
        infos = harvest_classes(tree, path) if infos is None else infos
        for ci in infos:
            self.by_name.setdefault(ci.name, ci)
            self.all.append(ci)
        for item in tree.body:
            if isinstance(item, ast.Assign) and len(item.targets) == 1:
                t = item.targets[0]
                if (
                    isinstance(t, ast.Name)
                    and t.id.isupper()
                    and isinstance(item.value, ast.Constant)
                    and isinstance(item.value.value, str)
                ):
                    self.constants.setdefault(t.id, item.value.value)
        return infos

    def chain(self, ci: ClassInfo) -> List[ClassInfo]:
        """``ci`` plus resolvable ancestors, nearest first (depth-first over
        base names — a linearization approximation that is exact for the
        package's single-inheritance metric hierarchy)."""
        out: List[ClassInfo] = []
        seen: Set[int] = set()

        def walk(c: ClassInfo) -> None:
            if id(c) in seen:
                return
            seen.add(id(c))
            out.append(c)
            for b in c.base_names:
                base = self.by_name.get(b)
                if base is not None:
                    walk(base)

        walk(ci)
        return out

    def is_metric_class(self, ci: ClassInfo) -> bool:
        """Does ``ci`` look like a Metric subclass? True when the textual
        ancestry reaches a class named ``Metric`` or any ancestor (itself
        included) declares state via ``add_state``."""
        for c in self.chain(ci):
            if c.name == "Metric" or c.add_state_calls:
                return True
        return "Metric" in ci.base_names


# ---------------------------------------------------------------------------
# update/compute reachability + attribute writes
# ---------------------------------------------------------------------------

@dataclass
class AttrWrite:
    attr: str
    line: int
    col: int
    in_place: bool
    owner: str  # "Class.method"
    path: str = ""  # source file of the method that performs the write


@dataclass
class BodyScan:
    """Everything the mutation/host-sync rules need about one entry point
    (``update`` or ``compute``) of one class, helpers included."""

    writes: List[AttrWrite] = field(default_factory=list)
    host_syncs: List[Finding] = field(default_factory=list)
    #: if/while tests that depend on device VALUES (not shapes/dtypes):
    #: legal in eager, a host read that fails the FakeTensorMode probe and
    #: CUDA graph capture — their presence demotes a "clean" runtime verdict
    #: to "unknown" so the probe keeps the last (and precise) word.
    #: Entries are ``(line, owner, path)``.
    value_branches: List[Tuple[int, str, str]] = field(default_factory=list)
    #: self attributes (or aliases of them) passed as arguments to callees
    #: that are not known-pure: an in-place mutation could hide there. The
    #: runtime verdict demotes to "unknown" when the live value is mutable.
    leaked: List[str] = field(default_factory=list)
    #: False when something prevented a complete scan: a dynamic attribute
    #: write (setattr/getattr dispatch), an unresolvable self-method call, or
    #: ``self`` escaping into a non-method call. The runtime integration only
    #: trusts fully-resolved scans.
    resolved: bool = True


def _self_attr(expr: ast.expr) -> Optional[str]:
    if (
        isinstance(expr, ast.Attribute)
        and isinstance(expr.value, ast.Name)
        and expr.value.id == "self"
    ):
        return expr.attr
    return None


#: namespaces whose functions never mutate their tensor/container arguments
#: in place — except a function named in the in-place convention (``add_``)
#: or given an ``out=`` argument (:func:`_callee_is_pure`)
_PURE_ARG_NAMESPACES = frozenset({"torch", "F", "np", "numpy", "onp", "math"})


def _receiver_attr(expr: ast.expr, aliases: Dict[str, str]) -> Optional[str]:
    """The self attribute an in-place write through ``expr`` lands in:
    ``self.a``, ``self.a[i]``, ``self.a.data`` or a local alias of one."""
    while isinstance(expr, ast.Subscript) or (
        isinstance(expr, ast.Attribute) and _self_attr(expr) is None
        and isinstance(expr.value, (ast.Attribute, ast.Subscript))
    ):
        expr = expr.value
    attr = _self_attr(expr)
    if attr is None and isinstance(expr, ast.Name):
        attr = aliases.get(expr.id)
    return attr


def _out_targets(node: ast.Call) -> List[ast.expr]:
    for kw in node.keywords:
        if kw.arg == "out":
            return list(kw.value.elts) if isinstance(kw.value, (ast.Tuple, ast.List)) else [kw.value]
    return []


def _setattr_target(node: ast.Call) -> Tuple[bool, Optional[ast.expr]]:
    """``(is a setattr on self, name expression)`` for ``setattr(self, n, v)``
    and ``<cls>.__setattr__(self, n, v)`` (``nn.Module``/``object``)."""
    func = node.func
    if (isinstance(func, ast.Name) and func.id == "setattr") or (
        isinstance(func, ast.Attribute) and func.attr == "__setattr__"
    ):
        if node.args and isinstance(node.args[0], ast.Name) and node.args[0].id == "self":
            return True, node.args[1] if len(node.args) > 1 else None
    return False, None


def _collect_writes(fn: ast.FunctionDef, owner: str, path: str, scan: BodyScan) -> None:
    # local aliases of self attributes (`buf = self.seen`): an in-place
    # mutation of the alias is a mutation of the attribute
    aliases: Dict[str, str] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Attribute):
            attr = _self_attr(node.value)
            if attr is not None:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        aliases[t.id] = attr
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                _write_target(t, owner, path, scan)
                # rebinding an alias name to something else ends the alias —
                # but a SUBSCRIPT store through it is still an attr mutation
                if isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name):
                    attr = aliases.get(t.value.id)
                    if attr is not None:
                        scan.writes.append(AttrWrite(attr, t.lineno, t.col_offset, True, owner, path))
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            _write_target(node.target, owner, path, scan)
        elif isinstance(node, ast.AugAssign):
            _write_target(node.target, owner, path, scan, aug=True)
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                attr = _self_attr(t)
                if attr is not None:
                    scan.writes.append(AttrWrite(attr, t.lineno, t.col_offset, False, owner, path))
                elif isinstance(t, ast.Subscript):
                    attr = _self_attr(t.value)
                    if attr is not None:
                        scan.writes.append(AttrWrite(attr, t.lineno, t.col_offset, True, owner, path))
        elif isinstance(node, ast.Call):
            func = node.func
            is_setattr, name_expr = _setattr_target(node)
            attr = None
            # in-place container mutation: self.attr.append(...) — or the
            # same through a local alias (`buf = self.attr; buf.append(x)`)
            if isinstance(func, ast.Attribute) and func.attr in _MUTATING_METHODS:
                attr = _self_attr(func.value)
                if attr is None and isinstance(func.value, ast.Name):
                    attr = aliases.get(func.value.id)
            # a torch in-place method: self.attr.add_(...), also on
            # self.attr[i], self.attr.data or an alias
            elif isinstance(func, ast.Attribute) and _is_inplace_method(func.attr):
                attr = _receiver_attr(func.value, aliases)
            # setattr(self, ...) / nn.Module.__setattr__(self, ...): a write
            # we may not be able to name
            elif is_setattr:
                if isinstance(name_expr, ast.Constant):
                    scan.writes.append(
                        AttrWrite(str(name_expr.value), node.lineno, node.col_offset, False, owner, path)
                    )
                else:
                    scan.resolved = False
            if attr is not None:
                scan.writes.append(AttrWrite(attr, node.lineno, node.col_offset, True, owner, path))
            # out=self.attr: the callee writes the attribute's storage
            for target in _out_targets(node):
                attr = _receiver_attr(target, aliases)
                if attr is not None:
                    scan.writes.append(
                        AttrWrite(attr, node.lineno, node.col_offset, True, owner, path)
                    )
            # a self attribute (or an alias of one) handed to an arbitrary
            # callee may be mutated in place where we cannot see it — python
            # scalars are immutable, tensors and container latches are not.
            # Record the leak; the runtime verdict demotes to "unknown" only
            # when the attr's LIVE value is actually mutable (so config
            # scalars like `self.reduce` passed to functional helpers keep
            # the stat-score family statically clean). torch/np-namespace
            # calls (but their in-place and out= forms) and benign builtins
            # are known pure.
            if not _callee_is_pure(node):
                for arg in list(node.args) + [kw.value for kw in node.keywords]:
                    leaked = None
                    if isinstance(arg, ast.Attribute):
                        leaked = _self_attr(arg)
                    elif isinstance(arg, ast.Name):
                        leaked = aliases.get(arg.id)
                    if leaked is not None:
                        scan.leaked.append(leaked)


def _write_target(t: ast.expr, owner: str, path: str, scan: BodyScan, aug: bool = False) -> None:
    attr = _self_attr(t)
    if attr == "__dict__":
        return
    if (
        isinstance(t, ast.Subscript)
        and _self_attr(t.value) == "__dict__"
    ):
        # self.__dict__["name"] = v: a write of `name`, unnamed when the key
        # is not a literal
        if isinstance(t.slice, ast.Constant) and isinstance(t.slice.value, str):
            scan.writes.append(AttrWrite(t.slice.value, t.lineno, t.col_offset, False, owner, path))
        else:
            scan.resolved = False
        return
    if attr is None and isinstance(t, ast.Attribute) and t.attr == "data":
        # self.a.data = v (or self.a[i].data = v): the tensor self.a in place
        attr = _receiver_attr(t.value, {})
        if attr is not None:
            scan.writes.append(AttrWrite(attr, t.lineno, t.col_offset, True, owner, path))
        return
    if attr is not None:
        # plain assignment rebinds; augmented assignment on a container
        # mutates in place, but either way it is a write to the attr
        scan.writes.append(AttrWrite(attr, t.lineno, t.col_offset, aug, owner, path))
        return
    if isinstance(t, ast.Subscript):
        attr = _self_attr(t.value)
        if attr is not None:
            scan.writes.append(AttrWrite(attr, t.lineno, t.col_offset, True, owner, path))
    elif isinstance(t, (ast.Tuple, ast.List)):
        for el in t.elts:
            _write_target(el, owner, path, scan, aug=aug)


# -- host-sync taint ---------------------------------------------------------

def _is_array_annotation(ann: Optional[ast.expr]) -> bool:
    if ann is None:
        return False
    text = ast.unparse(ann) if hasattr(ast, "unparse") else ""
    return any(frag in text for frag in _ARRAY_ANNOTATIONS)


#: annotation names that describe host values only (Python scalars, strings
#: and typing containers of them)
_HOST_ANNOTATION_NAMES = frozenset(
    {
        "bool", "int", "float", "str", "bytes", "None", "list", "tuple", "dict",
        "List", "Tuple", "Sequence", "Union", "Optional", "Dict", "typing",
    }
)


def _is_host_annotation(ann: Optional[ast.expr]) -> bool:
    if ann is None:
        return False
    names = [n.id for n in ast.walk(ann) if isinstance(n, ast.Name)]
    names += [n.attr for n in ast.walk(ann) if isinstance(n, ast.Attribute)]
    consts = [n for n in ast.walk(ann) if isinstance(n, ast.Constant) and n.value is not None]
    return bool(names) and not consts and all(n in _HOST_ANNOTATION_NAMES for n in names)


class _TaintScan(ast.NodeVisitor):
    """Single-function forward taint: which local names carry device values?

    Seeds: parameters with array-typed annotations, ``self.<state>`` reads.
    Propagation: any assignment whose RHS mentions a tainted name (or a
    tainted self-state read) taints its targets; ``for`` targets inherit
    the iterable's taint. One forward pass in source order plus a fixpoint
    loop, which is enough for the package's straight-line update bodies.
    """

    def __init__(self, fn: ast.FunctionDef, state_names: Set[str], seed_all: bool = False) -> None:
        self.state_names = state_names
        self.tainted: Set[str] = set()
        args = fn.args
        for a in list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs):
            if a.arg == "self":
                continue
            # seed_all: the entry's parameters are device values by contract
            # (merge_states receives state pytrees), unless annotated as a
            # host type alone (`in_place: bool`, `Union[str, List[str]]`)
            if (seed_all and not _is_host_annotation(a.annotation)) or _is_array_annotation(a.annotation):
                self.tainted.add(a.arg)

    def expr_tainted(self, expr: ast.expr) -> bool:
        for node in ast.walk(expr):
            if isinstance(node, ast.Name) and node.id in self.tainted:
                return True
            attr = _self_attr(node) if isinstance(node, ast.Attribute) else None
            if attr is not None and attr in self.state_names:
                return True
        return False

    def run(self, fn: ast.FunctionDef) -> None:
        for _ in range(3):  # fixpoint for simple forward/backward dataflow
            before = set(self.tainted)
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) and self.expr_tainted(node.value):
                    for t in node.targets:
                        self._taint_target(t)
                elif isinstance(node, ast.AugAssign) and (
                    self.expr_tainted(node.value) or self.expr_tainted(node.target)
                ):
                    self._taint_target(node.target)
                elif isinstance(node, ast.AnnAssign) and node.value is not None and self.expr_tainted(node.value):
                    self._taint_target(node.target)
                elif isinstance(node, ast.For) and self.expr_tainted(node.iter):
                    self._taint_target(node.target)
                elif isinstance(node, ast.withitem) and node.optional_vars is not None:
                    if self.expr_tainted(node.context_expr):
                        self._taint_target(node.optional_vars)
            if self.tainted == before:
                break

    def _taint_target(self, t: ast.expr) -> None:
        if isinstance(t, ast.Name):
            self.tainted.add(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for el in t.elts:
                self._taint_target(el)
        elif isinstance(t, ast.Starred):
            self._taint_target(t.value)


#: schema reads on tensors — branching on these is static under capture
#: (attributes, and the methods ``numel()``/``dim()``/``size()``/...)
_SHAPE_ATTRS = frozenset(
    {"shape", "ndim", "dtype", "size", "numel", "dim", "element_size", "is_floating_point", "device", "is_cuda"}
)
#: ``_is_concrete`` (``utils/checks.py``) is the port's ``is_traced``
_SCHEMA_PREDICATES = frozenset({"isinstance", "len", "callable", "hasattr", "type", "_is_concrete"})


def _test_value_dependent(expr: ast.expr, taint: "_TaintScan") -> bool:
    """Does a branch test read device *values* (vs shapes/dtypes/types)?
    ``if preds.ndim == 1`` is static under capture; ``if preds.sum() > 0``
    reads the value back to the host, which capture cannot hold."""
    found = False

    def visit(node: ast.AST) -> None:
        nonlocal found
        if found:
            return
        if isinstance(node, ast.Attribute):
            if node.attr in _SHAPE_ATTRS:
                return  # schema read — do not descend
            attr = _self_attr(node)
            if attr is not None and attr in taint.state_names:
                found = True
                return
        if isinstance(node, ast.Call):
            name = None
            if isinstance(node.func, ast.Name):
                name = node.func.id
            elif isinstance(node.func, ast.Attribute):
                name = node.func.attr
            if name in _SCHEMA_PREDICATES:
                return
        if isinstance(node, ast.Name) and node.id in taint.tainted:
            found = True
            return
        for child in ast.iter_child_nodes(node):
            visit(child)

    visit(expr)
    return found


def _scan_host_syncs(
    fn: ast.FunctionDef, owner: str, path: str, state_names: Set[str], scan: BodyScan,
    seed_all: bool = False,
) -> None:
    taint = _TaintScan(fn, state_names, seed_all=seed_all)
    taint.run(fn)
    for node in ast.walk(fn):
        test = None
        if isinstance(node, (ast.If, ast.While, ast.IfExp)):
            test = node.test
        elif isinstance(node, ast.Assert):
            test = node.test
        if test is not None and _test_value_dependent(test, taint):
            scan.value_branches.append((node.lineno, owner, path))
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        finding = _host_sync_of(node, taint)
        if finding:
            scan.host_syncs.append(
                Finding(
                    "host-sync-in-update",
                    path,
                    node.lineno,
                    node.col_offset,
                    f"{owner}: {finding}",
                    owner=owner,
                )
            )


#: tensor methods that copy the value to the host
_HOST_COPY_METHODS = frozenset({"cpu", "tolist", "numpy"})
#: ops whose output shape depends on the data: the host reads the count back
#: from the device before it can size the output (no CUDA graph can hold it)
_DATA_SHAPE_OPS = frozenset({"nonzero", "unique", "masked_select"})


def _is_torch_namespace(expr: ast.expr) -> bool:
    return isinstance(expr, ast.Name) and expr.id in _TORCH_MODULE_NAMES


def _is_cpu_device(expr: ast.expr) -> bool:
    if isinstance(expr, ast.Constant):
        return expr.value == "cpu"
    return (
        isinstance(expr, ast.Call)
        and _call_name_of(expr.func) == "device"
        and bool(expr.args)
        and isinstance(expr.args[0], ast.Constant)
        and expr.args[0].value == "cpu"
    )


def _host_sync_of(node: ast.Call, taint: "_TaintScan") -> Optional[str]:
    """The host-sync finding of one call, or None."""
    func = node.func
    if isinstance(func, ast.Name) and func.id in ("float", "int", "bool"):
        if node.args and taint.expr_tainted(node.args[0]):
            return (
                f"{func.id}() on a device value forces a device->host sync "
                "every step (and breaks CUDA graph capture)"
            )
        return None
    if not isinstance(func, ast.Attribute):
        return None
    name = func.attr
    torch_fn = _is_torch_namespace(func.value)
    # the tensor the call reads: the receiver of a method, the first
    # argument of a torch.<op>(...) function
    subject = node.args[0] if torch_fn and node.args else (None if torch_fn else func.value)
    tainted = subject is not None and taint.expr_tainted(subject)
    if name == "item" and not node.args and not torch_fn:
        return ".item() on a device value forces a device->host sync every step" if tainted else None
    if name in ("asarray", "array") and isinstance(func.value, ast.Name) and func.value.id in _NUMPY_MODULE_NAMES:
        if node.args and taint.expr_tainted(node.args[0]):
            return (
                f"np.{name}() on a device value materializes it on the "
                "host every step — keep the hot path in torch"
            )
        return None
    if name in _HOST_COPY_METHODS and not torch_fn:
        return f".{name}() copies a device value to the host every step" if tainted else None
    if name == "to" and not torch_fn:
        device = node.args[0] if node.args else next((kw.value for kw in node.keywords if kw.arg == "device"), None)
        if device is not None and _is_cpu_device(device) and tainted:
            return '.to("cpu") copies a device value to the host every step'
        return None
    if name == "synchronize" and _call_name_of(func.value) == "cuda":
        return "torch.cuda.synchronize() inside the per-step hot path blocks on the device"
    if name in _DATA_SHAPE_OPS and tainted:
        return (
            f"{name}() has a data-dependent output shape: it reads a count back "
            "from the device every step (and cannot be captured)"
        )
    if name == "where" and torch_fn and len(node.args) == 1 and not node.keywords and tainted:
        return (
            "one-argument torch.where() is nonzero(): a data-dependent output "
            "shape read back from the device every step"
        )
    if name == "repeat_interleave" and tainted:
        if any(kw.arg == "output_size" for kw in node.keywords):
            return None
        repeats = node.args[1] if torch_fn and len(node.args) > 1 else (
            node.args[0] if not torch_fn and node.args else None)
        repeats = repeats if repeats is not None else next(
            (kw.value for kw in node.keywords if kw.arg == "repeats"), None)
        if isinstance(repeats, ast.Constant) and isinstance(repeats.value, int):
            return None  # a fixed repeat count: the output shape is static
        return (
            "repeat_interleave() without output_size reads the output length "
            "back from the device every step"
        )
    return None


# -- reachability ------------------------------------------------------------

#: builtins that take ``self`` without ever mutating its attributes
_BENIGN_SELF_CONSUMERS = frozenset({"type", "id", "repr", "str", "hash", "len", "isinstance"})

#: builtins that never mutate their arguments in place
_PURE_BUILTIN_CALLEES = frozenset(
    {
        "len", "float", "int", "bool", "str", "repr", "hash", "type", "id",
        "isinstance", "callable", "hasattr", "getattr", "list", "tuple",
        "dict", "set", "frozenset", "sorted", "reversed", "enumerate", "zip",
        "range", "min", "max", "sum", "abs", "all", "any", "print", "format",
    }
)


def _callee_is_pure(node: ast.Call) -> bool:
    """Callees that provably do not mutate their arguments in place: benign
    builtins and anything under the torch/np namespaces, unless the function
    is named in the in-place convention (``torch.nn.init.normal_``) or
    writes an ``out=`` argument."""
    func = node.func
    if isinstance(func, ast.Name):
        return func.id in _PURE_BUILTIN_CALLEES
    if isinstance(func, ast.Attribute):
        if _is_inplace_method(func.attr) or _out_targets(node):
            return False
        root = func.value
        while isinstance(root, ast.Attribute):
            root = root.value
        return isinstance(root, ast.Name) and root.id in _PURE_ARG_NAMESPACES
    return False


def _self_method_calls(fn: ast.FunctionDef) -> Tuple[Set[str], bool]:
    """(names of self.<m>(...) calls, self_escapes) — ``self_escapes`` is True
    when ``self`` is passed as an argument to anything non-introspective
    (the callee may then mutate attributes we cannot see)."""
    calls: Set[str] = set()
    escapes = False
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            if (
                isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "self"
            ):
                calls.add(node.func.attr)
            callee = _call_name_of(node.func)
            if callee in _BENIGN_SELF_CONSUMERS:
                continue
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                if isinstance(arg, ast.Name) and arg.id == "self":
                    escapes = True
                elif isinstance(arg, ast.Starred) and isinstance(arg.value, ast.Name) and arg.value.id == "self":
                    escapes = True
    return calls, escapes


def _call_name_of(func: ast.expr) -> Optional[str]:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


#: Metric-API methods update bodies legitimately call without them being
#: "helpers to scan" (they live on the runtime base and never mutate
#: non-exempt attrs from update; add_state is scanned separately)
_RUNTIME_API_METHODS = frozenset(
    {
        "add_state", "reset", "compute", "update", "forward", "clone",
        "_group_detach_if_stray", "pure_update", "pure_compute",
        "_batch_default_state", "merge_states", "_filtered_kwargs",
        "enable_check_finite", "with_capacity",
    }
)


#: one scan of each method for each (owner, the states it reads, seeding):
#: the base class's methods (``Metric.merge_states`` and its helpers) are on
#: every class's path. The entry holds ``fn``, so its id stays unique.
_FUNCTION_SCANS: Dict[Tuple, Tuple[ast.FunctionDef, BodyScan, Set[str]]] = {}


def _scan_function(
    fn: ast.FunctionDef, owner: str, path: str, state_names: Set[str], seed_all: bool
) -> Tuple[BodyScan, Set[str]]:
    """Writes and host syncs of one method, and the self-methods it calls."""
    reads = {a for a in (_self_attr(n) for n in ast.walk(fn) if isinstance(n, ast.Attribute)) if a}
    key = (id(fn), owner, path, frozenset(reads & set(state_names)), seed_all)
    hit = _FUNCTION_SCANS.get(key)
    if hit is None:
        part = BodyScan()
        _collect_writes(fn, owner, path, part)
        _scan_host_syncs(fn, owner, path, state_names, part, seed_all=seed_all)
        calls, escapes = _self_method_calls(fn)
        part.resolved = part.resolved and not escapes
        hit = _FUNCTION_SCANS[key] = (fn, part, calls)
    return hit[1], hit[2]


def scan_entry(
    universe: Universe, ci: ClassInfo, entry: str, state_names: Set[str],
    seed_all_params: bool = False,
) -> Optional[BodyScan]:
    """Scan ``entry`` (``update``/``compute``/``merge_states``) of ``ci``:
    the nearest definition in the textual MRO plus every reachable
    self-method helper. Returns ``None`` when no definition is visible
    anywhere in the chain.

    ``seed_all_params=True`` taints every entry parameter regardless of
    annotation — the conservative mode the runtime probe pre-classification
    uses for its demote-to-unknown signals (an unannotated array parameter
    must not let a host sync or value branch slip past the "clean" verdict;
    the CLI keeps the annotation-based seeding so unannotated host-side
    metrics do not produce false findings)."""
    chain = universe.chain(ci)

    def find(name: str) -> Optional[Tuple[ClassInfo, ast.FunctionDef]]:
        for c in chain:
            fn = c.methods.get(name)
            if fn is not None:
                return c, fn
        return None

    start = find(entry)
    if start is None:
        return None
    scan = BodyScan()
    seen: Set[str] = set()
    queue: List[Tuple[ClassInfo, ast.FunctionDef]] = [start]
    while queue:
        owner_ci, fn = queue.pop()
        if fn.name in seen:
            continue
        seen.add(fn.name)
        # merge_states runs inside every forward() step (and the compiled
        # forward captures it): its state-dict parameters are device values.
        # compute is scanned too — its host syncs are never CLI findings
        # (a one-shot compute() may legitimately leave the device), but its
        # value branches demote the runtime "clean" verdict to "unknown".
        part, calls = _scan_function(
            fn, f"{owner_ci.name}.{fn.name}", owner_ci.path, state_names,
            seed_all_params or (entry == "merge_states"),
        )
        scan.writes.extend(part.writes)
        scan.host_syncs.extend(part.host_syncs)
        scan.value_branches.extend(part.value_branches)
        scan.leaked.extend(part.leaked)
        scan.resolved = scan.resolved and part.resolved
        for name in calls:
            if name in seen or name in _RUNTIME_API_METHODS:
                continue
            target = find(name)
            if target is None:
                # a self-method we cannot see (defined on an unanalyzed base
                # or built dynamically): the scan is incomplete
                scan.resolved = False
            else:
                queue.append(target)
    return scan


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

def _chain_state_names(universe: Universe, ci: ClassInfo) -> Tuple[Set[str], bool]:
    names: Set[str] = set()
    dynamic = False
    for c in universe.chain(ci):
        names |= c.state_names
        dynamic = dynamic or c.dynamic_state_names
        for ref in c.state_name_refs:
            resolved = universe.constants.get(ref)
            if resolved is None:
                dynamic = True
            else:
                names.add(resolved)
    return names, dynamic


def _chain_shared_attrs(universe: Universe, ci: ClassInfo) -> Tuple[Set[str], bool]:
    """(declared shared attrs, dynamic?) — nearest declaration wins, like a
    class attribute."""
    for c in universe.chain(ci):
        if c.shared_dynamic:
            return set(), True
        if c.shared_attrs is not None:
            return set(c.shared_attrs), False
    return set(), False


def _chain_declares_identity(universe: Universe, ci: ClassInfo) -> bool:
    for c in universe.chain(ci):
        if c.defines_identity and c.identity_nontrivial:
            return True
    return False


def _is_scalar_default(expr: ast.expr) -> bool:
    """Statically-certain 0-d defaults: numeric literals, ``torch.zeros(())``/
    ``torch.ones(())``, ``torch.tensor(<number>)``."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, (int, float)):
        return True
    if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute):
        if expr.func.attr in ("zeros", "ones") and expr.args:
            shape = expr.args[0]
            return isinstance(shape, (ast.Tuple, ast.List)) and not shape.elts
        if expr.func.attr in ("tensor", "as_tensor", "asarray", "array") and expr.args:
            return isinstance(expr.args[0], ast.Constant) and isinstance(
                expr.args[0].value, (int, float)
            )
    return False


def check_class(universe: Universe, ci: ClassInfo) -> List[Finding]:
    findings: List[Finding] = []
    state_names, dynamic_states = _chain_state_names(universe, ci)
    shared, dynamic_shared = _chain_shared_attrs(universe, ci)
    declares_identity = _chain_declares_identity(universe, ci)

    # ---- state-default hygiene ------------------------------------------
    seen_names: Set[str] = set()
    for c in [ci]:  # own declarations only; ancestors report on themselves
        for call in c.add_state_calls:
            node = call.node
            for n in call.names:
                # conditional declarations (if/else list-vs-array schema
                # choices) are alternatives, never duplicates
                if n in seen_names and not call.conditional:
                    findings.append(
                        Finding(
                            "state-default", ci.path, node.lineno, node.col_offset,
                            f"{ci.name}: duplicate add_state declaration of {n!r}",
                            attr=n, owner=ci.name,
                        )
                    )
                if not call.conditional:
                    seen_names.add(n)
            if isinstance(call.default, ast.List) and call.default.elts:
                findings.append(
                    Finding(
                        "state-default", ci.path, node.lineno, node.col_offset,
                        f"{ci.name}: add_state default must be a tensor or an "
                        "EMPTY list (non-empty list defaults are rejected at runtime)",
                        owner=ci.name,
                    )
                )
            fx_literal: Optional[object] = None
            if isinstance(call.fx, ast.Constant):
                fx_literal = call.fx.value
            if isinstance(fx_literal, str) and fx_literal not in _ALLOWED_FX:
                findings.append(
                    Finding(
                        "state-default", ci.path, node.lineno, node.col_offset,
                        f"{ci.name}: dist_reduce_fx {fx_literal!r} is not one of "
                        f"{sorted(_ALLOWED_FX)} (or a callable/None)",
                        owner=ci.name,
                    )
                )
            if (
                isinstance(call.default, ast.List)
                and not call.default.elts
                and fx_literal in ("sum", "mean", "max", "min")
            ):
                findings.append(
                    Finding(
                        "state-default", ci.path, node.lineno, node.col_offset,
                        f"{ci.name}: a growing list state cannot use the reduce-style "
                        f"dist_reduce_fx {fx_literal!r} — the host sync treats lists as "
                        "cat-family (use 'cat'/None/a callable, or an array default)",
                        owner=ci.name,
                    )
                )
            if call.default is not None and fx_literal == "cat" and _is_scalar_default(call.default):
                findings.append(
                    Finding(
                        "state-default", ci.path, node.lineno, node.col_offset,
                        f"{ci.name}: a 0-d default cannot be a 'cat' state — "
                        "concatenation needs a leading row dimension (shape/dtype "
                        "mismatch with the declared reduction)",
                        owner=ci.name,
                    )
                )

    # ---- update-identity-redeclare --------------------------------------
    if ci.defines_update and not ci.defines_identity:
        for c in universe.chain(ci)[1:]:
            if c.defines_identity and c.identity_nontrivial:
                fn = ci.methods["update"]
                findings.append(
                    Finding(
                        "update-identity-redeclare", ci.path, fn.lineno, fn.col_offset,
                        f"{ci.name} overrides update() but not update_identity(); the "
                        f"key inherited from {c.name} is silently dropped at runtime "
                        "(Metric._effective_update_identity) — re-declare the key (or "
                        "an explicit `return None`) to make the grouping contract "
                        "visible",
                        owner=f"{ci.name}.update",
                    )
                )
                break

    # ---- mutation + host-sync rules -------------------------------------
    # only report findings for code the class itself defines — inherited
    # bodies are the ancestor's findings, at its own definition site
    own_methods = {f"{ci.name}.{m}" for m in ci.methods}
    for entry in ("update", "compute", "merge_states"):
        scan = scan_entry(universe, ci, entry, state_names)
        if scan is None:
            continue
        if entry != "compute":  # compute host syncs are not hot-path findings
            findings.extend(f for f in scan.host_syncs if f.owner in own_methods)
        if entry == "merge_states":
            # merge_states is checked for host syncs only: it must not touch
            # self at all, but inherited Metric.merge_states bookkeeping and
            # super() delegation make a write rule too noisy to be useful
            continue
        if dynamic_states or dynamic_shared:
            continue  # cannot know the declared sets; stay silent
        for w in scan.writes:
            if w.owner not in own_methods:
                continue
            if w.attr in state_names or w.attr in shared or w.attr in RUNTIME_EXEMPT_ATTRS:
                continue
            if w.attr.startswith("__"):
                continue
            verb = "mutates (in place)" if w.in_place else "assigns"
            if declares_identity and entry == "update":
                findings.append(
                    Finding(
                        "unshared-latch", ci.path, w.line, w.col,
                        f"{w.owner} {verb} self.{w.attr}, which is not an add_state "
                        "state and is missing from _group_shared_attrs — a compute "
                        "group would not propagate it to siblings (declare it, or "
                        "drop the update_identity key)",
                        attr=w.attr, owner=w.owner,
                    )
                )
            else:
                findings.append(
                    Finding(
                        "undeclared-state", ci.path, w.line, w.col,
                        f"{w.owner} {verb} self.{w.attr}, which no reachable "
                        "add_state() declares — an undeclared latch: reset()/sync/"
                        "checkpoint will not cover it and the compiled hot path "
                        "must exclude this class (declare it with add_state, or "
                        "set it in __init__ and list it in _group_shared_attrs)",
                        attr=w.attr, owner=w.owner,
                    )
                )
    return findings


def run_metric_pass(universe: Universe, infos: Sequence[ClassInfo]) -> List[Finding]:
    findings: List[Finding] = []
    seen: Set[Tuple] = set()
    for ci in infos:
        if not universe.is_metric_class(ci):
            continue
        if ci.name in ("Metric", "MetricCollection"):
            continue  # the runtime bases themselves, not metric subclasses
        for f in check_class(universe, ci):
            key = (f.rule, f.path, f.line, f.col, f.message)
            if key not in seen:
                seen.add(key)
                findings.append(f)
    return findings
