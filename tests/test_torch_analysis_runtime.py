"""metricslint for the port, the runtime bridge: probe pre-classification and
the compute-group planner.

The JAX suite (``tests/analysis/test_runtime_integration.py``) case for case
on the port's compiled path, with a probe counter on
``metric_mod.probe_traceable`` and ``coll_mod.probe_traceable``:
statically-verified classes skip the FakeTensorMode probe with results
bit-identical to the probed path; statically-refuted classes fall back with a
diagnostic naming the attribute and source line; unknown classes still
probe; the planner screens compute-group candidates against the static
report; ``METRICS_TPU_ANALYSIS_PRECLASSIFY=0`` turns all of it off. Then
(c): the verdicts and grouping hazards of every
``tests/test_torch_package.py::DEFAULT_DEVICE_CASES`` entry equal the JAX
package's, and the torch-only cases (in-place latch, dynamic write, a host
read the analysis cannot see).
"""
import sys
import types
import warnings

import numpy as np
import pytest
import torch

import metrics_tpu as ref
import metrics_tpu_torch.core.collections as coll_mod
import metrics_tpu_torch.core.metric as metric_mod
from metrics_tpu.analysis import runtime as ref_runtime
from metrics_tpu_torch import MeanSquaredError, MetricCollection, Precision
from metrics_tpu_torch.analysis import runtime
from metrics_tpu_torch.analysis.runtime import clear_cache, static_probe_verdict
from metrics_tpu_torch.observability import diagnostics
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError
from tests.helpers.torch_analysis_fixtures import (
    BranchyUnannotated,
    CleanSum,
    DynamicWrite,
    GroupableClean,
    GroupableLeaky,
    HiddenHostRead,
    InPlaceLatch,
    LeakyLatch,
)
from tests.test_torch_package import DEFAULT_DEVICE_CASES

BATCHES = [torch.from_numpy(np.linspace(0.0, 1.0, 32).astype(np.float32) * (i + 1)) for i in range(4)]
CPU = {"device": "cpu"}


@pytest.fixture()
def probe_counter(monkeypatch):
    calls = []
    orig = metric_mod.probe_traceable

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(metric_mod, "probe_traceable", counting)
    monkeypatch.setattr(coll_mod, "probe_traceable", counting)
    return calls


def compiled(m):
    m.compiled_update = True
    return m


# ---------------------------------------------------------------------------
# verdicts
# ---------------------------------------------------------------------------

def test_fixture_class_verdicts():
    assert static_probe_verdict(CleanSum(**CPU), ("update",))[0] == "clean"
    verdict, detail = static_probe_verdict(LeakyLatch(**CPU), ("update",))
    assert verdict == "dirty"
    assert "last_shape" in detail and "torch_analysis_fixtures.py" in detail
    assert static_probe_verdict(BranchyUnannotated(**CPU), ("update",))[0] == "unknown"


def test_shipped_class_verdicts():
    assert static_probe_verdict(MeanSquaredError(**CPU), ("update",))[0] == "clean"
    assert static_probe_verdict(Precision(**CPU), ("update",))[0] == "clean"
    assert static_probe_verdict(MeanSquaredError(**CPU), ("update", "compute", "merge"))[0] == "clean"


def test_escape_hatch_disables_preclassification(monkeypatch):
    monkeypatch.setenv("METRICS_TPU_ANALYSIS_PRECLASSIFY", "0")
    assert static_probe_verdict(CleanSum(**CPU), ("update",))[0] == "unknown"
    assert static_probe_verdict(LeakyLatch(**CPU), ("update",))[0] == "unknown"


# ---------------------------------------------------------------------------
# probe skip, bit-identical results
# ---------------------------------------------------------------------------

def test_clean_class_skips_probe(probe_counter):
    m = compiled(CleanSum(**CPU))
    for b in BATCHES:
        m.update(b)
    stats = m.compile_stats()
    assert probe_counter == [], "statically-clean class must not probe"
    assert stats["dispatches"] == len(BATCHES) and stats["fallback"] is None


def test_probe_skip_results_bit_identical(probe_counter, monkeypatch):
    def run():
        m = compiled(CleanSum(**CPU))
        for b in BATCHES:
            m.update(b)
        return {k: v.clone() for k, v in m._state.items()}, m.compute()

    skipped_state, skipped_value = run()
    n_skip = len(probe_counter)
    monkeypatch.setenv("METRICS_TPU_ANALYSIS_PRECLASSIFY", "0")
    probed_state, probed_value = run()
    assert n_skip == 0 and len(probe_counter) > 0
    assert torch.equal(skipped_value, probed_value)
    for k in probed_state:
        assert torch.equal(skipped_state[k], probed_state[k]) and skipped_state[k].dtype == probed_state[k].dtype


@pytest.mark.parametrize("cls, attr", [(LeakyLatch, "last_shape"), (InPlaceLatch, "rows")])
def test_dirty_class_definition_time_diagnostic(probe_counter, cls, attr):
    m = compiled(cls(**CPU))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for b in BATCHES:
            m.update(b)
    assert probe_counter == [], "statically-dirty class must not probe either"
    stats = m.compile_stats()
    reason = stats["fallback"]["update"]
    assert stats["dispatches"] == 0
    assert attr in reason and "torch_analysis_fixtures.py:" in reason
    # ... and the eager path kept the latch and the values correct
    if cls is LeakyLatch:
        assert m.last_shape == (32,)
    else:
        assert float(m.rows) == 32 * len(BATCHES)
    assert float(m.compute()) == pytest.approx(sum(float(b.sum()) for b in BATCHES), rel=1e-6)
    msgs = [str(w.message) for w in caught if "compiled" in str(w.message)]
    assert len(msgs) == 1 and attr in msgs[0]


@pytest.mark.parametrize("cls", [BranchyUnannotated, DynamicWrite])
def test_unknown_class_still_probes(probe_counter, cls):
    m = compiled(cls(**CPU))
    m.update(BATCHES[0])
    assert len(probe_counter) == 1, "unknown verdict keeps the probe in the loop"
    reason = m.compile_stats()["fallback"]["update"]
    assert ("not traceable" if cls is BranchyUnannotated else "latch") in reason


def test_collection_fused_update_skips_probe_when_all_clean(probe_counter):
    mc = MetricCollection({"mse": MeanSquaredError(**CPU), "prec": Precision(**CPU)})
    for m in mc.values():
        m.compiled_update = True
    rng = np.random.RandomState(0)
    for _ in range(4):
        mc.update(torch.from_numpy(rng.rand(16).astype(np.float32)),
                  torch.from_numpy((rng.rand(16) > 0.5).astype(np.int64)))
    assert probe_counter == []
    assert mc.compile_stats()["collection"]["dispatches"] == 4


def test_collection_member_refuted_statically_falls_back_alone(probe_counter):
    mc = MetricCollection({"sum": CleanSum(**CPU), "leaky": LeakyLatch(**CPU)}, compute_groups=False)
    for m in mc.values():
        m.compiled_update = True
    for b in BATCHES:
        mc.update(b)
    assert probe_counter == []
    assert "last_shape" in mc["leaky"].compile_stats()["fallback"]["update"]
    assert mc["sum"].compile_stats()["fallback"] is None
    assert mc["leaky"].last_shape == (32,)
    assert float(mc["leaky"].compute()) == pytest.approx(sum(float(b.sum()) for b in BATCHES), rel=1e-6)


# ---------------------------------------------------------------------------
# compute-group planner screening
# ---------------------------------------------------------------------------

def test_planner_groups_clean_identity_classes():
    mc = MetricCollection({"a": GroupableClean(**CPU), "b": GroupableClean(**CPU)})
    mc.update(BATCHES[0])
    assert mc.compute_group_keys == [["a", "b"]]


def test_planner_excludes_statically_refuted_class():
    diagnostics.reset(("group-static-hazard", GroupableLeaky))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mc = MetricCollection({"a": GroupableLeaky(**CPU), "b": GroupableLeaky(**CPU)})
        mc.update(BATCHES[0])
    assert mc.compute_group_keys == [], "hazardous class must stay solo"
    msgs = [str(w.message) for w in caught if "excluded from compute groups" in str(w.message)]
    assert msgs and "rows_seen" in msgs[0]
    for m in mc.values():
        assert m.rows_seen == 32
        assert float(m.compute()) == pytest.approx(float(BATCHES[0].sum()), rel=1e-6)


def test_explicit_group_override_refuted_loudly():
    with pytest.raises(MetricsTPUUserError, match="rows_seen"):
        MetricCollection(
            {"a": GroupableLeaky(**CPU), "b": GroupableLeaky(**CPU)}, compute_groups=[["a", "b"]],
        ).update(BATCHES[0])


def test_planner_screen_disabled_by_escape_hatch(monkeypatch):
    monkeypatch.setenv("METRICS_TPU_ANALYSIS_PRECLASSIFY", "0")
    mc = MetricCollection({"a": GroupableLeaky(**CPU), "b": GroupableLeaky(**CPU)})
    mc.update(BATCHES[0])
    assert mc.compute_group_keys == [["a", "b"]], "the pre-analysis behavior restored"


# ---------------------------------------------------------------------------
# review findings of the JAX suite, as modules on the path
# ---------------------------------------------------------------------------

def _import_module(tmp_path, monkeypatch, name, text):
    (tmp_path / f"{name}.py").write_text(text)
    monkeypatch.syspath_prepend(str(tmp_path))
    sys.modules.pop(name, None)
    __import__(name)
    # inspect.getsourcefile finds a class through sys.modules: keep it there
    # for the test, and take it out after
    monkeypatch.setitem(sys.modules, name, sys.modules[name])
    return sys.modules[name]


HEADER = "import torch\nfrom metrics_tpu_torch.core.metric import Metric\n\n"


def test_alias_mutation_is_not_verdicted_clean(tmp_path, monkeypatch):
    mod = _import_module(tmp_path, monkeypatch, "torch_alias_fixture_mod", HEADER + (
        "class AliasLatch(Metric):\n"
        "    def __init__(self, **kw):\n"
        "        super().__init__(**kw)\n"
        "        self.add_state('total', torch.zeros(()), dist_reduce_fx='sum')\n"
        "        self.seen = []\n"
        "    def update(self, x):\n"
        "        buf = self.seen\n"
        "        buf.append(int(x.shape[0]))\n"
        "        self.total = self.total + torch.sum(x)\n"
        "    def compute(self):\n"
        "        return self.total\n"))
    verdict, detail = static_probe_verdict(mod.AliasLatch(**CPU), ("update",))
    assert verdict == "dirty" and "seen" in detail
    m = compiled(mod.AliasLatch(**CPU))
    for b in BATCHES:
        m.update(b)
    assert m.seen == [32] * len(BATCHES)


def test_self_writing_merge_states_is_not_verdicted_clean(tmp_path, monkeypatch):
    mod = _import_module(tmp_path, monkeypatch, "torch_merge_fixture_mod", HEADER + (
        "class MergeCounter(Metric):\n"
        "    def __init__(self, **kw):\n"
        "        super().__init__(**kw)\n"
        "        self.add_state('total', torch.zeros(()), dist_reduce_fx='sum')\n"
        "        self.merges = 0\n"
        "    def update(self, x):\n"
        "        self.total = self.total + torch.sum(x)\n"
        "    def merge_states(self, a, b):\n"
        "        self.merges = self.merges + 1\n"
        "        return {'total': a['total'] + b['total']}\n"
        "    def compute(self):\n"
        "        return self.total\n"))
    assert static_probe_verdict(mod.MergeCounter(**CPU), ("update",))[0] == "clean"
    assert static_probe_verdict(mod.MergeCounter(**CPU), ("update", "compute", "merge"))[0] == "unknown"
    m = compiled(mod.MergeCounter(**CPU))
    for b in BATCHES:
        m(b)
    assert m.merges == len(BATCHES)


def test_mutable_attr_leaked_to_opaque_callee_demotes(tmp_path, monkeypatch):
    mod = _import_module(tmp_path, monkeypatch, "torch_leak_fixture_mod", HEADER + (
        "def _note(seen, x):\n"
        "    seen.append(x)\n\n"
        "class LeakyList(Metric):\n"
        "    def __init__(self, **kw):\n"
        "        super().__init__(**kw)\n"
        "        self.add_state('total', torch.zeros(()), dist_reduce_fx='sum')\n"
        "        self.seen = []\n"
        "    def update(self, x):\n"
        "        _note(self.seen, 1)\n"
        "        self.total = self.total + torch.sum(x)\n"
        "    def compute(self):\n"
        "        return self.total\n\n"
        "def _scaled(t, reduce, scale):\n"
        "    return torch.sum(t) * scale\n\n"
        "class ScalarConfig(Metric):\n"
        "    def __init__(self, **kw):\n"
        "        super().__init__(**kw)\n"
        "        self.add_state('total', torch.zeros(()), dist_reduce_fx='sum')\n"
        "        self.reduce = 'micro'\n"
        "        self.scale = torch.ones(())\n"
        "    def update(self, x):\n"
        "        self.total = self.total + _scaled(x, self.reduce, self.scale)\n"
        "    def compute(self):\n"
        "        return self.total\n"))
    assert static_probe_verdict(mod.LeakyList(**CPU), ("update",))[0] == "unknown"
    # a config string and a tensor (a replay repeats any in-place write to it)
    assert static_probe_verdict(mod.ScalarConfig(**CPU), ("update",))[0] == "clean"


def test_clear_cache_is_idempotent():
    clear_cache()
    assert static_probe_verdict(CleanSum(**CPU), ("update",))[0] == "clean"
    clear_cache()


# ---------------------------------------------------------------------------
# torch only
# ---------------------------------------------------------------------------

def test_hidden_host_read_is_the_residual_case(probe_counter, monkeypatch):
    """The analysis cannot see into a module-level helper: the verdict is
    clean and the probe is skipped. On the CPU the program runs directly (no
    capture) and equals the eager run; on the card the capture refuses it
    (``test_torch_analysis_cuda.py``, ``chip_smoke.py --analysis-only``). The
    probe alone would have refused it."""
    assert static_probe_verdict(HiddenHostRead(**CPU), ("update",))[0] == "clean"
    eager, m = HiddenHostRead(**CPU), compiled(HiddenHostRead(**CPU))
    for b in BATCHES:
        eager.update(b)
        m.update(b)
    assert probe_counter == [] and torch.equal(eager.compute(), m.compute())
    monkeypatch.setenv("METRICS_TPU_ANALYSIS_PRECLASSIFY", "0")
    probed = compiled(HiddenHostRead(**CPU))
    probed.update(BATCHES[0])
    assert "not traceable" in probed.compile_stats()["fallback"]["update"]


def test_merge_states_overflow_waiver_is_real(monkeypatch):
    """The port's merge_states suppression (core/metric.py, the JAX package's
    metric.py:2019 counterpart) waives a branch on a host bool: stripped, the
    forward verdict of every shipped class demotes to unknown."""
    assert static_probe_verdict(MeanSquaredError(**CPU), ("update", "compute", "merge"))[0] == "clean"
    read = runtime._read_source

    def stripped(path, sources):
        src = read(path, sources)
        return None if src is None else src.replace("# metricslint: disable", "# stripped")

    clear_cache()
    monkeypatch.setattr(runtime, "_read_source", stripped)
    try:
        assert static_probe_verdict(MeanSquaredError(**CPU), ("update", "compute", "merge"))[0] == "unknown"
    finally:
        clear_cache()


# ---------------------------------------------------------------------------
# (c) parity of the verdicts with the JAX package
# ---------------------------------------------------------------------------

#: JAX constructors where the port's case does not translate by name (the
#: port's member takes a device)
REFERENCE_CASES = {
    "RetrievalCollection": lambda: ref.RetrievalCollection({"map": ref.RetrievalMAP()}, num_queries=8)
    .with_capacity(64),
}

#: verdicts that differ from the JAX package's, each with its reason and a
#: test of the side it comes from: none
DIVERGENCES = {}


@pytest.fixture(scope="module")
def fast_reference():
    """The JAX bridge parses every module on a class's MRO, and each file's
    suppressions once per write, for every class anew; both are pure
    functions of a file, so within this module they are computed once (the
    JAX package itself is not touched)."""
    import functools

    import metrics_tpu.analysis.metric_pass as ref_pass
    import metrics_tpu.analysis.report as ref_report

    harvested = {}

    def harvest(tree, path, _orig=ref_pass.harvest_classes):
        if path not in harvested:
            harvested[path] = _orig(tree, path)
        return harvested[path]

    parse = functools.lru_cache(maxsize=None)(ref_report.parse_suppressions)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_pass, "harvest_classes", harvest)
        mp.setattr(ref_report, "parse_suppressions", parse)
        mp.setattr(ref_runtime, "parse_suppressions", parse)
        ref_runtime.clear_cache()
        yield
    ref_runtime.clear_cache()


def _reference(name, make):
    if name in REFERENCE_CASES:
        return REFERENCE_CASES[name]()
    rebound = types.FunctionType(make.__code__, {**make.__globals__, "port": ref}, make.__name__,
                                 make.__defaults__, make.__closure__)
    return rebound()


def _hazard_attrs(hazards):
    return sorted(h.split("(")[0] for h in hazards)


@pytest.mark.parametrize("name", sorted(DEFAULT_DEVICE_CASES))
def test_verdicts_equal_the_reference(name, fast_reference):
    make = DEFAULT_DEVICE_CASES[name]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mine, theirs = make(device="cpu"), _reference(name, make)
    got = {
        kinds: (static_probe_verdict(mine, kinds)[0], ref_runtime.static_probe_verdict(theirs, kinds)[0])
        for kinds in (("update",), ("update", "compute", "merge"))
    }
    got["hazards"] = (_hazard_attrs(runtime.grouping_hazards(mine)),
                      _hazard_attrs(ref_runtime.grouping_hazards(theirs)))
    differing = {k: v for k, v in got.items() if v[0] != v[1]}
    assert differing == DIVERGENCES.get(name, {})
