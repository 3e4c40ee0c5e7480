"""metricslint for the port, collective-schedule pass: the JAX suite
(``tests/analysis/test_schedule_pass.py``) case for case over the torch twins
of its fixtures and torch snippets, the invariant over the port's shipped
modules, and the torch vocabulary: every collective and rank source the pass
knows fires, and every symmetric reading it adds sits beside the asymmetric
form that still fires (``tests/torch_analysis_fixtures/violating_rank_taint.py``).
"""
import ast
import functools
from pathlib import Path

import pytest

from metrics_tpu_torch.analysis import analyze_paths, analyze_source
from metrics_tpu_torch.analysis import schedule_pass
from metrics_tpu_torch.analysis.schedule_pass import run_schedule_pass

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "metrics_tpu_torch"
FIXTURES = ROOT / "tests" / "torch_analysis_fixtures"


def findings_for(name: str):
    findings, errors = analyze_paths([str(FIXTURES / name)])
    assert not errors
    return findings


def by_function(findings):
    out = {}
    for f in findings:
        out.setdefault(f.owner, set()).add(f.rule)
    return out


def test_schedule_fixture_covers_every_rule():
    owners = by_function(findings_for("violating_schedule.py"))
    assert owners["rank_zero_extra_gather"] == {"rank-dependent-collective"}
    assert owners["data_dependent_gather"] == {"data-dependent-collective"}
    assert owners["early_exit_desync"] == {"data-dependent-collective"}
    assert owners["collective_in_handler"] == {"collective-in-handler"}
    assert "nondeterministic-collective-order" in owners["set_iteration_order"]
    assert owners["transitive_rank_dependence"] == {"rank-dependent-collective"}
    assert "clean_symmetric_paths" not in owners


def test_collective_result_is_symmetric():
    src = '''
import torch

def _gather(x, group=None, timeout=None):
    return [x]

def uneven_gather(result):
    shapes = torch.stack(_gather(torch.tensor(result.shape)))
    if bool((shapes == shapes[0]).all()):
        return _gather(result)                  # clean: gathered guard
    return _gather(torch.nn.functional.pad(result, (0, 3)))
'''
    assert run_schedule_pass(ast.parse(src), "<s>") == []


def test_dict_iteration_order_is_schema_but_elements_are_data():
    src = '''
def _gather(x, group=None, timeout=None):
    return [x]

def per_leaf(state):
    out = {}
    for name, value in state.items():
        if len(value) == 0:        # local-data guard over a collective
            continue
        out[name] = _gather(value)
    return out
'''
    findings = run_schedule_pass(ast.parse(src), "<s>")
    assert {f.rule for f in findings} == {"data-dependent-collective"}


def test_finally_block_counts_as_handler():
    src = '''
def _gather(x, group=None, timeout=None):
    return [x]

def f(x):
    try:
        return _gather(x)
    finally:
        _gather(x)
'''
    findings = run_schedule_pass(ast.parse(src), "<s>")
    assert any(f.rule == "collective-in-handler" for f in findings)


def test_in_program_collectives_are_tracked():
    """The port's counterpart of the in-jit ``psum``: the functional
    collectives and the in-program seam."""
    src = '''
import torch.distributed._functional_collectives as funcol

def f(value, axis_name, fx):
    if len(value) == 0:
        return value
    return funcol.all_reduce(value, "sum", axis_name)

def g(value, axis_name):
    if len(value) == 0:
        return value
    return _program_collective(value, "sum", axis_name)
'''
    findings = run_schedule_pass(ast.parse(src), "<s>")
    assert by_function(findings) == {"f": {"data-dependent-collective"}, "g": {"data-dependent-collective"}}


def test_async_round_api_is_known_emitting():
    src = '''
import torch.distributed as dist

def maybe_launch(state, reductions):
    if len(state) > 0:
        return launch_round(state, reductions, update_count=1, epoch=1)
    return None

def maybe_resolve(round_, value):
    if value.sum() > 0:
        return resolve_round(round_)
    return None

def rank_zero_drain(round_):
    if dist.get_rank() == 0:
        drain_round(round_)

def clean_resolve(round_):
    synced, wait_s = resolve_round(round_)
    if synced.sum() > 0:      # collective result: symmetric guard
        return host_sync_state(synced, {})
    return synced
'''
    owners = by_function(run_schedule_pass(ast.parse(src), "<s>"))
    assert owners["maybe_launch"] == {"data-dependent-collective"}
    assert owners["maybe_resolve"] == {"data-dependent-collective"}
    assert owners["rank_zero_drain"] == {"rank-dependent-collective"}
    assert "clean_resolve" not in owners


def test_shipped_parallel_modules_verify():
    """Every reachable path in the port's parallel/ emits collectives in
    rank/data-independent order. The deliberate exceptions carry the JAX
    package's commented suppressions, and stripping them resurfaces the
    findings."""
    parallel = PKG / "parallel"
    findings, errors = analyze_paths([str(parallel)])
    assert not errors
    assert findings == [], "\n".join(f.format() for f in findings)
    sync_path = parallel / "sync.py"
    src = sync_path.read_text().replace("# metricslint: disable", "# stripped")
    resurfaced = analyze_source(src, str(sync_path))
    assert {f.rule for f in resurfaced} == {"data-dependent-collective", "collective-in-handler"}
    assert {f.owner for f in resurfaced} == {"sync_in_jit", "host_sync_state"}


def test_guarded_emit_fixture_covers_the_rule():
    owners = by_function(findings_for("violating_guarded_emit.py"))
    assert owners["rank_gated_emit"] == {"guarded-telemetry-emit"}
    assert owners["data_gated_emit"] == {"guarded-telemetry-emit"}
    assert owners["rank_gated_emit_via_helper"] == {"guarded-telemetry-emit"}
    assert "_emit_helper" not in owners
    assert "active_gated_emit_is_clean" not in owners


def test_recorder_calls_are_not_collectives_and_do_not_wash_taint():
    src = '''
def _gather(x, group=None, timeout=None):
    return [x]

def emit_then_gather(state, x):
    record("sync.gather", states=len(state))   # emission, NOT a collective
    n = len(state)
    record("sync.plan", buckets=n)
    if n > 0:                                   # still local: record washed nothing
        return _gather(x)
    return x
'''
    findings = run_schedule_pass(ast.parse(src), "<s>")
    assert by_function(findings)["emit_then_gather"] == {"data-dependent-collective"}
    assert all(f.rule != "guarded-telemetry-emit" or f.line != 7 for f in findings)


def test_emit_only_functions_are_checked():
    src = '''
def emit_only(value):
    if value.sum() > 0:
        record("sync.resolve", stale=True)
'''
    findings = run_schedule_pass(ast.parse(src), "<s>")
    assert by_function(findings)["emit_only"] == {"guarded-telemetry-emit"}


def test_shipped_package_emission_sites_are_guard_free():
    findings, errors = analyze_paths([str(PKG)])
    assert not errors
    assert [f for f in findings if f.rule == "guarded-telemetry-emit"] == []
    ckpt_path = PKG / "core" / "checkpoint.py"
    src = ckpt_path.read_text().replace("# metricslint: disable", "# stripped")
    resurfaced = [f for f in analyze_source(src, str(ckpt_path)) if f.rule == "guarded-telemetry-emit"]
    # the snapshot, save, prune and load sites, as in the JAX package
    assert {f.owner for f in resurfaced} == {"save_checkpoint", "load_checkpoint"}
    assert len({f.line for f in resurfaced}) == 4


def test_controller_fixture_covers_asymmetric_schedule_decision():
    owners = by_function(findings_for("violating_controller.py"))
    assert owners["rank_dependent_cadence"] == {"asymmetric-schedule-decision"}
    assert owners["rank_derived_timeout"] == {"asymmetric-schedule-decision"}
    assert owners["data_dependent_policy"] == {"asymmetric-schedule-decision"}
    assert owners["latch_governed_decision"] == {"asymmetric-schedule-decision"}
    assert "clean_symmetric_decision" not in owners


def test_schedule_decision_value_taint_is_flagged():
    src = '''
def straight_line_commit(state):
    cadence = 1 + len(state)
    commit_schedule_decision("sync_cadence_multiplier", cadence, epoch=1, reason="x")
'''
    findings = run_schedule_pass(ast.parse(src), "<s>")
    assert by_function(findings)["straight_line_commit"] == {"asymmetric-schedule-decision"}


def test_probation_gate_is_local_and_membership_readers_are_symmetric():
    src = '''
def _gather(x, group=None, timeout=None):
    return [x]

def gate_guarded_gather(x):
    if channel_gate() == "open":
        return _gather(x)
    return x

def membership_guarded_gather(x):
    if effective_world() > 1 and membership_epoch() > 0:
        return _gather(x)
    return x
'''
    owners = by_function(run_schedule_pass(ast.parse(src), "<s>"))
    assert owners["gate_guarded_gather"] == {"data-dependent-collective"}
    assert "membership_guarded_gather" not in owners


def test_shipped_resilience_module_verifies():
    findings, errors = analyze_paths([str(PKG / "parallel" / "resilience.py")])
    assert not errors
    assert [f for f in findings if f.rule == "asymmetric-schedule-decision"] == []


def test_plan_invalidation_fixture_covers_asymmetric_schedule_decision():
    owners = by_function(findings_for("violating_plan_invalidation.py"))
    assert owners["rank_dependent_invalidation"] == {"asymmetric-schedule-decision"}
    assert owners["data_dependent_invalidation"] == {"asymmetric-schedule-decision"}
    assert owners["data_derived_reason"] == {"asymmetric-schedule-decision"}
    assert owners["latch_governed_invalidation"] == {"asymmetric-schedule-decision"}
    assert "clean_symmetric_invalidation" not in owners


def test_shipped_plan_module_verifies():
    findings, errors = analyze_paths([str(PKG / "core" / "plan.py"), str(PKG / "core" / "collections.py")])
    assert not errors
    assert [f for f in findings if f.rule == "asymmetric-schedule-decision"] == []


def test_tier_hop_fixture_is_rank_dependent():
    owners = by_function(findings_for("violating_tier_hop.py"))
    assert owners == {
        "adhoc_leader_exchange": {"rank-dependent-collective"},
        "adhoc_tier_branch": {"rank-dependent-collective"},
    }


# ---------------------------------------------------------------------------
# the torch vocabulary
# ---------------------------------------------------------------------------

def _rank_taint_lines():
    findings = findings_for("violating_rank_taint.py")
    out = {}
    for f in findings:
        out.setdefault(f.owner, set()).add((f.line, f.rule))
    return out


def test_every_collective_fires_under_a_rank_guard():
    lines = _rank_taint_lines()["every_collective_rank_gated"]
    src = (FIXTURES / "violating_rank_taint.py").read_text().splitlines()
    fired = {src[line - 1].strip().split("(")[0].split(".")[-1] for line, _ in lines}
    # wait_tensor(all_reduce(...)) fires twice on one line
    assert fired | {"all_reduce"} == {
        "all_gather", "all_gather_into_tensor", "all_reduce", "broadcast", "reduce_scatter_tensor",
        "all_to_all_single", "barrier", "all_gather_object", "broadcast_object_list", "all_gather_tensor",
        "wait_tensor", "_gather", "_program_collective",
    }
    assert {rule for _, rule in lines} == {"rank-dependent-collective"}
    assert len(lines) == 13  # thirteen lines, fourteen calls
    assert fired | {"all_reduce"} == set(schedule_pass.COLLECTIVE_CALLS)


def test_every_rank_source_taints():
    lines = _rank_taint_lines()
    assert lines["rank_helper_gated"] == {(n, "rank-dependent-collective") for n in (68, 70, 72, 75)}
    assert lines["rank_env_gated"] == {(n, "rank-dependent-collective") for n in (82, 84, 86)}
    assert "symmetric_env_knob" not in lines
    assert set(schedule_pass.RANK_CALLS) == {"get_rank", "_rank", "_current_rank", "_default_rank",
                                              "_default_coordinates"}


def test_symmetric_readings_beside_their_asymmetric_forms():
    lines = _rank_taint_lines()
    assert lines["world_size_guard"] == {(100, "rank-dependent-collective")}
    assert lines["schema_guards"] == {(111, "data-dependent-collective")}
    assert lines["key_set_guards"] == {
        (120, "data-dependent-collective"), (122, "data-dependent-collective"),
        (124, "data-dependent-collective"), (124, "nondeterministic-collective-order"),
    }


@pytest.mark.parametrize("name", sorted(
    schedule_pass.KNOWN_EMITTING_CALLS | schedule_pass.RECORDER_CALLS | schedule_pass.SCHEDULE_DECISION_CALLS
    | schedule_pass.RANK_CALLS - {"get_rank"}
    | (schedule_pass._SYMMETRIC_CALLS - schedule_pass.COLLECTIVE_CALLS
       - {"isinstance", "callable", "get_world_size", "negotiate_allgather", "subset_allgather"})
    | {"_gather", "_program_collective", "channel_is_suspect", "channel_gate", "build_health_word"}))
def test_vocabulary_names_are_defined_in_the_port(name):
    """Each name of the tables is a function of the port (the torch.distributed
    names and the quorum transport's two methods aside)."""
    assert name in _port_functions()


@functools.lru_cache(maxsize=None)
def _port_functions():
    defined = set()
    for path in PKG.rglob("*.py"):
        if "analysis" in path.parts:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.FunctionDef):
                defined.add(node.name)
    return frozenset(defined)


def test_no_jax_vocabulary_is_left():
    jax_names = {"process_index", "process_count", "process_allgather", "_process_allgather",
                 "_raw_process_allgather", "psum", "pmean", "pmax", "pmin", "device_get"}
    tables = (schedule_pass.COLLECTIVE_CALLS | schedule_pass.KNOWN_EMITTING_CALLS
              | schedule_pass._SYMMETRIC_CALLS | schedule_pass._LOCAL_CALLS | schedule_pass.RANK_CALLS)
    assert not tables & jax_names
