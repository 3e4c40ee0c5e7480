"""Package rules of the PyTorch port.

- No module of ``metrics_tpu_torch``, not ``chip_smoke.py`` and no
  ``examples/torch_*.py`` imports JAX or anything of the JAX package
  ``metrics_tpu``: the port keeps its own copies.
- Metrics run on the card by default: without CUDA, a metric constructed
  without ``device="cpu"`` raises instead of quietly running on the host.
"""
import ast
from pathlib import Path

import pytest
import torch

import metrics_tpu_torch as port

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = (sorted((ROOT / "metrics_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "examples").glob("torch_*.py")))


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(module):
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "metrics_tpu")


def test_port_files_are_found():
    names = {p.name for p in PORT_FILES}
    assert {"metric.py", "binned_stats.py", "chip_smoke.py", "_build.py", "torch_sharded_eval.py",
            "torch_train_loop_integration.py", "torch_bert_score_own_model.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = sorted({m for m in _imported_modules(path) if _forbidden(m)})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_matches_the_reference_but_not_the_port():
    assert _forbidden("metrics_tpu.utils.enums")
    assert _forbidden("jax.numpy")
    assert not _forbidden("metrics_tpu_torch.utils.enums")


def test_kernel_sources_ship_with_the_package():
    assert (ROOT / "metrics_tpu_torch" / "csrc" / "binned_stats.cu").exists()
    assert '"metrics_tpu_torch" = ["csrc/*.cu"]' in (ROOT / "pyproject.toml").read_text()


def _doctest_modules():
    """Every port module whose source holds a docstring example (``>>>``),
    read, not imported."""
    out = []
    for path in sorted((ROOT / "metrics_tpu_torch").rglob("*.py")):
        if ">>>" in path.read_text():
            parts = path.relative_to(ROOT).with_suffix("").parts
            out.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return out


def test_doctest_walk_finds_every_family():
    found = set(_doctest_modules())
    assert {"metrics_tpu_torch.core.metric", "metrics_tpu_torch.image.fid", "metrics_tpu_torch.functional.image.ssim",
            "metrics_tpu_torch.text.bert", "metrics_tpu_torch.models.bert"} <= found
    assert len(found) >= 110


@pytest.mark.parametrize("module", _doctest_modules())
def test_docstring_examples_run(module):
    import doctest
    import importlib

    result = doctest.testmod(importlib.import_module(module))
    assert result.attempted > 0 and result.failed == 0, result


def _identity(*x):
    return x[0]


DEFAULT_DEVICE_CASES = {
    "Accuracy": lambda **kw: port.Accuracy(num_classes=10, **kw),
    "StatScores": lambda **kw: port.StatScores(reduce="macro", num_classes=10, **kw),
    "BinnedAveragePrecision": lambda **kw: port.BinnedAveragePrecision(num_classes=10, **kw),
    "Precision": lambda **kw: port.Precision(num_classes=10, average="macro", **kw),
    "Recall": lambda **kw: port.Recall(**kw),
    "FBeta": lambda **kw: port.FBeta(beta=0.5, **kw),
    "F1": lambda **kw: port.F1(**kw),
    "Specificity": lambda **kw: port.Specificity(**kw),
    "HammingDistance": lambda **kw: port.HammingDistance(**kw),
    "ConfusionMatrix": lambda **kw: port.ConfusionMatrix(10, **kw),
    "IoU": lambda **kw: port.IoU(10, **kw),
    "CohenKappa": lambda **kw: port.CohenKappa(10, **kw),
    "MatthewsCorrcoef": lambda **kw: port.MatthewsCorrcoef(10, **kw),
    "AUC": lambda **kw: port.AUC(**kw),
    "AUROC": lambda **kw: port.AUROC(num_classes=10, **kw).with_capacity(64),
    "AveragePrecision": lambda **kw: port.AveragePrecision(**kw),
    "ROC": lambda **kw: port.ROC(**kw),
    "PrecisionRecallCurve": lambda **kw: port.PrecisionRecallCurve(**kw),
    "CalibrationError": lambda **kw: port.CalibrationError(**kw),
    "KLDivergence": lambda **kw: port.KLDivergence(**kw),
    "Hinge": lambda **kw: port.Hinge(**kw),
    "AverageMeter": lambda **kw: port.AverageMeter(**kw),
    "MeanSquaredError": lambda **kw: port.MeanSquaredError(squared=False, **kw),
    "MeanAbsoluteError": lambda **kw: port.MeanAbsoluteError(**kw),
    "MeanSquaredLogError": lambda **kw: port.MeanSquaredLogError(**kw),
    "MeanAbsolutePercentageError": lambda **kw: port.MeanAbsolutePercentageError(**kw),
    "SymmetricMeanAbsolutePercentageError": lambda **kw: port.SymmetricMeanAbsolutePercentageError(**kw),
    "R2Score": lambda **kw: port.R2Score(num_outputs=3, **kw),
    "ExplainedVariance": lambda **kw: port.ExplainedVariance(**kw),
    "TweedieDevianceScore": lambda **kw: port.TweedieDevianceScore(power=2.0, **kw),
    "PearsonCorrcoef": lambda **kw: port.PearsonCorrcoef(**kw),
    "SpearmanCorrcoef": lambda **kw: port.SpearmanCorrcoef(**kw).with_capacity(64),
    "CosineSimilarity": lambda **kw: port.CosineSimilarity(reduction="mean", **kw),
    "RetrievalMAP": lambda **kw: port.RetrievalMAP(**kw),
    "RetrievalMRR": lambda **kw: port.RetrievalMRR(**kw),
    "RetrievalFallOut": lambda **kw: port.RetrievalFallOut(k=10, **kw),
    "RetrievalNormalizedDCG": lambda **kw: port.RetrievalNormalizedDCG(k=10, **kw),
    "RetrievalPrecision": lambda **kw: port.RetrievalPrecision(k=10, **kw),
    "RetrievalRecall": lambda **kw: port.RetrievalRecall(k=100, **kw),
    # members are configuration: the collection's own device counts
    "RetrievalCollection": lambda **kw: port.RetrievalCollection(
        {"map": port.RetrievalMAP(device="cpu")}, num_queries=8, **kw).with_capacity(64),
    # a composite takes its operands' device
    "CompositionalMetric": lambda **kw: port.Precision(**kw) * port.Recall(**kw) + 1.0,
    "PSNR": lambda **kw: port.PSNR(data_range=1.0, **kw),
    "SSIM": lambda **kw: port.SSIM(data_range=1.0, **kw),
    # a callable network: the built-in ones take the metric's device too
    "FID": lambda **kw: port.FID(_identity, feature_dim=8, streaming=True, **kw),
    "KID": lambda **kw: port.KID(_identity, **kw),
    "IS": lambda **kw: port.IS(_identity, **kw),
    "LPIPS": lambda **kw: port.LPIPS(net=_identity, **kw),
    "SNR": lambda **kw: port.SNR(**kw),
    "SI_SDR": lambda **kw: port.SI_SDR(**kw),
    "SI_SNR": lambda **kw: port.SI_SNR(**kw),
    "PIT": lambda **kw: port.PIT(_identity, **kw),
    "WER": lambda **kw: port.WER(**kw),
    "BLEUScore": lambda **kw: port.BLEUScore(**kw),
    "ROUGEScore": lambda **kw: port.ROUGEScore(**kw),
    # a callable model: the built-in encoder is built at compute() on the metric's device
    "BERTScore": lambda **kw: port.BERTScore(model=_identity, **kw),
    # a wrapper lives on its base metric's device
    "BootStrapper": lambda **kw: port.BootStrapper(port.MeanSquaredError(**kw), num_bootstraps=2),
    "MetricTracker": lambda **kw: port.MetricTracker(port.MeanSquaredError(**kw)),
}


def test_every_exported_metric_has_a_default_device_case():
    metrics = {name for name in port.__all__ if name[0].isupper()} - {
        "Metric", "MetricCollection", "CatBuffer", "RetrievalMetric"}
    assert metrics - {"BinnedPrecisionRecallCurve", "BinnedRecallAtFixedPrecision"} == set(DEFAULT_DEVICE_CASES)


@pytest.mark.parametrize("make", DEFAULT_DEVICE_CASES.values(), ids=DEFAULT_DEVICE_CASES.keys())
def test_default_device_is_cuda(make):
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert make(device="cpu").device == torch.device("cpu")


def test_checkpoint_functions_are_exported():
    from metrics_tpu_torch.core import checkpoint

    functions = {name for name in port.__all__ if not name[0].isupper()}
    assert functions == {"load_checkpoint", "prune_checkpoints", "save_checkpoint"}
    assert all(getattr(port, name) is getattr(checkpoint, name) for name in functions)


def test_load_checkpoint_restores_onto_the_metric_device(tmp_path):
    """The restored leaves sit on the metric's own device: the card when
    there is one, the host otherwise; a CatBuffer state with its buffer."""
    src = port.RetrievalMAP(device="cpu").with_capacity(16)
    src.update(torch.tensor([0.5, 0.2, 0.9]), torch.tensor([1, 0, 1]), indexes=torch.tensor([0, 0, 1]))
    port.save_checkpoint(src, str(tmp_path), rank=0, world=1)
    for device in (["cuda"] if torch.cuda.is_available() else []) + ["cpu"]:
        m = port.load_checkpoint(port.RetrievalMAP(device=device).with_capacity(16), str(tmp_path), rank=0, world=1)
        assert all(v.buffer.device.type == device for v in m._state.values())
        assert float(m.compute()) == float(src.compute())
        acc = port.Accuracy(device=device)
        acc.update(torch.tensor([1, 0]).to(device), torch.tensor([1, 1]).to(device))
        port.save_checkpoint(acc, str(tmp_path / device), rank=0, world=1)
        restored = port.load_checkpoint(port.Accuracy(device=device), str(tmp_path / device), rank=0, world=1)
        assert all(v.device.type == device for v in restored._state.values())


# ---- the import surface (ROADMAP C.20) --------------------------------------

#: Everything of the JAX package the port has no namesake for, each with its
#: reason (ROADMAP.md §A's no-twin list): a whole module (``"utils.checkpoint"``),
#: a public name of a module (``"models.bert::bert_apply"``) or a parameter of
#: a function or constructor (``"models.bert::config_from_params(params)"``).
#: An entry the port has since gained fails ``test_every_reference_module_*``.
NO_TWIN = {
    "integrations": "the nn.Module is the integration: flax's linen wrappers have no torch counterpart",
    "integrations.flax": "the nn.Module is the integration",
    "ops.pallas_binned": "the TPU kernel B1: the port's is csrc/binned_stats.cu behind ops/binned_stats.py",
    "utils.checkpoint": "the orbax path; state_dict is the interop path",
    "utils.compile_cache": "the XLA disk cache",
    "utils::compile_cache": "the XLA disk cache",
    "utils.device_trace": "the port measures with torch.profiler",
    "utils.data::is_traced": "no JAX tracer: its counterpart is utils/checks.py::_is_concrete (a FakeTensor or a "
                             "capture's tensor reads no value)",
    "models::inception_v3_apply": "the nn.Module is the form (InceptionV3.forward)",
    "models.inception::inception_v3_apply": "the nn.Module is the form (InceptionV3.forward)",
    "models.bert::bert_apply": "the nn.Module is the form (BertEncoder.forward)",
    "models.lpips_net::lpips_apply": "the nn.Module is the form (LPIPSNetwork.forward)",
    "models.bert::config_from_params(params)": "renamed state_dict: it reads a torch state dict in HF's layout, "
                                               "not a JAX param tree",
    "models.lpips_net::load_torch_lpips_weights(net)": "renamed model: it loads into an LPIPSNetwork in place "
                                                       "(which knows its tower), not into params built for a "
                                                       "tower name",
    "core.compiled::dispatch_program(states)": "a CUDA-graph program writes its own static state buffers: no "
                                               "states are passed for donation",
    "parallel.bucketing::SyncPlan(leaves)": "the by-name leaf map, which no caller of either package reads",
    "parallel.bucketing::host_sync_state_bucketed(plan)": "the plan comes from the schema-keyed plan store on "
                                                          "every call (build_sync_plan); no caller of either "
                                                          "package passes one",
}
SUBPACKAGES = sorted(p.parent.name for p in (ROOT / "metrics_tpu").glob("*/__init__.py")
                     if (ROOT / "metrics_tpu_torch" / p.parent.name / "__init__.py").exists())


def _reference_exports(sub):
    tree = ast.parse((ROOT / "metrics_tpu" / sub / "__init__.py").read_text())
    return sorted({a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom) for a in node.names})


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_reference_subpackage_name_imports_from_the_same_path(sub):
    import importlib

    mod = importlib.import_module(f"metrics_tpu_torch.{sub}")
    excused = [n for n in _reference_exports(sub) if f"{sub}::{n}" in NO_TWIN]
    missing = [n for n in _reference_exports(sub) if n not in excused and not hasattr(mod, n)]
    assert missing == [], f"metrics_tpu_torch.{sub} lacks {missing}"
    stale = [n for n in excused if hasattr(mod, n)]
    assert stale == [], f"{stale} are ported now: take them out of NO_TWIN"
    if sub == "utils":
        assert mod.TorchMetricsUserError is mod.MetricsTPUUserError


def test_distributed_initialize_with_retry_backs_off_on_transient_errors():
    from metrics_tpu_torch.parallel import distributed_initialize_with_retry
    from metrics_tpu_torch.utils.exceptions import SyncTimeoutError

    calls = []

    def flaky(**kw):
        calls.append(kw)
        if len(calls) < 3:
            raise RuntimeError("The server socket has failed to bind: address already in use")

    distributed_initialize_with_retry("localhost:29500", 2, 1, base_backoff_s=0.0, initialize_fn=flaky, backend="gloo")
    assert len(calls) == 3
    assert calls[-1] == {"init_method": "tcp://localhost:29500", "world_size": 2, "rank": 1, "backend": "gloo"}

    def broken(**kw):
        raise ValueError("bad rank")

    with pytest.raises(ValueError, match="bad rank"):
        distributed_initialize_with_retry("tcp://h:1", 2, 0, base_backoff_s=0.0, initialize_fn=broken)

    def refused(**kw):
        raise RuntimeError("Connection refused")

    with pytest.raises(SyncTimeoutError, match="after 3 attempts"):
        distributed_initialize_with_retry("h:1", 2, 0, max_retries=2, base_backoff_s=0.0, initialize_fn=refused)


#: Items 9.3, 10.1, 10.2 and 10.3: the names each brings, at the JAX
#: package's paths. Nothing of ``parallel`` or ``core.plan`` is queued any
#: more.
LANDED = {
    "core.plan": ("ExecutionPlan", "plan_for", "clear_plans", "plan_cache_info", "unified_plan_enabled",
                  "next_sync_epoch", "fused_step_refusal", "compiled_step", "TierSchedule", "tier_schedule_for"),
    "parallel": ("sync_in_jit", "sync_leaf_in_jit", "jit_distributed_available", "AsyncSyncRound",
                 "STALENESS_POLICIES", "drain_round", "launch_round", "resolve_round", "sync_channel"),
    "parallel.async_sync": ("SerialExecutor", "new_sync_stats", "validate_staleness_policy"),
    "core.cat_buffer": ("sync_cat_buffer_in_jit",),
    "utils.exceptions": ("StaleSyncError",),
    # 10.2: quorum, probation and the adaptive controller
    "parallel.resilience": ("Membership", "AdaptiveController", "advance_membership", "active_subset_transport",
                            "adaptive_sync_timeout", "channel_gate", "channel_is_suspect",
                            "channel_probe_succeeded", "commit_schedule_decision", "configure_probation",
                            "current_membership", "effective_world", "is_missing_rank_error",
                            "last_schedule_decisions", "live_ranks", "live_count", "mark_channel_suspect",
                            "maybe_rejoin", "membership_epoch", "negotiate_quorum", "note_sync_round",
                            "reset_channel_health", "reset_membership", "reset_resilience", "set_quorum_transport",
                            "FLAP_WINDOW_ROUNDS", "DEFAULT_PROBATION_COOLDOWN_S"),
    # 10.3: the tiers and the quantized slow hop
    "parallel.tiering": ("TIER_SIZE_ENV", "TierTopology", "active_tier_transport", "active_topology",
                         "expected_tier_column", "my_tier_id", "reset_tiering", "set_tier_map", "set_tier_transport",
                         "tier_of_rank", "tier_topology", "tiering_configured"),
    "parallel.quantize": ("BLOCK", "PRECISION_CODES", "SYNC_PRECISIONS", "decode", "encode", "encoded_size",
                          "kahan_sum", "precision_code", "validate_sync_precision"),
}


def _reference_module_names(path):
    """The top-level names ``metrics_tpu/<path>.py`` defines (read, not imported)."""
    tree = ast.parse((ROOT / "metrics_tpu" / (path.replace(".", "/") + ".py")).read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return names


def _reference_init_args(path, cls):
    tree = ast.parse((ROOT / "metrics_tpu" / path).read_text())
    node = next(n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == cls)
    init = next(n for n in node.body if isinstance(n, ast.FunctionDef) and n.name == "__init__")
    extra = [init.args.vararg.arg] if init.args.vararg else []
    return {a.arg for a in init.args.args + init.args.kwonlyargs} - {"self"} | set(extra)


@pytest.mark.parametrize("path", sorted(LANDED))
def test_items_9_3_and_10_1_export_at_the_reference_paths(path):
    import importlib

    mod = importlib.import_module(f"metrics_tpu_torch.{path}")
    if path == "parallel":
        ref_names = set(_reference_exports("parallel"))
    else:
        ref_names = _reference_module_names(path)
    for name in LANDED[path]:
        assert name in ref_names, f"metrics_tpu.{path} has no {name}"
        assert hasattr(mod, name), f"metrics_tpu_torch.{path} lacks {name}"
    if path.startswith("parallel.") or path == "core.plan":
        # a module of the sync stack exports every public name its JAX twin defines
        missing = sorted(n for n in ref_names if not n.startswith("_") and not hasattr(mod, n)
                         and n not in ("annotations",))
        assert missing == [], f"metrics_tpu_torch.{path} lacks {missing}"


def test_constructor_arguments_match_the_reference():
    """``Metric`` and ``MetricCollection`` take the JAX package's arguments,
    ``sync_mode``, ``staleness_policy`` and ``sync_precision`` included;
    ``device`` is the port's own."""
    import inspect

    from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

    for cls, path in (("Metric", "core/metric.py"), ("MetricCollection", "core/collections.py")):
        mine = set(inspect.signature(getattr(port, cls).__init__).parameters) - {"self", "args", "kwargs"}
        theirs = _reference_init_args(path, cls) - {"args", "kwargs"}
        assert theirs - mine == set(), cls
        assert mine - theirs == ({"device"} if cls == "Metric" else set()), cls
    mc = port.MetricCollection({"a": port.Accuracy(device="cpu")}, sync_mode="overlap", staleness_policy="merge")
    assert (mc.sync_mode, mc.staleness_policy) == ("overlap", "merge")
    with pytest.raises(MetricsTPUUserError, match="sync_mode"):
        port.MetricCollection({"a": port.Accuracy(device="cpu")}, sync_mode="lazy")
    with pytest.raises(MetricsTPUUserError, match="staleness_policy"):
        port.MetricCollection({"a": port.Accuracy(device="cpu")}, staleness_policy="stale")
    mc = port.MetricCollection({"a": port.Accuracy(device="cpu")}, sync_precision="int8")
    assert mc.sync_precision == "int8"
    with pytest.raises(MetricsTPUUserError, match="sync_precision"):
        port.MetricCollection({"a": port.Accuracy(device="cpu")}, sync_precision="fp8")


def _reference_top_level():
    import metrics_tpu

    return sorted(metrics_tpu.__all__)


def _parameters(obj):
    import inspect

    fn = obj.__init__ if inspect.isclass(obj) else obj
    return [(p.name, p.kind) for p in inspect.signature(fn).parameters.values() if p.name not in ("self", "device")]


@pytest.mark.parametrize("name", _reference_top_level())
def test_top_level_export_takes_the_reference_parameters(name):
    """Every class and function ``metrics_tpu`` exports takes the JAX
    package's parameters, by name, kind and order; ``device`` is the
    port's own (BERTScore has it in both)."""
    import metrics_tpu

    assert _parameters(getattr(port, name)) == _parameters(getattr(metrics_tpu, name)), name


# ---- every module of the JAX package ----------------------------------------

def _reference_modules():
    """``(dotted path under the package, source file)`` of every module of
    ``metrics_tpu``, read, not imported (``pkgutil.walk_packages`` would not
    enter ``ops/``, a namespace package without an ``__init__``)."""
    out = []
    for path in sorted((ROOT / "metrics_tpu").rglob("*.py")):
        parts = path.relative_to(ROOT / "metrics_tpu").with_suffix("").parts
        out.append((".".join(parts[:-1] if parts[-1] == "__init__" else parts), path))
    return out


REFERENCE_MODULES = _reference_modules()


def _public_api(path):
    """``{name: parameter names or None}`` of a JAX module, read with ``ast``:
    its ``__all__`` if it has one, else every top-level definition without a
    leading underscore, and in a package's ``__init__`` what it imports too.
    A function's parameters, or a class's ``__init__``'s, ``self`` aside."""
    tree = ast.parse(path.read_text())
    found, listed = {}, None

    def params(fn):
        a = fn.args
        return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs + [a.vararg, a.kwarg] if x is not None
                and x.arg not in ("self", "cls")]

    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            found[node.name] = params(node)
        elif isinstance(node, ast.ClassDef):
            init = next((n for n in node.body if isinstance(n, ast.FunctionDef) and n.name == "__init__"), None)
            found[node.name] = params(init) if init else None
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for target in node.targets if isinstance(node, ast.Assign) else [node.target]:
                if isinstance(target, ast.Name):
                    found[target.id] = None
                    if target.id == "__all__":
                        listed = [ast.literal_eval(e) for e in node.value.elts]
        elif isinstance(node, ast.ImportFrom) and path.name == "__init__.py":
            found.update({a.asname or a.name: None for a in node.names})
    names = listed if listed is not None else [n for n in found if not n.startswith("_")]
    return {n: found.get(n) for n in names}


def _port_parameters(obj):
    import inspect

    return set(inspect.signature(obj.__init__ if inspect.isclass(obj) else obj).parameters)


@pytest.mark.parametrize("module,path", REFERENCE_MODULES, ids=[m or "metrics_tpu" for m, _ in REFERENCE_MODULES])
def test_every_reference_module_has_its_names_in_the_port(module, path):
    """Every public name of every JAX module has a namesake in the port's
    module of the same path, taking every JAX parameter name; ``NO_TWIN``
    excuses the rest, each with its reason, and fails when the port has
    gained what it excuses."""
    import importlib

    port_name = "metrics_tpu_torch" + (f".{module}" if module else "")
    if module in NO_TWIN:
        twin = ROOT / "metrics_tpu_torch" / module.replace(".", "/")
        assert not (twin.is_dir() or twin.with_suffix(".py").exists()), \
            f"{port_name} exists now: take it out of NO_TWIN"
        return
    mod = importlib.import_module(port_name)
    missing, stale = [], []
    for name, params in _public_api(path).items():
        excused = f"{module}::{name}" in NO_TWIN
        if not hasattr(mod, name):
            missing += [] if excused else [name]
            continue
        stale += [name] if excused else []
        if params is None or not callable(getattr(mod, name)):
            continue
        mine = _port_parameters(getattr(mod, name))
        for p in params:
            key = f"{module}::{name}({p})"
            if p not in mine and key not in NO_TWIN:
                missing.append(f"{name}({p})")
            elif p in mine and key in NO_TWIN:
                stale.append(key)
    assert missing == [], f"{port_name} lacks {missing}"
    assert stale == [], f"{stale} are ported now: take them out of NO_TWIN"


def test_no_twin_entries_name_reference_modules():
    modules = {m for m, _ in REFERENCE_MODULES}
    assert {key.split("::")[0] for key in NO_TWIN} <= modules
    assert len(modules) >= 160 and {"core.compiled", "utils.data", "ops.pallas_binned"} <= modules
