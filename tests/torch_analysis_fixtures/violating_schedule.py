"""metricslint fixture (torch twin, line for line): collective-schedule violations —
every way a rank can end up emitting a different collective sequence.

The CI gate asserts the CLI exits NONZERO on this file. The collective and
helper names mirror ``parallel/sync.py``'s conventions (that is what the
pass keys on); the stubs keep the module import-safe.
"""
import torch
import torch.distributed as dist


def _gather(x, group=None, timeout=None):  # stand-in collective
    return [torch.as_tensor(x)]


def state_has_nonfinite(state):  # stand-in local-data predicate
    return False


def rank_zero_extra_gather(x, state):
    """finding: rank-dependent-collective — only rank 0 emits the gather."""
    if dist.get_rank() == 0:
        return _gather(x)
    return x


def data_dependent_gather(state, x):
    """finding: data-dependent-collective — ranks with empty local state
    skip the collective their peers emit."""
    if len(state) > 0:
        return _gather(x)
    return x


def early_exit_desync(state, x):
    """finding: data-dependent-collective — a local-data raise ahead of the
    gather means a poisoned rank leaves its peers hanging in the gather."""
    if state_has_nonfinite(state):
        raise RuntimeError("poisoned")
    return _gather(x)


def collective_in_handler(x):
    """finding: collective-in-handler — a locally-caught failure is not a
    symmetric event; the retry gather pairs with nothing on healthy ranks."""
    try:
        return _gather(x)
    except Exception:
        return _gather(torch.zeros_like(x))


def set_iteration_order(state):
    """finding: nondeterministic-collective-order — set iteration order
    differs across processes, so the gather sequence does too."""
    out = {}
    for name in set(state):
        out[name] = _gather(state[name])
    return out


def transitive_rank_dependence(x, flag):
    """finding: rank-dependent-collective — the collective hides one call
    away, behind a rank-dependent branch."""
    if dist.get_rank() > 0:
        return _emitting_helper(x)
    return x


def _emitting_helper(x):
    return _gather(x)


def clean_symmetric_paths(state, x, world):
    """No findings: unconditional gathers, branches only on symmetric data
    (the gathered result, world size, schema)."""
    counts = torch.stack(_gather(torch.tensor(len(state))))
    if bool((counts == 0).any()):
        raise RuntimeError("symmetric failure on every rank")
    if world == 1:
        return x
    if x.ndim == 0:
        x = x[None]
    return _gather(x)
