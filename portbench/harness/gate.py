"""The check that decides ``correct``: what the timed window produced,
against the plain reference over the same inputs.

Two numbers, each against its limit:

- ``state_cells_off``: entries of the members' accumulated states (the
  confusion matrices, tp/fp/tn/fn, Hamming's counts) after the window's last
  pass, as the compiled replays left them, that differ from the reference's
  counts of the pass. Counts are exact: the limit is 0.
- ``value_err``: the largest gap between a member's value at a pass-end read
  (a seeded sample of the window's reads, and its last) and the reference's
  float64 value over the pass, as a share of the value where
  that is above 1 (a raw confusion matrix holds counts) and absolute below.
  Its limit is the configuration's ``limits.value_err``, set from the
  program's and the control's readings (``PERF.md``).

The control is the reference put in the program's place and computed in
bfloat16, the precision below the configuration's float32.
"""
from typing import Dict, List, Tuple

import torch

from harness.spec import Cell, load_module

Reads = List[Tuple[int, Dict[str, torch.Tensor]]]


def expected(cell: Cell, inputs, dtype) -> Tuple[dict, dict]:
    """The reference's states and values of one pass over ``inputs``."""
    ref = load_module("reference", cell.config["reference"])
    confmat = ref.pass_confmat(inputs.steps, int(cell.config["classes"]), dtype)
    members = cell.config["collection"]["members"]
    return ({k: ref.member_state(s, confmat) for k, s in members.items()},
            {k: ref.member_value(s, confmat, dtype) for k, s in members.items()})


def state_cells_off(states: dict, want: dict) -> int:
    off = 0
    for key, named in want.items():
        for name, w in named.items():
            got = states.get(key, {}).get(name)
            w = torch.as_tensor(w).cpu().double()
            if got is None or torch.as_tensor(got).shape != w.shape:
                off += max(w.numel(), 1)
            else:
                off += int((torch.as_tensor(got).cpu().double() != w).sum())
    return off


def value_err(got, want: torch.Tensor) -> float:
    """Largest |got - want| / max(1, |want|); NaN where one side is and the
    other is not is infinitely far, NaN on both sides is equal."""
    g, w = torch.as_tensor(got).cpu().double(), want.cpu().double()
    if g.shape != w.shape:
        return float("inf")
    both = torch.isnan(g) & torch.isnan(w)
    d = ((g - w).abs() / w.abs().clamp(min=1.0)).masked_fill(both, 0.0).nan_to_num(nan=float("inf"))
    return float(d.max()) if d.numel() else 0.0


def judge(states: dict, reads: Reads, want_states: dict, want_values: dict, limit: float) -> dict:
    errs = [max(value_err(vals.get(k, torch.tensor(float("nan"))), w) for k, w in want_values.items())
            for _, vals in reads]
    worst = max(errs) if errs else float("inf")
    off = state_cells_off(states, want_states)
    failed = sum(1 for e in errs if not e <= limit) + (1 if off else 0)
    return {"failed": failed, "correct": bool(reads) and failed == 0,
            "checks": {"state_cells_off": {"value": off, "limit": 0},
                       "value_err": {"value": worst, "limit": limit}}}


def check(cell: Cell, inputs, states: dict, reads: Reads, control: bool = False) -> dict:
    """The program's verdict; with ``control``, also the control's readings
    on the same inputs (``control_checks``)."""
    limit = float(cell.config["limits"]["value_err"])
    want_states, want_values = expected(cell, inputs, torch.float64)
    out = judge(states, reads, want_states, want_values, limit)
    if control:
        c_states, c_values = expected(cell, inputs, torch.bfloat16)
        out["control_checks"] = judge(c_states, [(0, c_values)], want_states, want_values, limit)["checks"]
    return out
