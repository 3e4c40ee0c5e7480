"""``MetricCollection``: several metrics fed by one ``update``/``forward`` call.

Counterpart of the base of ``metrics_tpu/core/collections.py``: a dict of
metrics (sorted by key when built from a dict), prefix/postfix on the output
keys, keyword filtering by each member's ``update`` signature, and
update/forward/compute/reset/clone/state_dict. Compute groups, the fused
collection sync and overlapped sync are not ported yet; each member syncs
itself in its own ``compute()``.

It is a ``torch.nn.ModuleDict``, as upstream TorchMetrics' is, so ``.to()``
moves every member.
"""
from copy import deepcopy
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple, Union

from torch import nn

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.utils.exceptions import StateDictMismatchError


class MetricCollection(nn.ModuleDict):
    """An ordered dict of metrics sharing a single ``update``/``forward``
    call — pass the superset of inputs once and each member picks the
    keyword arguments its ``update`` accepts.

    Args:
        metrics: one Metric, a list/tuple of Metrics, or a dict name->Metric.
        prefix / postfix: added to every key in the output dict.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy, MetricCollection, StatScores
        >>> mc = MetricCollection({"acc": Accuracy(num_classes=3, device="cpu"),
        ...                        "stats": StatScores(reduce="micro", num_classes=3, device="cpu")})
        >>> vals = mc(torch.tensor([0, 2, 1]), torch.tensor([0, 1, 1]))
        >>> round(float(vals["acc"]), 4), vals["stats"].tolist()
        (0.6667, [2, 1, 5, 1, 3])
    """

    def __init__(
        self,
        metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]],
        *additional_metrics: Metric,
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
    ) -> None:
        super().__init__()
        self.prefix = self._check_arg(prefix, "prefix")
        self.postfix = self._check_arg(postfix, "postfix")
        self.add_metrics(metrics, *additional_metrics)

    @staticmethod
    def _check_arg(arg: Optional[str], name: str) -> Optional[str]:
        if arg is None or isinstance(arg, str):
            return arg
        raise ValueError(f"Expected input `{name}` to be a string, but got {type(arg)}")

    def add_metrics(
        self,
        metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]],
        *additional_metrics: Metric,
    ) -> None:
        if isinstance(metrics, Metric):
            metrics = [metrics]
        if isinstance(metrics, Sequence):
            metrics = list(metrics)
            remain: list = []
            for m in additional_metrics:
                (metrics if isinstance(m, Metric) else remain).append(m)
            if remain:
                raise ValueError(
                    f"You have passes extra arguments {remain} which are not `Metric` so they will be ignored."
                )
        elif additional_metrics:
            raise ValueError(
                f"You have passes extra arguments {additional_metrics} which are not compatible"
                f" with first passed dictionary {metrics} so they will be ignored."
            )

        if isinstance(metrics, dict):
            for name in sorted(metrics.keys()):
                metric = metrics[name]
                if not isinstance(metric, (Metric, MetricCollection)):
                    raise ValueError(
                        f"Value {metric} belonging to key {name} is not an instance of `Metric` or `MetricCollection`"
                    )
                if isinstance(metric, Metric):
                    self[name] = metric
                else:
                    for k, v in metric.items(keep_base=False):
                        self[f"{name}_{k}"] = v
        elif isinstance(metrics, Sequence):
            for metric in metrics:
                if not isinstance(metric, (Metric, MetricCollection)):
                    raise ValueError(
                        f"Input {metric} to `MetricCollection` is not a instance of `Metric` or `MetricCollection`"
                    )
                if isinstance(metric, Metric):
                    name = type(metric).__name__
                    if name in self:
                        raise ValueError(f"Encountered two metrics both named {name}")
                    self[name] = metric
                else:
                    for k, v in metric.items(keep_base=False):
                        self[k] = v
        else:
            raise ValueError("Unknown input to MetricCollection.")

    def _set_name(self, base: str) -> str:
        name = base if self.prefix is None else self.prefix + base
        return name if self.postfix is None else name + self.postfix

    def items(self, keep_base: bool = True) -> Iterable[Tuple[str, Metric]]:  # type: ignore[override]
        """Default keeps base keys; pass ``keep_base=False`` for the
        prefixed/postfixed view."""
        if keep_base:
            return super().items()
        return [(self._set_name(k), v) for k, v in super().items()]

    def keys(self, keep_base: bool = True) -> Iterable[str]:  # type: ignore[override]
        if keep_base:
            return super().keys()
        return [self._set_name(k) for k in super().keys()]

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Each member's ``forward``: accumulate, and return the batch values."""
        return {self._set_name(k): m(*args, **m._filtered_kwargs(kwargs)) for k, m in super().items()}

    def update(self, *args: Any, **kwargs: Any) -> None:
        for m in self.values():
            m.update(*args, **m._filtered_kwargs(kwargs))

    def compute(self) -> Dict[str, Any]:
        """Every member's value (each member syncs itself first)."""
        return {self._set_name(k): m.compute() for k, m in super().items()}

    def reset(self) -> None:
        for m in self.values():
            m.reset()

    def clone(self, prefix: Optional[str] = None, postfix: Optional[str] = None) -> "MetricCollection":
        """Deep copy, optionally with a new prefix/postfix."""
        mc = deepcopy(self)
        if prefix:
            mc.prefix = self._check_arg(prefix, "prefix")
        if postfix:
            mc.postfix = self._check_arg(postfix, "postfix")
        return mc

    def persistent(self, mode: bool = True) -> None:
        for m in self.values():
            m.persistent(mode)

    def load_state_dict(self, state_dict: Dict[str, Any], strict: bool = False) -> None:  # type: ignore[override]
        """Per-member load of a ``state_dict()`` snapshot (keys ``"<member>.<state>"``).

        With ``strict=True`` the snapshot must cover every member's every
        declared state and carry no other key, or a
        :class:`StateDictMismatchError` is raised before any member changes.
        """
        if strict:
            declared = {f"{k}.{name}" for k, m in super().items() for name in m._defaults}
            missing = sorted(declared - set(state_dict))
            unexpected = sorted(set(state_dict) - declared)
            if missing or unexpected:
                raise StateDictMismatchError(
                    "load_state_dict(strict=True) for MetricCollection: "
                    f"missing keys {missing}, unexpected keys {unexpected}. "
                    "Nothing was loaded."
                )
        for k, m in super().items():
            m.load_state_dict(state_dict, prefix=f"{k}.")
