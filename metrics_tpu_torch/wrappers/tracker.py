"""MetricTracker: one metric tracked across steps or epochs.

Counterpart of ``metrics_tpu/wrappers/tracker.py``: a list of clones of the
base metric, one per ``increment()``, with the best value and its step.
"""
from copy import deepcopy
from typing import Any, Tuple, Union

import torch

from metrics_tpu_torch.core.metric import Metric


class MetricTracker(list):
    """Keeps one clone of the base metric per ``increment()``; ``forward``,
    ``update``, ``compute`` and ``reset`` act on the newest. It lives on its
    base metric's device.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy, MetricTracker
        >>> tracker = MetricTracker(Accuracy(num_classes=3, device="cpu"))
        >>> for preds in ([0, 2, 1], [0, 1, 1]):
        ...     tracker.increment()
        ...     _ = tracker(torch.tensor(preds), torch.tensor([0, 1, 1]))
        >>> best, step = tracker.best_metric(return_step=True)
        >>> round(best, 4), step
        (1.0, 1)
    """

    def __init__(self, metric: Metric, maximize: bool = True) -> None:
        super().__init__()
        if not isinstance(metric, Metric):
            raise TypeError(f"metric arg need to be an instance of a metrics_tpu_torch metric but got {metric}")
        self._base_metric = metric
        self.maximize = maximize
        self._increment_called = False

    @property
    def device(self) -> torch.device:
        """The base metric's device."""
        return self._base_metric.device

    @property
    def n_steps(self) -> int:
        return len(self)

    def increment(self) -> None:
        """Start tracking a fresh clone of the base metric."""
        self._increment_called = True
        self.append(deepcopy(self._base_metric))

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        self._check_for_increment("forward")
        return self[-1](*args, **kwargs)

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.forward(*args, **kwargs)

    def update(self, *args: Any, **kwargs: Any) -> None:
        self._check_for_increment("update")
        self[-1].update(*args, **kwargs)

    def compute(self) -> Any:
        self._check_for_increment("compute")
        return self[-1].compute()

    def compute_all(self) -> torch.Tensor:
        self._check_for_increment("compute_all")
        return torch.stack([metric.compute() for metric in self], dim=0)

    def reset(self) -> None:
        self[-1].reset()

    def reset_all(self) -> None:
        for metric in self:
            metric.reset()

    def best_metric(self, return_step: bool = False) -> Union[float, Tuple[float, int]]:
        """The best tracked value, and with ``return_step`` the step that
        gave it: ``(best, step)``, the JAX package's order."""
        vals = self.compute_all()
        idx = int(torch.argmax(vals) if self.maximize else torch.argmin(vals))
        best = float(vals[idx])
        if return_step:
            return best, idx
        return best

    def _check_for_increment(self, method: str) -> None:
        if not self._increment_called:
            raise ValueError(f"`{method}` cannot be called before `.increment()` has been called")
