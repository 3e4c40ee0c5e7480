"""PearsonCorrcoef module metric.

Counterpart of ``metrics_tpu/regression/pearson.py``. The six states are
each process's running moments with ``dist_reduce_fx=None``: a sync gathers
each 0-d state to ``[W]``, and ``compute()`` folds the ``W`` entries with
the pairwise moment merge (:func:`_final_aggregation`). The same merge is
this metric's ``merge_states``, which ``forward`` and ``merge_state`` use.
The count ``n_total`` is a float32 state, as in the JAX package.
"""
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.regression.pearson import _pearson_corrcoef_compute, _pearson_corrcoef_update

_MOMENTS = ("mean_x", "mean_y", "var_x", "var_y", "corr_xy", "n_total")


def _merge_two(
    mx1: torch.Tensor, my1: torch.Tensor, vx1: torch.Tensor, vy1: torch.Tensor, cxy1: torch.Tensor, n1: torch.Tensor,
    mx2: torch.Tensor, my2: torch.Tensor, vx2: torch.Tensor, vy2: torch.Tensor, cxy2: torch.Tensor, n2: torch.Tensor,
) -> Tuple[torch.Tensor, ...]:
    """Pairwise merge of two running-moment states."""
    nb = n1 + n2
    mean_x = (n1 * mx1 + n2 * mx2) / nb
    mean_y = (n1 * my1 + n2 * my2) / nb
    var_x = vx1 + vx2 + n1 * (mx1 - mean_x) ** 2 + n2 * (mx2 - mean_x) ** 2
    var_y = vy1 + vy2 + n1 * (my1 - mean_y) ** 2 + n2 * (my2 - mean_y) ** 2
    corr_xy = (
        cxy1 + n1 * (mx1 - mean_x) * (my1 - mean_y)
        + cxy2 + n2 * (mx2 - mean_x) * (my2 - mean_y)
    )
    return mean_x, mean_y, var_x, var_y, corr_xy, nb


def _final_aggregation(
    means_x: torch.Tensor,
    means_y: torch.Tensor,
    vars_x: torch.Tensor,
    vars_y: torch.Tensor,
    corrs_xy: torch.Tensor,
    nbs: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fold the gathered ``[W]`` moment vectors into global statistics, in
    rank order (the loop runs over the gathered length, known on the host)."""
    mx1, my1, vx1, vy1, cxy1, n1 = means_x[0], means_y[0], vars_x[0], vars_y[0], corrs_xy[0], nbs[0]
    for i in range(1, means_x.shape[0]):
        mx1, my1, vx1, vy1, cxy1, n1 = _merge_two(
            mx1, my1, vx1, vy1, cxy1, n1,
            means_x[i], means_y[i], vars_x[i], vars_y[i], corrs_xy[i], nbs[i],
        )
    return vx1, vy1, cxy1, n1


class PearsonCorrcoef(Metric):
    r"""Pearson correlation coefficient between a prediction and a target
    stream: linear association in [-1, 1].

    The state is five running moments and the count, merged pairwise
    across processes, batches and resumes. Expects 1-D inputs of one shape.

    Args:
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
            device: see :class:`~metrics_tpu_torch.Metric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import PearsonCorrcoef
        >>> pearson = PearsonCorrcoef(device="cpu")
        >>> round(float(pearson(torch.tensor([2.0, 2.0, 2.0, 2.0, 6.0]), torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0]))), 4)
        0.7071
    """

    is_differentiable = True

    def __init__(
        self,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        super().__init__(
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=device,
        )
        for name in _MOMENTS:
            self.add_state(name, torch.tensor(0.0), dist_reduce_fx=None)

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:  # type: ignore[override]
        self.mean_x, self.mean_y, self.var_x, self.var_y, self.corr_xy, self.n_total = _pearson_corrcoef_update(
            preds, target, self.mean_x, self.mean_y, self.var_x, self.var_y, self.corr_xy, self.n_total
        )

    def merge_states(self, a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
        """The pairwise merge, with an empty side (a count of 0) selected
        away on the device: no host read. A merge of two empty sides feeds
        the formula a dummy count of 1, so that no 0/0 arises in the branch
        the select drops."""
        n_a = torch.sum(torch.atleast_1d(a["n_total"]))
        n_b = torch.sum(torch.atleast_1d(b["n_total"]))
        a_empty, b_empty = n_a == 0, n_b == 0
        n2 = torch.where(a_empty & b_empty, torch.ones_like(b["n_total"]), b["n_total"])
        mx, my, vx, vy, cxy, n = _merge_two(
            a["mean_x"], a["mean_y"], a["var_x"], a["var_y"], a["corr_xy"], a["n_total"],
            b["mean_x"], b["mean_y"], b["var_x"], b["var_y"], b["corr_xy"], n2,
        )
        merged = {"mean_x": mx, "mean_y": my, "var_x": vx, "var_y": vy, "corr_xy": cxy, "n_total": n}
        return {k: torch.where(b_empty, a[k], torch.where(a_empty, b[k], merged[k])) for k in merged}

    def compute(self) -> torch.Tensor:
        if self.mean_x.ndim > 0 and self.mean_x.shape[0] > 1:
            # the gathered [W] states of a sync: fold them with the pairwise merge
            var_x, var_y, corr_xy, n_total = _final_aggregation(
                self.mean_x, self.mean_y, self.var_x, self.var_y, self.corr_xy, self.n_total
            )
        else:
            var_x, var_y, corr_xy, n_total = self.var_x, self.var_y, self.corr_xy, self.n_total
        return _pearson_corrcoef_compute(var_x, var_y, corr_xy, n_total)
