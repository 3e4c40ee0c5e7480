"""RetrievalMetric base: stateful accumulation grouped by query id.

Counterpart of ``metrics_tpu/retrieval/retrieval_metric.py``. ``compute``
sorts all rows by (query, score desc) once and scores every query at once
with segment reductions (``ops/segment.py``); subclasses implement
``_segment_metric`` (per-query scores ``[G]``) and inherit the empty-query
policy.

Two ``compute`` paths, as in the JAX package: list states read the group
count from the data; CatBuffer states (``with_capacity``) with a
``num_queries`` bound group the whole buffer in padded mode, the unfilled
rows routed outside every group. Both give the same bits when the bound
equals the number of queries.
"""
from abc import ABC, abstractmethod
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.core.cat_buffer import CatBuffer
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.ops.segment import GroupedByQuery, group_by_query, segment_sum
from metrics_tpu_torch.utils.checks import _check_retrieval_inputs
from metrics_tpu_torch.utils.data import dim_zero_cat

_EMPTY_TARGET_ACTIONS = ("error", "skip", "neg", "pos")


def _check_num_queries(num_queries: Optional[int], actions: Any) -> None:
    if num_queries is not None and "error" in actions:
        raise ValueError(
            "`empty_target_action='error'` needs a host-side check and is "
            "incompatible with the jittable `num_queries` mode."
        )


def _grouped_state(metric: Metric, num_queries: Optional[int]) -> Optional[GroupedByQuery]:
    """One grouping of a retrieval state (``indexes``, ``preds``,
    ``target``), or ``None`` when it holds no rows."""
    preds = metric.preds
    if isinstance(preds, CatBuffer) and num_queries is not None:
        if preds.buffer is None:
            return None
        return group_by_query(
            metric.indexes.buffer, preds.buffer, metric.target.buffer, num_groups=num_queries, valid=preds.mask()
        )
    if not len(preds):
        return None
    indexes, preds, target = (dim_zero_cat(v) for v in (metric.indexes, metric.preds, metric.target))
    return group_by_query(indexes, preds, target, num_groups=num_queries)


class RetrievalMetric(Metric, ABC):
    """Base for all retrieval metrics: accumulate ``(indexes, preds,
    target)`` rows, group rows by query id at compute, score each query
    with the subclass's ``_segment_metric``, and average over queries.

    Args:
        empty_target_action: what a query with no relevant rows (no
            positives; :class:`~metrics_tpu_torch.RetrievalFallOut` inverts
            this to "no negatives") contributes — ``"neg"`` scores it 0,
            ``"pos"`` scores it 1, ``"skip"`` drops it from the mean,
            ``"error"`` raises.
        num_queries: upper bound on DISTINCT query ids. With CatBuffer
            states (``with_capacity``) ``compute`` groups the whole buffer
            with padding; empty groups are masked out of the mean.
            Incompatible with ``empty_target_action="error"``, as in the JAX
            package.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
            device: see :class:`~metrics_tpu_torch.Metric`.

    ``update(preds, target, indexes=...)`` appends the three aligned
    tensors to list states (``dist_reduce_fx=None``: a sync gathers every
    rank's rows), so every rank scores the global query set at compute.

    Raises:
        ValueError: missing ``indexes``, mismatched shapes, non-binary
            targets (where required), or an unknown
            ``empty_target_action``.
    """

    higher_is_better = True
    allow_non_binary_target = False
    # which rows make a query "empty" for the policy: positives (default) or
    # negatives (FallOut inverts this)
    empty_on_negatives = False

    def __init__(
        self,
        empty_target_action: str = "neg",
        num_queries: Optional[int] = None,
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
        if empty_target_action not in _EMPTY_TARGET_ACTIONS:
            raise ValueError(f"Argument `empty_target_action` received a wrong value `{empty_target_action}`.")
        self.empty_target_action = empty_target_action
        _check_num_queries(num_queries, (empty_target_action,))
        self.num_queries = num_queries

        self.add_state("indexes", default=[], dist_reduce_fx=None)
        self.add_state("preds", default=[], dist_reduce_fx=None)
        self.add_state("target", default=[], dist_reduce_fx=None)

    def update(self, preds: torch.Tensor, target: torch.Tensor, indexes: torch.Tensor) -> None:  # type: ignore[override]
        if indexes is None:
            raise ValueError("Argument `indexes` cannot be None")
        indexes, preds, target = _check_retrieval_inputs(
            indexes, preds, target, allow_non_binary_target=self.allow_non_binary_target
        )
        self.indexes.append(indexes)
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> torch.Tensor:
        g = _grouped_state(self, self.num_queries)
        if g is None:
            return torch.tensor(0.0, device=self.device)
        value = self._reduce_scores(g, self._segment_metric(g))
        return self.preds.poison(value) if isinstance(self.preds, CatBuffer) else value

    def _reduce_scores(self, g: GroupedByQuery, scores: torch.Tensor) -> torch.Tensor:
        """Fold per-query ``scores`` [G] into the final mean under this
        metric's empty-query policy. Shared by :meth:`compute` and
        :class:`~metrics_tpu_torch.RetrievalCollection` (which scores many
        metrics off one grouping)."""
        relevant = g.target > 0
        empty = segment_sum(~relevant if self.empty_on_negatives else relevant, g) == 0
        # with a `num_queries` bound, group ids beyond the data are empty
        # padding segments: mask them out of every reduction
        present = g.group_sizes > 0

        if self.empty_target_action == "error":
            if bool(torch.any(empty & present)):
                kind = "negative" if self.empty_on_negatives else "positive"
                raise ValueError(f"`compute` method was provided with a query with no {kind} target.")
            return scores.mean()
        if self.empty_target_action == "skip":
            valid = ~empty & present
            n_valid = valid.sum()
            mean = torch.where(valid, scores, 0.0).sum() / n_valid.clamp(min=1)
            return torch.where(n_valid == 0, 0.0, mean)
        fill = 1.0 if self.empty_target_action == "pos" else 0.0
        n_present = present.sum().clamp(min=1)
        return torch.where(present, torch.where(empty, fill, scores), 0.0).sum() / n_present

    @abstractmethod
    def _segment_metric(self, g: GroupedByQuery) -> torch.Tensor:
        """Vectorized per-query scores ``[num_groups]`` over sorted segments."""
