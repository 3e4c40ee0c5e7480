"""RetrievalCollection: many retrieval metrics, one sort.

Counterpart of ``metrics_tpu/retrieval/collection.py``. Every retrieval
metric's ``compute`` starts with the same expensive step, a sort of all
rows by (query id, -score) plus segment metadata
(``ops/segment.py::group_by_query``). This collection accumulates one copy
of ``(indexes, preds, target)`` and scores every member off one grouping:
N metrics cost one sort and N sets of segment reductions.
"""
from typing import Any, Callable, Dict, Optional, Sequence, Union

import torch

from metrics_tpu_torch.core.cat_buffer import CatBuffer
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.retrieval.retrieval_metric import RetrievalMetric, _check_num_queries, _grouped_state
from metrics_tpu_torch.utils.checks import _check_retrieval_inputs


class RetrievalCollection(Metric):
    """A named collection of retrieval metrics sharing accumulated rows and
    a single query-grouping sort at compute.

    Each member keeps its own configuration (``k``, ``empty_target_action``,
    FallOut's inverted empty policy, nDCG's non-binary targets); only the
    row storage and the sort are shared. Members are used as CONFIG: rows
    given to ``collection.update`` live in the collection only, and member
    instances are never updated, reset or moved by the collection. Input
    validation uses the strictest member's rule (binary targets unless EVERY
    member accepts non-binary).

    Args:
        metrics: dict name -> :class:`RetrievalMetric`, or a list/tuple
            (named by lower-cased class name).
        num_queries: upper bound on distinct query ids for the padded
            CatBuffer path (see :class:`RetrievalMetric`). When omitted, the
            largest ``num_queries`` any member declares is inherited.
            Incompatible with any member using ``empty_target_action="error"``.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
            device: see :class:`~metrics_tpu_torch.Metric`.

    :meth:`compute` returns a dict name -> value.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalCollection, RetrievalMAP, RetrievalMRR
        >>> rc = RetrievalCollection({"map": RetrievalMAP(device="cpu"), "mrr": RetrievalMRR(device="cpu")},
        ...                          device="cpu")
        >>> rc.update(torch.tensor([0.9, 0.2, 0.6, 0.4]), torch.tensor([1, 0, 1, 0]),
        ...           indexes=torch.tensor([0, 0, 1, 1]))
        >>> out = rc.compute()
        >>> print({k: round(float(v), 4) for k, v in sorted(out.items())})
        {'map': 1.0, 'mrr': 1.0}
    """

    def __init__(
        self,
        metrics: Union[Dict[str, RetrievalMetric], Sequence[RetrievalMetric]],
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
        if isinstance(metrics, dict):
            items = list(metrics.items())
        else:
            items = [(type(m).__name__.lower(), m) for m in metrics]
            if len({n for n, _ in items}) != len(items):
                raise ValueError(
                    "Two members share a class name — pass a dict of name -> metric instead."
                )
        for name, m in items:
            if not isinstance(m, RetrievalMetric):
                raise ValueError(
                    f"RetrievalCollection members must be RetrievalMetric instances, got {name}={m!r}"
                )
        # a plain dict, not submodules: members are configuration, and the
        # collection's moves, casts and state_dict leave them alone
        self.metrics: Dict[str, RetrievalMetric] = dict(items)
        if num_queries is None:
            member_bounds = [m.num_queries for m in self.metrics.values() if m.num_queries]
            num_queries = max(member_bounds) if member_bounds else None
        _check_num_queries(num_queries, [m.empty_target_action for m in self.metrics.values()])
        self.num_queries = num_queries
        self._allow_non_binary = all(m.allow_non_binary_target for m in self.metrics.values())

        self.add_state("indexes", default=[], dist_reduce_fx=None)
        self.add_state("preds", default=[], dist_reduce_fx=None)
        self.add_state("target", default=[], dist_reduce_fx=None)

    def update(self, preds: torch.Tensor, target: torch.Tensor, indexes: torch.Tensor) -> None:  # type: ignore[override]
        if indexes is None:
            raise ValueError("Argument `indexes` cannot be None")
        indexes, preds, target = _check_retrieval_inputs(
            indexes, preds, target, allow_non_binary_target=self._allow_non_binary
        )
        self.indexes.append(indexes)
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> Dict[str, torch.Tensor]:
        """One grouping pass, every member metric scored off it.

        An empty collection (no ``update`` yet) returns 0.0 for EVERY member,
        including members constructed with ``empty_target_action='error'``,
        whose error policy applies to empty *queries* within data.
        """
        g = _grouped_state(self, self.num_queries)
        if g is None:
            return {name: torch.tensor(0.0, device=self.device) for name in self.metrics}
        out = {name: m._reduce_scores(g, m._segment_metric(g)) for name, m in self.metrics.items()}
        if isinstance(self.preds, CatBuffer):
            out = {name: self.preds.poison(v) for name, v in out.items()}
        return out

    def __repr__(self) -> str:
        inner = ", ".join(f"{n}={type(m).__name__}" for n, m in self.metrics.items())
        return f"{type(self).__name__}({inner})"
