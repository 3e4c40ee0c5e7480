"""Classification input normalization.

Counterpart of ``metrics_tpu/utils/checks.py:39-335``. Which of binary /
multi-label / multi-class / multi-dim multi-class a ``(preds, target)`` pair
falls into depends only on shapes and dtypes; the value checks read the data
(one host read each, as in the JAX package's eager path). They run only on
concrete tensors (:func:`_is_concrete`), as the JAX package's run only
outside a trace: a compiled program (``core/compiled.py``) skips them, and
its first run is an eager one on a copy of the state, where they raise.
"""
from typing import Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

from metrics_tpu_torch.utils.data import select_topk, to_onehot
from metrics_tpu_torch.utils.enums import DataType


def _is_concrete(*tensors: torch.Tensor) -> bool:
    """True when running eagerly: not inside a compiled program (its probe,
    CPU run or CUDA graph capture), no fake tensor among ``tensors``, and no
    CUDA graph capturing on the current stream. A host read is legal only
    then (counterpart of ``metrics_tpu/utils/checks.py:39-50``)."""
    from metrics_tpu_torch.core.compiled import in_program

    if in_program():
        return False
    if any(isinstance(t, FakeTensor) for t in tensors):
        return False
    return not (any(t.is_cuda for t in tensors) and torch.cuda.is_current_stream_capturing())


def _is_floating(x: torch.Tensor) -> bool:
    return x.is_floating_point()


def _check_not_empty(target: torch.Tensor) -> None:
    """An empty batch has no label to validate: the JAX package fails on the
    ``min()`` of its target with ``ValueError``, torch with ``RuntimeError``."""
    if target.numel() == 0:
        raise ValueError(f"Expected a non-empty batch, got `target` of shape {tuple(target.shape)}.")


def _check_broadcastable(shape_a: Tuple[int, ...], shape_b: Tuple[int, ...], message: str) -> None:
    """Raise where the JAX package's elementwise op on arrays of these shapes
    raises: ``TypeError`` from ``lax`` when the ranks agree, ``ValueError``
    from ``jnp``'s broadcast when they differ (torch raises ``RuntimeError``
    for both)."""
    if all(a == b or a == 1 or b == 1 for a, b in zip(reversed(shape_a), reversed(shape_b))):
        return
    error = TypeError if len(shape_a) == len(shape_b) else ValueError
    raise error(f"{message} (shapes {tuple(shape_a)} and {tuple(shape_b)} do not broadcast)")


def _check_same_shape(preds: torch.Tensor, target: torch.Tensor) -> None:
    if preds.shape != target.shape:
        raise RuntimeError(
            f"Predictions and targets are expected to have the same shape, "
            f"got {tuple(preds.shape)} and {tuple(target.shape)}"
        )


def _input_squeeze(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop all size-1 dims except the leading batch dim."""

    def squeeze_keep_batch(x: torch.Tensor) -> torch.Tensor:
        if x.ndim <= 1:
            return x
        kept = [x.shape[0]] + [d for d in x.shape[1:] if d != 1]
        return x.reshape(kept)

    return squeeze_keep_batch(preds), squeeze_keep_batch(target)


def _classify_case(preds: torch.Tensor, target: torch.Tensor) -> Tuple[DataType, int]:
    """Shape/dtype-based case detection; returns ``(case, implied_classes)``."""
    preds_float = _is_floating(preds)
    if preds.ndim == target.ndim:
        if preds.shape != target.shape:
            raise ValueError(
                f"The `preds` and `target` should have the same shape, got "
                f"{tuple(preds.shape)} and {tuple(target.shape)}."
            )
        if preds.ndim == 1:
            case = DataType.BINARY if preds_float else DataType.MULTICLASS
        else:
            case = DataType.MULTILABEL if preds_float else DataType.MULTIDIM_MULTICLASS
        implied_classes = 1
        for d in preds.shape[1:]:
            implied_classes *= d
    elif preds.ndim == target.ndim + 1:
        if not preds_float:
            raise ValueError(
                "If `preds` have one dimension more than `target`, `preds` should be a float tensor."
            )
        if preds.shape[2:] != target.shape[1:]:
            raise ValueError(
                "If `preds` have one dimension more than `target`, the shape of `preds` should be "
                "(N, C, ...) and the shape of `target` (N, ...)."
            )
        implied_classes = preds.shape[1]
        case = DataType.MULTICLASS if preds.ndim == 2 else DataType.MULTIDIM_MULTICLASS
    else:
        raise ValueError(
            "Either `preds` and `target` both should have the (same) shape (N, ...), or `target` "
            "should be (N, ...) and `preds` should be (N, C, ...)."
        )
    return case, implied_classes


def _validate_values(
    preds: torch.Tensor,
    target: torch.Tensor,
    case: DataType,
    implied_classes: int,
    num_classes: Optional[int],
    multiclass: Optional[bool],
) -> None:
    """Value-dependent validation (reads the data on the host); eager only."""
    if not _is_concrete(preds, target):
        return
    if _is_floating(target):
        raise ValueError("The `target` has to be an integer tensor.")
    _check_not_empty(target)
    if int(target.min()) < 0:
        raise ValueError("The `target` has to be a non-negative tensor.")
    preds_float = _is_floating(preds)
    if not preds_float and int(preds.min()) < 0:
        raise ValueError("If `preds` are integers, they have to be non-negative.")
    if preds.shape[0] != target.shape[0]:
        raise ValueError("The `preds` and `target` should have the same first dimension.")
    if multiclass is False and int(target.max()) > 1:
        raise ValueError("If you set `multiclass=False`, then `target` should not exceed 1.")
    if multiclass is False and not preds_float and int(preds.max()) > 1:
        raise ValueError(
            "If you set `multiclass=False` and `preds` are integers, then `preds` should not exceed 1."
        )
    if preds.ndim == target.ndim and preds_float and int(target.max()) > 1:
        raise ValueError(
            "If `preds` and `target` are of shape (N, ...) and `preds` are floats, `target` should be binary."
        )
    if preds.shape != target.shape:
        if multiclass is False and implied_classes != 2:
            raise ValueError(
                "You have set `multiclass=False`, but have more than 2 classes in your data,"
                " based on the C dimension of `preds`."
            )
        if int(target.max()) >= implied_classes:
            raise ValueError(
                "The highest label in `target` should be smaller than the size of the `C` dimension of `preds`."
            )
    if num_classes:
        if case == DataType.BINARY:
            if num_classes > 2:
                raise ValueError("Your data is binary, but `num_classes` is larger than 2.")
            if num_classes == 2 and not multiclass:
                raise ValueError(
                    "Your data is binary and `num_classes=2`, but `multiclass` is not True."
                )
            if num_classes == 1 and multiclass:
                raise ValueError(
                    "You have binary data and have set `multiclass=True`, but `num_classes` is 1."
                )
        elif case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS):
            if num_classes == 1 and multiclass is not False:
                raise ValueError(
                    "You have set `num_classes=1`, but predictions are integers."
                    " If you want to convert (multi-dimensional) multi-class data with 2 classes"
                    " to binary/multi-label, set `multiclass=False`."
                )
            if num_classes > 1:
                if multiclass is False and implied_classes != num_classes:
                    raise ValueError(
                        "You have set `multiclass=False`, but the implied number of classes"
                        " does not match `num_classes`."
                    )
                if num_classes <= int(target.max()):
                    raise ValueError(
                        "The highest label in `target` should be smaller than `num_classes`."
                    )
                if preds.shape != target.shape and num_classes != implied_classes:
                    raise ValueError(
                        "The size of C dimension of `preds` does not match `num_classes`."
                    )
        elif case == DataType.MULTILABEL:
            if multiclass and num_classes != 2:
                raise ValueError(
                    "You have set `multiclass=True`, but `num_classes` is not equal to 2."
                )
            if not multiclass and num_classes != implied_classes:
                raise ValueError(
                    "The implied number of classes (from shape of inputs) does not match num_classes."
                )


def _check_top_k(
    top_k: int, case: DataType, implied_classes: int, multiclass: Optional[bool], preds_float: bool
) -> None:
    if case == DataType.BINARY:
        raise ValueError("You can not use `top_k` parameter with binary data.")
    if not isinstance(top_k, int) or top_k <= 0:
        raise ValueError("The `top_k` has to be an integer larger than 0.")
    if not preds_float:
        raise ValueError("You have set `top_k`, but you do not have probability predictions.")
    if multiclass is False:
        raise ValueError("If you set `multiclass=False`, you can not set `top_k`.")
    if case == DataType.MULTILABEL and multiclass:
        raise ValueError(
            "If you want to transform multi-label data to 2 class multi-dimensional"
            " multi-class data using `multiclass=True`, you can not use `top_k`."
        )
    if top_k >= implied_classes:
        raise ValueError("The `top_k` has to be strictly smaller than the `C` dimension of `preds`.")


def _check_classification_inputs(
    preds: torch.Tensor,
    target: torch.Tensor,
    threshold: float,
    num_classes: Optional[int],
    multiclass: Optional[bool],
    top_k: Optional[int],
) -> DataType:
    """Full input validation; returns the detected case."""
    case, implied_classes = _classify_case(preds, target)
    _validate_values(preds, target, case, implied_classes, num_classes, multiclass)
    # a probability threshold outside (0, 1) maps every prediction to one
    # class; logits may cut anywhere, so the check applies only when every
    # pred lies in [0, 1]
    if (
        case in (DataType.BINARY, DataType.MULTILABEL)
        and not top_k
        and _is_floating(preds)
        and not 0 < threshold < 1
        and _is_concrete(preds)
        and bool(torch.all((preds >= 0) & (preds <= 1)))
    ):
        raise ValueError(
            f"The `threshold` {threshold} is outside (0,1) but `preds` are probabilities;"
            " probability thresholds must lie strictly between 0 and 1"
            " (raw logit inputs may use any threshold)."
        )
    if top_k is not None:
        _check_top_k(top_k, case, implied_classes, multiclass, _is_floating(preds))
    return case


def _onehot_width(preds: torch.Tensor, target: torch.Tensor, num_classes: Optional[int]) -> int:
    """The width at which :func:`_input_format_classification` one-hot encodes
    (multi-dim) multi-class labels: the scores' C dim, else ``num_classes``,
    else the largest label + 1 (two host reads); at least 2."""
    if _is_floating(preds):
        return max(2, preds.shape[1])
    if not num_classes:
        num_classes = max(int(preds.max()), int(target.max())) + 1
    return max(2, num_classes)


def _input_format_classification(
    preds: torch.Tensor,
    target: torch.Tensor,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    num_classes: Optional[int] = None,
    multiclass: Optional[bool] = None,
    validate: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, DataType]:
    """Normalize any accepted (preds, target) pair to binary int64 tensors of
    shape ``(N, C)`` or ``(N, C, X)``, with the JAX package's semantics:

    - binary / multi-label float preds are thresholded (or top-k'd for
      multi-label with ``top_k``);
    - (multi-dim) multi-class preds/targets are one-hot encoded, float preds
      by top-k selection over the C dim;
    - ``multiclass=True`` lifts binary/multi-label to 2-class one-hot form;
      ``multiclass=False`` projects 2-class data down to the positive column.
    """
    preds, target, case = _classification_case(preds, target, threshold, top_k, num_classes, multiclass, validate)
    return _format_classification(preds, target, case, threshold, top_k, num_classes, multiclass)


def _classification_case(
    preds: torch.Tensor,
    target: torch.Tensor,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    num_classes: Optional[int] = None,
    multiclass: Optional[bool] = None,
    validate: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, DataType]:
    """The first half of :func:`_input_format_classification`: the pair
    squeezed, half preds in float32, and its case, validated (or, with
    ``validate=False``, only detected)."""
    preds, target = _input_squeeze(preds, target)
    if preds.dtype in (torch.float16, torch.bfloat16):
        preds = preds.to(torch.float32)
    if validate:
        case = _check_classification_inputs(
            preds, target, threshold=threshold, num_classes=num_classes,
            multiclass=multiclass, top_k=top_k,
        )
    else:
        case, _ = _classify_case(preds, target)
    return preds, target, case


def _format_classification(
    preds: torch.Tensor,
    target: torch.Tensor,
    case: DataType,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    num_classes: Optional[int] = None,
    multiclass: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor, DataType]:
    """The second half of :func:`_input_format_classification`: the pair of
    :func:`_classification_case` formatted to binary int64 tensors."""
    if case in (DataType.BINARY, DataType.MULTILABEL) and not top_k:
        preds = (preds >= threshold).long()
        num_classes = num_classes if not multiclass else 2

    if case == DataType.MULTILABEL and top_k:
        preds = select_topk(preds, top_k)

    if case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS) or multiclass:
        width = _onehot_width(preds, target, num_classes)
        preds = select_topk(preds, top_k or 1) if _is_floating(preds) else to_onehot(preds, width)
        target = to_onehot(target, width)
        if multiclass is False:
            preds, target = preds[:, 1, ...], target[:, 1, ...]

    if (case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS) and multiclass is not False) or multiclass:
        target = target.reshape(target.shape[0], target.shape[1], -1)
        preds = preds.reshape(preds.shape[0], preds.shape[1], -1)
    else:
        target = target.reshape(target.shape[0], -1)
        preds = preds.reshape(preds.shape[0], -1)

    # squeeze the trailing X dim the reshapes above introduce for plain MC/binary
    if preds.ndim > 2 and preds.shape[-1] == 1:
        preds, target = preds.squeeze(-1), target.squeeze(-1)

    return preds.long(), target.long(), case


def _input_mode(preds: torch.Tensor, target: torch.Tensor) -> DataType:
    """The case ``_input_format_classification(preds, target)`` detects, with
    the same validation, without building the formatted tensors: for
    callers that take only the mode (AUROC, CalibrationError)."""
    return _classification_case(preds, target)[2]


def _check_retrieval_target_and_prediction_types(
    preds: torch.Tensor, target: torch.Tensor, allow_non_binary_target: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dtype and value checks of retrieval inputs; returns flat float32
    ``preds`` and flat ``target`` (float32 if floating, else int32, as in the
    JAX package). The binary check reads the data on the host."""
    if not (target.is_floating_point() or target.dtype == torch.bool or _is_integer(target)):
        raise ValueError("`target` must be a tensor of booleans, integers or floats")
    if not _is_floating(preds):
        raise ValueError("`preds` must be a tensor of floats")
    if not allow_non_binary_target and target.numel() and _is_concrete(target):
        flat = target.reshape(-1).to(torch.float32 if target.is_floating_point() else torch.int64)
        lo, hi = torch.stack(torch.aminmax(flat)).tolist()  # one host read
        if int(hi) > 1 or int(lo) < 0:
            raise ValueError("`target` must contain `binary` values")
    target = target.to(torch.float32 if _is_floating(target) else torch.int32).reshape(-1)
    return preds.to(torch.float32).reshape(-1), target


def _is_integer(x: torch.Tensor) -> bool:
    return not (x.is_floating_point() or x.is_complex() or x.dtype == torch.bool)


def _check_retrieval_functional_inputs(
    preds: torch.Tensor, target: torch.Tensor, allow_non_binary_target: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    if preds.shape != target.shape:
        raise ValueError("`preds` and `target` must be of the same shape")
    if preds.numel() == 0 or preds.ndim == 0:
        raise ValueError("`preds` and `target` must be non-empty and non-scalar tensors")
    return _check_retrieval_target_and_prediction_types(preds, target, allow_non_binary_target)


def _check_retrieval_inputs(
    indexes: torch.Tensor, preds: torch.Tensor, target: torch.Tensor, allow_non_binary_target: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shape and dtype checks of ``(indexes, preds, target)``; returns them
    flat, with the query ids in int32.

    Query ids are ids, not counts: they stay int32, as in the JAX package, so
    the ids, the padding sentinel (``iinfo(int32).max``, ``ops/segment.py``)
    and its error are the JAX package's. An id of 2**31 or above wraps as
    the JAX package's ``astype(int32)`` wraps it.
    """
    if indexes.shape != preds.shape or preds.shape != target.shape:
        raise ValueError("`indexes`, `preds` and `target` must be of the same shape")
    if indexes.numel() == 0 or indexes.ndim == 0:
        raise ValueError("`indexes`, `preds` and `target` must be non-empty and non-scalar tensors")
    if not _is_integer(indexes):
        raise ValueError("`indexes` must be a tensor of long integers")
    preds, target = _check_retrieval_target_and_prediction_types(preds, target, allow_non_binary_target)
    return indexes.to(torch.int32).reshape(-1), preds, target


def _check_retrieval_k(k: Optional[int]) -> None:
    """Shared top-k validation for retrieval metrics (module + functional
    layers); rejects bools, which python counts as ints."""
    if k is not None and (isinstance(k, bool) or not isinstance(k, int) or k <= 0):
        raise ValueError("`k` has to be a positive integer or None")
