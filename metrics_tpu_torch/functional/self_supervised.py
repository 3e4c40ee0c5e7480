"""Pairwise embedding similarity.

Counterpart of ``metrics_tpu/functional/self_supervised.py``. The product
``batch @ batch.T`` is a plain matrix product (the JAX package runs it
outside any kernel), computed in true float32: a caller's TF32 flag would
otherwise round a float32 product's inputs to 10-bit mantissas on the card.
"""
import torch

from metrics_tpu_torch.utils.device import full_float32


def embedding_similarity(
    batch: torch.Tensor, similarity: str = "cosine", reduction: str = "none", zero_diagonal: bool = True
) -> torch.Tensor:
    """Pairwise representation similarity matrix, on ``batch``'s device.

    Args:
        batch: embeddings ``[batch, dim]``.
        similarity: ``'dot'`` or ``'cosine'``.
        reduction: ``'none'`` | ``'sum'`` | ``'mean'`` along the last dim.
        zero_diagonal: zero self-similarities.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import embedding_similarity
        >>> embeddings = torch.tensor([[1., 2., 3., 4.], [1., 2., 3., 4.], [4., 5., 6., 7.]])
        >>> embedding_similarity(embeddings).shape
        torch.Size([3, 3])
    """
    if similarity == "cosine":
        batch = batch / torch.linalg.norm(batch, dim=1, keepdim=True)
    with full_float32():
        sqr_mtx = batch @ batch.T
    if zero_diagonal:
        # a product, as the JAX package's: a NaN self-similarity stays NaN
        sqr_mtx = sqr_mtx * (1 - torch.eye(sqr_mtx.shape[0], dtype=sqr_mtx.dtype, device=sqr_mtx.device))
    if reduction == "mean":
        sqr_mtx = torch.mean(sqr_mtx, dim=-1)
    elif reduction == "sum":
        sqr_mtx = torch.sum(sqr_mtx, dim=-1)
    return sqr_mtx
