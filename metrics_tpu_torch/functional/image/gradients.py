"""Image gradients — functional layer.

Counterpart of ``metrics_tpu/functional/image/gradients.py``.
"""
from typing import Tuple

import torch
import torch.nn.functional as F


def _image_gradients_validate(img: torch.Tensor) -> None:
    if img.ndim != 4:
        raise RuntimeError(f"The size of the image tensor {tuple(img.shape)} is not supported. Expected BxCxHxW.")


def _compute_image_gradients(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward differences along H and W, zero-padded at the far edge."""
    dy = img[..., 1:, :] - img[..., :-1, :]
    dx = img[..., :, 1:] - img[..., :, :-1]
    return F.pad(dy, (0, 0, 0, 1)), F.pad(dx, (0, 1, 0, 0))


def image_gradients(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel ``(dy, dx)`` gradients of a BxCxHxW image batch.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import image_gradients
        >>> dy, dx = image_gradients(torch.arange(16.0).reshape(1, 1, 4, 4))
        >>> dy[0, 0, 0].tolist()
        [4.0, 4.0, 4.0, 4.0]
    """
    _image_gradients_validate(img)
    return _compute_image_gradients(img)
