"""LPIPS module metric.

Counterpart of ``metrics_tpu/image/lpip_similarity.py``, with the network
an ``nn.Module`` of the port (``models/lpips_net.py``) held outside the
metric's states (``image/_extractor.py``).
"""
from typing import Any, Callable, Optional, Tuple, Union

import torch

from metrics_tpu_torch.image._extractor import NetworkMetric
from metrics_tpu_torch.models.lpips_net import LPIPSNetwork


def _valid_img(*imgs: torch.Tensor) -> bool:
    """Every image batch ``[N, 3, H, W]`` with values in [-1, 1]. The range
    of all of them is one device-side reduction and one host read."""
    if not all(img.ndim == 4 and img.shape[1] == 3 for img in imgs):
        return False
    in_range = torch.stack([torch.all(torch.abs(img) <= 1.0) for img in imgs])
    return bool(torch.all(in_range))


class LPIPS(NetworkMetric):
    r"""Learned Perceptual Image Patch Similarity, accumulated over batches.

    Args:
        net_type: 'alex' | 'vgg' feature tower.
        reduction: 'mean' | 'sum' over all scored pairs.
        net: a custom callable ``(img0, img1) -> [N] distances``, in place of
            the built-in network.
        weights: ``(tower_state_dict, lin_state_dict)`` for the built-in
            network (random weights otherwise).
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
            device: see :class:`~metrics_tpu_torch.Metric`.

    Example:
        >>> import numpy as np, torch
        >>> from metrics_tpu_torch import LPIPS
        >>> rng = np.random.RandomState(0)
        >>> def dist_fn(x, y):                       # custom perceptual distance
        ...     return torch.mean((x - y) ** 2, dim=(1, 2, 3))
        >>> lpips = LPIPS(net=dist_fn, device="cpu")
        >>> a = torch.from_numpy(rng.rand(2, 3, 8, 8).astype(np.float32)) * 2 - 1
        >>> b = torch.from_numpy(rng.rand(2, 3, 8, 8).astype(np.float32)) * 2 - 1
        >>> round(float(lpips(a, b)), 4)
        0.6495
    """

    is_differentiable = True

    def __init__(
        self,
        net_type: str = "alex",
        reduction: str = "mean",
        net: Optional[Union[LPIPSNetwork, Callable]] = None,
        weights: Optional[Tuple[Any, Any]] = None,
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
        self._set_network("net", net if net is not None else LPIPSNetwork(net_type, weights, device=self.device))
        valid_reduction = ("mean", "sum")
        if reduction not in valid_reduction:
            raise ValueError(f"Argument `reduction` must be one of {valid_reduction}, but got {reduction}")
        self.reduction = reduction
        self.add_state("sum_scores", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, img1: torch.Tensor, img2: torch.Tensor) -> None:  # type: ignore[override]
        if not _valid_img(img1, img2):
            raise ValueError(
                "Expected both input arguments to be normalized tensors (all values in range [-1,1])"
                f" and to have shape [N, 3, H, W] but `img1` have shape {tuple(img1.shape)}"
                f" and `img2` have shape {tuple(img2.shape)}"
            )
        loss = self.net(img1, img2)
        self.sum_scores = self.sum_scores + loss.sum()
        self.total = self.total + img1.shape[0]

    def compute(self) -> torch.Tensor:
        if self.reduction == "mean":
            return self.sum_scores / self.total
        return self.sum_scores
