"""Where a metric's state lives.

The port runs on the card unless the caller asks for the CPU: ``device=None``
means CUDA, and on a machine without CUDA that is an error, never a quiet
fallback to the host.
"""
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """Return the device a metric should hold its state on.

    ``None`` resolves to the current CUDA device. Raises ``RuntimeError`` when
    CUDA is asked for (explicitly or by default) and none is available; pass
    ``device="cpu"`` to run on the host.
    """
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "metrics_tpu_torch runs on a CUDA device by default, but "
                "torch.cuda.is_available() is False. Pass device='cpu' to run "
                "on the host."
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
