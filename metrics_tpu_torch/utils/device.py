"""Where a metric's state lives.

The port runs on the card unless the caller asks for the CPU: ``device=None``
means CUDA, and on a machine without CUDA that is an error, never a quiet
fallback to the host.
"""
import contextlib
from typing import Iterator, Optional, Union

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


@contextlib.contextmanager
def full_float32() -> Iterator[None]:
    """Run float32 convolutions and matmuls as true float32 inside the block.

    PyTorch lets cuDNN use TF32 (10-bit mantissas) for float32 convolutions
    by default (``torch.backends.cudnn.allow_tf32``), and cuBLAS for matmuls
    when ``torch.backends.cuda.matmul.allow_tf32`` is set. The JAX package's
    float32 forwards and moments are float32 throughout, so the image family
    turns both off for its own work and restores the caller's flags after,
    whatever they were. No effect on the CPU or on other dtypes.
    """
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
