"""Distance of two float32 arrays in units in the last place."""
import numpy as np


def max_ulps(a, b) -> int:
    """The largest distance of two float32 array-likes (tensors on any
    device, arrays) in units in the last place: the floats' bits as ordered
    integers, negatives below zero."""
    def ordered(x):
        x = x.detach().cpu().numpy() if hasattr(x, "detach") else x
        i = np.array(x, dtype=np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    diff = np.abs(ordered(a) - ordered(b))
    return int(diff.max()) if diff.size else 0
