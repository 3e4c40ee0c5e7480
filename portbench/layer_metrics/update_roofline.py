"""The update step's kernels' share of their roofline: the least time the
card could take for what a step needs (each input byte read once, each
state byte written once, at the HBM peak; see ``harness/roofline.py``) over
the device-busy time of a profiled update step."""
from harness import tracing


def read(ctx):
    tw = ctx.steps
    busy_s = tracing.busy_us(tw.device) / 1e6 / tw.steps if tw.device else 0.0
    if ctx.peak is None or busy_s <= 0:
        return None
    return 100.0 * ctx.need["bytes"] / ctx.peak["hbm_byte_per_s"] / busy_s
