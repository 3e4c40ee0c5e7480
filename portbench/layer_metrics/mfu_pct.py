"""The whole step's share of the card's peak: the least time for what a
step needs (the larger of its operations over the float32 peak and its bytes
over the HBM peak) over the wall time a step took in the traced run's
window, pass-end reads and resets included."""
from harness import roofline


def read(ctx):
    if ctx.peak is None:
        return None
    return 100.0 * roofline.least_seconds(ctx.need, ctx.peak) / (ctx.window.wall_s / ctx.window.steps)
