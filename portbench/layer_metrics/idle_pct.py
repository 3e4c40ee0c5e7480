"""Share of the profiled passes' wall time (from the first marked call to
the end of the last) in which no device operation ran."""
from harness import tracing


def read(ctx):
    tw = ctx.passes
    if not tw.device:
        return None
    lo, hi = tw.span
    return 100.0 * (1.0 - tracing.busy_us(tw.device, (lo, hi)) / (hi - lo))
