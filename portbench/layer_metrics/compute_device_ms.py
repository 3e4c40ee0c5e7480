"""Device milliseconds of a pass-end ``compute()`` (from its call to every
value on the host): the device operations that the host operations inside
the call launched, over the profiled passes' reads. Updates still queued
when the read starts run inside its span but are not its work: the
profiler's link from each device operation to its launch leaves them out."""
from harness import tracing


def read(ctx):
    tw = ctx.passes
    if not tw.launched or not tw.reads:
        return None
    return tracing.launched_within_us(tw.launched, tw.marked("compute")) / tw.reads / 1e3
