"""CUDA graph replays a steady update step launches (``cudaGraphLaunch``
host events over the profiled update steps): 1 when the collection's
eligible members replay as one program, 0 when the step runs eager. The
compiled path's fallbacks, from ``compile_stats()``, are on an earlier
line of standard error."""


def read(ctx):
    tw = ctx.steps
    if not tw.device:
        return None
    return tw.host_named("cudaGraphLaunch") / tw.steps
