"""Device kernels a steady update step runs, those replayed inside a CUDA
graph included (copies and sets left out), over the profiled update steps."""


def read(ctx):
    tw = ctx.steps
    if not tw.device:
        return None
    return len(tw.kernels()) / tw.steps
