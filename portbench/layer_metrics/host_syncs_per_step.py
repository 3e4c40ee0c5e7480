"""Host reads a steady update step makes: ``cudaStreamSynchronize`` host
events and device-to-host copies, over the profiled update steps."""


def read(ctx):
    tw = ctx.steps
    if not tw.device:
        return None
    d2h = sum(1 for n, _, _ in tw.device if "DtoH" in n)
    return (tw.host_named("cudaStreamSynchronize") + d2h) / tw.steps
