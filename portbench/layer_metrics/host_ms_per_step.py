"""Host milliseconds a call of ``update`` takes: the harness's own span
around every ``update`` of the traced run's window, over its steps."""


def read(ctx):
    return ctx.window.update_s / ctx.window.steps * 1e3
