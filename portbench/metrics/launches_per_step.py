"""Device kernels in the traced window per link step (one
``link.count_errors`` span a ``link_step``)."""


def read(ctx):
    if not ctx.steps or not ctx.trace.kernels:
        return None
    return len(ctx.trace.kernels) / ctx.steps
