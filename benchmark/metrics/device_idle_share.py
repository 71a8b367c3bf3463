"""device_idle_share (%): the share of the traced window in which no
kernel, copy or set ran on the card: 1 - busy / window, both read from
the one traced window (busy: the union of the device's intervals)."""


def read(ctx):
    span = ctx.trace.span[1] - ctx.trace.span[0]
    busy = ctx.trace.busy_ns()
    if busy <= 0 or span <= 0:
        return None
    return 100.0 * (1.0 - busy / span)
