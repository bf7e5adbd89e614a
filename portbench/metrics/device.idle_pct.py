"""device.idle_pct (%; layer: device): the share of the profiled steps'
span, from the first device operation's start to the last one's end and the
gaps between steps included, in which no device operation runs."""


def read(ctx):
    if ctx.trace is None:
        return None
    return ctx.trace.idle_pct()
