"""inner.idle_share: the share of the traced window in which the device sat
idle while an inner-loop sweep (an ``obs:sweep`` span of the program) was
open, its host reads included, in %."""
from kkbench import spans


def read(ctx):
    return spans.idle_share(ctx.trace, "obs:sweep")
