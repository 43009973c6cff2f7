"""stage.idle_share: the share of the traced window in which the device sat
idle while a batch was fetched and put on the device (an ``obs:stage``
span of the program), in %."""
from kkbench import spans


def read(ctx):
    return spans.idle_share(ctx.trace, "obs:stage")
