"""plan.peak_ratio: the allocator's peak over the window against the
program's own price of one batch (``obs.memory.predicted_batch_footprint``
for the exact path, the embedded footprint for a map), per device."""


def read(ctx):
    if ctx.device.type != "cuda" or not ctx.shape.predicted_bytes:
        return None
    return ctx.peak / ctx.shape.predicted_bytes
