"""fit_rows_per_s: the training rows of every batch the window's steps
fitted, over the window's seconds (every step the window starts, it
finishes; the window ends with the step that passes ``--seconds``)."""


def read(ctx):
    return sum(sum(o.rows) for o in ctx.outs) / ctx.elapsed
