"""outer.inner_iters: the mean of the program's ``BatchStats.inner_iters``
over every batch the window fitted."""


def read(ctx):
    iters = [h.inner_iters for o in ctx.outs for h in o.history]
    return sum(iters) / len(iters)
