"""setup_s: seconds from the process's start to its first timed step
(data made, fit planned, shapes warmed; the first run in a checkout also
builds the kernels)."""


def read(ctx):
    return ctx.setup_s
