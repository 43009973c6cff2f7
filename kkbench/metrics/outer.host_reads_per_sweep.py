"""outer.host_reads_per_sweep: the program's reads of device values by the
host in the traced window, one ``obs:host_read[<site>]`` span each
(``repro_torch/obs/trace.py``), over the inner-loop sweeps of the window's
fits (the sum of ``BatchStats.inner_iters``), in reads a sweep. None where
the program spans no read."""
from kkbench import spans


def read(ctx):
    if ctx.trace is None:
        return None
    reads = sum(r.count for name, r in spans.reduce(ctx.trace).items()
                if name.startswith(spans.HOST_READ))
    sweeps = sum(h.inner_iters for o in ctx.outs for h in o.history)
    if not reads or not sweeps:
        return None
    return reads / sweeps
