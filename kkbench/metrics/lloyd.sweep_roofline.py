"""lloyd.sweep_roofline: what the embedded fit's Lloyd sweeps need, over the
device time of everything launched under the program's ``obs:sweep``
spans, as a share of the card's bound, in %. A sweep needs one read of the
resident Z [rows, m] in the cell's precision and one [rows, m] x [m, C]
contraction (as ``fit_mfu`` counts it), counted once whatever the sweep
launches; the bytes bound it."""
from kkbench import spans


def read(ctx):
    t = ctx.trace
    if t is None or ctx.cell["method"] == "exact":
        return None
    r = spans.reduce(t).get("obs:sweep")
    if r is None or r.device_s <= 0:
        return None
    m, c = ctx.cell["embed_dim"], ctx.cell["n_clusters"]
    item = 2 if ctx.cell["precision"] == "bf16" else 4
    flops = nbytes = 0.0
    for o in ctx.outs:
        for rows, h in zip(o.rows, o.history):
            flops += h.inner_iters * 2.0 * rows * m * c
            nbytes += h.inner_iters * item * rows * m
    bound = ctx.work.bound_seconds(flops, nbytes, ctx.cell["precision"])
    return 100.0 * bound / r.device_s
