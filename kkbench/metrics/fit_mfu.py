"""fit_mfu: the operations the algorithm needs (``kkbench/work.py``:
exact, K(X_b, L) once a batch and one [rows, |L|] x [|L|, C] contraction a
sweep; RFF, the map once a batch and one [rows, m] x [m, C] contraction a
sweep), whatever implements them, over the window's step time times the
peak of the cell's precision on every chip it uses, in %."""


def read(ctx):
    c, d, s = ctx.cell["n_clusters"], ctx.data.x.shape[1], ctx.cell["s"]
    flops = 0.0
    for o in ctx.outs:
        for rows, h in zip(o.rows, o.history):
            if ctx.cell["method"] == "exact":
                n_l = max(int(-(-s * rows // 1)), c)
                flops += ctx.work.exact_batch_flops(rows, n_l, d, c,
                                                    h.inner_iters)
            else:
                flops += ctx.work.rff_batch_flops(
                    rows, d, ctx.cell["embed_dim"], c, h.inner_iters)
    peak = ctx.work.peak_flops(ctx.cell["precision"]) * ctx.shape.world
    return 100.0 * flops / (sum(ctx.walls) * peak)
