"""engine.matvec_roofline: the bytes each inner-loop sweep of the Gram
engine (``core/engine.py``) needs, over the device time of the GEMM
kernels launched under its ``obs:engine_stats[materialize]`` spans, as a
share of the card's bandwidth bound, in %. A sweep needs one read of the
materialized [rows, |L|] panel, the one-hot panel H and the output
(``kkbench/work.py``'s ``gram_matvec``), counted once whatever the engine
launches: a second contraction over the landmarks' rows (K_ll @ H, rows of
the same panel) is time, not work."""
import re
import sys

SPAN = "obs:engine_stats[materialize]"
GEMM = re.compile(r"gemm|gemv|splitk|xmma|cutlass", re.I)


def read(ctx):
    t = ctx.trace
    if t is None or ctx.shape.engine != "materialize":
        return None
    ks = t.kernels_under(SPAN, lambda name: GEMM.search(name) is not None)
    calls = sum(h.inner_iters + 1 for o in ctx.outs for h in o.history)
    if not ks or t.count(SPAN) != calls:
        print(f"engine.matvec_roofline: {t.count(SPAN)} spans against "
              f"{calls} expected, {len(ks)} kernels; not read",
              file=sys.stderr)
        return None
    c = ctx.cell["n_clusters"]
    flops = nbytes = 0.0
    for o in ctx.outs:
        for rows, h in zip(o.rows, o.history):
            f, b = ctx.work.gram_matvec(*ctx.shape.panel(rows, ctx.cell["s"]),
                                        c)
            flops += (h.inner_iters + 1) * f
            nbytes += (h.inner_iters + 1) * b
    bound = ctx.work.bound_seconds(flops, nbytes, ctx.cell["precision"])
    return 100.0 * bound / (sum(k[2] for k in ks) * 1e-6)
