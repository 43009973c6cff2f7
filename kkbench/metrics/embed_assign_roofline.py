"""embed_assign_roofline: the work of the fused embed-and-assign launches
(``kernels/csrc/embed_assign.cu``; ``predict`` of the held-out rows on an
RFF fit), counted from the rows they label by ``kkbench/work.py``, over
those kernels' device time, as a share of the card's bound, in %."""
import re

KERNEL = re.compile(r"\bembed_(assign_f32|bf16)_kernel\b")


def read(ctx):
    t = ctx.trace
    if t is None or ctx.cell["method"] != "rff":
        return None
    ks = t.kernels(lambda name: KERNEL.search(name) is not None)
    if not ks:
        return None
    n = ctx.data.x_test.shape[0] * len(ctx.outs)
    f, b = ctx.work.embed_assign(n, ctx.data.x.shape[1],
                                 ctx.cell["embed_dim"],
                                 ctx.cell["n_clusters"], len(ks))
    bound = ctx.work.bound_seconds(f, b, ctx.cell["precision"])
    return 100.0 * bound / (sum(k[2] for k in ks) * 1e-6)
