"""nmi: NMI between the generator's labels of the held-out rows and
``predict``'s, averaged over the window's steps."""
from kkbench.quality import nmi


def read(ctx):
    y = ctx.data.y_test.cpu().numpy()
    vals = [nmi(y, o.labels.cpu().numpy()) for o in ctx.outs]
    return sum(vals) / len(vals)
