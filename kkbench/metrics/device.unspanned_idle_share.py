"""device.unspanned_idle_share: the share of the traced window in which the
device sat idle while no span of the program (``obs:...``) was open on the
window's thread, in %: the idle time that no layer of the program
explains. None where the program does not span its fits (``obs:fit``)."""
from kkbench import spans


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0 or not t.device:
        return None
    rows = spans.reduce(t)
    if "obs:fit" not in rows:
        return None
    return 100.0 * rows.get(spans.NONE, spans.Row()).idle_s / t.window_s
