"""mesh.collective_share: the share of rank 0's traced window in which a
NCCL kernel (a device op whose name holds ``nccl``: the mesh's label
all_gather, its fused all_reduce and the medoid argmins' gathers) ran on
its device, in %: exposed communication and the wait for a slower rank
alike, what the mesh's layer costs. None without such ops (a world of
one, the CPU)."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    spans = t.busy_intervals(lambda name: "nccl" in name.lower())
    if not spans:
        return None
    return 100.0 * sum(b - a for a, b in spans) * 1e-6 / t.window_s
