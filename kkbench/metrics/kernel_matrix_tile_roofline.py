"""kernel_matrix_tile_roofline: the Gram build each batch needs, K(X_b, L)
once on a rank's share of the rows (``kkbench/work.py``'s
``kernel_matrix_tile``, counted from the shapes; the landmarks' own rows,
K_ll, are rows of it however often the program builds them), over the
device time of every launch of the ``kernel_matrix`` tile bodies
(``kernels/csrc/kernel_matrix.cu``) in the window, as a share of the
card's bound, in %."""

NAMES = ("tile_f32_kernel", "tile_bf16_kernel")


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    ks = t.kernels(lambda name: any(n in name for n in NAMES))
    if not ks:
        return None
    d = ctx.data.x.shape[1]
    item = 2 if ctx.cell["precision"] == "bf16" else 4
    bound = sum(ctx.work.bound_seconds(*ctx.work.kernel_matrix_tile(
        *ctx.shape.panel(rows, ctx.cell["s"]), d, item),
        ctx.cell["precision"]) for o in ctx.outs for rows in o.rows)
    return 100.0 * bound / (sum(k[2] for k in ks) * 1e-6)
