"""peak_hbm_gib: ``torch.cuda.max_memory_allocated()`` over the window
(reset after set-up), in GiB; nothing off the card."""


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    return ctx.peak / 2.0 ** 30
