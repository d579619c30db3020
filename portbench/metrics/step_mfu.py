"""``step_mfu``: the whole local step's share of the card's float32 peak:
the FLOPs the traced window's local steps need (``counts.step_flops``,
real images only), over the window's seconds times 67 TFLOP/s."""

from portbench import counts


def read(ctx):
    if not ctx.flops or ctx.window_s <= 0:
        return None
    return 100.0 * ctx.flops / (ctx.window_s * counts.F32_FLOPS_PER_S)
