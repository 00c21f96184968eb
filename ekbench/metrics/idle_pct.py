"""idle_pct: the share of the traced window in which the card ran no
kernel, copy or fill."""
UNIT = "%"
LAYER = "Device"
MOVES = "mlups"


def read(ctx):
    w = ctx.trace.window_us
    if w <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_us / w)
