"""idle_pct.4card: idle_pct of process 0's card on the pod."""
UNIT = "%"
LAYER = "Device"
MOVES = "mlups_4card"


def read(ctx):
    w = ctx.trace.window_us
    if w <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_us / w)
