"""series_ms: device milliseconds per series event, from the first to the
last kernel launched in each of the harness's `series` spans."""
UNIT = "ms"
LAYER = "Diagnostics (diagnostics.py)"
MOVES = "mlups"


def read(ctx):
    spans = ctx.trace.instances("series")
    if not spans:
        return None
    return sum(e - s for s, e in spans) * 1e-3 / len(spans)
