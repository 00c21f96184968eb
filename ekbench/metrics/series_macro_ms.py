"""series_macro_ms: device milliseconds per series event of the series
point's full-grid pass (`compute_macro` and `efield`, diagnostics.py
`series_point`), from the program's own `ekpnp_torch.series.macro` spans:
the mean of their timing-event milliseconds on the card.  None where the
program keeps no such records."""
UNIT = "ms"
LAYER = "Diagnostics (diagnostics.py)"
MOVES = "mlups"
SPAN = "ekpnp_torch.series.macro"


def read(ctx):
    try:
        from ekpnp_torch import telemetry
    except ImportError:
        return None
    ms = [r.device_ms() for r in telemetry.records(SPAN)]
    if not ms or None in ms:
        return None
    return sum(ms) / len(ms)
