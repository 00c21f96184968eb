"""solve_span_ms: device milliseconds per step of the spectral solve alone
(`ops/poisson.py` `poisson_psi_hx_from_rhs`), from the program's own
`ekpnp_torch.solve` spans (kernels/step.py `_chunk`, one each step): the
mean of the window's spans' timing-event milliseconds on the card times
the solves a step.  Unlike solve_ms it holds neither the row products of
the pass nor the psi_hx encode and decode.  None where the program keeps
no such records (no `ekpnp_torch.telemetry`, or no card)."""
UNIT = "ms"
LAYER = "Spectral solve (ops/poisson.py)"
MOVES = "mlups"
SPAN = "ekpnp_torch.solve"


def read(ctx):
    try:
        from ekpnp_torch import telemetry
    except ImportError:
        return None
    ms = [r.device_ms() for r in telemetry.records(SPAN)]
    if not ms or None in ms or ctx.steps <= 0:
        return None
    return sum(ms) / ctx.steps     # the mean span times the spans a step
