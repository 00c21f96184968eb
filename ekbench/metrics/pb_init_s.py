"""pb_init_s: seconds of the Poisson-Boltzmann cold start
(`ekpnp_torch.init.initialize`, 501 under-relaxed solves), by the host
clock around the call, the card synchronised after it."""
UNIT = "s"
LAYER = "Cold start (init.py, ops/pbe.py)"
MOVES = "setup_s"


def read(ctx):
    return ctx.pb_init_s
