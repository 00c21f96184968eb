"""load_s: host seconds of the kernel library's load (kernels/fused_step.py
`_load`, its first call: hashing the source, opening the two libraries,
checking their constant blocks), from the program's `ekpnp_torch.load`
span less its `ekpnp_torch.build` child, so that a checkout's first run,
which builds the libraries with nvcc, reads what every other run reads.
None where the program keeps no such span or loaded no library."""
UNIT = "s"
LAYER = "Set-up: the kernel library (kernels/fused_step.py)"
MOVES = "setup_s"


def read(ctx):
    try:
        from ekpnp_torch import telemetry
    except ImportError:
        return None
    load = telemetry.stat("ekpnp_torch.load")
    if load is None:
        return None
    build = telemetry.stat("ekpnp_torch.build")
    return load.first - (build.first if build is not None else 0.0)
