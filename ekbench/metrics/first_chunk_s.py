"""first_chunk_s: host seconds of the process's first call of the time
loop (`ekpnp_torch.chunk`, kernels/step.py `multi_step`: the harness's
warm chunk), where the first launches, the lazy loads of the kernel
modules, the solve library's handles and the allocator's growth fall.
None where the program keeps no such span."""
UNIT = "s"
LAYER = "Set-up: the time loop's first call (kernels/step.py)"
MOVES = "setup_s"


def read(ctx):
    try:
        from ekpnp_torch import telemetry
    except ImportError:
        return None
    first = telemetry.stat("ekpnp_torch.chunk")
    return None if first is None else first.first
