"""step_mfu: the whole step's share of the card's peak memory rate, the
rate that bounds this memory-bound step: the step's byte floor (872 or
392 B per node in float32, every population read and written once, phi
read, the right-hand side written) times the nodes and the window's
steps, over the device-busy time of the kernels launched in the harness's
`chunk` spans.  Whatever kernels do the work, the same floor is counted."""
UNIT = "%"
LAYER = "CUDA kernels (csrc/fused_step.cu through kernels/fused_step.py)"
MOVES = "mlups"
SPAN = "chunk"


def read(ctx):
    from ekbench.accounting import step_bytes_per_node

    busy = ctx.trace.busy_in(SPAN) * 1e-6
    if busy <= 0 or ctx.steps <= 0:
        return None
    nz, ny, nx = ctx.local_shape
    floor = (step_bytes_per_node(ctx.q_f, ctx.q_s, ctx.itemsize)
             * nz * ny * nx * ctx.steps / ctx.bandwidth)
    return 100.0 * floor / busy
