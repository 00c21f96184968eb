"""step_mfu.4card: step_mfu of process 0's shard on the pod (its nodes'
byte floor over its card's busy time in `chunk` spans)."""
UNIT = "%"
LAYER = "CUDA kernels (csrc/fused_step.cu through kernels/fused_step.py)"
MOVES = "mlups_4card"
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
