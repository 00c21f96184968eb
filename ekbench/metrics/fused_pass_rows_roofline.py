"""fused_pass_rows_roofline: the row-staged shard pass
(fused_pass_rows_kernel, phi_hx form) on process 0's slab shard of the
pod (512x64x257) against its composed byte bound with the edge rows read
from the y-neighbours (2.244 ms at 3.35 TB/s): the bound over the pass's
mean time plus two row products' mean time, in the `chunk` spans."""
UNIT = "%"
LAYER = "CUDA kernels (csrc/fused_step.cu through kernels/fused_step.py)"
MOVES = "mlups_4card"
PASS = r"\bfused_pass_rows_kernel\b"
ROWS = r"\bhartley_rows(_tf32x3)?_kernel\b"


def read(ctx):
    from ekbench.accounting import pass_bytes

    passes = ctx.trace.matching(PASS, "chunk")
    rows = ctx.trace.matching(ROWS, "chunk")
    if not passes or not rows:
        return None
    mean = lambda ks: sum(k[2] for k in ks) / len(ks) * 1e-6
    took = mean(passes) + 2 * mean(rows)
    bound = pass_bytes(ctx.q_f, ctx.q_s, ctx.itemsize, ctx.local_shape,
                       shard=True, phi_hx=True) / ctx.bandwidth
    return 100.0 * bound / took
