"""fused_pass_roofline: the one-device fused pass in its phi_hx form (a
step's collide and the previous step's stream in one launch, beside the
decode of phi and the product of the RHS rows) against its composed byte
bound (4.464 / 2.051 ms at 256x256x257 and 3.35 TB/s): the bound over the
pass kernel's mean time plus two row products' mean time, every launch
in the `chunk` spans counted."""
UNIT = "%"
LAYER = "CUDA kernels (csrc/fused_step.cu through kernels/fused_step.py)"
MOVES = "mlups"
PASS = r"\bfused_pass_kernel\b"
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
                       phi_hx=True) / ctx.bandwidth
    return 100.0 * bound / took
