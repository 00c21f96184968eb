"""solve_ms: device milliseconds per step of every kernel launched in the
`chunk` spans that is not a collide, pass or stream kernel: the psi_hx
solve's GEMMs and element-wise work and the x-Hartley row products."""
UNIT = "ms"
LAYER = "Spectral solve (ops/poisson.py)"
MOVES = "mlups"
LBM = r"\b(collide_kernel|fused_pass\w*_kernel|stream_bc\w*_kernel)\b"


def read(ctx):
    if ctx.steps <= 0 or not ctx.trace.matching(r".", "chunk"):
        return None
    return ctx.trace.busy_in("chunk", exclude=LBM) * 1e-3 / ctx.steps
