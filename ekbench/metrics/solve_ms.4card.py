"""solve_ms.4card: solve_ms on process 0's card of the pod, NCCL kernels
left out too (they are nccl_ms.4card's)."""
UNIT = "ms"
LAYER = "Spectral solve (ops/poisson.py)"
MOVES = "mlups_4card"
LBM = r"\b(collide_kernel|fused_pass\w*_kernel|stream_bc\w*_kernel)\b|nccl"


def read(ctx):
    if ctx.steps <= 0 or not ctx.trace.matching(r".", "chunk"):
        return None
    return ctx.trace.busy_in("chunk", exclude=LBM) * 1e-3 / ctx.steps
