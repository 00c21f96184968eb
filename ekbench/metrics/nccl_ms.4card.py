"""nccl_ms.4card: device milliseconds per step of NCCL kernels on process
0's card, their wait for the peers included (a NCCL kernel runs until
its message has crossed)."""
UNIT = "ms"
LAYER = "Collectives and processes (parallel/collectives.py, parallel/halo.py, parallel/fft.py)"
MOVES = "mlups_4card"
NCCL = r"(?i)nccl"


def read(ctx):
    ks = ctx.trace.matching(NCCL)
    if not ks or ctx.steps <= 0:
        return None
    return sum(k[2] for k in ks) * 1e-3 / ctx.steps
