"""idle_loop_pct: the share of the traced window in which the card idled
while the host was inside the program's time loop: the window's idle gaps
(`ctx.trace.gaps`) that began while the host was inside one of the
program's `ekpnp_torch.chunk` or `ekpnp_torch.series` spans (their
children lie inside them), over the window.  The rest of idle_pct began
in the harness: its writer queue, its snapshots, the drain.

The program stamps its spans by the host's time.time_ns(), the trace
counts from a base of its own: each program chunk begins a few
microseconds after the harness's `chunk` span that called it, so the
least difference between the two, chunk by chunk in order, maps the
program's stamps onto the trace (`offset`).  None where the program keeps
no records (no `ekpnp_torch.telemetry`) or the trace shows no chunk's
launches."""
import bisect

UNIT = "%"
LAYER = "Device"
MOVES = "mlups"
LOOP = ("ekpnp_torch.chunk", "ekpnp_torch.series")
OUTSIDE = "outside the program's spans"


def offset(trace, records):
    """Program stamp less trace time, in microseconds, or None where the
    program's chunks and the harness's do not pair up one to one."""
    harness = sorted({k[4] for k in trace.kernels
                      if k[3] == "chunk" and k[4] is not None})
    mine = [r.start_us for r in records if r.name == LOOP[0]]
    if not harness or len(harness) != len(mine):
        return None
    return min(p - h for p, h in zip(mine, harness))


def _merged(spans):
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def in_loop_us(trace, records, off) -> float:
    """Microseconds of the gaps that began inside a LOOP span."""
    spans = _merged((r.start_us - off, r.end_us - off) for r in records
                    if r.name in LOOP)
    starts = [s for s, _ in spans]
    total = 0.0
    for s, e in trace.gaps:
        i = bisect.bisect_right(starts, s)
        if i and s <= spans[i - 1][1]:
            total += e - s
    return total


def by_span(trace, records, off) -> dict:
    """{innermost program span the host was in when a gap began: gap
    microseconds}, the gaps in no program span under OUTSIDE.  The spans
    of one thread nest, so the innermost one holding a time is the latest
    to begin before it or one of that span's ancestors."""
    recs = sorted(records, key=lambda r: r.start_us)
    starts = [r.start_us - off for r in recs]
    out = {}
    for s, e in trace.gaps:
        i = bisect.bisect_right(starts, s) - 1
        rec = recs[i] if i >= 0 else None
        while rec is not None and rec.end_us - off < s:
            rec = rec.parent
        name = OUTSIDE if rec is None else rec.name
        out[name] = out.get(name, 0.0) + (e - s)
    return out


def read(ctx):
    try:
        from ekpnp_torch import telemetry
    except ImportError:
        return None
    recs = telemetry.records()
    off = offset(ctx.trace, recs)
    if off is None or ctx.trace.window_us <= 0:
        return None
    return 100.0 * in_loop_us(ctx.trace, recs, off) / ctx.trace.window_us
