"""The row-staged shard pass's index rules (csrc/fused_step.cu
`fused_pass_rows_kernel`, `stage_rows`, `RowStaged`), mirrored in numpy on
the CPU, where no kernel runs.

A block is B nodes of one plane (B = kThreads = 128 in the kernel): B / TW
row segments of TW nodes (TW = 128, or 64 on a 64-wide shard).  For each
(field, direction) slot and each segment it copies one source row segment
with the value left and right of it into shared memory, then thread t
reads its pulled value at its x shifted by -ex.

- The gather: a mirror of which buffer (the shard's post-collision set,
  the y-neighbours' rows lo / hi, a pencil's x-neighbour columns xlo /
  xhi, the local wrap, a scalar wall node's own row of direction opp(d))
  and which offset each (field, direction, block row, segment position)
  is copied from, where in the slot it lands, and which place thread t
  reads at -ex, gathers a seeded post-collision set equal to
  `stream_bc_reference(rows=, cols=)` bit for bit (f64), with B and TW
  parameters so that small grids take the kernel's rules: cases C
  (zerograd-top, D3Q7 scalars), I (injection with Joule heating) and F
  (thermal without EK), on slab 2, slab 4, pencil 2x2, pencil 2x3 (its
  uneven cut of a shard's rows over x in the solve) and pencil 2x4 (two
  rows a block, as the 64-wide shards).
- The slot layout at the kernel's B = 128: every segment's 16-byte pieces
  land once, aligned, the lanes of each warp cover its slots, the two
  halo values of a segment land where the shifted reads find them and
  nowhere else, and the launcher's shared memory fits 4 blocks an SM in
  f32 (57,344 B) and 2 in f64 (115,712 B) for all 36 (QF, QS, ek, nspec,
  thermal) combinations.
- The host's choice of path (`shard_pass_tile`, `_shard_tile`) by shape
  and alignment.
- The kernel's run-time direction table `kRowDir` is dir_e's, edge_slot's
  and x_slot's.
"""
import functools
import re

import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (one torch thread per worker)
from test_torch_common import CASES
from test_torch_pull_tables import (_combos, _dir_table, _opp, _source,
                                    _wall_rule)

THREADS = 128                        # kThreads: a block's nodes
STRIDE = THREADS + 4                 # kRowsStride
SMEM_BLOCKS = {4: 57344, 8: 115712}  # the most a block may ask, 4 / 2 an SM
FIELDS = ("f", "h", "hn", "g")
# mesh: (shards, pencil, global NX): local NX 16 (slab), 8 (pencil 2x2,
# 2x3) and 4 (pencil 2x4: two rows a block at B = 8)
MESHES = {"slab2": (2, False, 16), "slab4": (4, False, 16),
          "pencil2x2": (4, True, 16), "pencil2x3": (6, True, 24),
          "pencil2x4": (8, True, 16)}


def _table(name):
    body = re.search(rf"int {name}\(int d\) \{{.*?\{{(.*?)\}};", _source(),
                     re.S).group(1)
    return [int(v) for v in re.findall(r"-?\d+", body)]


@functools.lru_cache(maxsize=None)
def _row_dir():
    """The kernel's kRowDir, (27, 5)."""
    body = re.search(r"kRowDir\[27\]\[5\] = \{(.*?)\}\};", _source(),
                     re.S).group(1)
    return np.array([int(v) for v in re.findall(r"-?\d+", body)]).reshape(
        27, 5)


_directions = functools.lru_cache(maxsize=None)(_dir_table)


def test_run_time_direction_table():
    """kRowDir[d] = (ex, ey, ez, edge_slot(d), x_slot(d))."""
    want = np.concatenate([_dir_table(), np.array(_table("edge_slot"))[:, None],
                           np.array(_table("x_slot"))[:, None]], axis=1)
    assert np.array_equal(_row_dir(), want)


def _places(B, TW, r):
    """(left, right) of segment r in a slot: adjacent to the segment where
    the block is one segment, else at the slot's head."""
    if B == TW:
        return 3, 4 + B
    assert B == 2 * TW, "one or two segments a block"
    return 2 * r, 2 * r + 1


def _read_places(B, TW):
    """Per thread t, the place in a slot it reads at ex = +1, 0, -1 (not a
    wall node): the kernel's 4 + t - ex, or its segment's halo place."""
    t = np.arange(B)
    r, p = t // TW, t % TW
    if B == TW:
        return {1: 3 + t, 0: 4 + t, -1: 5 + t}
    return {1: np.where(p == 0, 2 * r, 3 + t), 0: 4 + t,
            -1: np.where(p == TW - 1, 2 * r + 1, 5 + t)}


def _staged_field(cfg, k, post, rows, cols, B, TW):
    """Field k of a shard pulled as fused_pass_rows_kernel pulls it, with
    B nodes a block and segments of TW: each slot's copies (source buffer,
    offset, place), then each thread's read.  Also checks that every read
    place was written once and that the 16-byte copies are aligned."""
    E, rd = _directions(), _row_dir()
    wneg, wadd, cbc = _wall_rule(cfg)
    nz, ny, nx = cfg.grid.shape
    plane, n = ny * nx, nz * ny * nx
    assert nx % TW == 0 and plane % B == 0
    q = post.shape[0]
    pencil = cols is not None
    lo, hi = rows
    xlo, xhi = cols if pencil else (np.zeros(1), np.zeros(1))
    rw, xoff = (nx + 2, 1) if pencil else (nx, 0)
    bufs = [a.reshape(-1) for a in (post, lo, hi, xlo, xhi)]
    S = B + 4
    nb = n // B
    n0 = np.arange(nb) * B
    z, q0 = n0 // plane, n0 % plane
    top = z == nz - 1
    zg = k in (1, 2) and cbc == 2
    wall = (k > 0) & ((z == 0) | top) & ~(zg & top)
    smem = np.full((nb, q * S + 1), np.nan)
    count = np.zeros(smem.shape, int)

    def gather(buf, idx):
        """values of buffer ids `buf` (nb,) at offsets idx (nb, m)"""
        out = np.empty(idx.shape)
        for b in np.unique(buf):
            sel = buf == b
            out[sel] = bufs[b][idx[sel]]
        return out

    def put(mask, place, buf, idx):
        at = np.ix_(np.nonzero(mask)[0], place)
        smem[at] = gather(buf[mask], idx[mask])
        count[at] += 1

    for d in range(q):
        ex, ey, ez = E[d]
        es, xs = rd[d, 3], rd[d, 4]
        raw = np.where(ez > 0, np.where(z == 0, nz - 1, z - 1),
                       np.where(ez < 0, np.where(top, 0, z + 1), z))
        zs = np.where(zg & (top | (raw == nz - 1)), nz - 2, raw)
        for r in range(B // TW):
            qr = q0 + r * TW
            y, x0 = qr // nx, qr % nx
            sy = y - ey
            yin = (sy >= 0) & (sy < ny)
            rowbuf = 1 if ey > 0 else 2
            in_row = d * n + zs * plane + sy * nx      # column 0 of post's row
            halo_row = (es * nz + zs) * rw + xoff      # column 0 of lo / hi's
            # the segment: the wall row of opp(d), the shard's row, or the
            # neighbour's; 16-byte pieces unless a pencil's row buffer
            buf = np.where(wall | yin, 0, rowbuf)
            start = np.where(wall, _opp(d) * n + z * plane + y * nx + x0,
                             np.where(yin, in_row, halo_row) + x0)
            vec = wall | yin | (not pencil)
            for vw in (2, 4):  # f64, f32: 16-byte pieces from 16-byte places
                if TW % vw == 0 and nx % vw == 0:
                    assert (start[vec] % vw == 0).all()
                    assert (4 + r * TW) % vw == 0 and S % vw == 0
            places = d * S + 4 + r * TW + np.arange(TW)
            put(np.ones(nb, bool), places, buf,
                start[:, None] + np.arange(TW))
            left, right = _places(B, TW, r)
            col = (xs * nz + zs) * ny + sy                   # xlo / xhi's
            end = x0 + TW == nx
            if ex > 0:  # x0 - 1
                ib = np.where(yin, np.where((x0 == 0) & pencil, 3, 0), rowbuf)
                ii = np.where(
                    yin, np.where(x0 > 0, start - 1,
                                  col if pencil else in_row + nx - 1),
                    np.where((x0 > 0) | pencil, start - 1, halo_row + nx - 1))
                put(~wall, [d * S + left], ib, ii[:, None])
            if ex < 0:  # x0 + TW
                ib = np.where(yin, np.where(end & pencil, 4, 0), rowbuf)
                ii = np.where(
                    yin, np.where(~end, start + TW, col if pencil else in_row),
                    np.where(~end | pencil, start + TW, halo_row))
                put(~wall, [d * S + right], ib, ii[:, None])
    assert count.max() == 1, "a place written twice"
    reads = _read_places(B, TW)
    s = np.where(z == 0, 0, 1)
    out = np.empty((q, n))
    for d in range(q):
        ex = E[d][0]
        place = d * S + np.where(wall[:, None], reads[0], reads[ex])
        assert (count[np.arange(nb)[:, None], place] == 1).all()
        v = smem[np.arange(nb)[:, None], place]
        # the wall rule on the read (Pulled::fix)
        kk = max(k - 1, 0)
        v = np.where(wall[:, None], (-v if wneg[kk] else v)
                     + wadd[kk, s, d][:, None], v)
        out[d] = v.reshape(-1)
    return out.reshape(post.shape)


def _cfg(case, nx):
    import ekpnp_torch

    name, ov = CASES[case]
    return ekpnp_torch.preset(name, **dict(ov, nx=nx, ny=16,
                                           fft_method="matmul",
                                           dtype="float64"))


@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("case", ["C", "I", "F"])
def test_row_staging_equals_the_shard_stream(case, mname):
    """Per shard and active field, the mirror's pulled set (B = 8, every
    TW in {8, 4} the shard's rows take: one segment of a row, two of one
    row, or two rows of the 4-wide pencil 2x4 shards) equals the plain
    shard stream with its edge rows (and a pencil's columns) bit for
    bit."""
    from ekpnp_torch.kernels import fused_step as fs
    from ekpnp_torch.parallel.halo import post_edges
    from ekpnp_torch.parallel.mesh import local_cfg, make_mesh

    shards, pencil, nx = MESHES[mname]
    cfg = _cfg(case, nx)
    mesh = make_mesh(["cpu"] * shards, pencil=pencil)
    cfg_l = local_cfg(cfg, mesh)
    qs = dict(fs._fields(cfg_l, with_phi=False))
    rng = np.random.default_rng(len(mname) * 31 + ord(case))
    posts = [tuple(torch.as_tensor(rng.standard_normal(
        (qs[f],) + cfg_l.grid.shape)) if f in qs else None for f in FIELDS)
        for _ in range(shards)]
    tiles = [(8, TW) for TW in (8, 4) if cfg_l.grid.nx % TW == 0]
    assert (cfg_l.grid.ny * cfg_l.grid.nx) % 8 == 0 and tiles
    for i, (rows, cols) in enumerate(post_edges(cfg_l, mesh, posts)):
        want = fs.stream_bc_reference(cfg_l, *posts[i], rows=rows, cols=cols)
        for k, a in enumerate(posts[i]):
            if a is None:
                continue
            r = tuple(t.numpy() for t in rows[k])
            c = tuple(t.numpy() for t in cols[k]) if cols is not None else None
            for B, TW in tiles:
                got = _staged_field(cfg_l, k, a.numpy(), r, c, B, TW)
                assert np.array_equal(got, want[k].numpy()), (
                    case, mname, i, FIELDS[k], B, TW)


def test_row_slot_layout():
    """At the kernel's B = 128, TW = 128 and 64, f32 and f64: warp w's
    lanes copy slots w, w + 4, ... (each segment's LPS = 32 TW / B lanes,
    NP = TW / VW pieces, the halo values by lanes LH = NP % LPS and RH =
    (NP + 1) % LPS); every interior place is copied once, 16-byte pieces
    aligned, each halo value once and to the place the shifted reads
    take; the places of different slots and segments do not meet; the
    launcher asks at most 57,344 B (f32) / 115,712 B (f64) of shared
    memory for all 36 combinations."""
    combos = list(_combos())
    assert len(combos) == 36
    for qf, qs, ek, nspec, thermal in combos:
        n = qf + (nspec * qs if ek else 0) + (qs if thermal else 0)
        for itemsize in (4, 8):
            assert (n * STRIDE + 1) * itemsize <= SMEM_BLOCKS[itemsize]
            vw = 16 // itemsize
            for TW in (128, 64):
                lps, npc = 32 * TW // THREADS, TW // vw
                lh, rh = npc % lps, (npc + 1) % lps
                hits = np.zeros(n * STRIDE + 1, int)
                halo = {}
                for w in range(THREADS // 32):
                    for s in range(w, n, THREADS // 32):
                        for lane in range(32):
                            r, sub = lane // lps, lane % lps
                            seg = s * STRIDE + 4 + r * TW
                            for i in range(sub, npc, lps):
                                assert (seg + i * vw) % vw == 0
                                hits[seg + i * vw:seg + (i + 1) * vw] += 1
                            left, right = _places(THREADS, TW, r)
                            if sub == lh:
                                halo[(s, r, 1)] = s * STRIDE + left
                            if sub == rh:
                                halo[(s, r, -1)] = s * STRIDE + right
                assert lh != rh and len(halo) == 2 * n * (THREADS // TW)
                for place in halo.values():
                    hits[place] += 1
                assert hits.max() == 1
                reads = _read_places(THREADS, TW)
                t = np.arange(THREADS)
                r, p = t // TW, t % TW
                for s in (0, n - 1):
                    for ex in (1, 0, -1):
                        want = np.where(
                            (p - ex >= 0) & (p - ex < TW),
                            s * STRIDE + 4 + t - ex,
                            [halo.get((s, ri, ex), -1) for ri in r])
                        assert np.array_equal(s * STRIDE + reads[ex], want)


def test_host_chooses_the_path():
    """shard_pass_tile: 128 where NX is a multiple of it, 64 where only of
    64, with whole 128-node blocks in a plane and 16-byte aligned
    pointers; else 0 (the per-node pass).  _shard_tile passes the fields
    and, on a slab, their edge rows (a pencil's rows are copied value by
    value), so a misaligned slab row takes the per-node pass and a
    misaligned pencil row does not."""
    from ekpnp_torch.kernels import fused_step as fs

    tile = fs.shard_pass_tile
    assert tile(64, 256) == 128       # slab 4 of 256^3
    assert tile(32, 256) == 128       # slab 8
    assert tile(128, 128) == 128      # pencil 2x2
    assert tile(128, 64) == 64        # pencil 2x3, 2x4: two rows a block
    assert tile(128, 192) == 64
    assert tile(3, 64) == 0           # a plane of 192 nodes
    assert tile(4, 50) == tile(8, 16) == tile(4, 8) == 0  # the cases' shards
    assert tile(64, 256, 0, 16, 4096) == 128
    assert tile(64, 256, 0, 8) == 0   # a pointer off 16 bytes
    cfg = _cfg("F", 256)
    from ekpnp_torch.parallel.mesh import local_cfg, make_mesh

    for pencil in (False, True):
        mesh = make_mesh(["cpu"] * 4, pencil=pencil)
        cfg_l = local_cfg(cfg, mesh)
        nz, ny, nx = cfg_l.grid.shape
        pops = [torch.zeros((27, nz, ny, nx), dtype=torch.float64)
                for _ in range(2)] + [None, torch.zeros(
                    (27, nz, ny, nx), dtype=torch.float64)]
        width = nx + 2 if pencil else nx
        rows = [(torch.zeros((9, nz, width), dtype=torch.float64),) * 2
                if a is not None else None for a in pops]
        cols = [(torch.zeros((9, nz, ny), dtype=torch.float64),) * 2
                if a is not None else None for a in pops] if pencil else None
        want = 128
        assert fs._shard_tile(cfg_l, pops, rows, cols) == want
        off = torch.zeros(9 * nz * width + 1, dtype=torch.float64)[1:]
        rows[0] = (off.view(9, nz, width), rows[0][1])
        assert fs._shard_tile(cfg_l, pops, rows, cols) == (want if pencil
                                                           else 0)
        pops[3] = torch.zeros(27 * nz * ny * nx + 1,
                              dtype=torch.float64)[1:].view(27, nz, ny, nx)
        assert fs._shard_tile(cfg_l, pops, rows, cols) == 0
