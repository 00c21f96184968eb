"""The index rules of the collide and stream kernels (csrc/fused_step.cu),
mirrored in numpy on the CPU, where no kernel runs.

- The pull tables: a mirror of `PullSrc::view` (the source plane, row and
  column offsets by ez + 1, ey + 1, ex + 1, the scalar wall flag with the
  wall rule's `wneg` / `wadd` from `pack_constants`, the zerograd-top
  substitution) gathers a seeded post-collision set into every node equal
  to `stream_bc_reference` bit for bit, on cases A-J and the reference's
  50x8x51, f64.  `stream_bc_kernel` reads through these tables: one value
  a direction where NX is no multiple of its vector width, else
  (`stream_field`, W > 1) the W values at x of the source row, the value
  it lacks across x from the neighbour lane or, at a warp's or a row's
  end, loaded; that lane rule is mirrored too, for W = 4 (f32) and 2
  (f64).
- The collide's slot layout (`slot_base`, `slot_count`, `stage_block`,
  the launcher's `slots_of`): every active population of every (QF, QS,
  ek, nspec, thermal) combination the kernels are built for has a slot of
  its own, the block's copy fills each slot once, its 16-byte pieces are
  aligned, and the layout fits the dynamic shared memory the launcher
  requests.
The kernel's direction table and lattice pairs are read from the source.
"""
import re

import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (one torch thread per worker)
from test_torch_common import CASES

ALL_CASES = dict(CASES, ref50=("reference", {}))
THREADS = 128           # kThreads
SMEM_MAX = 232448       # dynamic shared memory a block may have (sm_90)
FIELDS = ("f", "h", "hn", "g")


def _source():
    from ekpnp_torch.kernels import fused_step as fs

    with open(fs.SOURCE) as fh:
        return fh.read()


def _dir_table():
    """The kernel's dir_e table, (27, 3) as (ex, ey, ez)."""
    body = re.search(r"int dir_e\(int d, int a\) \{.*?\{(.*?)\};", _source(),
                     re.S).group(1)
    vals = [int(v) for v in re.findall(r"-?\d+", body)]
    return np.array(vals).reshape(27, 3)


def _opp(d):
    """dir_opp."""
    return 0 if d == 0 else (d + 1 if d & 1 else d - 1)


def _cfg(case):
    import ekpnp_torch

    name, ov = ALL_CASES[case]
    return ekpnp_torch.preset(name, **dict(ov, dtype="float64"))


def _wall_rule(cfg):
    """(wneg[3], wadd[3, 2, 27]) as the kernels receive them."""
    from ekpnp_torch.kernels import fused_step as fs

    ints, consts = fs.pack_constants(cfg)
    iv = dict(zip(fs._INTS, ints))
    wneg = [iv["wneg_h"], iv["wneg_hn"], iv["wneg_g"]]
    return wneg, consts[-3 * 2 * 27:].reshape(3, 2, 27), iv["cbc"]


def _pull_tables(cfg, k, z, y, x):
    """PullSrc::view at nodes (z, y, x) of field k (0 f, 1 h, 2 hn, 3 g):
    (zo, yo, xo, wall, s), the offsets indexed by ez + 1, ey + 1, ex + 1."""
    nz, ny, nx = cfg.grid.shape
    plane = ny * nx
    cbc = _wall_rule(cfg)[2]
    top = z == nz - 1
    zg = k in (1, 2) and cbc == 2
    wall = (k > 0) & ((z == 0) | top) & ~(zg & top)
    s = np.where(z == 0, 0, 1)
    zs = (np.where(top, 0, z + 1), z, np.where(z == 0, nz - 1, z - 1))
    zo = [np.where(zg & (top | (zi == nz - 1)), nz - 2, zi) * plane
          for zi in zs]
    yo = [np.where(y == ny - 1, 0, y + 1) * nx, y * nx,
          np.where(y == 0, ny - 1, y - 1) * nx]
    xo = [np.where(x == nx - 1, 0, x + 1), x, np.where(x == 0, nx - 1, x - 1)]
    return zo, yo, xo, wall, s


def _fix(cfg, k, d, v, wall, s):
    """Pulled::fix: the wall rule on the value read."""
    wneg, wadd, _ = _wall_rule(cfg)
    kk = max(k - 1, 0)
    return np.where(wall, (-v if wneg[kk] else v) + wadd[kk, s, d], v)


def _pulled(cfg, k, post):
    """The field streamed by the tables, one value a direction (W = 1)."""
    E = _dir_table()
    q, n = post.shape[0], post[0].size
    flat = post.reshape(-1)
    z, y, x = (a.reshape(-1) for a in np.indices(cfg.grid.shape))
    idx = np.arange(n)
    zo, yo, xo, wall, s = _pull_tables(cfg, k, z, y, x)
    out = np.empty((q, n))
    for d in range(q):
        ex, ey, ez = E[d]
        src = np.where(wall, _opp(d) * n + idx,
                       d * n + zo[ez + 1] + yo[ey + 1] + xo[ex + 1])
        out[d] = _fix(cfg, k, d, flat[src], wall, s)
    return out.reshape(post.shape)


def _pulled_vec(cfg, k, post, w):
    """The field streamed as stream_field<W> streams it: thread g owns the
    w nodes g w .. g w + w - 1 of a row and loads the w values at its x of
    each source row; ex = +1 takes lane - 1's last value (the neighbour's
    16-byte load), ex = -1 lane + 1's first, unless the thread is lane 0 /
    31 of its warp or its x is the row's first / last: then it loads the
    value (the wrap).  A scalar's wall thread keeps its load (the opposite
    direction at its own nodes)."""
    E = _dir_table()
    nz, ny, nx = cfg.grid.shape
    q, n = post.shape[0], post[0].size
    flat = post.reshape(-1)
    g = np.arange(n // w)
    idx, lane = g * w, g % 32  # 128-thread blocks: lane = g mod 32
    z, y, x = idx // (ny * nx), (idx // nx) % ny, idx % nx
    zo, yo, _, wall, s = _pull_tables(cfg, k, z, y, x)
    xm = np.where(x == 0, nx - 1, x - 1)
    xp = np.where(x + w == nx, 0, x + w)
    out = np.empty((q, n))
    for d in range(q):
        ex, ey, ez = E[d]
        row = d * n + zo[ez + 1] + yo[ey + 1]
        a = flat[np.where(wall, _opp(d) * n + idx, row + x)[:, None]
                 + np.arange(w)]
        o = a
        if ex != 0:
            up = ex > 0
            own = (lane == 0) | (x == 0) if up else (lane == 31) | (xp == 0)
            # the shuffle's end lanes always load: np.roll's wrap is unused
            assert own[0 if up else -1]
            e = np.roll(a[:, -1] if up else a[:, 0], 1 if up else -1)
            e[own] = flat[row[own] + (xm if up else xp)[own]]
            shifted = (np.concatenate([e[:, None], a[:, :-1]], 1) if up
                       else np.concatenate([a[:, 1:], e[:, None]], 1))
            o = np.where(wall[:, None], a, shifted)
        out[d] = _fix(cfg, k, d, o, wall[:, None], s[:, None]).reshape(-1)
    return out.reshape(post.shape)


def _post_set(cfg, seed):
    """A seeded post-collision set (f, h, hn, g; None where inactive)."""
    from ekpnp_torch.kernels import fused_step as fs

    rng = np.random.default_rng(seed)
    qs = dict(fs._fields(cfg, with_phi=False))
    return tuple(rng.standard_normal((qs[f],) + cfg.grid.shape)
                 if f in qs else None for f in FIELDS)


def _reference(cfg, post):
    from ekpnp_torch.kernels import fused_step as fs

    t = [None if a is None else torch.as_tensor(a) for a in post]
    return [None if a is None else a.numpy() for a in
            fs.stream_bc_reference(cfg, *t)]


def test_kernel_direction_table_is_the_lattice():
    """dir_e is D3Q27's E (D3Q19, D3Q7 its prefixes) and dir_opp reverses
    each direction."""
    from ekpnp_torch.lattice import get_lattice

    E = _dir_table()
    for name in ("D3Q27", "D3Q19", "D3Q7"):
        lat = get_lattice(name)
        assert np.array_equal(lat.E, E[: lat.Q])
    for d in range(27):
        assert np.array_equal(E[_opp(d)], -E[d])


@pytest.mark.parametrize("case", list(ALL_CASES))
def test_pull_tables_equal_the_stream(case):
    """The tables, one value a direction, equal the plain stream with its
    wall BCs bit for bit."""
    cfg = _cfg(case)
    post = _post_set(cfg, seed=len(case) * 7 + ord(case[0]))
    want = _reference(cfg, post)
    for k, (a, b) in enumerate(zip(post, want)):
        if a is None:
            assert b is None
            continue
        assert np.array_equal(_pulled(cfg, k, a), b), (case, FIELDS[k])


@pytest.mark.parametrize("case", list(ALL_CASES))
def test_vector_lanes_equal_the_stream(case):
    """The 16-byte path's lane rule (W = 4 in f32, 2 in f64, where NX is
    a multiple of W) equals the plain stream bit for bit; at NX = 10 and
    50 the f32 kernel takes the W = 1 path."""
    cfg = _cfg(case)
    nx = cfg.grid.nx
    post = _post_set(cfg, seed=len(case) * 11 + ord(case[0]))
    want = _reference(cfg, post)
    widths = [w for w in (4, 2) if nx % w == 0]
    assert widths == ([4, 2] if nx % 4 == 0 else [2])
    for w in widths:
        for k, (a, b) in enumerate(zip(post, want)):
            if a is not None:
                assert np.array_equal(_pulled_vec(cfg, k, a, w), b), (
                    case, w, FIELDS[k])


def _pairs():
    """EKPNP_LATTICE_PAIRS: the (QF, QS) the kernels are built for."""
    body = re.search(r"#define EKPNP_LATTICE_PAIRS\(X\)(.*?)\n\n", _source(),
                     re.S).group(1)
    return [tuple(map(int, p)) for p in re.findall(r"X\((\d+), (\d+)\)", body)]


def _combos():
    for qf, qs in _pairs():
        for ek in (0, 1):
            for nspec in ((1, 2) if ek else (0,)):
                for thermal in (0, 1):
                    yield qf, qs, ek, nspec, thermal


def test_collide_slot_layout():
    """slot_base gives each active population its own slot, slot_count
    (the kernel) and slots_of (the launcher) count them alike,
    stage_block's pieces fill every slot once, from the right field and
    direction, 16-byte aligned where it copies 16-byte pieces, and the
    shared memory the launcher requests fits a block."""
    combos = list(_combos())
    assert len(_pairs()) == 6 and len(combos) == 6 * 6
    for qf, qs, ek, nspec, thermal in combos:
        nh, nhn = (qs if ek else 0), (qs if nspec == 2 else 0)
        base = (0, qf, qf + nh, qf + nh + nhn)           # slot_base
        active = [(0, d) for d in range(qf)]
        active += [(k, d) for k, on in ((1, ek), (2, nspec == 2),
                                        (3, thermal)) if on
                   for d in range(qs)]
        slots = sorted(base[k] + d for k, d in active)
        count = base[3] + (qs if thermal else 0)         # slot_count
        launcher = qf + (nspec * qs if ek else 0) + (qs if thermal else 0)
        assert slots == list(range(count)) and count == launcher
        for itemsize in (4, 8):
            assert launcher * THREADS * itemsize <= SMEM_MAX
            for w in (1, 16 // itemsize):
                per = THREADS // w
                filled = np.zeros((count, THREADS), int)
                n = 20400  # 50x8x51: a multiple of w, no multiple of 128
                n0 = (n // THREADS) * THREADS  # the last, partial block
                for c in range(count * per):
                    s, j = c // per, (c % per) * w
                    k = 0 if s < qf else (1 if s < base[2] else
                                          (2 if s < base[3] else 3))
                    d = s - base[k]
                    assert (k, d) in active and base[k] + d == s
                    assert (d * n + n0 + j) % w == 0  # 16-byte pieces
                    filled[s, j:j + w] += 1
                assert (filled == 1).all()
