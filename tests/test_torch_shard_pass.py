"""The sharded time loop cut at the stream (`parallel.halo.make_halo_multi_step`:
per shard one collide, n - 1 fused passes that pull across the shard's
edges, one stream), on the CPU, shards in one process, where every launch
runs its plain version (`fused_pass` with edge rows / columns runs
`fused_pass_reference`).

- The chunk equals n two-launch sharded steps (`step_halo`: a collide and
  a stream per step and shard) bit for bit in f64, for n = 1, 2, 3, on
  slab 2, slab 4 and pencil 2x2, on zerograd-top with D3Q7 scalars (C),
  injection with Joule heating (I) and a thermal case without EK (F).
  The JAX GSPMD oracle holds the chunk through tests/test_torch_sharding.py.
- Pencil corners: a diagonal direction pulled into a shard's corner node
  across its exchanged rows (widened by the columns) is the unsharded
  stream's value there.
- The kernel's x-slot table is the order of the exchanged columns.
- The donated buffers: with each launch writing into the set it is given,
  as on the card, no launch writes a set it reads, and a second chunk on
  the first one's output still equals its steps.
- The overlapped chunk equals the serial one bit for bit.
"""
import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (one torch thread per worker)
from test_torch_common import CASES, make_state_np, port_state
from test_torch_fused_pass import _card_like

MESHES = {"slab2": (2, False), "slab4": (4, False), "pencil2x2": (4, True)}
FIELDS = ("f", "h", "hn", "g", "phi")
STEPS = 3


def _cfg(case):
    """The port config of a case, f64, y at least 16 (4-row shards on
    slab 4), the Hartley solve."""
    import ekpnp_torch

    name, ov = CASES[case]
    return ekpnp_torch.preset(name, **dict(ov, ny=max(16, ov["ny"]),
                                           fft_method="matmul",
                                           dtype="float64"))


def _mesh(name):
    from ekpnp_torch.parallel.mesh import make_mesh

    n, pencil = MESHES[name]
    return make_mesh(["cpu"] * n, pencil=pencil)


def _sharded(cfg, mesh, arrays):
    """A fresh sharded state (copies: shard_state copies each block)."""
    from ekpnp_torch.parallel.mesh import shard_state

    return shard_state(cfg, mesh, port_state(cfg, arrays))


def _two_launch(cfg, mesh, state, n):
    """n `step_halo` steps of a sharded state on the route the chunk takes:
    phi_hx (one encode, the steps, one decode) where the shard can carry
    psi_hx, else real phi; the sharded state after each step (with real
    phi)."""
    from ekpnp_torch.kernels.step import phi_hx_capable
    from ekpnp_torch.ops.poisson import phi_from_psi_hx, psi_hx_from_phi
    from ekpnp_torch.parallel.halo import step_halo
    from ekpnp_torch.parallel.mesh import local_cfg

    hx = not mesh.pencil and phi_hx_capable(local_cfg(cfg, mesh))
    if hx:
        state = state._replace(phi=psi_hx_from_phi(cfg, state.phi, mesh))
    out = []
    for _ in range(n):
        state = step_halo(cfg, mesh, state, phi_hx=hx)
        st = state
        if hx:
            st = st._replace(phi=phi_from_psi_hx(cfg, st.phi, mesh))
        out.append(st)
    return out


def _equal(a, b, label):
    for k in FIELDS + ("t",):
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), f"{label}{k}"
        assert x is None or torch.equal(x, y), f"{label}{k}"


@pytest.mark.parametrize("case", ["C", "I", "F"])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_chunk_equals_two_launch_steps(case, name):
    """n = 1, 2, 3: the chunk (one collide, n - 1 passes, one stream per
    shard) equals n `step_halo` steps bit for bit, f64."""
    from ekpnp_torch.kernels import fused_step as fs
    from ekpnp_torch.parallel.halo import make_halo_multi_step
    from ekpnp_torch.parallel.mesh import gather_state

    cfg = _cfg(case)
    mesh = _mesh(name)
    arrays = make_state_np(cfg, seed=41)
    want = _two_launch(cfg, mesh, _sharded(cfg, mesh, arrays), STEPS)
    before = dict(fs.launches)
    for n in range(1, STEPS + 1):
        got = make_halo_multi_step(cfg, mesh, n)(_sharded(cfg, mesh, arrays))
        _equal(gather_state(mesh, got), gather_state(mesh, want[n - 1]),
               f"{case} {name} n={n}: ")
    assert fs.launches == before  # CPU tensors launch nothing


def test_kernel_x_slots_are_the_exchanged_columns():
    """The pass kernel's x_slot table (csrc/fused_step.cu) gives each
    direction its row in the exchanged columns: its place in
    `edge_dirs(lat, ex, axis=0)`, on every lattice."""
    import re

    from ekpnp_torch.kernels import fused_step as fs
    from ekpnp_torch.lattice import get_lattice

    with open(fs.SOURCE) as fh:
        src = fh.read()
    body = re.search(r"int x_slot\(int d\) \{.*?\{(.*?)\};", src,
                     re.S).group(1)
    tab = [int(v) for v in body.replace("\n", " ").split(",")]
    assert len(tab) == 27
    for name in ("D3Q27", "D3Q19", "D3Q7"):
        lat = get_lattice(name)
        for ex in (1, -1):
            dirs = fs.edge_dirs(lat, ex, axis=0)
            assert len(dirs) == {27: 9, 19: 5, 7: 1}[lat.Q]
            assert [tab[d] for d in dirs] == list(range(len(dirs)))


@pytest.mark.parametrize("case", ["A", "C"])
def test_pencil_corners_pull_the_diagonal_shard(case):
    """On pencil 2x2, the pass's stream (`stream_bc_reference` with the
    rows and columns of `post_edges`) equals the unsharded stream of the
    gathered post-collision set everywhere, and at each shard's four corner
    nodes every diagonal direction (ex != 0 and ey != 0) holds the value
    the unsharded stream pulls there, which lies on the diagonal shard."""
    from ekpnp_torch.kernels import fused_step as fs
    from ekpnp_torch.parallel.halo import post_edges
    from ekpnp_torch.parallel.mesh import (gather_field, local_cfg,
                                           shard_field)

    cfg = _cfg(case)
    mesh = _mesh("pencil2x2")
    cfg_l = local_cfg(cfg, mesh)
    st = port_state(cfg, make_state_np(cfg, seed=42))
    # a post-collision set of random values: every pull is told apart
    rng = np.random.default_rng(43)
    post = [None if a is None else torch.as_tensor(
        rng.standard_normal(tuple(a.shape))) for a in st[:4]]
    want = fs.stream_bc_reference(cfg, *post)
    shards = [tuple(None if a is None else shard_field(cfg, mesh, a)[i]
                    for a in post) for i in range(mesh.size)]
    edges = post_edges(cfg_l, mesh, shards)
    got = [fs.stream_bc_reference(cfg_l, *p, rows=r, cols=c)
           for p, (r, c) in zip(shards, edges)]
    nyl, nxl = cfg_l.grid.ny, cfg_l.grid.nx
    lats = (cfg.lattice,) + (cfg.scalar_lat,) * 3
    for k, lat in enumerate(lats):
        if want[k] is None:
            continue
        whole = gather_field(mesh, [g[k] for g in got])
        assert torch.equal(whole, want[k]), k
        diag = [d for d in range(lat.Q) if lat.E[d][0] and lat.E[d][1]]
        for i in range(mesh.size):
            y0, _, x0, _ = mesh.block(cfg, i)
            for y, x in ((0, 0), (0, nxl - 1), (nyl - 1, 0),
                         (nyl - 1, nxl - 1)):
                a = got[i][k][diag, 1:-1, y, x]
                b = want[k][diag, 1:-1, y0 + y, x0 + x]
                assert torch.equal(a, b), (k, i, y, x)


@pytest.mark.parametrize("name", ["slab2", "pencil2x2"])
def test_donated_buffers_leave_the_returned_state_intact(name, monkeypatch):
    """With every launch writing into the set it is given (each shard's
    donated input set and one more), the chunk never writes a set it still
    reads and never returns one it overwrote: for n = 1, 2, 3 it equals n
    `step_halo` steps bit for bit, and so does a second chunk of 2 on the
    first one's output, which it donates in turn (against 2 more steps
    from the n steps' state: on the phi_hx route a chunk boundary decodes
    and encodes psi, which is exact only to roundoff)."""
    from ekpnp_torch.kernels import fused_step as fs
    from ekpnp_torch.parallel import halo
    from ekpnp_torch.parallel.mesh import gather_state

    cfg = _cfg("C")
    mesh = _mesh(name)
    arrays = make_state_np(cfg, seed=44)
    want = _two_launch(cfg, mesh, _sharded(cfg, mesh, arrays), STEPS)
    more = [_two_launch(cfg, mesh, w, 2)[-1] for w in want]
    card = {fn: _card_like(getattr(fs, fn), "post" if fn == "collide" else "out")
            for fn in ("collide", "fused_pass", "stream_bc")}
    for fn_name, fn in card.items():
        monkeypatch.setattr(halo.fs, fn_name, fn)
    for n in range(1, STEPS + 1):
        got = halo.make_halo_multi_step(cfg, mesh, n)(
            _sharded(cfg, mesh, arrays))
        _equal(gather_state(mesh, got), gather_state(mesh, want[n - 1]),
               f"{name} n={n}: ")
        again = halo.make_halo_multi_step(cfg, mesh, 2)(got)
        _equal(gather_state(mesh, again), gather_state(mesh, more[n - 1]),
               f"{name} n={n} + 2: ")


@pytest.mark.parametrize("name", sorted(MESHES))
def test_overlapped_chunk_equals_serial(name):
    """The exchange on a side stream during the solve (overlap=True) gives
    the serial chunk's state bit for bit."""
    from ekpnp_torch.parallel.halo import make_halo_multi_step
    from ekpnp_torch.parallel.mesh import gather_state

    cfg = _cfg("I")
    mesh = _mesh(name)
    arrays = make_state_np(cfg, seed=45)
    a, b = (gather_state(mesh, make_halo_multi_step(cfg, mesh, STEPS,
                                                    overlap=ov)(
        _sharded(cfg, mesh, arrays))) for ov in (True, False))
    _equal(a, b, f"{name}: ")
