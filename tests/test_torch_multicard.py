"""The port's sharded time loop with its shards on several cards: peer
copies between cards in the collectives, one side stream per card for the
overlapped post-row exchange, the kernels launched on each shard's card.
Each run is held to the same mesh with every shard on one card, and the
overlapped chunk to the serial one.  Needs 4 CUDA devices and skips
otherwise; on a machine with them:

    python -m pytest --noconftest -q tests/test_torch_multicard.py

(--noconftest: the repo's conftest imports JAX, which none of this needs.)
"""
import os
import subprocess
import sys

import pytest
import torch

pytestmark = pytest.mark.skipif(
    torch.cuda.device_count() < 4,
    reason="needs 4 CUDA devices (the shards on several cards)")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (preset, overrides), f64: A runs the phi_hx .halo route on the slab and
# shard_x on the pencil; C adds D3Q7 scalars and zerograd-top (the
# pencil's column repair of the ions' top plane)
CASES = {"A": ("reference", dict(nx=16, ny=16, nz=9)),
         "C": ("reference", dict(nx=16, ny=32, nz=9,
                                 charge_bc="zerograd-top",
                                 scalar_lattice="D3Q7"))}
STEPS = 4


def _run(cfg, devices, pencil, state, overlap=True):
    """STEPS sharded steps of `state` on a mesh over `devices`; the
    gathered state on cuda:0 and the launch counts."""
    from ekpnp_torch.kernels import fused_step as fs
    from ekpnp_torch.parallel.mesh import (gather_state, make_mesh,
                                           make_sharded_multi_step,
                                           shard_state)

    mesh = make_mesh(devices, pencil=pencil)
    sh = shard_state(cfg, mesh, state)
    fs.reset_launches()
    out = make_sharded_multi_step(cfg, mesh, STEPS, overlap=overlap)(sh)
    torch.cuda.synchronize()
    counts = {k: v for k, v in fs.launches.items() if v}
    return gather_state(mesh, out, device=torch.device("cuda", 0)), counts


@pytest.mark.parametrize("pencil", [False, True], ids=["slab4", "pencil2x2"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_shards_on_four_cards_match_one_card(case, pencil):
    """Shards on cuda:0-3 equal the same mesh stacked on cuda:0, max|d| /
    max|ref| <= 1e-12 per field (f64), with the chunk's launches of the
    route's forms (per shard a collide, a fused pass for every other step
    and a stream, and the row products) on each; the overlapped chunk
    equals the serial one bit for bit."""
    import ekpnp_torch
    from ekpnp_torch.init import initialize
    from ekpnp_torch.parallel.mesh import mesh_devices

    name, ov = CASES[case]
    cfg = ekpnp_torch.preset(name, dtype="float64", **ov)
    state, _ = initialize(cfg, device="cuda:0")
    cards = mesh_devices(torch.device("cuda"), 4)
    assert sorted(d.index for d in cards) == [0, 1, 2, 3]
    clone = lambda s: s.__class__(*(None if a is None else a.clone()
                                    for a in s))
    want, n1 = _run(cfg, [torch.device("cuda", 0)] * 4, pencil, clone(state))
    got, n4 = _run(cfg, cards, pencil, clone(state))
    serial, _ = _run(cfg, cards, pencil, clone(state), overlap=False)
    # one chunk: per shard one collide, STEPS - 1 fused passes and one
    # stream; the slab's phi_hx .halo route adds four row products per
    # shard and step (psi, its two halo rows, the RHS)
    want_n = ({"collide_kernel.shard_x": 4,
               "fused_pass_kernel.shard_x": 4 * (STEPS - 1)} if pencil else
              {"collide_kernel.phi_hx.halo": 4,
               "fused_pass_kernel.phi_hx.halo": 4 * (STEPS - 1),
               "hartley_rows_kernel": 16 * STEPS})
    want_n["stream_bc_kernel.halo"] = 4
    assert n1 == n4 == want_n
    for k in ("f", "h", "hn", "g", "phi"):
        a, b, c = getattr(got, k), getattr(want, k), getattr(serial, k)
        if b is None:
            assert a is None and c is None, k
            continue
        assert torch.isfinite(a).all(), k
        err = float((a - b).abs().max() / b.abs().max())
        assert err <= 1e-12, (k, err)
        assert torch.equal(a, c), k


def test_cli_mesh_over_four_cards(tmp_path):
    """`run reference --mesh slab --mesh-devices 4` places a shard on each
    card; `merge` then writes the data.dat; the series equals the same run
    with every shard on one card (CUDA_VISIBLE_DEVICES=0) to 1e-12."""
    rows = {}
    for label, visible in (("cards", None), ("one", "0")):
        env = dict(os.environ, OMP_NUM_THREADS="1")
        if visible is not None:
            env["CUDA_VISIBLE_DEVICES"] = visible
        out = tmp_path / label
        for args in (["run", "reference", "--steps", "10", "--mesh", "slab",
                      "--mesh-devices", "4", "--outdir", str(out)],
                     ["merge", "reference", str(out)]):
            p = subprocess.run([sys.executable, "-m", "ekpnp_torch", *args],
                               cwd=ROOT, env=env, capture_output=True,
                               text=True, timeout=600)
            assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
        assert (out / "data.dat").exists()
        rows[label] = [[float(v) for v in line.split(",")] for line in
                       (out / "series.csv").read_text().splitlines()[1:]]
    assert len(rows["cards"]) == len(rows["one"]) > 0
    for a, b in zip(rows["cards"], rows["one"]):
        for x, y in zip(a, b):
            assert abs(x - y) <= 1e-12 * max(abs(y), 1e-300), (a, b)
