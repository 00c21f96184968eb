"""The port's sharded time loop over several processes on cards: min(4,
cards) processes under NCCL, one card each, drive a 4-shard mesh (cases A
and C of test_torch_multicard.py, slab 4 and pencil 2x2, f64, 4 steps)
and each run is held to the same mesh driven by one process over the same
cards (peer copies).  Needs 2 CUDA devices and skips otherwise; on a
machine with them:

    python -m pytest --noconftest -q -rA tests/test_torch_distributed_cards.py

(--noconftest: the repo's conftest imports JAX, which none of this needs.)
The file is also its own worker: `python tests/test_torch_distributed_cards.py
<rank> <world> <store> <out>`.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (preset, overrides), f64, as test_torch_multicard.py's: A runs the phi_hx
# .halo route on the slab and shard_x on the pencil; C adds D3Q7 scalars
# and zerograd-top (the pencil's column repair of the ions' top plane)
CASES = {"A": ("reference", dict(nx=16, ny=16, nz=9)),
         "C": ("reference", dict(nx=16, ny=32, nz=9,
                                 charge_bc="zerograd-top",
                                 scalar_lattice="D3Q7"))}
RUNS = [(c, p) for c in sorted(CASES) for p in (False, True)]
STEPS = 4
SHARDS = 4
TIMEOUT = 600  # seconds, the launch


def _start(cfg):
    """The seeded numpy start of test_torch_common, on the CPU."""
    from test_torch_common import make_state_np, port_state

    return port_state(cfg, make_state_np(cfg, seed=43))


def _cfg(case):
    import ekpnp_torch

    name, ov = CASES[case]
    return ekpnp_torch.preset(name, dtype="float64", **ov)


def _run(mesh, case):
    """STEPS sharded steps of case's start on `mesh`: the gathered state
    (rank 0; None elsewhere) and this process's launch counts."""
    from ekpnp_torch.kernels import fused_step as fs
    from ekpnp_torch.parallel.mesh import (gather_state,
                                           make_sharded_multi_step,
                                           shard_state)

    cfg = _cfg(case)
    sh = shard_state(cfg, mesh, _start(cfg))
    fs.reset_launches()
    out = make_sharded_multi_step(cfg, mesh, STEPS)(sh)
    torch.cuda.synchronize()
    counts = {k: v for k, v in fs.launches.items() if v}
    return gather_state(mesh, out, device=torch.device("cpu")), counts


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The processes' gathered states and launches, and the one-process
    mesh's, per (case, pencil)."""
    from ekpnp_torch.device import torch_setup
    from ekpnp_torch.kernels.fused_step import _load
    from ekpnp_torch.parallel.mesh import make_mesh, mesh_devices

    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA devices (one NCCL process per card)")
    world = min(4, torch.cuda.device_count())
    torch_setup()
    _load()  # one build for every process
    tmp = tmp_path_factory.mktemp("nccl")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         f"file://{tmp / 'store'}", str(tmp)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"process {r}:\n{log[-4000:]}"
    one = {}
    for case, pencil in RUNS:
        mesh = make_mesh(mesh_devices(torch.device("cuda"), SHARDS),
                         pencil=pencil)
        one[case, pencil] = _run(mesh, case)
    return world, tmp, one


@pytest.mark.parametrize("pencil", [False, True], ids=["slab4", "pencil2x2"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_nccl_processes_equal_one_process(runs, case, pencil):
    """The processes' run equals the one-process run over the same cards:
    bit for bit is expected (the same kernels on the same blocks, the
    messages exact); held at max|d| / max|ref| <= 1e-12 per field, f64,
    reported per field.  Each process launched its own shards' forms
    (one shard each on 4 cards)."""
    world, tmp, one = runs
    want, _ = one[case, pencil]
    tag = f"{case}_{'pencil' if pencil else 'slab'}"
    got = np.load(tmp / f"{tag}.npz")
    report = {}
    for k in ("f", "h", "hn", "g", "phi"):
        w = getattr(want, k)
        if w is None:
            assert k not in got.files, k
            continue
        a = torch.as_tensor(got[k])
        assert torch.isfinite(a).all(), k
        report[k] = ("bit for bit" if torch.equal(a, w) else
                     float((a - w).abs().max() / w.abs().max()))
        assert report[k] == "bit for bit" or report[k] <= 1e-12, (k, report)
    print(f"{tag}, {world} NCCL processes against one process over "
          f"{world} cards: {report}")
    counts = json.loads((tmp / f"{tag}_launches_0.json").read_text())
    per = SHARDS // world
    form = "shard_x" if pencil else "phi_hx.halo"
    assert counts[f"collide_kernel.{form}"] == per
    assert counts[f"fused_pass_kernel.{form}"] == per * (STEPS - 1)
    assert counts["stream_bc_kernel.halo"] == per


def _worker(rank, world, store, out):
    sys.path.insert(0, ROOT)
    import torch.distributed as dist

    from ekpnp_torch.device import torch_setup
    from ekpnp_torch.parallel.mesh import make_mesh, mesh_devices

    torch.cuda.set_device(rank)
    torch_setup()
    dist.init_process_group("nccl", init_method=store, rank=rank,
                            world_size=world)
    dist.barrier(device_ids=[rank])  # every rank in NCCL's first collective
    try:
        for case, pencil in RUNS:
            mesh = make_mesh(mesh_devices(torch.device("cuda"), SHARDS,
                                          world),
                             pencil=pencil, rank=rank, world=world)
            state, counts = _run(mesh, case)
            tag = f"{case}_{'pencil' if pencil else 'slab'}"
            with open(os.path.join(out, f"{tag}_launches_{rank}.json"),
                      "w") as fh:
                json.dump(counts, fh)
            if rank == 0:
                np.savez(os.path.join(out, f"{tag}.npz"),
                         **{k: getattr(state, k).numpy()
                            for k in ("f", "h", "hn", "g", "phi")
                            if getattr(state, k) is not None})
        return 0
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(_worker(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:5]))
