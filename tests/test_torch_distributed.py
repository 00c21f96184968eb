"""The port's sharded time loop over several processes (`run --distributed`)
on the CPU: two processes of 2 shards each join one 4-shard mesh over Gloo,
as tests/test_multihost.py joins two JAX processes, on a slab and on a
pencil (whose x exchanges stay inside a process and whose y exchanges
cross processes), four processes of one shard each on a pencil (every
exchange crosses processes, and each process takes part in some pairs of
a call only), and two processes of 3 shards each on pencil 2x3, whose
shards' 4 rows the 3 x-shards cut 2/1/1 (a process holds a whole x ring,
the solve's uneven pieces cross processes).  Held to the JAX package's
single-process step at rtol 1e-11 and to the port's one-process mesh of
the same shards bit for bit: the state, the collectives (the uneven
50-over-4, 16-over-3 and 4-over-3 cuts included), the diagnostics, the per-process
dumps once merged and the per-process checkpoint; then the CLI as two
processes with the environment `python -m torch.distributed.run` sets.

This file is also its own worker process:

    python tests/test_torch_distributed.py <rank> <world> <store> <job> <out>

joins the Gloo group at the `file://` store and runs <job> (a mesh of
JOBS, or `fail`: process 1 raises, process 0 must not wait for it).
Every launch has a timeout, so a hang fails the test.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (one torch thread per process)
from test_torch_common import FIELDS, jax_steps, make_state_np, port_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120  # seconds, per launch
STEPS = 3
# job: (processes, shards, pencil)
JOBS = {"slab": (2, 4, False), "pencil": (2, 4, True),
        "pencil4": (4, 4, True), "pencil2x3": (2, 6, True)}


def grid_of(job):
    """The job's case: `reference` at 16x8x9 (24x8x9 on pencil 2x3), f64,
    matmul solve."""
    return dict(nx=24 if JOBS[job][1] == 6 else 16, ny=8, nz=9,
                fft_method="matmul", dtype="float64")


def cfg_of(job):
    import ekpnp_torch

    return ekpnp_torch.preset("reference", **grid_of(job))


def shard_np(mesh, a):
    """This process's blocks of a global numpy array (..., NY, NX) as
    tensors, None for the others'."""
    ny, nx = mesh.grid
    h, w = a.shape[-2] // ny, a.shape[-1] // nx

    def cut(i):
        yi, xi = mesh.coords(i)
        return torch.as_tensor(np.ascontiguousarray(
            a[..., yi * h:(yi + 1) * h, xi * w:(xi + 1) * w]))
    return mesh.each(cut)


def collectives(mesh):
    """{name/shard: tensor} of every collective and distributed transform
    on this process's shards: ring_shift along each axis both ways,
    all_to_all in the transforms' layouts and across the reference's
    uneven 50-wide x (13/13/12/12 over 4; on pencil 2x3 48 wide, a
    shard's 16 columns over 3 x-shards 6/5/5) and back, and the
    transforms on it (on pencil 2x3 they cut a shard's 4 rows 2/1/1)."""
    import ekpnp_torch.parallel.fft as tfft
    from ekpnp_torch.parallel.collectives import (all_to_all, even_cut,
                                                  ring_shift)

    px = mesh.grid[1]
    w, uw = (16, 50) if px != 3 else (24, 48)  # x extents the mesh divides
    rng = np.random.default_rng(7)
    a = shard_np(mesh, rng.standard_normal((3, 8, w)))
    u = shard_np(mesh, rng.standard_normal((5, 8, uw)))
    e = shard_np(mesh, rng.standard_normal((w, 8, w)))
    res = {}
    axes = ["y", ("y", "x")] + (["x"] if mesh.pencil else [])
    for axis in axes:
        for shift in (1, -1):
            res[f"ring {axis} {shift}"] = ring_shift(mesh, a, axis, shift)
    groups = ["y", ("y", "x")] + (["x"] if mesh.pencil else [])
    for axis in groups:
        there = all_to_all(mesh, u, axis, 2, 1)
        res[f"a2a {axis} uneven"] = there
        n = mesh.size if axis == ("y", "x") else mesh.shape[axis]
        res[f"a2a {axis} back"] = all_to_all(
            mesh, there, axis, 1, 2, cat_sizes=even_cut(uw // px, n))
        res[f"a2a {axis} z"] = all_to_all(mesh, e, axis, 0, 2)
    res["hartley2_xy"] = tfft.hartley2_xy(u, mesh)
    res["hartley_y"] = tfft.hartley_y(u, mesh)
    res["fft2_xy"] = tfft.fft2_xy(u, mesh)
    res["fft3"] = tfft.fft3(e, mesh)
    return {f"{k}/{i}": v[i] for k, v in res.items() for i in mesh.local}


def drive(mesh, out, job):
    """The distributed path on `mesh` from the same numpy start, written
    under `out`: collectives (coll_<rank>.npz), dumps at steps 0 and 3
    (io/), the chunk's collective counters (counters_<rank>.json), the
    series point (series_<rank>.npy), the per-process checkpoint (ckpt/)
    and its round trip on this process (roundtrip_<rank>.txt), and the
    state gathered on rank 0 (state.npz)."""
    from ekpnp_torch import telemetry
    from ekpnp_torch.diagnostics import series_point
    from ekpnp_torch.io.checkpoint import load_sharded, save_sharded
    from ekpnp_torch.io.fields import save_fields_sharded
    from ekpnp_torch.parallel.halo import shard_macros
    from ekpnp_torch.parallel.mesh import (fields, gather_state,
                                           make_sharded_multi_step,
                                           shard_state)

    rank = mesh.rank
    cfg = cfg_of(job)
    np.savez(os.path.join(out, f"coll_{rank}.npz"),
             **{k: v.numpy() for k, v in collectives(mesh).items()})

    def dump(d, st):
        parts = shard_macros(cfg, mesh, st)
        save_fields_sharded(os.path.join(out, "io", f"fields_{d:06d}.shards"),
                            cfg, mesh, fields(mesh, parts, 0), st.phi,
                            fields(mesh, parts, 1), float(st.t),
                            pid=rank, nprocs=mesh.world)

    state = shard_state(cfg, mesh, port_state(cfg, make_state_np(cfg, 41)))
    dump(0, state)
    before = dict(telemetry.counters)
    state = make_sharded_multi_step(cfg, mesh, STEPS)(state)
    with open(os.path.join(out, f"counters_{rank}.json"), "w") as fh:
        json.dump({k: v - before.get(k, 0)
                   for k, v in telemetry.counters.items()}, fh)
    dump(STEPS, state)
    np.save(os.path.join(out, f"series_{rank}.npy"),
            np.array([float(x) for x in series_point(cfg, state, mesh)]))

    ck = os.path.join(out, "ckpt")
    save_sharded(ck, cfg, state, mesh, pid=rank, nprocs=mesh.world)
    if mesh.world > 1:
        torch.distributed.barrier()
    back = load_sharded(ck, cfg, mesh, device="cpu")
    same = float(back.t) == float(state.t) and all(
        torch.equal(getattr(back, k)[i], getattr(state, k)[i])
        for k in FIELDS if getattr(state, k) is not None for i in mesh.local)
    with open(os.path.join(out, f"roundtrip_{rank}.txt"), "w") as fh:
        fh.write("exact" if same else "differs")
    whole = gather_state(mesh, state)
    if rank == 0:
        np.savez(os.path.join(out, "state.npz"),
                 **{k: getattr(whole, k).numpy() for k in FIELDS
                    if getattr(whole, k) is not None})


def _launch(argvs, envs=None):
    """Start one process per argv (with its environment: envs[k], else
    this one), one torch thread each, and wait for all, TIMEOUT each:
    [(rc, output)]; a hang kills them all and fails."""
    envs = envs or [os.environ] * len(argvs)
    procs = [subprocess.Popen(a, cwd=ROOT, env=dict(e, OMP_NUM_THREADS="1"),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for a, e in zip(argvs, envs)]
    outs = []
    try:
        for p in procs:
            outs.append((p.communicate(timeout=TIMEOUT)[0], p.returncode))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(rc, text) for text, rc in outs]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per job: (its processes' output dir, the one-process mesh's)."""
    from ekpnp_torch.parallel.mesh import make_mesh

    tmp = tmp_path_factory.mktemp("dist")
    got = {}
    store = lambda j: f"file://{tmp / (j + '.store')}"
    argvs, outs = [], {}
    for job, (world, _, _) in JOBS.items():
        outs[job] = tmp / job
        (outs[job] / "io").mkdir(parents=True)
        argvs += [[sys.executable, os.path.abspath(__file__), str(r),
                   str(world), store(job), job, str(outs[job])]
                  for r in range(world)]
    results = _launch(argvs)
    for k, (rc, text) in enumerate(results):
        assert rc == 0, f"worker {k} rc {rc}:\n{text[-4000:]}"
    for job, (_, shards, pencil) in JOBS.items():
        one = tmp / f"{job}_one"
        (one / "io").mkdir(parents=True)
        drive(make_mesh(["cpu"] * shards, pencil=pencil), str(one), job)
        got[job] = (outs[job], one)
    return got


@pytest.fixture(scope="module")
def jax_want():
    """job -> 3 steps of the JAX package's step on the job's case, each
    grid once."""
    import ekpnp

    done = {}

    def want(job):
        key = grid_of(job)["nx"]
        if key not in done:
            done[key] = jax_steps(ekpnp.preset("reference", **grid_of(job)),
                                  make_state_np(cfg_of(job), 41), STEPS)
        return done[key]
    return want


@pytest.mark.parametrize("job", sorted(JOBS))
def test_processes_equal_the_jax_step(runs, jax_want, job):
    """The job's shards over its processes, 3 steps: the gathered state
    equals 3 steps
    of the JAX package's single-process step at rtol 1e-11 / atol 1e-13
    on f, h, hn, g and phi."""
    from test_torch_common import assert_fields_close

    got = np.load(runs[job][0] / "state.npz")
    assert_fields_close(jax_want(job), {k: got[k] if k in got else None
                                        for k in FIELDS}, label=f"{job} ")


@pytest.mark.parametrize("job", sorted(JOBS))
def test_processes_equal_one_process_bit_for_bit(runs, job):
    """The gathered state and the series point on each process equal the
    port's one-process mesh of the same shards bit for bit."""
    two, one = runs[job]
    world = JOBS[job][0]
    a, b = np.load(two / "state.npz"), np.load(one / "state.npz")
    assert sorted(a.files) == sorted(b.files) == ["f", "g", "h", "hn", "phi"]
    for k in a.files:
        assert np.array_equal(a[k], b[k]), k
    want = np.load(one / "series_0.npy")
    assert np.isfinite(want).all() and want[4] == 1.0
    for r in range(world):
        assert np.array_equal(np.load(two / f"series_{r}.npy"), want), r


@pytest.mark.parametrize("job", sorted(JOBS))
def test_collectives_across_processes(runs, job):
    """ring_shift along "y", "x" and ("y", "x"), all_to_all there and back
    across the uneven 50-over-4 cut, and the distributed transforms
    (fft3's complex blocks included) give each shard what the one-process
    mesh gives it, bit for bit, on the process that holds it."""
    two, one = runs[job]
    world = JOBS[job][0]
    want = np.load(one / "coll_0.npz")
    got = {}
    for r in range(world):
        with np.load(two / f"coll_{r}.npz") as z:
            got.update({k: z[k] for k in z.files})
    assert sorted(got) == sorted(want.files)
    if JOBS[job][1] == 4:  # 50 over 4 slabs: 13/13/12/12
        assert any(want[k].shape[-1] == 12 for k in want.files
                   if k.startswith("a2a y uneven"))
    else:  # a shard's 16 columns over 3 x-shards: 6/5/5
        assert [want[f"a2a x uneven/{i}"].shape[-1] for i in range(6)] == \
            [6, 5, 5] * 2
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k
    per = JOBS[job][1] // world
    for r in range(world):  # contiguous blocks of mesh order
        with np.load(two / f"coll_{r}.npz") as z:
            assert {int(k.split("/")[1]) for k in z.files} == set(
                range(r * per, (r + 1) * per))


@pytest.mark.parametrize("job", sorted(JOBS))
def test_the_chunks_collective_counters(runs, job):
    """Over processes, every process counts the message batches and the
    bytes it sends of the sharded chunk's edge exchanges (ring_shift) and
    solve (all_to_all); on the slab the exchanges exactly: per process one
    piece a call, the phi (psi_hx) halo's two rows before the collide and
    after each solve but the last, and each active field's post edge rows
    (lo and hi) each step.  The one-process mesh sends nothing."""
    from ekpnp_torch.kernels.fused_step import edge_dirs

    two, one = runs[job]
    world, shards, pencil = JOBS[job]
    C = "ekpnp_torch.collective."
    assert not any(json.loads((one / "counters_0.json").read_text()).values())
    got = [json.loads((two / f"counters_{r}.json").read_text())
           for r in range(world)]
    for g in got:
        for op in ("ring_shift", "all_to_all"):
            assert g[C + "calls." + op] > 0 and g[C + "bytes." + op] > 0, op
    if pencil:
        return
    cfg = cfg_of(job)
    nz, nx, item = cfg.grid.nz, cfg.grid.nx, 8
    fields = [cfg.lattice, cfg.scalar_lat, cfg.scalar_lat, cfg.scalar_lat]
    rows = sum(len(edge_dirs(lat, s)) for lat in fields for s in (1, -1))
    calls = 2 * STEPS + STEPS * 2 * len(fields)
    sent = (2 * STEPS * nz * nx + STEPS * rows * nz * nx) * item
    for g in got:
        assert (g[C + "calls.ring_shift"], g[C + "bytes.ring_shift"]) == \
            (calls, sent)


@pytest.mark.parametrize("job", sorted(JOBS))
def test_merged_dumps_are_byte_identical(runs, job):
    """Each process dumps its own shards (shard_<rank>.npz); `merge_run_dir`
    of the processes' dumps writes data.dat and data_end.dat byte for byte
    as the one-process mesh run's merge."""
    import json

    from ekpnp_torch.io.fields import merge_run_dir

    two, one = runs[job]
    world = JOBS[job][0]
    d = two / "io" / "fields_000003.shards"
    assert sorted(p.name for p in d.iterdir()) == ["meta.json"] + [
        f"shard_{r}.npz" for r in range(world)]
    assert json.loads((d / "meta.json").read_text())["nprocs"] == world
    cfg = cfg_of(job)
    assert merge_run_dir(str(two / "io"), cfg) == 2
    assert merge_run_dir(str(one / "io"), cfg) == 2
    for name in ("data.dat", "data_end.dat"):
        assert (two / "io" / name).read_bytes() == \
            (one / "io" / name).read_bytes(), name


@pytest.mark.parametrize("job", sorted(JOBS))
def test_per_process_checkpoint_round_trip_and_resume(runs, job):
    """save_sharded from the processes round-trips bit for bit on each;
    restored on one process as one state, and onto the other mesh kind in
    one process, it equals the gathered state exactly."""
    from ekpnp_torch.io.checkpoint import load_sharded
    from ekpnp_torch.parallel.mesh import gather_state, make_mesh

    two, _ = runs[job]
    world, _, pencil = JOBS[job]
    for r in range(world):
        assert (two / f"roundtrip_{r}.txt").read_text() == "exact", r
    cfg = cfg_of(job)
    want = np.load(two / "state.npz")
    whole = load_sharded(str(two / "ckpt"), cfg, device="cpu")
    other = make_mesh(["cpu"] * 4, pencil=not pencil)
    moved = gather_state(other, load_sharded(str(two / "ckpt"), cfg, other))
    for k in FIELDS:
        for st in (whole, moved):
            if k not in want:
                assert getattr(st, k) is None, k
                continue
            assert np.array_equal(getattr(st, k).numpy(), want[k]), k


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_cli_distributed_equals_one_process_mesh(tmp_path):
    """`run reference --device cpu --precision f64 --distributed --mesh slab
    --mesh-devices 4 --steps 10` as two processes (the environment of
    `python -m torch.distributed.run`): rc 0, process 1 prints nothing,
    series.csv byte for byte and the per-process state_end.ckpt bit for
    bit as the one-process `--mesh` run's."""
    import ekpnp_torch
    from ekpnp_torch.io.checkpoint import load_sharded

    base = ["-m", "ekpnp_torch", "run", "reference", "--device", "cpu",
            "--precision", "f64", "--mesh", "slab", "--mesh-devices", "4",
            "--steps", "10", "--checkpoint-full"]
    port = str(_free_port())
    envs = [dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                 LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=port) for r in range(2)]
    dist, one = tmp_path / "dist", tmp_path / "one"
    argvs = [[sys.executable, *base, "--distributed", "--outdir", str(dist)]
             ] * 2 + [[sys.executable, *base, "--outdir", str(one)]]
    res = _launch(argvs, envs + [os.environ])
    for k, (rc, text) in enumerate(res):
        assert rc == 0, f"process {k} rc {rc}:\n{text[-4000:]}"
    assert "Iteration: 10" in res[0][1] and "in each of 2 processes (gloo)" \
        in res[0][1]
    assert "EK-PNP-3D" not in res[1][1] and "Iteration" not in res[1][1]
    csv = (dist / "series.csv").read_bytes()
    assert csv == (one / "series.csv").read_bytes() and csv.count(b"\n") > 1
    ck = dist / "state_end.ckpt"
    assert sorted(p.name for p in ck.iterdir()) == [
        "meta.json", "shard_0.npz", "shard_1.npz"]
    cfg = ekpnp_torch.preset("reference", dtype="float64")
    a = load_sharded(str(ck), cfg, device="cpu")
    b = load_sharded(str(one / "state_end.ckpt"), cfg, device="cpu")
    for k in FIELDS + ("t",):
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None and y is None) or torch.equal(x, y), k


def test_cli_distributed_refuses_what_it_cannot_run(monkeypatch):
    """--distributed without --mesh, and --device cuda without NCCL, raise
    with a message before any process group is joined."""
    import torch.distributed as dist

    from ekpnp_torch.run import main

    with pytest.raises(SystemExit, match="--distributed needs --mesh"):
        main(["run", "reference", "--device", "cpu", "--distributed"])
    monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        main(["run", "reference", "--device", "cuda", "--distributed",
              "--mesh", "slab"])
    assert not dist.is_initialized()


def test_an_error_on_one_process_ends_the_other(tmp_path):
    """Process 1 raises before its first message; process 0, waiting in a
    ring_shift for it, fails at once instead of waiting: both exit
    non-zero within the launch timeout."""
    res = _launch([[sys.executable, os.path.abspath(__file__), str(r), "2",
                    f"file://{tmp_path / 'store'}", "fail", str(tmp_path)]
                   for r in range(2)])
    assert res[1][0] != 0 and "deliberate" in res[1][1], res[1][1][-2000:]
    assert res[0][0] != 0, res[0][1][-2000:]


def test_mesh_ownership_and_its_checks():
    """Shards are dealt to processes in contiguous blocks of mesh order; a
    count that the processes do not divide, or a distributed mesh without
    its process group, raises."""
    from ekpnp_torch.parallel.mesh import Mesh, make_mesh, mesh_devices

    m = make_mesh(["cpu"] * 4, pencil=True)
    assert (m.local, [m.owner(i) for i in range(4)]) == ([0, 1, 2, 3],
                                                         [0] * 4)
    assert m.each(lambda i: i * i) == [0, 1, 4, 9]
    assert mesh_devices("cpu", None, 4) == [torch.device("cpu")] * 4
    with pytest.raises(ValueError, match="multiple of the 2 processes"):
        mesh_devices("cpu", 3, 2)
    with pytest.raises(ValueError, match="cannot be dealt to 2 processes"):
        make_mesh(["cpu"] * 3, rank=0, world=2)
    with pytest.raises(RuntimeError, match="init_process_group"):
        Mesh(["cpu"] * 4, (2, 2), True, rank=1, world=2)


def _worker(rank, world, store, job, out):
    sys.path.insert(0, ROOT)
    import torch.distributed as dist

    from ekpnp_torch.parallel.mesh import make_mesh

    dist.init_process_group("gloo", init_method=store, rank=rank,
                            world_size=world)
    try:
        _, shards, pencil = JOBS.get(job, (0, 4, False))
        mesh = make_mesh(["cpu"] * shards, pencil=pencil, rank=rank,
                         world=world)
        if job == "fail":
            from ekpnp_torch.parallel.collectives import ring_shift

            if rank == 1:
                raise RuntimeError("deliberate failure on process 1")
            ring_shift(mesh, mesh.each(lambda i: torch.zeros(3)), "y", 1)
            return 0
        drive(mesh, out, job)
        dist.barrier()
        return 0
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(_worker(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6]))
