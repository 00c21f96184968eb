#!/usr/bin/env python3
"""Time the sharded time loop of the `pod` preset (512x256x257, f32, every
field D3Q27, PB cold start with pb_omega 0.02) on a mesh of --shards
shards (4 by default; 8 makes pencil 2x4 and slab 8), one of three ways:

    # 4 processes, one card each, NCCL
    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        scripts/torch_distributed_pod.py --way nccl --mesh slab
    # one process over 4 cards (peer copies, a side stream per card)
    python3 scripts/torch_distributed_pod.py --way cards --mesh slab
    # one process, the 4 shards stacked on one card
    python3 scripts/torch_distributed_pod.py --way one --mesh pencil
    # pencil 2x4: 4 processes of 2 shards each
    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        scripts/torch_distributed_pod.py --way nccl --mesh pencil --shards 8

Each process runs the cold start itself and keeps its shards; one chunk
of --every steps runs untimed (first launches, NCCL's first messages),
then --steps steps in chunks of --every, each timed by the host clock
between synchronised cards (and, over processes, barriers).  Then, on the
state reached, by the host clock over 10 repetitions (median): the
exchange of a step (the phi halo and the post-collision edges of every
shard) and the route's distributed solve (psi_hx on the slab, the plain
RHS on the pencil).  Peak device memory per card over the loop.  Rank 0
prints the card's name and power limit, then one line `POD {...}`.

--device cpu --size tiny (32x16x17) rehearses the same path on the CPU
(Gloo under `torch.distributed.run`); its times are CPU times.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--way", choices=["nccl", "cards", "one"], required=True)
    ap.add_argument("--mesh", choices=["slab", "pencil"], required=True)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--size", choices=["pod", "tiny"], default="pod")
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--every", type=int, default=25)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    import ekpnp_torch
    from ekpnp_torch.device import resolve_device
    from ekpnp_torch.init import initialize
    from ekpnp_torch.kernels import fused_step as fs
    from ekpnp_torch.ops.poisson import (poisson_phi_from_rhs,
                                         poisson_psi_hx_from_rhs,
                                         psi_hx_from_phi)
    from ekpnp_torch.parallel.halo import (make_halo_multi_step, phi_halos,
                                           post_edges)
    from ekpnp_torch.parallel.mesh import (local_cfg, make_mesh,
                                           mesh_devices, shard, shard_state)

    cuda = args.device == "cuda"
    rank, world = 0, 1
    if args.way == "nccl":
        if cuda:
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        dist.init_process_group("nccl" if cuda else "gloo",
                                init_method="env://")
        rank, world = dist.get_rank(), dist.get_world_size()
    dev = resolve_device(args.device)
    pencil = args.mesh == "pencil"
    if args.way == "nccl":
        devices = mesh_devices(dev, args.shards, world)
    elif args.way == "cards":
        devices = mesh_devices(dev, args.shards)
    else:
        devices = [torch.device("cuda", 0) if cuda else dev] * args.shards
    mesh = make_mesh(devices, pencil=pencil, rank=rank, world=world)
    grid = {} if args.size == "pod" else dict(nx=32, ny=16, nz=17)
    cfg = ekpnp_torch.preset("pod", pb_omega=0.02, **grid)
    cards = sorted({mesh.device(i) for i in mesh.local}, key=str)

    def sync():
        if cuda:
            for d in cards:
                torch.cuda.synchronize(d)
        if world > 1:
            dist.barrier(**({"device_ids": [cards[0].index]} if cuda else {}))

    t0 = time.perf_counter()
    state, _ = initialize(cfg, device=mesh.device(mesh.local[0]))
    sync()
    init_s = time.perf_counter() - t0
    state = shard_state(cfg, mesh, state)  # the whole state is dropped here
    if cuda:
        torch.cuda.empty_cache()
    state = make_halo_multi_step(cfg, mesh, args.every)(state)  # untimed
    sync()
    if cuda:
        for d in cards:
            torch.cuda.reset_peak_memory_stats(d)
    fs.reset_launches()
    chunks = []
    for _ in range(args.steps // args.every):
        sync()
        t0 = time.perf_counter()
        state = make_halo_multi_step(cfg, mesh, args.every)(state)
        sync()
        chunks.append((time.perf_counter() - t0) / args.every * 1e3)
    launches = {k: v for k, v in fs.launches.items() if v}
    peak = [torch.cuda.max_memory_allocated(d) / 1e9 for d in cards] \
        if cuda else []

    def host_ms(fn, reps=10):
        fn()
        times = []
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    # the exchange and the solve of one step, on the state reached
    cfg_l = local_cfg(cfg, mesh)
    hx = not pencil  # the route make_halo_multi_step takes
    form = dict(hartley_x=fs.resolve_hartley_x(
        cfg_l, False if pencil else None, hx), phi_hx=hx)
    phi = psi_hx_from_phi(cfg, state.phi, mesh) if hx else state.phi
    halos = phi_halos(mesh, phi)
    outs = mesh.each(lambda i: fs.collide(
        cfg_l, *shard(state, i)[:4], phi[i], phi_halo=halos[i], **form))
    posts = mesh.each(lambda i: tuple(outs[i][:4]))
    rhs = mesh.each(lambda i: outs[i][4])
    del state, outs
    exchange_ms = host_ms(lambda: (phi_halos(mesh, phi),
                                   post_edges(cfg_l, mesh, posts)))
    solve_ms = host_ms(
        (lambda: poisson_psi_hx_from_rhs(cfg, rhs, mesh)) if hx else
        (lambda: poisson_phi_from_rhs(cfg, rhs, mesh,
                                      rhs_hx=form["hartley_x"])))
    if world > 1:
        every = [None] * world
        dist.all_gather_object(every, peak)
        peak = [p for ps in every for p in ps]
    ms_step = statistics.median(chunks)
    row = dict(way=args.way, mesh=args.mesh, size=args.size,
               device=(torch.cuda.get_device_name(0) if cuda else "cpu"),
               grid=list(mesh.grid), processes=world, cards=len({str(d) for d in devices})
               if args.way != "nccl" else world,
               init_s=init_s, chunk_ms_step=chunks, ms_step=ms_step,
               mlups=cfg.grid.num_nodes / (ms_step * 1e3),
               exchange_ms=exchange_ms, solve_ms=solve_ms,
               peak_gb_per_card=peak, rank0_launches=launches)
    if rank == 0:
        if cuda:
            smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"],
                                 capture_output=True, text=True, timeout=60)
            print(smi.stdout.strip().splitlines()[0])
        print("POD " + json.dumps(row), flush=True)
    if args.way == "nccl":
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
