#!/usr/bin/env python3
"""Time the fused passes of this checkout against another checkout of the
repo on one NVIDIA card, in turns.

    python3 scripts/torch_pass_ab.py OTHER_ROOT

OTHER_ROOT is another checkout (for example the parent commit, unpacked by
`git archive` into a directory that .gitignore lists).  Each arm runs in a
process of its own, since the two checkouts' `ekpnp_torch` packages cannot
share one: it builds its checkout's f32 kernel library, then times by CUDA
events (20 launches after one) at 256x256x257 f32, for `ek-pnp-thermal`
(every field D3Q27, from its PB cold start; keys `*_d3q27_ms`) and the
D3Q7 headline (uniform start; `*_d3q7_ms`):

  - `pass`: the one-device fused pass (plain RHS), fused_pass_kernel;
  - `collide`, `collide_hartley_x`, `collide_phi_hx`: the one-device
    collide call of each form, its row products included
    (collide_kernel, .hartley_x, .phi_hx), on the start state (phi_hx:
    phi encoded as psi_hx first, outside the clock);
  - `stream`: stream_bc_kernel on the plain collide's post-collision set,
    and `copy`, Tensor.copy_ of the same bytes into the same output
    (the stream's practical ceiling);
  - where the checkout has the shard pass, on `ek-pnp-thermal` only: the
    pass on shard 0 of slab 4 and of pencil 2x2 (4 shards on the card),
    the plain collide there (`collide_kernel.halo` on the slab,
    `.shard_x` on the pencil), the edge exchange of all shards, and the
    sharded chunk's ms/step (20 steps, host clock).

The arms run other, this, this, other; one line `AB {...}` each, after the
card's name and power limit.
"""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _events_ms(fn, reps=20):
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def arm(root, tag, build_only):
    """Build, or time, the checkout at `root` (its package on sys.path)."""
    sys.path.insert(0, root)
    import torch

    from ekpnp_torch.kernels import fused_step as fs

    fs.REALS = {0: "float"}  # f32 only
    if build_only:
        fs.build()
        print(f"{tag} built in {fs.build_info['seconds']:.1f} s", flush=True)
        return
    import ekpnp_torch
    from ekpnp_torch.device import torch_setup
    from ekpnp_torch.init import initialize, state_from_macro
    from ekpnp_torch.ops.poisson import psi_hx_from_phi
    from ekpnp_torch.state import Macro

    torch_setup()
    res = {"tag": tag}

    def one_device(cfg, st, lat):
        """The pass, the collide forms, the stream and the copy."""
        post = fs.collide(cfg, st.f, st.h, st.hn, st.g, st.phi,
                          hartley_x=False)
        out = fs._empty_like_fields(cfg, st.f)
        res[f"pass_{lat}_ms"] = _events_ms(lambda: fs.fused_pass(
            cfg, *post[:4], st.phi, out=out, hartley_x=False))
        psi = psi_hx_from_phi(cfg, st.phi)
        for form, kw, phi in (("collide", dict(hartley_x=False), st.phi),
                              ("collide_hartley_x", dict(hartley_x=True),
                               st.phi),
                              ("collide_phi_hx", dict(phi_hx=True), psi)):
            res[f"{form}_{lat}_ms"] = _events_ms(lambda: fs.collide(
                cfg, st.f, st.h, st.hn, st.g, phi, post=out, **kw))
        res[f"stream_{lat}_ms"] = _events_ms(
            lambda: fs.stream_bc(cfg, *post[:4], out=out))
        res[f"copy_{lat}_ms"] = _events_ms(
            lambda: [a.copy_(b) for a, b in zip(out, post[:4])
                     if b is not None])
        del post, out, psi
        torch.cuda.empty_cache()

    cfg = ekpnp_torch.preset("ek-pnp-thermal", pb_omega=0.02)
    st, _ = initialize(cfg, device="cuda")
    one_device(cfg, st, "d3q27")
    head = ekpnp_torch.preset("reference", nx=256, ny=256, nz=257,
                              dtype="float32", fft_method="matmul",
                              scalar_lattice="D3Q7")
    kw = dict(dtype=torch.float32, device="cuda")
    shape = head.grid.shape
    macro = Macro(rho=torch.full(shape, 1000.0, **kw),
                  u=torch.zeros((3,) + shape, **kw),
                  charge=torch.full(shape, 0.01, **kw),
                  chargen=torch.full(shape, 0.01, **kw),
                  temp=torch.full(shape, 0.5, **kw))
    hs = state_from_macro(head, macro, torch.zeros(shape, **kw),
                          torch.zeros((3,) + shape, **kw), 0.0)
    one_device(head, hs, "d3q7")
    del hs, macro
    torch.cuda.empty_cache()
    if hasattr(fs, "pass_form"):  # the checkout has the shard pass
        from ekpnp_torch.parallel.halo import (make_halo_multi_step,
                                               phi_halos, post_edges)
        from ekpnp_torch.parallel.mesh import (local_cfg, make_mesh, shard,
                                               shard_state)

        for name, pencil in (("slab4", False), ("pencil2x2", True)):
            mesh = make_mesh(["cuda"] * 4, pencil=pencil)
            cfg_l = local_cfg(cfg, mesh)
            sh = shard_state(cfg, mesh, st)
            halos = phi_halos(mesh, sh.phi)
            posts = [fs.collide(cfg_l, *shard(sh, i)[:5], phi_halo=halos[i],
                                hartley_x=False)[:4] for i in range(4)]
            rows, cols = post_edges(cfg_l, mesh, posts)[0]
            o = fs._empty_like_fields(cfg_l, posts[0][0])
            x0 = shard(sh, 0)[:5]
            res[f"shard_collide_{name}_ms"] = _events_ms(lambda: fs.collide(
                cfg_l, *x0, post=o, phi_halo=halos[0], hartley_x=False))
            res[f"shard_pass_{name}_ms"] = _events_ms(lambda: fs.fused_pass(
                cfg_l, *posts[0], sh.phi[0], out=o, rows=rows, cols=cols,
                phi_halo=halos[0], hartley_x=False))
            res[f"exchange_{name}_ms"] = _events_ms(
                lambda: post_edges(cfg_l, mesh, posts), 10)
            del posts, o, rows, cols, x0
            sh = make_halo_multi_step(cfg, mesh, 2)(sh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sh = make_halo_multi_step(cfg, mesh, 20)(sh)
            torch.cuda.synchronize()
            res[f"step_{name}_ms"] = (time.perf_counter() - t0) / 20 * 1e3
            del sh
            torch.cuda.empty_cache()
    print("AB " + json.dumps(res), flush=True)


def main(argv):
    if argv[:1] == ["--arm"]:
        arm(argv[1], argv[2], argv[3] == "build")
        return 0
    other = os.path.abspath(argv[0])
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"], check=True, timeout=60)
    me = os.path.abspath(__file__)
    arms = {"other": other, "this": HERE}
    builds = [subprocess.Popen([sys.executable, me, "--arm", root, tag,
                                "build"]) for tag, root in arms.items()]
    if any(p.wait() != 0 for p in builds):
        return 1
    for tag in ("other", "this", "this", "other"):
        p = subprocess.run([sys.executable, me, "--arm", arms[tag], tag,
                            "time"], capture_output=True, text=True,
                           timeout=900)
        lines = [ln for ln in p.stdout.splitlines() if ln.startswith("AB ")]
        if p.returncode != 0 or not lines:
            print(p.stdout[-2000:], p.stderr[-3000:])
            return 1
        print(lines[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
