"""The port's parity map: every public top-level name of the JAX package
(`ekpnp/**/*.py`) and every flag of its `run` and `bench` commands, with
its counterpart in `ekpnp_torch` ("module:name", a flag of the port's
command) or the reason it is not carried over (the TPU machinery of
ROADMAP section 1).  Read with `ast` alone: neither package is imported.

It fails when the JAX package has a name or flag the map lacks (or the map
one the package no longer has), and when a named counterpart does not
exist."""
import ast
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOT = "not carried over: "
_GSPMD = NOT + ("a GSPMD sharding spec; a sharded field is a list of "
                "per-shard tensors (ekpnp_torch.parallel.mesh.shard_field)")
_TPU_SIZING = NOT + ("sizing of the TPU kernel's VMEM strips and lanes; the "
                     "CUDA kernels index any shard (ROADMAP section 2)")
_HALO8 = NOT + ("the TPU kernel's 8-row halo block (DMA alignment); the "
                "CUDA shard forms take the neighbours' post-collision edge "
                "rows (ekpnp_torch.parallel.halo.post_rows)")


def _same(module, *names):
    """name -> the same name in the port's module of the same path."""
    return {f"ekpnp.{module}:{n}": f"ekpnp_torch.{module}:{n}" for n in names}


NAMES = {
    **_same("benchmark", "main"),
    "ekpnp.compile_cache:enable": NOT + (
        "JAX's persistent compilation cache; the port builds its kernel "
        "library once per source hash (ekpnp_torch.kernels.fused_step.build)"),
    **_same("config", "GridConfig", "PhysicsConfig", "RunConfig", "Config",
            "preset", "from_file"),
    **_same("diagnostics", "wall_extrapolate", "ionic_current", "umax",
            "velocity_magnitude_max", "check_finite", "series_point",
            "dimensionless_banner"),
    **_same("init", "InitFields", "cold_fields", "initialize",
            "state_from_macro"),
    **_same("io.checkpoint", "save_npz", "load_npz", "save_full_npz",
            "is_full_checkpoint", "load_full_npz", "save_sharded",
            "is_sharded_checkpoint", "load_sharded", "save_reference_ascii",
            "load_reference_ascii"),
    **_same("io.fields", "save_fields_sharded", "list_dump_dirs",
            "merge_run_dir"),
    **_same("io.native", "format_tecplot", "format_table", "parse_table"),
    **_same("io.scalars", "save_scalar", "load_scalar", "save_scalars"),
    **_same("io.tecplot", "HEADER", "write_zone"),
    **_same("io.vtk", "write_vtk", "read_vtk"),
    **_same("lattice", "Lattice", "get_lattice", "D3Q27", "D3Q19", "D3Q7"),
    **_same("ops.boundary", "bounce_back_walls", "scalar_wall_bcs"),
    **_same("ops.collide", "PostCollision", "body_force",
            "perturbation_velocity", "guo_force_pops", "compute_macro",
            "collide"),
    **_same("ops.equilibrium", "lattice_consts", "feq", "moments",
            "trt_split"),
    **_same("ops.pbe", "boltzmann_closure", "pb_init"),
    **_same("ops.poisson", "wavenumbers", "minus_laplacian_symbol",
            "odd_extension", "charge_rhs", "lifting_profile",
            "poisson_solve_dst", "poisson_phi_from_rhs",
            "poisson_psi_hx_from_rhs", "phi_from_psi_hx", "psi_hx_from_phi",
            "poisson_phi", "poisson_solve", "efield"),
    "ekpnp.ops.poisson:dst_symbol": "ekpnp_torch.ops.poisson:_scaled_inv_symbol",
    "ekpnp.ops.poisson:interior_rhs": NOT + (
        "no caller in ekpnp: the reduced solve carries the plates by "
        "lifting_profile, in both packages"),
    **_same("ops.stream", "stream"),
    "ekpnp.ops.stream:stream_many": NOT + (
        "no caller in ekpnp; ekpnp_torch.step.stream_and_bcs streams every "
        "population set"),
    "ekpnp.pallas.fused_step:HALO": _HALO8,
    "ekpnp.pallas.fused_step:fused_supported": _TPU_SIZING,
    "ekpnp.pallas.fused_step:phi_hx_profitable": _TPU_SIZING,
    "ekpnp.pallas.fused_step:auto_cchunk": _TPU_SIZING,
    "ekpnp.pallas.fused_step:fused_recommended": _TPU_SIZING,
    "ekpnp.pallas.fused_step:build_fused_step":
        "ekpnp_torch.kernels.fused_step:fused_step",
    "ekpnp.pallas.step:step_pallas": "ekpnp_torch.kernels.step:step_fused",
    "ekpnp.pallas.step:step_pallas_hx":
        "ekpnp_torch.kernels.step:step_fused_hx",
    "ekpnp.pallas.step:step_pallas_diff": "ekpnp_torch.kernels.step:step_diff",
    "ekpnp.pallas.step:multi_step_pallas":
        "ekpnp_torch.kernels.step:multi_step_rhs",
    "ekpnp.pallas.step:multi_step_pallas_hx":
        "ekpnp_torch.kernels.step:multi_step_hx",
    "ekpnp.parallel.fft:default_method": NOT + (
        "it picks the DFT-as-matmul backend the TPU needed; complex "
        "transforms are torch.fft on either device"),
    **_same("parallel.fft", "fft3", "dst_z", "dst_z_padded", "hartley2_xy",
            "hartley_y", "hartley_x_local", "fft2_xy"),
    "ekpnp.parallel.halo:HALO": _HALO8,
    "ekpnp.parallel.halo:supports_halo_step": NOT + (
        "the TPU kernel's shard rules (8-row slabs, 128-lane pencil "
        "shards); the port checks divisibility alone "
        "(ekpnp_torch.parallel.mesh.check_divisibility)"),
    "ekpnp.parallel.halo:initial_pop_halos":
        "ekpnp_torch.parallel.halo:post_edges",
    **_same("parallel.halo", "step_halo", "make_halo_multi_step"),
    **_same("parallel.mesh", "make_mesh", "check_divisibility",
            "shard_state", "make_sharded_step", "make_sharded_multi_step"),
    "ekpnp.parallel.mesh:pop_spec": _GSPMD,
    "ekpnp.parallel.mesh:scalar_spec": _GSPMD,
    "ekpnp.parallel.mesh:vector_spec": _GSPMD,
    "ekpnp.parallel.mesh:state_shardings": _GSPMD,
    "ekpnp.parallel.mesh:macro_shardings": _GSPMD,
    **_same("run", "build_config", "cmd_merge", "cmd_info", "cmd_run",
            "main"),
    "ekpnp.state:Array": "ekpnp_torch.state:Tensor",
    **_same("state", "State", "Macro", "zeros_state"),
    **_same("step", "step", "multi_step"),
    "ekpnp.step:step_jit": "ekpnp_torch.step:step",
}

# "<command> <flag>" of the JAX CLI -> the port's flag of the same command
FLAGS = {
    **{f"run {f}": f for f in (
        "--steps", "--set", "--precision", "--outdir", "--resume", "--mesh",
        "--mesh-devices", "--distributed", "--profile", "--vtk",
        "--checkpoint-full", "--save-scalars")},
    "run --platform": "--device",
    **{f"bench {f}": f for f in (
        "--size", "--steps", "--reps", "--mode", "--dtype",
        "--scalar-lattice", "--no-parity-run")},
    "bench --pallas": NOT + (
        "the Pallas switch; the port runs its kernels on the card and "
        "their plain versions on the CPU (bench --device)"),
    "bench --no-pallas": NOT + "the Pallas switch, as --pallas",
}
# the file of each command's parser, in either package
COMMANDS = {"run": "run.py", "bench": "benchmark.py"}


def _tree(path):
    with open(path) as fh:
        return ast.parse(fh.read())


def _top_names(tree, imports=True):
    """Names a module binds at its top level (by import too, unless not
    `imports`)."""
    out = set()
    for n in tree.body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, ast.Assign):
            out |= {t.id for t in n.targets if isinstance(t, ast.Name)}
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            out.add(n.target.id)
        elif imports and isinstance(n, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in n.names}
    return out


def _module_file(module):
    base = os.path.join(ROOT, *module.split("."))
    return base + ".py" if os.path.isfile(base + ".py") else os.path.join(
        base, "__init__.py")


def _flags(path):
    """The option strings of every add_argument call in a file."""
    return {a.value for n in ast.walk(_tree(path)) if isinstance(n, ast.Call)
            and getattr(n.func, "attr", None) == "add_argument"
            for a in n.args if isinstance(a, ast.Constant)
            and str(a.value).startswith("--")}


def _jax_names():
    out = set()
    pkg = os.path.join(ROOT, "ekpnp")
    for d, _, files in os.walk(pkg):
        for f in files:
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(d, f), ROOT)[:-3]
            module = rel.replace(os.sep, ".").removesuffix(".__init__")
            out |= {f"{module}:{n}" for n in _top_names(
                _tree(os.path.join(d, f)), imports=False)
                if not n.startswith("_")}
    return out


def test_every_jax_name_is_mapped():
    """The map holds every public top-level name the JAX package defines,
    and no other."""
    names = _jax_names()
    assert len(names) > 100
    assert sorted(names - set(NAMES)) == [], "JAX names missing from the map"
    assert sorted(set(NAMES) - names) == [], "mapped names ekpnp lacks"


def test_every_named_counterpart_exists():
    """Each counterpart "ekpnp_torch.module:name" is bound at the top level
    of that module; every other value gives its reason."""
    tops = {}
    for jax_name, port in NAMES.items():
        if port.startswith(NOT):
            assert len(port) > len(NOT) + 10, jax_name
            continue
        module, name = port.split(":")
        assert module.split(".")[0] == "ekpnp_torch", jax_name
        if module not in tops:
            tops[module] = _top_names(_tree(_module_file(module)))
        assert name in tops[module], f"{jax_name}: {port} does not exist"


def test_every_cli_flag_is_mapped():
    """Every flag of `ekpnp run` and `ekpnp bench` is in the map, with a
    flag the port's command has, or its reason."""
    want = {f"{cmd} {f}" for cmd, fname in COMMANDS.items()
            for f in _flags(os.path.join(ROOT, "ekpnp", fname))}
    assert sorted(want - set(FLAGS)) == [], "JAX flags missing from the map"
    assert sorted(set(FLAGS) - want) == [], "mapped flags ekpnp lacks"
    port = {cmd: _flags(os.path.join(ROOT, "ekpnp_torch", fname))
            for cmd, fname in COMMANDS.items()}
    for key, flag in FLAGS.items():
        if flag.startswith(NOT):
            continue
        assert flag in port[key.split()[0]], f"{key}: the port lacks {flag}"
