"""The port's per-shard field dumps (`ekpnp_torch.io.fields`) are the JAX
package's format: the same npz keys, blocks and meta.json, each package's
merge reads the other's dumps, and the merged files are byte-identical."""
import json

import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (one torch thread per worker)

GRID = dict(nx=16, ny=8, nz=9)


def _fields(seed=0):
    """Global numpy macro fields, phi and E of the reference physics."""
    rng = np.random.default_rng(seed)
    shape = (GRID["nz"], GRID["ny"], GRID["nx"])
    s = lambda: rng.standard_normal(shape)
    v = lambda: rng.standard_normal((3,) + shape)
    return dict(rho=s(), u=v(), charge=s(), chargen=s(), temp=s()), s(), v()


@pytest.mark.parametrize("pencil", [False, True])
def test_dump_is_the_jax_format(eight_devices, tmp_path, pencil):
    """save_fields_sharded over a 4-shard mesh writes the npz keys and
    blocks, and the meta.json, that the JAX package's writes from the same
    fields on the same mesh shape; each package's merge of the other's
    dump writes the same bytes."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    import ekpnp
    import ekpnp_torch
    from ekpnp.io import fields as jf
    from ekpnp.parallel.mesh import make_mesh as jax_make_mesh
    from ekpnp.state import Macro as JMacro
    from ekpnp_torch.io import fields as tf
    from ekpnp_torch.parallel.mesh import make_mesh, shard_field
    from ekpnp_torch.state import Macro

    jcfg = ekpnp.preset("reference", dtype="float64", **GRID)
    cfg = ekpnp_torch.preset("reference", dtype="float64", **GRID)
    macro, phi, E = _fields()

    jmesh = jax_make_mesh(eight_devices[:4], pencil=pencil)
    xax = "x" if pencil else None
    put = lambda a: jax.device_put(a, NamedSharding(
        jmesh, P(*([None] * (a.ndim - 2)), "y", xax)))
    jf.save_fields_sharded(str(tmp_path / "jax"), jcfg,
                           JMacro(**{k: put(a) for k, a in macro.items()}),
                           put(phi), put(E), 0.5)

    mesh = make_mesh(["cpu"] * 4, pencil=pencil)
    cut = lambda a: shard_field(cfg, mesh, torch.as_tensor(a))
    per = {k: cut(a) for k, a in macro.items()}
    macros = [Macro(**{k: per[k][i] for k in per}) for i in range(4)]
    tf.save_fields_sharded(str(tmp_path / "port"), cfg, mesh, macros,
                           cut(phi), cut(E), 0.5)

    with np.load(tmp_path / "jax" / "shard_0.npz") as a, \
            np.load(tmp_path / "port" / "shard_0.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert any(k.endswith("@0_0_4_8" if pencil else "@0_0_6_0")
                   for k in b.files)
        for k in a.files:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    meta = [json.loads((tmp_path / d / "meta.json").read_text())
            for d in ("jax", "port")]
    assert meta[0] == meta[1] == {"grid": [16, 8, 9], "t": 0.5, "nprocs": 1}

    # the run-dir layout: each package merges the other's dumps
    run = tmp_path / "run"
    run.mkdir()
    (tmp_path / "port").rename(run / "fields_000000.shards")
    assert tf.merge_run_dir(str(run), cfg) == 1
    jf.merge_run_dir(str(run), jcfg, data_path=str(tmp_path / "j.dat"),
                     end_path=str(tmp_path / "j_end.dat"),
                     end_npz_path=str(tmp_path / "j_end.npz"))
    assert (run / "data.dat").read_bytes() == (tmp_path / "j.dat").read_bytes()
    assert (run / "data_end.dat").read_bytes() == \
        (tmp_path / "j_end.dat").read_bytes()


def test_merge_orders_dumps_and_checks_coverage(tmp_path):
    """Dump dirs merge in step order (not name order), the zones carry the
    merged fields, and a dump missing a shard's blocks raises."""
    import ekpnp_torch
    from ekpnp_torch.io import fields as tf
    from ekpnp_torch.parallel.mesh import make_mesh, shard_field
    from ekpnp_torch.state import Macro

    cfg = ekpnp_torch.preset("reference", dtype="float64", **GRID)
    mesh = make_mesh(["cpu"] * 2)
    for step in (10, 2, 100):
        macro, phi, E = _fields(seed=step)
        cut = lambda a: shard_field(cfg, mesh, torch.as_tensor(a))
        per = {k: cut(a) for k, a in macro.items()}
        tf.save_fields_sharded(
            str(tmp_path / f"fields_{step:06d}.shards"), cfg, mesh,
            [Macro(**{k: per[k][i] for k in per}) for i in range(2)],
            cut(phi), cut(E), float(step))
    dirs = tf.list_dump_dirs(str(tmp_path))
    assert [d.rsplit("_", 1)[1] for d in dirs] == \
        ["000002.shards", "000010.shards", "000100.shards"]
    macro, phi, _, t = tf._assemble(dirs[-1], cfg)
    np.testing.assert_array_equal(phi, _fields(seed=100)[1])
    assert t == 100.0 and macro.u.shape == (3, 9, 8, 16)
    assert tf.merge_run_dir(str(tmp_path), cfg) == 3
    zones = (tmp_path / "data.dat").read_text().count("ZONE T=")
    assert zones == 3

    # a dump missing the second shard's blocks does not cover its fields
    bad = tmp_path / "bad" / "fields_000001.shards"
    bad.mkdir(parents=True)
    with np.load(tmp_path / "fields_000002.shards" / "shard_0.npz") as fl:
        np.savez(bad / "shard_0.npz",
                 **{k: fl[k] for k in fl.files
                    if k.split("@")[1].split("_")[-2] == "0"})
    (bad / "meta.json").write_text(
        (tmp_path / "fields_000002.shards" / "meta.json").read_text())
    with pytest.raises(ValueError, match="does not cover"):
        tf.merge_run_dir(str(tmp_path / "bad"), cfg)
