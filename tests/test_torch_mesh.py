"""Mesh export: the port's ops/mesh.py against the JAX package's
(open_diffusiongs_tpu/ops/mesh.py), both on the repository's
native/libmesher.so.

* the density field: `density_grid_ref` through the port's
  `gaussian_density_grid` against JAX's at resolutions 32 and 64, one case
  capped (`max_per_block` below the candidates); atol 1e-6 + rtol 1e-5
  (JAX sums a slab's terms in XLA's order, the twin in torch's), and each
  slab's selected Gaussians (`slab_select`'s, the path's) equal to the
  rows JAX's `eval_block` receives;
* the path's slab selection (`slab_select`, plain torch, here on CPU
  tensors) equal to the numpy `slab_tables` table for table, with equal
  opacities across the cap keeping the lower indices; the packed records;
* the cull's extents conservative for the twin's f32 power on
  adversarial Gaussians (discs, needles, near-singular, det-clamped,
  non-positive-definite, a seeded sweep);
* every native wrapper bit-identical to JAX's on the same inputs;
* the port's steps after the density field, fed JAX's grid, give JAX's
  verts and tris exactly;
* `extract_mesh` end to end on the 300-Gaussian ball of
  tests/test_mesh.py:74-93, under that test's bars;
* `save_mesh_obj` text equal to JAX's;
* `run.main([... "--extract-mesh", "--device", "cpu"])` writes mesh.obj.
"""

import os
import types

import jax
import numpy as np
import pytest
import torch

from open_diffusiongs_tpu.ops import mesh as jmesh
from open_diffusiongs_tpu.ops.gaussians import NumpyGaussians as JGaussians
from open_diffusiongs_tpu_torch import run
from open_diffusiongs_tpu_torch.ops import mesh
from open_diffusiongs_tpu_torch.ops.gaussians import NumpyGaussians

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE = os.path.join(ROOT, "extra_files", "test_cases", "sphere.png")
GRID_TOL = dict(atol=1e-6, rtol=1e-5)


def _fields(n, seed, radius=0.3, log_scale=(-3.0, -3.0)):
    """Gaussians in a ball: anisotropic scales, random rotations, random
    opacities (every inverse-covariance entry non-zero)."""
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return (
        (dirs * rng.uniform(0, radius, (n, 1))).astype(np.float32),
        np.zeros((n, 1, 3), np.float32),
        rng.uniform(*log_scale, (n, 3)).astype(np.float32),
        rng.normal(size=(n, 4)).astype(np.float32),
        rng.normal(1.0, 1.0, (n, 1)).astype(np.float32))


def _ball():
    """The 300-Gaussian ball of tests/test_mesh.py:74-93."""
    rng = np.random.default_rng(0)
    n = 300
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    pts = dirs * rng.uniform(0, 0.3, (n, 1))
    return (pts.astype(np.float32), np.zeros((n, 1, 3), np.float32),
            np.full((n, 3), -3.0, np.float32),
            np.tile(np.asarray([1, 0, 0, 0], np.float32), (n, 1)),
            np.full((n, 1), 2.0, np.float32))


def _sphere_grid(res=48, r=0.6):
    lin = np.linspace(-1, 1, res, dtype=np.float32)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    return (r - np.sqrt(x * x + y * y + z * z)).astype(np.float32)


def _recording_jax(calls):
    """A stand-in for the JAX mesh module's `jax` whose `jit` records each
    eval_block call's numpy arguments."""
    def jit(fn):
        jitted = jax.jit(fn)

        def call(*args):
            calls.append([np.asarray(a) for a in args])
            return jitted(*args)
        return call
    return types.SimpleNamespace(jit=jit)


@pytest.mark.parametrize("res,max_per_block,log_scale", [
    (32, 8192, (-3.0, -2.0)),
    (64, 8192, (-3.5, -2.5)),
    (64, 40, (-3.0, -2.0)),            # capped: the 40 most opaque a slab
])
def test_density_grid_matches_jax(monkeypatch, res, max_per_block,
                                  log_scale):
    fields = _fields(400, seed=res + max_per_block, log_scale=log_scale)
    calls = []
    monkeypatch.setattr(jmesh, "jax", _recording_jax(calls))
    want, wcenter, wscale = jmesh.gaussian_density_grid(
        JGaussians(*fields), res, max_per_block=max_per_block)
    got, center, scale = mesh.gaussian_density_grid(
        NumpyGaussians(*fields), res, max_per_block=max_per_block,
        device="cpu")
    np.testing.assert_array_equal(center, wcenter)
    assert scale == wscale
    assert got.shape == (res,) * 3 and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **GRID_TOL)
    assert want.max() > 0.5

    # the path's selections: JAX's eval_block gets the gathered rows
    xyz_n, inv, opa, _, _ = mesh.density_inputs(NumpyGaussians(*fields))
    _, slab_z, idx, counts, _ = (
        x.numpy() if torch.is_tensor(x) else x for x in mesh.slab_select(
            torch.from_numpy(xyz_n), torch.from_numpy(opa), res,
            max_per_block=max_per_block))
    live = np.nonzero(counts)[0]
    assert len(live) == len(calls) >= 1     # res 32: one slab of 32 rows
    if max_per_block < 8192:
        assert counts.max() == max_per_block
    for s, (_, bxyz, _, bopa, bmask) in zip(live, calls):
        n = counts[s]
        assert bmask.sum() == n and bmask[:n].all()
        np.testing.assert_array_equal(bxyz[:n], xyz_n[idx[s, :n]])
        np.testing.assert_array_equal(bopa[:n], opa[idx[s, :n]])


@pytest.mark.parametrize("res,max_per_block,log_scale,tied", [
    (32, 8192, (-3.0, -2.0), False),
    (64, 8192, (-3.5, -2.5), False),
    (64, 40, (-3.0, -2.0), False),
    (64, 40, (-3.0, -2.0), True),      # equal opacities across the cap
])
def test_slab_select_equals_slab_tables(res, max_per_block, log_scale, tied):
    """The path's selection (plain torch, here on CPU tensors, its mask
    made a few slabs at a time) equals the numpy loop table for table; the
    packed records hold each list's rows."""
    fields = list(_fields(400, seed=res + max_per_block, log_scale=log_scale))
    if tied:   # four raw opacities: ~100 Gaussians share each
        fields[4] = np.random.default_rng(5).choice(
            np.float32([-1.0, 0.0, 0.5, 2.0]), (400, 1))
    xyz_n, inv, opa, _, _ = mesh.density_inputs(NumpyGaussians(*fields))
    want = mesh.slab_tables(xyz_n, opa, res, max_per_block=max_per_block)
    got = mesh.slab_select(torch.from_numpy(xyz_n), torch.from_numpy(opa),
                           res, max_per_block=max_per_block,
                           chunk_elems=3 * 400)
    for w, g in zip(want[:4], got[:4]):
        assert g.dtype == torch.from_numpy(w).dtype
        np.testing.assert_array_equal(g.numpy(), w)
    assert got[4] == want[4]
    _, slab_z, idx, counts, _ = want
    if max_per_block < 8192:
        assert counts.max() == max_per_block
    if tied:   # the lowest kept level keeps its lowest indices
        lin = np.linspace(-1, 1, res, dtype=np.float32)
        straddles = 0
        for s, (z0, z1) in enumerate(slab_z):
            lo = np.float32([lin[0], lin[0], lin[z0]]) - np.float32(0.1)
            hi = np.float32([lin[-1], lin[-1], lin[z1 - 1]]) + np.float32(0.1)
            members = np.nonzero(((xyz_n > lo) & (xyz_n < hi)).all(-1))[0]
            if len(members) <= max_per_block:
                continue
            kept = idx[s, :counts[s]]
            level = opa[kept].min()
            tied_members = members[opa[members] == level]
            tied_kept = kept[opa[kept] == level]
            np.testing.assert_array_equal(
                tied_kept, tied_members[:len(tied_kept)])
            straddles += len(tied_kept) < len(tied_members)
        assert straddles >= 1

    xyz_t, inv_t, opa_t = (torch.from_numpy(x) for x in (xyz_n, inv, opa))
    rec = mesh.density_records(got[2], xyz_t, inv_t, opa_t)
    table = torch.cat([xyz_t, opa_t[:, None], inv_t,
                       mesh.cull_extents(inv_t)], 1)
    assert rec.shape == (len(counts), max_per_block, mesh.RECORD_FLOATS)
    for s, n in enumerate(counts):
        torch.testing.assert_close(rec[s, :n], table[idx[s, :n]],
                                   rtol=0, atol=0)


def _rotations(rng, n):
    q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    return q


def _cull_family(family, n, seed):
    """(mu [n, 3], inv [n, 6]) f32 of adversarial Gaussians, through
    density_inputs (its det clamp included) unless the family is a
    non-positive-definite inverse built directly."""
    rng = np.random.default_rng(seed)
    if family == "not_pd":
        lam = rng.uniform(1.0, 1e3, (n, 3)) * np.float64([1, 1, -1])
        r = _rotations(rng, n)
        q = np.einsum("nij,nj,nkj->nik", r, lam, r)
        inv = q[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]]
        return (rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32),
                inv.astype(np.float32))
    base = rng.uniform(-4.5, -2.5, (n, 1))
    logs = {"disc": base + [0.0, 0.0, -4.6],         # 100:1 in sigma
            "needle": base + [0.0, -4.6, -4.6],
            "near_singular": base + [0.0, 0.0, -9.2],  # 1e4:1
            "det_clamped": np.full((n, 3), -13.0),     # det(cov) < 1e-24
            "sweep": rng.uniform(-7.0, -1.0, (n, 3))}[family]
    g = NumpyGaussians(rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32),
                       np.zeros((n, 1, 3), np.float32),
                       logs.astype(np.float32),
                       rng.normal(size=(n, 4)).astype(np.float32),
                       np.zeros((n, 1), np.float32))
    xyz_n, inv, _, _, _ = mesh.density_inputs(g)
    return xyz_n, inv.astype(np.float32)


def _twin_power(d, inv):
    """The twin's f32 power of offsets d [..., n, 3] under inv [n, 6]."""
    d = torch.from_numpy(np.ascontiguousarray(d, np.float32))
    return mesh.density_power(d[..., 0], d[..., 1], d[..., 2],
                              torch.from_numpy(inv)).numpy()


@pytest.mark.parametrize("family", ["disc", "needle", "near_singular",
                                    "det_clamped", "not_pd", "sweep"])
def test_cull_extents_are_conservative(family):
    """Every offset that a Gaussian's cull extents exclude has a twin f32
    power below -104: on a grid (each point a tile box of one point), and
    at the tightest offsets, just past an extent, where dᵀQd is least."""
    n = 256 if family == "sweep" else 64
    mu, inv = _cull_family(family, n, seed=len(family))
    ext = mesh.cull_extents(torch.from_numpy(inv)).numpy()
    assert ext.shape == (n, 2) and ext.dtype == np.float32
    finite = np.isfinite(ext).all(1)
    if family in ("not_pd", "near_singular"):
        assert not finite.any()       # never culled
        return
    if family == "sweep":
        assert 0.5 < finite.mean() < 1.0
    else:
        assert finite.all()
    if family == "det_clamped":       # the clamp widened every Gaussian
        assert inv[:, [0, 3, 5]].max() < 1e6

    lin = np.linspace(-1.0, 1.0, 24, dtype=np.float32)
    zz, yy, xx = np.meshgrid(lin[::4], lin, lin, indexing="ij")
    pts = np.stack([xx, yy, zz], -1).reshape(-1, 1, 3)
    d = pts - mu[None]                                  # f32, as the kernel
    power = _twin_power(d, inv)
    culled = (np.abs(d[..., :2]) > ext[None]).any(-1)
    assert culled.any() and (~culled).any()
    assert (power[culled] < mesh.CULL_POWER).all(), power[culled].max()

    q = inv.astype(np.float64)[:, [0, 1, 2, 1, 3, 4, 2, 4, 5]].reshape(-1, 3,
                                                                      3)
    sig = np.linalg.inv(q[finite])
    tightest = []
    for axis in (0, 1):
        for sign in (1.0, -1.0):
            t = sign * np.nextafter(ext[finite, axis], np.float32(np.inf))
            probe = t[:, None] * sig[:, :, axis] / sig[:, axis, axis][:, None]
            probe = probe.astype(np.float32)
            probe[:, axis] = t
            p = _twin_power(probe, inv[finite])
            assert (p < mesh.CULL_POWER).all(), (axis, p.max())
            tightest.append(p.max())
    assert max(tightest) > 1.01 * mesh.CULL_POWER      # the extents are tight


def test_density_grid_runs_its_twin_on_cpu_and_raises_elsewhere():
    res = 16
    fields = _fields(50, seed=1)
    xyz_n, inv, opa, _, _ = mesh.density_inputs(NumpyGaussians(*fields))
    lin, slab_z, idx, counts, rows = mesh.slab_tables(xyz_n, opa, res)
    args = [torch.from_numpy(x) for x in (lin, slab_z, idx, counts, xyz_n,
                                          inv, opa)]
    before = mesh.LAUNCHES
    grid = mesh.density_grid(*args, slab_rows=rows)
    assert mesh.LAUNCHES == before           # the twin is no launch
    torch.testing.assert_close(grid, mesh.density_grid_ref(*args),
                               rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="unsupported device"):
        mesh.density_grid(*(a.to("meta") for a in args), slab_rows=rows)


def test_native_wrappers_match_jax():
    grid = _sphere_grid(48, 0.6)
    v, t = mesh.marching_tets(grid, 0.0)
    jv, jt = jmesh.marching_tets(grid, 0.0)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(t, jt)
    assert len(t) > 4000

    def same(a, b):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)

    same(mesh.clean_mesh(v, t), jmesh.clean_mesh(jv, jt))
    same(mesh.clean_mesh(v, t, repair=True, remesh=True, remesh_size=1.5),
         jmesh.clean_mesh(jv, jt, repair=True, remesh=True, remesh_size=1.5))
    same(mesh.repair_nonmanifold(v, t), jmesh.repair_nonmanifold(jv, jt))
    same(mesh.remesh_isotropic(v, t, 2.0), jmesh.remesh_isotropic(jv, jt, 2.0))
    same(mesh.largest_component(v, t), jmesh.largest_component(jv, jt))
    same(mesh.decimate_mesh(v, t, 1000), jmesh.decimate_mesh(jv, jt, 1000))
    same(mesh.decimate_mesh_cluster(v, t, 1000),
         jmesh.decimate_mesh_cluster(jv, jt, 1000))
    n = mesh.vertex_normals(v, t)
    np.testing.assert_array_equal(n, jmesh.vertex_normals(jv, jt))
    uv = mesh.spherical_uvs(v)
    np.testing.assert_array_equal(uv, jmesh.spherical_uvs(jv))
    np.testing.assert_array_equal(mesh.vertex_tangents(v, t, uv),
                                  jmesh.vertex_tangents(jv, jt, uv))


def test_steps_after_the_density_field_reproduce_jax_exactly(monkeypatch):
    fields = _ball()
    grid, center, scale = jmesh.gaussian_density_grid(JGaussians(*fields),
                                                      64)
    # JAX's extract_mesh on this grid, without computing it again
    monkeypatch.setattr(jmesh, "gaussian_density_grid",
                        lambda g, res: (grid, center, scale))
    want = jmesh.extract_mesh(JGaussians(*fields), density_thresh=0.05,
                              resolution=64)
    stages = {}
    got = mesh.mesh_from_grid(grid, center, scale, density_thresh=0.05,
                              stage_seconds=stages)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert sorted(stages) == ["clean", "decimate", "largest_component",
                              "marching_tets"]


def test_extract_mesh_end_to_end(tmp_path):
    """tests/test_mesh.py:74-93's bars, through the port's twin."""
    stages = {}
    verts, tris = mesh.extract_mesh(NumpyGaussians(*_ball()),
                                    density_thresh=0.05, resolution=64,
                                    device="cpu", stage_seconds=stages)
    assert len(verts) > 50 and len(tris) > 50
    assert np.linalg.norm(verts, axis=1).max() < 0.6
    assert sorted(stages) == ["clean", "decimate", "density_copy",
                              "density_field", "density_inputs",
                              "density_selection", "largest_component",
                              "marching_tets"]
    path = str(tmp_path / "m.obj")
    mesh.save_mesh_obj(path, verts, tris)
    assert open(path).readline().startswith("v ")


def test_save_mesh_obj_text_equals_jax(tmp_path):
    v, t = mesh.marching_tets(_sphere_grid(24, 0.5), 0.0)
    mesh.save_mesh_obj(str(tmp_path / "a" / "port.obj"), v, t)
    jmesh.save_mesh_obj(str(tmp_path / "jax.obj"), v, t)
    assert ((tmp_path / "a" / "port.obj").read_text()
            == (tmp_path / "jax.obj").read_text())


CFG = """
system_type: "diffusion-gs-system"
system:
  num_inference_steps: 2
  use_lpips: false
  shape_model:
    width: 64
    patch_size: 8
    n_gaussians: 2
    dim_heads: 32
    num_layers: 2
  noise_scheduler:
    num_train_timesteps: 50
  raster:
    max_tiles_per_gaussian: 16
    max_per_tile: 1056
"""


def test_run_main_extract_mesh_writes_obj(tmp_path, monkeypatch):
    # the CLI meshes at 256 as JAX's does; a 32^3 grid keeps the CPU run small
    full, asked = mesh.extract_mesh, []

    def small_grid(g, resolution=256, **kw):
        asked.append(resolution)
        return full(g, resolution=32, **kw)

    monkeypatch.setattr(mesh, "extract_mesh", small_grid)
    config = tmp_path / "tiny.yaml"
    config.write_text(CFG)
    out = tmp_path / "out"
    run.main(["--image", IMAGE, "--config", str(config), "--device", "cpu",
              "--matting", "border", "--resolution", "16", "--extract-mesh",
              "--out", str(out)])
    obj = out / "mesh.obj"
    assert obj.stat().st_size > 0
    text = obj.read_text()
    assert text.startswith("v ") and "\nf " in text
    assert (out / "gaussians.ply").stat().st_size > 0
    assert asked == [256]
