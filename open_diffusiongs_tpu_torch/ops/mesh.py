"""Mesh export: the Gaussians' density field on the card + a native
iso-surface and clean-up on the host.

The port's own copy of open_diffusiongs_tpu/ops/mesh.py (the port imports
nothing of the JAX package), replicating the reference's mesh export
(gs_core.py:786-869):
  1. recentre / scale the Gaussians to ~[-1, 1] (1.8 / bbox);
  2. the occupancy sum_i opacity_i * exp(-1/2 dᵀ Σ_i⁻¹ d) on a dense grid,
     blockwise over z-slabs, each slab against the Gaussians inside its box
     ± `relax` (the `max_per_block` most opaque);
  3. marching tetrahedra at `density_thresh`, clean_mesh (merge, duplicate
     and degenerate faces, small components, non-manifold repair,
     isotropic remesh), the largest component, quadric decimation
     (native/mesher.cpp).

Step 2 is `gaussian_density_grid`.  Its host steps are JAX's numpy, line
for line (`density_inputs`: normalisation, build_cov3d -- here the port's
ops/gs_math.py -- and the inverse-covariance entries).  Each slab's list
is JAX's: the Gaussians inside the slab's box, in ascending index, or
past `max_per_block` the most opaque, in descending opacity.  JAX orders
equal opacities by np.argsort's default, which is not stable; the port
defines the order among ties as ascending index, in both of its versions
(`slab_select`, plain torch with a stable sort, which selects the lists
on every device; `slab_tables`, numpy with kind="stable", its plain
reference in the tests and chip_smoke.py).  Where JAX
runs one jitted `eval_block` per slab, the port evaluates all slabs in ONE
launch of csrc/density_grid.cu (`density_grid`) on a CUDA tensor, each
slab's list packed into contiguous records (`density_records`) with the
half-extents outside which a Gaussian adds exactly 0 (`cull_extents`); its
plain twin `density_grid_ref` runs on CPU tensors (and beside the kernel
in chip_smoke.py).  On a CUDA tensor the wrapper launches the kernel or
raises.

Step 3 loads the repository's native/libmesher.so by path, as the JAX
copy does, and never writes to native/: when the library is missing or
does not load on this host, the port compiles its own copy from
native/mesher.cpp (the Makefile's flags) into build/native/.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..utils.timing import StageClock
from . import _build
from .gaussians import NumpyGaussians
from .gs_math import build_cov3d

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE_SRC = os.path.join(_REPO_ROOT, "native", "mesher.cpp")
_LIB_PATH = os.path.join(_REPO_ROOT, "native", "libmesher.so")
_BUILD_LIB = os.path.join(_REPO_ROOT, "build", "native", "libmesher.so")
CXXFLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]   # native/Makefile's

LAUNCHES = 0   # density_grid kernel launches (CUDA tensors only)


def _build_mesher() -> str:
    """Compile native/mesher.cpp into build/native/ (once per host)."""
    if not os.path.exists(_BUILD_LIB):
        os.makedirs(os.path.dirname(_BUILD_LIB), exist_ok=True)
        cxx = os.environ.get("CXX") or shutil.which("g++") or "c++"
        with tempfile.TemporaryDirectory(
                dir=os.path.dirname(_BUILD_LIB)) as work:
            tmp = os.path.join(work, "libmesher.so")
            subprocess.run([cxx, *CXXFLAGS, "-o", tmp, _NATIVE_SRC],
                           check=True, capture_output=True)
            os.replace(tmp, _BUILD_LIB)
    return _BUILD_LIB


@functools.lru_cache(None)
def _lib() -> ctypes.CDLL:
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:               # missing, or built for another host
        lib = ctypes.CDLL(_build_mesher())
    lib.mesh_marching_tets.restype = ctypes.c_int
    lib.mesh_marching_tets.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ctypes.POINTER(ctypes.c_int64)]
    lib.mesh_largest_component.restype = ctypes.c_int
    lib.mesh_decimate_cluster.restype = ctypes.c_int
    lib.mesh_decimate_quadric.restype = ctypes.c_int
    lib.mesh_clean.restype = ctypes.c_int
    lib.mesh_repair_nonmanifold.restype = ctypes.c_int
    lib.mesh_remesh_isotropic.restype = ctypes.c_int
    lib.mesh_free.restype = None
    lib.mesh_free.argtypes = [ctypes.c_void_p]
    return lib


def _unpack_out(vp, nv, tp, nt):
    verts = np.ctypeslib.as_array(vp, (nv.value, 3)).copy() \
        if nv.value else np.zeros((0, 3), np.float32)
    tris = np.ctypeslib.as_array(tp, (nt.value, 3)).copy() \
        if nt.value else np.zeros((0, 3), np.int32)
    _lib().mesh_free(ctypes.cast(vp, ctypes.c_void_p))
    _lib().mesh_free(ctypes.cast(tp, ctypes.c_void_p))
    return verts, tris


def _out_ptrs():
    return (ctypes.POINTER(ctypes.c_float)(), ctypes.c_int64(),
            ctypes.POINTER(ctypes.c_int32)(), ctypes.c_int64())


def _mesh_args(verts: np.ndarray, tris: np.ndarray) -> tuple:
    return (np.ascontiguousarray(verts, np.float32).ctypes.data_as(
                ctypes.POINTER(ctypes.c_float)),
            ctypes.c_int64(len(verts)),
            np.ascontiguousarray(tris, np.int32).ctypes.data_as(
                ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int64(len(tris)))


def marching_tets(grid: np.ndarray, iso: float
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """grid: [nx, ny, nz] float32 -> (verts [V, 3] in grid coords,
    tris [F, 3] int32)."""
    grid = np.ascontiguousarray(grid, np.float32)
    nx, ny, nz = grid.shape
    vp, nv, tp, nt = _out_ptrs()
    rc = _lib().mesh_marching_tets(
        grid.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        nx, ny, nz, ctypes.c_float(iso),
        ctypes.byref(vp), ctypes.byref(nv), ctypes.byref(tp), ctypes.byref(nt))
    assert rc == 0, "marching tets failed"
    return _unpack_out(vp, nv, tp, nt)


def largest_component(verts: np.ndarray, tris: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
    if len(tris) == 0:
        return verts, tris
    keep = np.zeros((len(tris),), np.uint8)
    rc = _lib().mesh_largest_component(
        *_mesh_args(verts, tris),
        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    assert rc == 0
    tris = tris[keep.astype(bool)]
    used = np.unique(tris)
    remap = np.full(len(verts), -1, np.int32)
    remap[used] = np.arange(len(used), dtype=np.int32)
    return verts[used], remap[tris]


def decimate_mesh(verts: np.ndarray, tris: np.ndarray,
                  target_tris: int = 100_000
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Quadric edge-collapse decimation toward a target triangle count
    (the reference's meshing_decimation_quadric_edge_collapse,
    utils/mesh_utils.py:44-85; native/mesher.cpp mesh_decimate_quadric)."""
    if len(tris) <= target_tris:
        return verts, tris
    vp, nv, tp, nt = _out_ptrs()
    rc = _lib().mesh_decimate_quadric(
        *_mesh_args(verts, tris), ctypes.c_int64(int(target_tris)),
        ctypes.byref(vp), ctypes.byref(nv), ctypes.byref(tp),
        ctypes.byref(nt))
    assert rc == 0, "quadric decimation failed"
    return _unpack_out(vp, nv, tp, nt)


def repair_nonmanifold(verts: np.ndarray, tris: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Non-manifold repair (pymeshlab meshing_repair_non_manifold_edges
    method=0 + meshing_repair_non_manifold_vertices vertdispratio=0,
    utils/mesh_utils.py:127-130)."""
    if len(tris) == 0:
        return verts, tris
    vp, nv, tp, nt = _out_ptrs()
    rc = _lib().mesh_repair_nonmanifold(
        *_mesh_args(verts, tris),
        ctypes.byref(vp), ctypes.byref(nv), ctypes.byref(tp),
        ctypes.byref(nt))
    assert rc == 0, "non-manifold repair failed"
    return _unpack_out(vp, nv, tp, nt)


def remesh_isotropic(verts: np.ndarray, tris: np.ndarray,
                     target_len: float, iterations: int = 3
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Isotropic explicit remeshing toward a target edge length (pymeshlab
    meshing_isotropic_explicit_remeshing, utils/mesh_utils.py:134-136)."""
    if len(tris) == 0:
        return verts, tris
    vp, nv, tp, nt = _out_ptrs()
    rc = _lib().mesh_remesh_isotropic(
        *_mesh_args(verts, tris),
        ctypes.c_float(target_len), ctypes.c_int(int(iterations)),
        ctypes.byref(vp), ctypes.byref(nv), ctypes.byref(tp),
        ctypes.byref(nt))
    assert rc == 0, "isotropic remesh failed"
    return _unpack_out(vp, nv, tp, nt)


def clean_mesh(verts: np.ndarray, tris: np.ndarray,
               v_pct: float = 1.0, min_f: int = 64, min_d: float = 20.0,
               repair: bool = False, remesh: bool = False,
               remesh_size: float = 0.01
               ) -> Tuple[np.ndarray, np.ndarray]:
    """pymeshlab-style cleaning (clean_mesh, utils/mesh_utils.py:88-146):
    merge vertices closer than v_pct% of the bbox diagonal, drop duplicate
    and degenerate faces, remove components with < min_f faces or diameter
    < min_d% of the bbox diagonal, drop unreferenced vertices; then
    optionally `repair` and `remesh` (off by default as in JAX; the export
    path turns both on)."""
    if len(tris) == 0:
        return verts, tris
    vp, nv, tp, nt = _out_ptrs()
    rc = _lib().mesh_clean(
        *_mesh_args(verts, tris),
        ctypes.c_float(v_pct), ctypes.c_float(min_d),
        ctypes.c_int64(min_f),
        ctypes.byref(vp), ctypes.byref(nv), ctypes.byref(tp),
        ctypes.byref(nt))
    assert rc == 0, "mesh clean failed"
    verts, tris = _unpack_out(vp, nv, tp, nt)
    if repair and len(tris):
        verts, tris = repair_nonmanifold(verts, tris)
    if remesh and len(tris):
        verts, tris = remesh_isotropic(verts, tris, remesh_size)
    return verts, tris


def decimate_mesh_cluster(verts: np.ndarray, tris: np.ndarray,
                          target_tris: int = 100_000, max_iters: int = 8
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Vertex-clustering decimation (fast, coarse; the cheap alternative to
    `decimate_mesh`)."""
    if len(tris) <= target_tris:
        return verts, tris
    lib = _lib()
    cells = 256
    cur_v, cur_t = verts, tris
    for _ in range(max_iters):
        vp, nv, tp, nt = _out_ptrs()
        rc = lib.mesh_decimate_cluster(
            *_mesh_args(verts, tris), ctypes.c_int(cells),
            ctypes.byref(vp), ctypes.byref(nv), ctypes.byref(tp),
            ctypes.byref(nt))
        assert rc == 0
        cur_v = np.ctypeslib.as_array(vp, (nv.value, 3)).copy()
        cur_t = np.ctypeslib.as_array(tp, (nt.value, 3)).copy() \
            if nt.value else np.zeros((0, 3), np.int32)
        lib.mesh_free(ctypes.cast(vp, ctypes.c_void_p))
        lib.mesh_free(ctypes.cast(tp, ctypes.c_void_p))
        if len(cur_t) <= target_tris or cells <= 8:
            break
        cells = max(8, int(cells / (len(cur_t) / target_tris) ** (1 / 3)))
    return cur_v.astype(np.float32), cur_t


# ---------------------------------------------------------------------------
# The density field
# ---------------------------------------------------------------------------

# expf of a power below this is 0 in f32 (e^-104 is under half the smallest
# denormal), so csrc/density_grid.cu adds no term there (its SKIP_BELOW)
CULL_POWER = -104.0
# The kernel's f32 power, -1/2 (A dx² + D dy² + F dz²) - B dx dy - C dx dz
# - E dy dz, rounds at most 7 times on any term's path: it lies within
# 7·2^-24 · ½|d|ᵀ|Q||d| of the exact value.  The cull takes 16·2^-24.
POWER_ROUNDING = 16 * 2.0 ** -24
# f32 values of a packed record: mu (3), opacity | A, B, C, D | E, F, and
# the cull's half-extents in x and y
RECORD_FLOATS = 12


def density_inputs(g: NumpyGaussians):
    """JAX's host steps (gaussian_density_grid :285-307): (xyz_n [N, 3],
    inv [N, 6], opa [N] f32, center [3], scale)."""
    xyz = g.xyz.astype(np.float32)
    opa = 1.0 / (1.0 + np.exp(-g.opacity[:, 0].astype(np.float32)))
    mn, mx = xyz.min(0), xyz.max(0)
    center = (mn + mx) / 2
    scale = 1.8 / max((mx - mn).max(), 1e-8)
    xyz_n = (xyz - center) * scale
    stds = np.exp(g.scaling.astype(np.float32)) * scale
    rot = g.rotation / np.clip(
        np.linalg.norm(g.rotation, axis=-1, keepdims=True), 1e-12, None)
    cov6 = build_cov3d(torch.from_numpy(np.ascontiguousarray(stds)),
                       torch.from_numpy(np.ascontiguousarray(rot))).numpy()
    # inverse covariance entries (gaussian_3d_coeff semantics)
    a, b, c = cov6[:, 0], cov6[:, 1], cov6[:, 2]
    d, e, f = cov6[:, 3], cov6[:, 4], cov6[:, 5]
    det = a * d * f + 2 * b * c * e - a * e * e - d * c * c - f * b * b
    det = np.where(np.abs(det) < 1e-24, 1e-24, det)
    inv = np.stack([(d * f - e * e), -(b * f - c * e), (b * e - c * d),
                    (a * f - c * c), -(a * e - b * c), (a * d - b * b)],
                   axis=-1) / det[:, None]
    return xyz_n, inv, opa, center, scale


def slab_grid(resolution: int, block_pts: int = 32768):
    """The grid's coordinates and z-slabs as JAX's loop makes them: (lin
    [res] f32, np.linspace's floats; slab_z [n_slabs, 2] int32 (z0, z1);
    slab_rows, the z rows of a slab)."""
    lin = np.linspace(-1.0, 1.0, resolution, dtype=np.float32)
    slab_rows = max(1, block_pts // (resolution * resolution))
    z0 = np.arange(0, resolution, slab_rows, dtype=np.int32)
    slab_z = np.stack([z0, np.minimum(z0 + slab_rows, resolution)], 1)
    return lin, slab_z.astype(np.int32), slab_rows


def slab_tables(xyz_n: np.ndarray, opa: np.ndarray, resolution: int,
                block_pts: int = 32768, max_per_block: int = 8192,
                relax: float = 0.1):
    """JAX's slab loop (:325-341) without the evaluation, in numpy: (lin
    [res] f32, slab_z [n_slabs, 2] int32, idx [n_slabs, max_per_block]
    int32 (zero past each count), counts [n_slabs] int32, slab_rows).  A
    slab's box is its points' min / max ± relax: lin[0] / lin[-1] in x and
    y, its first and last z (lin is increasing), as JAX's meshgrid gives
    them.  The plain reference of `slab_select` (the tests and
    chip_smoke.py); past the cap, ties in opacity keep the lower indices
    (see gaussian_density_grid)."""
    lin, slab_z, slab_rows = slab_grid(resolution, block_pts)
    idx_t = np.zeros((len(slab_z), max_per_block), np.int32)
    counts = np.zeros((len(slab_z),), np.int32)
    for s, (z0, z1) in enumerate(slab_z):
        vmin = np.stack([lin[0], lin[0], lin[z0]]) - relax
        vmax = np.stack([lin[-1], lin[-1], lin[z1 - 1]]) + relax
        mask = ((xyz_n > vmin) & (xyz_n < vmax)).all(-1)
        idx = np.nonzero(mask)[0]
        if len(idx) > max_per_block:
            idx = idx[np.argsort(-opa[idx], kind="stable")[:max_per_block]]
        idx_t[s, :len(idx)] = idx
        counts[s] = len(idx)
    return lin, slab_z, idx_t, counts, slab_rows


def slab_select(xyz_n: torch.Tensor, opa: torch.Tensor, resolution: int,
                block_pts: int = 32768, max_per_block: int = 8192,
                relax: float = 0.1, chunk_elems: int = 1 << 26):
    """`slab_tables` in plain torch on xyz_n's device (the path's
    selection, on the card or the CPU): the same tables, element for element, as tensors there
    (slab_rows an int).  Boxes and comparisons are f32 as numpy's; the
    [slabs, N] membership mask is made for as many slabs at a time as keep
    it under `chunk_elems` elements.  A slab's members come in ascending
    index; a capped slab's in the order of one stable sort of -opacity
    over all Gaussians, so ties keep the lower indices."""
    dev = xyz_n.device
    lin_np, slab_z_np, slab_rows = slab_grid(resolution, block_pts)
    lin, slab_z = (torch.from_numpy(x).to(dev) for x in (lin_np, slab_z_np))
    n_slabs, n = len(slab_z_np), xyz_n.shape[0]
    lo, hi = lin - np.float32(relax), lin + np.float32(relax)
    x, y, z = xyz_n.unbind(1)
    in_xy = (x > lo[0]) & (x < hi[-1]) & (y > lo[0]) & (y < hi[-1])
    z_lo = lo[slab_z[:, 0].long()]
    z_hi = hi[slab_z[:, 1].long() - 1]
    by_opacity = torch.sort(-opa, stable=True).indices
    idx = torch.zeros((n_slabs, max_per_block), dtype=torch.int32,
                      device=dev)
    counts = torch.zeros((n_slabs,), dtype=torch.int32, device=dev)
    step = max(1, chunk_elems // max(n, 1))
    for s0 in range(0, n_slabs, step):
        zl, zh = z_lo[s0:s0 + step, None], z_hi[s0:s0 + step, None]
        member = in_xy & (z > zl) & (z < zh)                  # [sc, N]
        count = member.sum(1)
        capped = count > max_per_block
        member[capped] = member[capped][:, by_opacity]
        row, col = member.nonzero(as_tuple=True)    # row-major order
        slot = (torch.arange(row.shape[0], device=dev)
                - (torch.cumsum(count, 0) - count)[row])
        keep = slot < max_per_block
        row, col, slot = row[keep], col[keep], slot[keep]
        col = torch.where(capped[row], by_opacity[col], col)
        idx[s0 + row, slot] = col.int()
        counts[s0:s0 + step] = count.clamp(max=max_per_block).int()
    return lin, slab_z, idx, counts, slab_rows


def cull_extents(inv: torch.Tensor) -> torch.Tensor:
    """Half-extents in x and y ([N, 2] f32) outside which each Gaussian's
    f32 power, as csrc/density_grid.cu evaluates it, is below CULL_POWER:
    a pair with |dx| > ext_x or |dy| > ext_y (dx, dy the kernel's f32
    offsets) adds exactly 0 to the grid.

    With Q = [[A, B, C], [B, D, E], [C, E, F]] (inv's f32 entries as
    reals), the kernel's power is within g·½ρ|d|² of -½dᵀQd (g =
    POWER_ROUNDING; ρ = max row sum of |Q| bounds |Q|'s norm).  Where Q' =
    Q - gρI is positive definite, ½dᵀQ'd > -CULL_POWER makes that power
    < CULL_POWER, and the least of dᵀQ'd on the plane d_x = t is
    t² / (Q'⁻¹)_xx: so ext_x = sqrt(-2 CULL_POWER (Q'⁻¹)_xx), from an
    LDLᵀ factorisation in f64, widened by 1e-5.  The factorisation must
    first succeed for Q - 2gρI (f64's rounding, ~1e-15 ρ, is far inside
    the second gρ); a Gaussian whose Q fails it (not positive definite,
    too ill-conditioned, or not finite) gets infinite extents and is never
    culled.  Plain torch on inv's device."""
    a, b, c, d, e, f = inv.double().unbind(1)
    rho = torch.maximum(torch.maximum(a.abs() + b.abs() + c.abs(),
                                      b.abs() + d.abs() + e.abs()),
                        c.abs() + e.abs() + f.abs())

    def ldl(shift):
        d1 = a - shift
        l21, l31 = b / d1, c / d1
        d2 = d - shift - l21 * b
        l32 = (e - l31 * b) / d2
        d3 = f - shift - l31 * c - l32 * l32 * d2
        return d1, d2, d3, l21, l31, l32

    d1, d2, d3 = ldl(2 * POWER_ROUNDING * rho)[:3]
    ok = (d1 > 0) & (d2 > 0) & (d3 > 0)
    d1, d2, d3, l21, l31, l32 = ldl(POWER_ROUNDING * rho)
    # diag(Q'^-1) = diag(L^-T D^-1 L^-1): sums of positive terms
    var_x = 1 / d1 + l21 * l21 / d2 + (l21 * l32 - l31) ** 2 / d3
    var_y = 1 / d2 + l32 * l32 / d3
    ext = torch.sqrt(-2 * CULL_POWER * torch.stack([var_x, var_y], 1))
    ext = torch.where(ok[:, None], ext * (1 + 1e-5), float("inf"))
    return ext.float()


def density_records(idx: torch.Tensor, xyz: torch.Tensor, inv: torch.Tensor,
                    opa: torch.Tensor) -> torch.Tensor:
    """Each slab's list gathered into packed records, [n_slabs,
    max_per_block, RECORD_FLOATS] f32 (mu, opacity | A, B, C, D | E, F,
    ext_x, ext_y; rows past a slab's count hold Gaussian 0's), so that the
    kernel stages a list with coalesced 16-byte loads."""
    table = torch.cat([xyz, opa[:, None], inv, cull_extents(inv)], 1)
    return table[idx.long()]


def density_power(dx: torch.Tensor, dy: torch.Tensor, dz: torch.Tensor,
                  q: torch.Tensor) -> torch.Tensor:
    """The twin's power of offsets (dx, dy, dz) under inverse-covariance
    entries q [..., 6] (A, B, C, D, E, F; broadcast against the offsets),
    in the kernel's order of operations."""
    a, b, c, d, e, f = q.unbind(-1)
    return (-0.5 * (a * (dx * dx) + d * (dy * dy) + f * (dz * dz))
            - b * dx * dy - c * dx * dz - e * dy * dz)


def density_grid_ref(lin: torch.Tensor, slab_z: torch.Tensor,
                     idx: torch.Tensor, counts: torch.Tensor,
                     xyz: torch.Tensor, inv: torch.Tensor, opa: torch.Tensor,
                     chunk_pairs: int = 1 << 22,
                     live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain twin of csrc/density_grid.cu (JAX's eval_block, :312-322),
    slab by slab, chunked over points so that at most `chunk_pairs`
    (point, Gaussian) pairs are alive at once.  Returns [res, res, res]
    f32 in [x, y, z] order.  `live`, a one-element int64 tensor, gets the
    pairs whose power lies in (CULL_POWER, 0] added to it."""
    res = lin.shape[0]
    grid = torch.zeros((res, res, res), dtype=torch.float32,
                       device=lin.device)
    for s in range(slab_z.shape[0]):
        n = int(counts[s])
        if n == 0:
            continue
        z0, z1 = int(slab_z[s, 0]), int(slab_z[s, 1])
        sel = idx[s, :n].long()
        mu, q, o = xyz[sel], inv[sel], opa[sel]
        zz, yy, xx = torch.meshgrid(lin[z0:z1], lin, lin, indexing="ij")
        pts = torch.stack([xx, yy, zz], -1).reshape(-1, 3)
        val = torch.empty(pts.shape[0], dtype=torch.float32,
                          device=lin.device)
        step = max(1, chunk_pairs // n)
        for p0 in range(0, pts.shape[0], step):
            p = pts[p0:p0 + step]
            power = density_power(*(p[:, i:i + 1] - mu[None, :, i]
                                    for i in range(3)), q)
            w = torch.where(power <= 0, torch.exp(power), 0.0)
            val[p0:p0 + step] = (o * w).sum(1)
            if live is not None:
                live += ((power <= 0) & (power > CULL_POWER)).sum()
        # val is (z, y, x); the grid is indexed [x, y, z]
        grid[:, :, z0:z1] = val.reshape(z1 - z0, res, res).permute(2, 1, 0)
    return grid


def _check(name: str, x: torch.Tensor, dtype, device) -> None:
    if x.device != device or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"density_grid: {name} must be a contiguous "
                         f"{dtype} tensor on {device}; got {x.dtype} on "
                         f"{x.device}")


def density_kernel(lin: torch.Tensor, slab_z: torch.Tensor,
                   counts: torch.Tensor, rec: torch.Tensor, slab_rows: int,
                   cull: bool = True,
                   counters: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of csrc/density_grid.cu over all slabs on CUDA tensors
    (records from `density_records`), the grid [res, res, res] f32.
    `cull=False` evaluates every pair of the lists (the check that the cull
    changes no bit; nothing on the serving path sets it).  `counters`, a
    [3] int64 tensor on the card, gets added to it the live pairs (f32
    power in (CULL_POWER, 0]), the evaluated (point, record) pairs and the
    (tile, record) box tests."""
    global LAUNCHES
    if lin.device.type != "cuda":
        raise RuntimeError(f"density_kernel: unsupported device "
                           f"{lin.device}")
    for name, x, dt in (("lin", lin, torch.float32),
                        ("slab_z", slab_z, torch.int32),
                        ("counts", counts, torch.int32),
                        ("rec", rec, torch.float32)):
        _check(name, x, dt, lin.device)
    n_slabs, max_per_block, width = rec.shape
    if (width != RECORD_FLOATS or slab_z.shape != (n_slabs, 2)
            or counts.shape != (n_slabs,) or rec.data_ptr() % 16):
        raise ValueError(f"density_kernel: rec {tuple(rec.shape)} (16-byte "
                         f"aligned, {RECORD_FLOATS} floats a row), slab_z "
                         f"{tuple(slab_z.shape)}, counts "
                         f"{tuple(counts.shape)}")
    if counters is not None:
        _check("counters", counters, torch.int64, lin.device)
        if counters.numel() != 3:
            raise ValueError("density_kernel: counters must hold 3 values")
    res = lin.shape[0]
    grid = torch.empty((res, res, res), dtype=torch.float32,
                       device=lin.device)
    err = _build.load_library().odgs_density_grid(
        lin.data_ptr(), slab_z.data_ptr(), counts.data_ptr(), rec.data_ptr(),
        grid.data_ptr(), res, n_slabs, max_per_block, slab_rows, int(cull),
        None if counters is None else counters.data_ptr(),
        torch.cuda.current_stream(lin.device).cuda_stream)
    _build.check(err, "density_grid")
    LAUNCHES += 1
    return grid


def density_grid(lin: torch.Tensor, slab_z: torch.Tensor, idx: torch.Tensor,
                 counts: torch.Tensor, xyz: torch.Tensor, inv: torch.Tensor,
                 opa: torch.Tensor, slab_rows: int) -> torch.Tensor:
    """The density field of every slab: on CUDA tensors (lin / xyz / inv /
    opa f32, slab_z / idx / counts int32, contiguous) the lists packed by
    `density_records` and csrc/density_grid.cu in one launch (the cull
    on); `density_grid_ref` on CPU tensors."""
    if lin.device.type == "cpu":
        return density_grid_ref(lin, slab_z, idx, counts, xyz, inv, opa)
    if lin.device.type != "cuda":
        raise RuntimeError(f"density_grid: unsupported device {lin.device}")
    for name, x, dt in (("idx", idx, torch.int32),
                        ("xyz", xyz, torch.float32),
                        ("inv", inv, torch.float32),
                        ("opa", opa, torch.float32)):
        _check(name, x, dt, lin.device)
    return density_kernel(lin, slab_z, counts,
                          density_records(idx, xyz, inv, opa), slab_rows)


def gaussian_density_grid(g: NumpyGaussians, resolution: int = 256,
                          block_pts: int = 32768,
                          max_per_block: int = 8192,
                          relax: float = 0.1, device=None,
                          stage_seconds: Optional[Dict[str, float]] = None):
    """Blockwise density field (extract_fields, gs_core.py:786-852) on
    `device` (the GPU, raising without one, unless it names another, e.g.
    "cpu").  Returns (grid [res, res, res] float32 numpy, center [3],
    scale): verts from the grid map back to world via v / scale + center.

    The slabs' lists are JAX's, with one rule JAX leaves to numpy: where a
    slab holds more than `max_per_block` Gaussians and equal opacities
    straddle the cut, the lower indices are kept (JAX's np.argsort is not
    stable, so its order among ties is numpy's own).  They are chosen on
    `device` (`slab_select`).
    `stage_seconds` receives the host seconds, at synchronized edges, of
    density_inputs (with the inputs' transfer to the device), the
    selection, the field and the grid's copy to the host."""
    from .. import select_device
    dev = select_device(device)
    clock = StageClock(stage_seconds, dev)
    xyz_n, inv, opa, center, scale = density_inputs(g)
    xyz_t, inv_t, opa_t = (torch.from_numpy(np.ascontiguousarray(
        x, np.float32)).to(dev) for x in (xyz_n, inv, opa))
    clock.stage("density_inputs")
    lin, slab_z, idx, counts, slab_rows = slab_select(
        xyz_t, opa_t, resolution, block_pts, max_per_block, relax)
    clock.stage("density_selection")
    grid = density_grid(lin, slab_z, idx, counts, xyz_t, inv_t, opa_t,
                        slab_rows=slab_rows)
    clock.stage("density_field")
    grid = grid.cpu().numpy()
    clock.stage("density_copy")
    return grid, center, scale


def extract_mesh(g: NumpyGaussians, density_thresh: float = 0.005,
                 resolution: int = 256, keep_largest: bool = True,
                 decimate_target: int = 100_000, clean: bool = True,
                 repair: bool = True, remesh: bool = True,
                 remesh_size: float = 0.01, device=None,
                 stage_seconds: Optional[Dict[str, float]] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Gaussians -> (verts [V, 3] world-space, tris [F, 3])
    (extract_mesh, gs_core.py:855-869, with JAX's defaults): the density
    field on `device` (as gaussian_density_grid), then `mesh_from_grid`.
    `stage_seconds` receives the host seconds of each step: the density
    field's density_inputs, density_selection, density_field and
    density_copy (gaussian_density_grid's), then marching_tets, clean
    (with repair and remesh), largest_component and decimate."""
    grid, center, scale = gaussian_density_grid(
        g, resolution, device=device, stage_seconds=stage_seconds)
    return mesh_from_grid(grid, center, scale, density_thresh,
                          keep_largest, decimate_target, clean, repair,
                          remesh, remesh_size, stage_seconds)


def mesh_from_grid(grid: np.ndarray, center, scale,
                   density_thresh: float = 0.005, keep_largest: bool = True,
                   decimate_target: int = 100_000, clean: bool = True,
                   repair: bool = True, remesh: bool = True,
                   remesh_size: float = 0.01,
                   stage_seconds: Optional[Dict[str, float]] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """A density grid [res, res, res] -> world-space (verts, tris): marching
    tets at `density_thresh`, clean_mesh with repair and remesh
    (`remesh_size` in the [-1, 1] frame, converted to grid units since
    cleaning runs before the rescale), the largest component, quadric
    decimation to `decimate_target` triangles (JAX extract_mesh :367-382)."""
    resolution = grid.shape[0]
    stage = StageClock(stage_seconds, "cpu").stage   # host steps only
    verts, tris = marching_tets(grid, density_thresh)
    stage("marching_tets")
    if clean and len(tris):
        # reference clean_mesh defaults: v_pct=1, min_f=64, min_d=20
        verts, tris = clean_mesh(
            verts, tris, repair=repair, remesh=remesh,
            remesh_size=remesh_size * (resolution - 1) / 2.0)
    stage("clean")
    if keep_largest and len(tris):
        verts, tris = largest_component(verts, tris)
    stage("largest_component")
    if decimate_target and decimate_target > 0:
        verts, tris = decimate_mesh(verts, tris, decimate_target)
    stage("decimate")
    # grid coords -> [-1, 1] -> world
    verts = verts / (resolution - 1.0) * 2.0 - 1.0
    verts = verts / scale + center
    return verts.astype(np.float32), tris


# ---------------------------------------------------------------------------
# Export helpers
# ---------------------------------------------------------------------------


def save_mesh_obj(path: str, verts: np.ndarray, tris: np.ndarray) -> None:
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for t in tris:
            f.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")


def vertex_normals(verts: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Area-weighted smooth vertex normals (reference geometry/utils.py
    Mesh._compute_vertex_normal)."""
    verts = np.asarray(verts, np.float64).reshape(-1, 3)
    tris = np.asarray(tris, np.int64).reshape(-1, 3)
    fn = np.cross(verts[tris[:, 1]] - verts[tris[:, 0]],
                  verts[tris[:, 2]] - verts[tris[:, 0]])  # 2*area * normal
    vn = np.zeros_like(verts)
    for c in range(3):
        np.add.at(vn, tris[:, c], fn)
    norm = np.linalg.norm(vn, axis=-1, keepdims=True)
    vn = np.where(norm > 1e-20, vn / np.maximum(norm, 1e-20),
                  np.array([0.0, 0.0, 1.0]))
    return vn.astype(np.float32)


def vertex_tangents(verts: np.ndarray, tris: np.ndarray, uvs: np.ndarray,
                    normals: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-vertex tangents from UVs (reference geometry/utils.py
    Mesh._compute_vertex_tangent), Gram-Schmidt-orthogonalized against the
    normal."""
    verts = np.asarray(verts, np.float64).reshape(-1, 3)
    tris = np.asarray(tris, np.int64).reshape(-1, 3)
    uvs = np.asarray(uvs, np.float64).reshape(-1, 2)
    if normals is None:
        normals = vertex_normals(verts, tris)
    normals = np.asarray(normals, np.float64).reshape(-1, 3)

    e1 = verts[tris[:, 1]] - verts[tris[:, 0]]
    e2 = verts[tris[:, 2]] - verts[tris[:, 0]]
    du1 = uvs[tris[:, 1]] - uvs[tris[:, 0]]
    du2 = uvs[tris[:, 2]] - uvs[tris[:, 0]]
    det = du1[:, 0] * du2[:, 1] - du1[:, 1] * du2[:, 0]
    r = np.where(np.abs(det) > 1e-20, 1.0 / np.where(det == 0, 1.0, det), 0.0)
    tang = (e1 * du2[:, 1:2] - e2 * du1[:, 1:2]) * r[:, None]
    vt = np.zeros_like(verts)
    for c in range(3):
        np.add.at(vt, tris[:, c], tang)
    vt = vt - normals * np.sum(vt * normals, axis=-1, keepdims=True)
    norm = np.linalg.norm(vt, axis=-1, keepdims=True)
    fallback = np.cross(normals, np.array([0.0, 1.0, 0.0]))
    fb_norm = np.linalg.norm(fallback, axis=-1, keepdims=True)
    fallback = np.where(fb_norm > 1e-6, fallback / np.maximum(fb_norm, 1e-20),
                        np.array([1.0, 0.0, 0.0]))
    vt = np.where(norm > 1e-10, vt / np.maximum(norm, 1e-20), fallback)
    return vt.astype(np.float32)


def spherical_uvs(verts: np.ndarray,
                  center: Optional[np.ndarray] = None) -> np.ndarray:
    """Spherical-projection UVs for a quick textured export when no atlas
    exists."""
    verts = np.asarray(verts, np.float64).reshape(-1, 3)
    if center is None:
        center = verts.mean(axis=0)
    d = verts - center
    r = np.linalg.norm(d, axis=-1)
    u = 0.5 + np.arctan2(d[:, 2], d[:, 0]) / (2.0 * np.pi)
    v = 0.5 + np.arcsin(np.clip(d[:, 1] / np.maximum(r, 1e-20), -1, 1)) / np.pi
    return np.stack([u, v], axis=-1).astype(np.float32)
