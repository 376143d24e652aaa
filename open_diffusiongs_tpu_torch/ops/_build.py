"""Build and load the port's hand-written CUDA kernels (csrc/*.cu).

Every `.cu` file under `open_diffusiongs_tpu_torch/csrc/` (with the shared
`.cuh` headers beside it) is compiled by its own `nvcc` process (all
started together, then linked) into ONE shared library with a plain C
interface, loaded with `ctypes` (no PyTorch headers: the build takes
seconds, not minutes).  The library lands in
`<repo>/build/torch_kernels/<hash>/`, keyed by a hash of the sources,
headers and flags, so an edited kernel rebuilds and an unchanged one is
reused; each source's ptxas report (`-Xptxas -v`) is kept there as
`<stem>.log` (`build_log`).  The TMA tensor maps are encoded through
`cudaGetDriverEntryPoint` (csrc/hopper.cuh), so nothing links `-lcuda`.
Nothing is built at import time: the first wrapper that launches a kernel
on a CUDA tensor calls `load_library()`.

No `--use_fast_math`: the blend's `expf` must stay IEEE-accurate to hold the
rasterizer's 2e-5 parity bar, and the density field's (density_grid.cu) its
1e-5 one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
# each source is compiled with ptxas's report (registers, spills, wgmma
# serialisation warnings), kept beside the library as <stem>.log
COMPILE_FLAGS = [f for f in NVCC_FLAGS if f != "-shared"] + ["-Xptxas", "-v"]
LIB_NAME = "libodgs_kernels.so"

_lib = None
BUILD_SECONDS = None   # nvcc wall time in this process (None: reused)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C signatures of the kernels' launch functions (csrc/*.cu); each returns
# the cudaError_t of its launch.
SIGNATURES = {
    # q, k, v, o, lse (or None), b, lp, h, dh, lk_real, lq_real, scale,
    # q/k/v batch and row strides (elements), scalar_max, o_f32, stream
    "odgs_flash_attn_fwd_bf16": [_P] * 5 + [_I] * 6 + [_F] + [_L] * 6
                                + [_I, _I, _P],
    # q, k, v, o, b, lq, lk, h, d, dm (columns the maps read), scale,
    # q/k/v batch, row and head strides (elements), pv_f32, score_bf16,
    # stream
    "odgs_flash_full_fwd_bf16": [_P] * 4 + [_I] * 6 + [_F] + [_L] * 9
                                + [_I, _I, _P],
    # q, k, v, o, lse, b, lq, lk, h, d, dm, scale (bf16(d^-1/2)), q/k/v
    # batch, row and head strides (elements), grid (CTAs), stream
    "odgs_flash_full_fwd_stats_bf16": [_P] * 5 + [_I] * 6 + [_F] + [_L] * 9
                                      + [_I, _P],
    # q, o, dout, q~ (out), delta (out), counters, b, lq, h, d, dm,
    # n_counters, scale (bf16(d^-1/2)), q/o/dout batch, row and head
    # strides (elements), stream
    "odgs_flash_full_bwd_prep_bf16": [_P] * 6 + [_I] * 6 + [_F] + [_L] * 9
                                     + [_P],
    # q~, k, v, dout, lse, delta, acc, counters, dq, dk, dv, b, lq, lk, h,
    # d, dm, groups, dq_scale, k/v/dout batch, row and head strides
    # (elements), stream
    "odgs_flash_full_bwd_bf16": [_P] * 11 + [_I] * 7 + [_F] + [_L] * 9
                                + [_P],
    # q, k, v, dout, lse, delta, dq, dk, dv, b, lp, h, dh, lk_real,
    # lq_real, scale, q/k/v/dout/dq/dk/dv batch and row strides
    # (elements), out_f32, stream
    "odgs_flash_attn_bwd_bf16": [_P] * 9 + [_I] * 6 + [_F] + [_L] * 14
                                + [_I, _P],
    # packed, idx, counts, num_tiles, k, tiles_x, t_fin, acc_c, acc_d,
    # n_end, stream
    "odgs_blend_fwd": [_P] * 3 + [_I] * 3 + [_P] * 5,
    # packed, idx, counts, n_end (or None), num_tiles, k, tiles_x, t_fin,
    # acc_c, acc_d, d_tfin, d_accc, d_accd, dg, stream
    "odgs_blend_bwd": [_P] * 4 + [_I] * 3 + [_P] * 8,
    # lin, slab_z, counts, rec, grid, res, n_slabs, max_per_block,
    # slab_rows, cull, counters (or None), stream
    "odgs_density_grid": [_P] * 5 + [_I] * 5 + [_P, _P],
}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot build")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + COMPILE_FLAGS).encode())
    for src in _sources() + _headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into build/torch_kernels/<hash>/ (no-op when the
    library for these sources exists).  Returns the library path."""
    global BUILD_SECONDS
    out_dir = build_dir()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as work:
        # one nvcc per source, all running at once, then one link
        jobs = []
        for src in _sources():
            obj = os.path.join(work, src.stem + ".o")
            cmd = [nvcc, *COMPILE_FLAGS, "-c", "-o", obj, str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = [(cmd, proc.communicate()[0], proc.returncode)
                for cmd, _, proc in jobs]
        for cmd, log, rc in logs:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}"
                                   f"\n{log}")
            (out_dir / (Path(cmd[-1]).stem + ".log")).write_text(log)
            if verbose and log:
                print(log)
        tmp = os.path.join(work, LIB_NAME)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *(obj for _, obj, _ in jobs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
        os.replace(tmp, lib_path)      # atomic: a reader never sees a torn .so
    BUILD_SECONDS = time.perf_counter() - t0
    return lib_path


def build_log(source: str) -> str:
    """The nvcc / ptxas output of one csrc source (e.g. "flash_full_fwd.cu")
    from the build of the current sources; FileNotFoundError if that build
    has not run."""
    return (build_dir() / (Path(source).stem + ".log")).read_text()


def load_library(verbose: bool = False) -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build(verbose=verbose)))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch function."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")
