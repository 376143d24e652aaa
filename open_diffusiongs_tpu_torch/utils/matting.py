"""GrabCut foreground extraction — the rembg stand-in (NumPy + ctypes).

The port's own copy of open_diffusiongs_tpu/utils/matting.py, line for line
(the port imports nothing of the JAX package).  It loads the repository's
C library native/libmatting.so by path, as the JAX copy does.

The reference pipeline removes backgrounds with rembg's learned u2net
(pipline_obj.py:256-261); its weights need network egress, so this module
implements the classical GrabCut algorithm (Rother et al. 2004) from
scratch: two K-component full-covariance GMM color models (foreground /
background) refit in an EM-style loop around a graph min-cut on the
4-connected pixel grid (native/matting.cpp, Dinic max-flow).

Seeding: instead of GrabCut's user rectangle, the border band of the image
is taken as definite background (the object-photo convention the reference
pipeline also assumes — the subject does not touch the frame), everything
else starts as probable foreground.

`grabcut_alpha` returns a float alpha in [0, 1] (hard cut + short linear
feather).  If the native library is unavailable the caller falls back to
the border-color heuristic (pipeline.remove_background).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB = None


def _load_lib() -> Optional[ctypes.CDLL]:
    global _LIB
    if _LIB is not None:
        return _LIB
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "native", "libmatting.so")
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    lib.grid_mincut.restype = ctypes.c_int
    lib.grid_mincut.argtypes = [
        ctypes.c_int32, ctypes.c_int32,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
    ]
    _LIB = lib
    return lib


def grid_mincut(cap_src: np.ndarray, cap_snk: np.ndarray,
                cap_right: np.ndarray, cap_down: np.ndarray) -> np.ndarray:
    """Min-cut on the [h, w] 4-connected grid; returns bool fg mask."""
    lib = _load_lib()
    assert lib is not None, "native/libmatting.so not built (make -C native)"
    h, w = cap_src.shape
    out = np.zeros((h, w), np.uint8)
    r = lib.grid_mincut(
        h, w, np.ascontiguousarray(cap_src, np.float32),
        np.ascontiguousarray(cap_snk, np.float32),
        np.ascontiguousarray(cap_right, np.float32),
        np.ascontiguousarray(cap_down, np.float32), out)
    assert r == 0, f"grid_mincut failed ({r})"
    return out.astype(bool)


# ---------------------------------------------------------------------------
# GMM color model (K full-covariance components, numpy)
# ---------------------------------------------------------------------------

class _GMM:
    def __init__(self, k: int = 5):
        self.k = k
        self.w = np.full(k, 1.0 / k)
        self.mu = np.zeros((k, 3))
        self.icov = np.tile(np.eye(3), (k, 1, 1))
        self.logdet = np.zeros(k)

    def fit(self, x: np.ndarray, comp: np.ndarray) -> None:
        """Refit from hard component assignments (GrabCut step 2)."""
        n = max(len(x), 1)
        for c in range(self.k):
            sel = x[comp == c]
            if len(sel) < 10:                     # degenerate: keep previous
                self.w[c] = max(len(sel), 1) / n
                continue
            self.w[c] = len(sel) / n
            mu = sel.mean(axis=0)
            d = sel - mu
            cov = (d.T @ d) / len(sel) + 1e-5 * np.eye(3)
            self.mu[c] = mu
            self.icov[c] = np.linalg.inv(cov)
            self.logdet[c] = np.log(np.linalg.det(cov))
        self.w /= self.w.sum()

    def _comp_neglog(self, x: np.ndarray) -> np.ndarray:
        """[n, k] negative log p(x | comp c) (up to the shared constant)."""
        d = x[None, :, :] - self.mu[:, None, :]          # [k, n, 3]
        m = np.einsum("kni,kij,knj->kn", d, self.icov, d)
        return (0.5 * (m + self.logdet[:, None])
                - np.log(np.maximum(self.w[:, None], 1e-8))).T

    def assign(self, x: np.ndarray) -> np.ndarray:
        return np.argmin(self._comp_neglog(x), axis=1)

    def neglog(self, x: np.ndarray) -> np.ndarray:
        return np.min(self._comp_neglog(x), axis=1)

    def init_kmeans(self, x: np.ndarray, rng: np.random.Generator,
                    iters: int = 8) -> None:
        """k-means init (random points -> Lloyd iterations)."""
        if len(x) < self.k:
            x = np.tile(x, (self.k, 1))
        centers = x[rng.choice(len(x), self.k, replace=False)]
        for _ in range(iters):
            d = ((x[:, None, :] - centers[None]) ** 2).sum(-1)
            a = np.argmin(d, axis=1)
            for c in range(self.k):
                sel = x[a == c]
                if len(sel):
                    centers[c] = sel.mean(axis=0)
        self.fit(x, a)


def grabcut_alpha(rgb: np.ndarray, iters: int = 4, gamma: float = 30.0,
                  k: int = 5, border_frac: float = 0.02,
                  max_side: int = 384, seed: int = 0) -> np.ndarray:
    """[h, w, 3] uint8 -> alpha [h, w] float32 in [0, 1].

    Border-band-seeded GrabCut; runs the cut at <= max_side resolution and
    upsamples the mask (the GMM/cut converge identically at lower res for
    photographic content, and the solver stays sub-second)."""
    from PIL import Image

    h0, w0 = rgb.shape[:2]
    scale = max(h0, w0) / max_side
    if scale > 1.0:
        h, w = max(2, int(round(h0 / scale))), max(2, int(round(w0 / scale)))
        small = np.asarray(Image.fromarray(rgb).resize((w, h), Image.BILINEAR))
    else:
        small, (h, w) = rgb, (h0, w0)

    img = small.astype(np.float64) / 255.0
    flat = img.reshape(-1, 3)
    rng = np.random.default_rng(seed)

    bw = max(1, int(round(border_frac * max(h, w))))
    definite_bg = np.zeros((h, w), bool)
    definite_bg[:bw] = definite_bg[-bw:] = True
    definite_bg[:, :bw] = definite_bg[:, -bw:] = True
    fg = ~definite_bg                       # initial probable foreground

    # smoothness: gamma * exp(-beta * ||ci - cj||^2), beta = 1/(2 E||.||^2)
    dr = ((img[:, 1:] - img[:, :-1]) ** 2).sum(-1)
    dd = ((img[1:] - img[:-1]) ** 2).sum(-1)
    beta = 1.0 / max(2.0 * (dr.mean() + dd.mean()) / 2.0, 1e-8)
    cap_right = (gamma * np.exp(-beta * dr)).astype(np.float32)
    cap_down = (gamma * np.exp(-beta * dd)).astype(np.float32)
    big = np.float32(1e9)

    gmm_fg, gmm_bg = _GMM(k), _GMM(k)
    gmm_fg.init_kmeans(flat[fg.reshape(-1)], rng)
    gmm_bg.init_kmeans(flat[definite_bg.reshape(-1)], rng)

    for _ in range(iters):
        fg_flat = fg.reshape(-1)
        if fg_flat.any():
            gmm_fg.fit(flat[fg_flat], gmm_fg.assign(flat[fg_flat]))
        bgf = ~fg_flat
        gmm_bg.fit(flat[bgf], gmm_bg.assign(flat[bgf]))

        d_fg = gmm_fg.neglog(flat).reshape(h, w).astype(np.float32)
        d_bg = gmm_bg.neglog(flat).reshape(h, w).astype(np.float32)
        # cap_src = cost of assigning BG label = -log p_fg flows from source
        cap_src = np.where(definite_bg, 0.0, d_bg).astype(np.float32)
        cap_snk = np.where(definite_bg, big, d_fg).astype(np.float32)
        new_fg = grid_mincut(cap_src, cap_snk, cap_right, cap_down)
        if (new_fg == fg).all():
            fg = new_fg
            break
        fg = new_fg

    alpha = fg.astype(np.float32)
    # short feather: average with the 4-neighborhood twice (anti-aliased edge)
    for _ in range(2):
        p = np.pad(alpha, 1, mode="edge")
        alpha = (p[1:-1, 1:-1] * 4 + p[:-2, 1:-1] + p[2:, 1:-1]
                 + p[1:-1, :-2] + p[1:-1, 2:]) / 8.0
    if scale > 1.0:
        alpha = np.asarray(Image.fromarray(
            (alpha * 255).astype(np.uint8)).resize((w0, h0), Image.BILINEAR),
            np.float32) / 255.0
    return alpha.astype(np.float32)


def available() -> bool:
    return _load_lib() is not None
