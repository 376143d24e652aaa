"""The port's GrabCut module (open_diffusiongs_tpu_torch/utils/matting.py)
against the JAX package's (open_diffusiongs_tpu/utils/matting.py), both on
the repository's native/libmatting.so.

The port keeps its own copy of the module (it imports nothing of the JAX
package); the two must compute the same masks bit for bit: `grid_mincut`
on seeded capacities, `grabcut_alpha` on a seeded textured image, and the
pipeline's grabcut branch, which must not load the JAX package.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from open_diffusiongs_tpu.utils import matting as jax_matting
from open_diffusiongs_tpu_torch import pipeline
from open_diffusiongs_tpu_torch.utils import matting

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(
    not matting.available(), reason="native/libmatting.so not built")


def _object_image(seed: int, h: int = 72, w: int = 96) -> np.ndarray:
    """[h, w, 3] uint8: a reddish disc on a textured blue-grey background."""
    rng = np.random.default_rng(seed)
    img = rng.normal(110, 18, (h, w, 3))
    img[..., 2] += 40
    yy, xx = np.mgrid[:h, :w]
    disc = (yy - h / 2) ** 2 + (xx - w / 2) ** 2 < (0.3 * min(h, w)) ** 2
    img[disc] = rng.normal((200, 60, 50), 12, (int(disc.sum()), 3))
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("seed,h,w", [(0, 3, 4), (1, 12, 17), (2, 40, 33)])
def test_grid_mincut_matches_jax_module(seed, h, w):
    rng = np.random.default_rng(seed)
    caps = (rng.uniform(0, 3, (h, w)), rng.uniform(0, 3, (h, w)),
            rng.uniform(0, 1.5, (h, w - 1)), rng.uniform(0, 1.5, (h - 1, w)))
    caps = [c.astype(np.float32) for c in caps]
    got = matting.grid_mincut(*caps)
    assert got.dtype == bool and got.shape == (h, w)
    np.testing.assert_array_equal(got, jax_matting.grid_mincut(*caps))


@pytest.mark.parametrize("seed,max_side", [(0, 384), (3, 48)])
def test_grabcut_alpha_matches_jax_module(seed, max_side):
    """Bit for bit, at full resolution and through the downscaled cut."""
    img = _object_image(seed)
    got = matting.grabcut_alpha(img, max_side=max_side)
    want = jax_matting.grabcut_alpha(img, max_side=max_side)
    assert got.dtype == np.float32 and got.shape == img.shape[:2]
    np.testing.assert_array_equal(got, want)
    # the disc is found: its centre is foreground, the corners background
    assert got[36, 48] > 0.5 and got[0, 0] < 0.5 and got[-1, -1] < 0.5


def test_pipeline_grabcut_is_the_ports_module():
    img = _object_image(4)
    np.testing.assert_array_equal(
        pipeline.remove_background(img, matting="grabcut"),
        jax_matting.grabcut_alpha(img))


def test_pipeline_grabcut_loads_no_jax_side():
    """The fault this file pins: the grabcut branch imported the JAX
    package's matting module inside the function, where no import-time
    check saw it."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from open_diffusiongs_tpu_torch.pipeline import remove_background\n"
        "img = np.full((32, 40, 3), 90, np.uint8)\n"
        "img[10:22, 12:28] = (220, 40, 40)\n"
        "a = remove_background(img, matting='grabcut')\n"
        "assert a.shape == (32, 40) and a[16, 20] > 0.5, a\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', "
        "'jaxlib', 'flax', 'optax', 'orbax', 'open_diffusiongs_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
