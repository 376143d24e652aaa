"""The port's copies of the framework-free data and artifact modules
against the JAX package's, bit for bit: EXR files written by one read by
the other; ObjaverseDataset / RE10KDataset `__getitem__` on the same tree,
seed and index order (every array `assert_array_equal`); the loader's index
stream and `collate`; pose interpolation; the MJPEG-AVI bytes; the image
grid; the trajectory-video frames and the timestep overlay.  Synthetic
trees come from tests/synthetic_fixtures.py.
"""

import json
from dataclasses import asdict

import numpy as np
import pytest

from open_diffusiongs_tpu.data import loader as jloader
from open_diffusiongs_tpu.data import objaverse as jobj
from open_diffusiongs_tpu.data import re10k as jre
from open_diffusiongs_tpu.systems import eval_utils as jeval
from open_diffusiongs_tpu.utils import exr as jexr
from open_diffusiongs_tpu.utils import pose_interp as jpose
from open_diffusiongs_tpu.utils import saving as jsaving
from open_diffusiongs_tpu.utils import video as jvideo
from open_diffusiongs_tpu_torch.data import loader, objaverse, re10k
from open_diffusiongs_tpu_torch.systems import eval_utils
from open_diffusiongs_tpu_torch.utils import exr, pose_interp, saving, video
from synthetic_fixtures import make_gobjaverse_tree, make_re10k_tree


def _assert_samples_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("comp", ["none", "zips", "zip"])
@pytest.mark.parametrize("half", [True, False])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_exr_files_cross_read(tmp_path, rng, comp, half, writer):
    # smooth rows compress; a noise row keeps one zip block raw
    img = np.linspace(0, 4, 37 * 21 * 4, dtype=np.float32).reshape(37, 21, 4)
    img[5] = rng.normal(size=(21, 4))
    mods = {"port": exr, "jax": jexr}
    own, other = mods[writer], mods["jax" if writer == "port" else "port"]
    path = str(tmp_path / "x.exr")
    own.write_exr(path, img, ["R", "G", "B", "A"], half=half,
                  compression=comp)
    got, names = other.read_exr(path)
    want, want_names = own.read_exr(path)
    assert names == want_names == ["A", "B", "G", "R"]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got[..., 0], img[..., 3].astype(np.float16 if half else np.float32))
    np.testing.assert_array_equal(other.read_depth_from_nd_exr(path),
                                  got[..., :1])
    # the same bytes from the other writer
    copy = str(tmp_path / "y.exr")
    other.write_exr(copy, img, ["R", "G", "B", "A"], half=half,
                    compression=comp)
    assert open(path, "rb").read() == open(copy, "rb").read()


@pytest.fixture(scope="module")
def gobj_tree(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gobj")
    root, img = make_gobjaverse_tree(tmp, np.random.default_rng(0), res=24,
                                     uids=("000/a", "000/b", "001/c"))
    return root, img


@pytest.mark.parametrize("rel", [True, False])
def test_objaverse_dataset_matches_jax(gobj_tree, rel):
    root, img = gobj_tree
    cfg = dict(local_dir=str(root), image_dir=str(img) + "/",
               gen_idxs=[30, 33, 36, 39], sel_views=3, gen_views=4,
               training_res=[16, 16], norm_radius=3.0, gen_rel_idxs=rel)
    port = objaverse.ObjaverseDataset(cfg, split="train", seed=5)
    ref = jobj.ObjaverseDataset(cfg, split="train", seed=5)
    assert len(port) == len(ref) == 3
    for i in (0, 2, 1, 0, 1):
        _assert_samples_equal(port[i], ref[i])


def test_objaverse_config_defaults_match_jax():
    assert asdict(objaverse.ObjaverseConfig()) == asdict(
        jobj.ObjaverseConfig())
    assert asdict(re10k.RE10KConfig()) == asdict(jre.RE10KConfig())
    np.testing.assert_array_equal(objaverse.RT_MATRIX, jobj.RT_MATRIX)


@pytest.fixture(scope="module")
def re10k_list(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("re10k")
    full_list = make_re10k_tree(tmp, np.random.default_rng(0), n_scenes=3,
                                n_frames=8, res=(36, 64))
    index = tmp / "index.json"
    index.write_text(json.dumps({
        "scene0": {"context": [1, 6], "target": [2, 3, 4]},
        "scene1": None,
        "scene2": {"context": [0, 7], "target": [5, 1, 2]}}))
    return str(full_list), str(index)


@pytest.mark.parametrize("split,use_index", [("train", False),
                                             ("test", False),
                                             ("test", True)])
def test_re10k_dataset_matches_jax(re10k_list, split, use_index):
    full_list, index = re10k_list
    cfg = dict(local_dir=full_list, local_eval_dir=full_list,
               view_idx_file_path=index if use_index else "",
               sel_views=3, sel_views_train=2, training_res=[16, 16],
               patch_size=8)
    port = re10k.RE10KDataset(cfg, split=split, seed=3)
    ref = jre.RE10KDataset(cfg, split=split, seed=3)
    assert port.uids == ref.uids
    assert len(port) == (2 if use_index else 3)
    for i in list(range(len(port))) * 2:
        _assert_samples_equal(port[i], ref[i])


def test_re10k_preprocess_poses_matches_jax(rng):
    c2ws = np.tile(np.eye(4), (5, 1, 1))
    c2ws[:, :3, 3] = rng.normal(size=(5, 3))
    c2ws[:, :3, :3] = np.linalg.qr(rng.normal(size=(5, 3, 3)))[0]
    np.testing.assert_array_equal(re10k.preprocess_poses(c2ws, 1.35),
                                  jre.preprocess_poses(c2ws, 1.35))


@pytest.mark.parametrize("n,batch,shuffle,drop_last", [
    (7, 3, True, True), (2, 5, True, True), (7, 3, False, True),
    (7, 3, False, False)])
def test_loader_index_stream_matches_jax(n, batch, shuffle, drop_last):
    data = list(range(n))
    port = loader.PrefetchLoader(data, batch, shuffle=shuffle, seed=4,
                                 drop_last=drop_last)
    ref = jloader.PrefetchLoader(data, batch, shuffle=shuffle, seed=4,
                                 drop_last=drop_last)
    a, b = port._index_stream(), ref._index_stream()
    for _ in range(12 if shuffle else -(-n // batch)):
        assert next(a, None) == next(b, None)
    assert port.first_batch_indices() == next(ref._index_stream())


def test_loader_batches_and_collate_match_jax(gobj_tree):
    root, img = gobj_tree
    cfg = dict(local_dir=str(root), image_dir=str(img) + "/",
               gen_idxs=[30, 33, 36, 39], sel_views=2, gen_views=4,
               training_res=[16, 16], gen_rel_idxs=True)
    batches = []
    for mod, lmod in ((objaverse, loader), (jobj, jloader)):
        ds = mod.ObjaverseDataset(cfg, seed=1)
        it = iter(lmod.PrefetchLoader(ds, 2, shuffle=True, num_threads=1,
                                      seed=2))
        batches.append([next(it) for _ in range(3)])
    for got, want in zip(*batches):
        _assert_samples_equal(got, want)
        assert got["rgbs"].shape == (2, 6, 3, 16, 16)
        assert isinstance(got["uid"], list)
    samples = [{"uid": "x", "a": np.ones((2, 3)), "s": 1.5},
               {"uid": "y", "a": np.zeros((2, 3)), "s": 2.5}]
    _assert_samples_equal(loader.collate(samples), jloader.collate(samples))


def test_pose_interp_matches_jax(rng):
    poses = np.tile(np.eye(4), (4, 1, 1))
    poses[:, :3, :3] = np.linalg.qr(rng.normal(size=(4, 3, 3)))[0]
    poses[:, :3, :3] *= np.sign(np.linalg.det(poses[:, :3, :3]))[:, None,
                                                                  None]
    poses[:, :3, 3] = rng.normal(size=(4, 3))
    np.testing.assert_array_equal(
        pose_interp.get_interpolated_poses_many(poses, 7),
        jpose.get_interpolated_poses_many(poses, 7))
    for method in ("pca", "up", "vertical", "none"):
        for center in ("poses", "focus", "none"):
            for got, want in zip(
                    pose_interp.auto_orient_and_center_poses(poses, method,
                                                             center),
                    jpose.auto_orient_and_center_poses(poses, method,
                                                       center)):
                np.testing.assert_array_equal(got, want)
    for a, b in (([1, 0, 0], [0, 1, 0]), ([0, 0, 1], [0, 0, -1])):
        np.testing.assert_array_equal(
            pose_interp.rotation_matrix_between(a, b),
            jpose.rotation_matrix_between(a, b))


def test_video_bytes_match_jax(tmp_path, rng):
    frames = [video.to_uint8(rng.uniform(size=(24, 40, 3)))
              for _ in range(5)]
    np.testing.assert_array_equal(frames[0], jvideo.to_uint8(
        frames[0] / 255.0))
    video.write_mjpeg_avi(str(tmp_path / "a.avi"), frames, fps=12)
    jvideo.write_mjpeg_avi(str(tmp_path / "b.avi"), frames, fps=12)
    assert (tmp_path / "a.avi").read_bytes() == (tmp_path / "b.avi"
                                                 ).read_bytes()
    saving.save_video(str(tmp_path / "c.mp4"), [f / 255.0 for f in frames])
    jsaving.save_video(str(tmp_path / "d.mp4"), [f / 255.0 for f in frames])
    assert (tmp_path / "c.avi").read_bytes() == (tmp_path / "d.avi"
                                                 ).read_bytes()


def test_image_grid_matches_jax(tmp_path, rng):
    imgs = rng.uniform(size=(5, 8, 6, 3)).astype(np.float32)
    saving.save_image_grid(str(tmp_path / "a" / "g.png"), imgs, ncols=2)
    jsaving.save_image_grid(str(tmp_path / "b" / "g.png"), imgs, ncols=2)
    assert (tmp_path / "a" / "g.png").read_bytes() == \
        (tmp_path / "b" / "g.png").read_bytes()
    chw = rng.uniform(size=(2, 3, 4, 5))
    np.testing.assert_array_equal(saving.chw_to_hwc(chw),
                                  jsaving.chw_to_hwc(chw))


def test_trajectory_frames_match_jax(rng):
    traj = rng.uniform(-0.2, 1.2, size=(3, 2, 3, 24, 24)).astype(np.float32)
    cond = rng.uniform(size=(1, 3, 24, 24)).astype(np.float32)
    tmap = [40, 20]
    got = eval_utils.trajectory_video_frames(traj, cond, tmap)
    want = jeval.trajectory_video_frames(traj, cond, tmap)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == (24, 72, 3)
        np.testing.assert_array_equal(g, w)
    frame = video.to_uint8(cond[0].transpose(1, 2, 0))
    np.testing.assert_array_equal(eval_utils.overlay_timestep(frame, "t=7"),
                                  jeval.overlay_timestep(frame, "t=7"))
