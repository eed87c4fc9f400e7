"""The port's viz layer (sp_orb_slam_tpu_torch/viz/) on the CPU.

(a) `draw_frame`: the same seeded state through the JAX package's drawer
    and the port's, as duck-typed frame / map objects and as each package's
    own FrameData / Map driven through one scripted history
    (test_torch_system._drive_map): the overlays are bit-equal;
(b) `draw_map`: the same maps rendered by both packages' drawers are
    pixel-equal after PNG decode (one matplotlib draws both, so no
    tolerance);
(c) the port's System on the synthetic rail with `set_debug_dir`
    (tests/test_viz.py's configuration, 25 frames): a frame PNG per frame,
    at least one map PNG, dust-status colours drawn;
(d) `run_vo --device cpu --dataset synthetic --debug-dir` writes its PNGs.
"""

import io
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

from sp_orb_slam_tpu.slam import frame as jframe
from sp_orb_slam_tpu.slam import map as jmap
from sp_orb_slam_tpu.viz import draw_frame as jdraw_frame
from sp_orb_slam_tpu.viz import draw_map as jdraw_map
from sp_orb_slam_tpu_torch.config import Config, _merge_dataclass
from sp_orb_slam_tpu_torch.io.dataset import SyntheticDataset
from sp_orb_slam_tpu_torch.slam import frame as tframe
from sp_orb_slam_tpu_torch.slam import map as tmap
from sp_orb_slam_tpu_torch.slam.system import System
from sp_orb_slam_tpu_torch.viz import draw_frame, draw_map
from test_torch_system import _drive_map

torch.set_num_threads(2)

K_HOST = np.array([260.0, 260.0, 160.0, 120.0], np.float32)
H, W = 240, 320


def _colored(img):
    """Pixels whose channels differ by more than 40 from their mean: the
    status colours, never the grayscale canvas."""
    return (np.abs(img.astype(int) - img.mean(-1, keepdims=True))
            .max(-1) > 40)


# ------------------------------------------------------------ (a) frames


def _duck_state(seed):
    """A frame and a map as plain objects: keypoints (some outside the
    image), bindings, outliers, a pose, and dust candidates in every status
    (missing, bad, behind the camera, off the image, yellow, red, green)."""
    rng = np.random.default_rng(seed)
    n, P = 300, 60
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.1, -0.05, 0.2]
    frame = SimpleNamespace(
        uv=rng.uniform(-20, 340, (n, 2)).astype(np.float32),
        valid=rng.random(n) > 0.2,
        mp_ids=np.where(rng.random(n) > 0.5, rng.integers(0, P, n), -1),
        outlier=rng.random(n) > 0.8,
        occ_grid=np.zeros((H // 8, W // 8), np.int32), Tcw=T)
    pos = np.stack([rng.uniform(-3, 3, P), rng.uniform(-2, 2, P),
                    rng.uniform(-1, 9, P)], -1).astype(np.float32)
    points = {pid: SimpleNamespace(pid=pid, bad=rng.random() > 0.9,
                                   in_view=rng.random() > 0.3,
                                   dust_match=rng.random() > 0.5)
              for pid in range(P)}
    world = SimpleNamespace(points=points, pool=SimpleNamespace(pos=pos))
    pids = list(range(P)) + [P + 5]  # one id the map does not hold
    image = rng.integers(0, 256, (H, W), np.uint8)
    return frame, world, pids, image


@pytest.mark.parametrize("state", ["OK", "LOST", "INIT"])
@pytest.mark.parametrize("canvas", ["image", "black"])
def test_draw_frame_matches_jax(state, canvas):
    frame, world, pids, image = _duck_state(3)
    img = image if canvas == "image" else None
    got = draw_frame(frame, world, dust_pids=pids, image=img, K_intr=K_HOST,
                     state=state)
    want = jdraw_frame(frame, world, dust_pids=pids, image=img,
                       K_intr=K_HOST, state=state)
    assert got.shape == (H, W, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert _colored(got[3:]).sum() > 50  # the status boxes, below the strip


def test_draw_frame_without_pose_or_candidates():
    frame, world, pids, image = _duck_state(4)
    for kw in (dict(dust_pids=[]), dict(dust_pids=pids, K_intr=None)):
        got = draw_frame(frame, world, image=image, **kw)
        np.testing.assert_array_equal(
            got, jdraw_frame(frame, world, image=image, **kw))
    frame.Tcw = None
    np.testing.assert_array_equal(
        draw_frame(frame, world, dust_pids=pids, K_intr=K_HOST),
        jdraw_frame(frame, world, dust_pids=pids, K_intr=K_HOST))


def _driven_maps():
    """Both packages' Maps after one scripted history, with the same dust
    flags set on their points."""
    jw, _ = _drive_map(jframe, jmap, True)
    tw, _ = _drive_map(tframe, tmap, False)
    rng = np.random.default_rng(5)
    for pid in sorted(jw.points):
        flags = rng.random(2) > 0.4
        for w in (jw, tw):
            w.points[pid].in_view, w.points[pid].dust_match = flags
    return jw, tw


def test_draw_frame_of_each_packages_map_matches_jax():
    jw, tw = _driven_maps()
    image = np.random.default_rng(6).integers(0, 256, (H, W), np.uint8)
    pids = sorted(jw.points)
    for kf_id in sorted(jw.keyframes):
        jf, tf = jw.keyframes[kf_id].data, tw.keyframes[kf_id].data
        tf.outlier[::5] = jf.outlier[::5] = True
        want = jdraw_frame(jf, jw, dust_pids=pids, image=image,
                           K_intr=K_HOST, state="OK")
        got = draw_frame(tf, tw, dust_pids=pids, image=image, K_intr=K_HOST,
                         state="OK")
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- (b) maps


def _png(drawer, world, **kw):
    buf = io.BytesIO()
    drawer(world, buf, fmt="png", **kw)
    return np.asarray(Image.open(io.BytesIO(buf.getvalue())))


@pytest.mark.parametrize("with_traj", [False, True])
def test_draw_map_matches_jax(with_traj):
    jw, tw = _driven_maps()
    traj = (np.cumsum(np.random.default_rng(7).normal(0, 0.1, (30, 3)), 0)
            if with_traj else None)
    cur = max(tw.keyframes)
    got = _png(draw_map, tw, current_kf=cur, trajectory=traj)
    want = _png(jdraw_map, jw, current_kf=cur, trajectory=traj)
    assert got.ndim == 3 and got.shape[0] > 100
    np.testing.assert_array_equal(got, want)


def test_draw_map_of_an_empty_map_matches_jax(tmp_path):
    got, want = tmp_path / "port.png", tmp_path / "jax.png"
    draw_map(tmap.Map(64), str(got))
    jdraw_map(jmap.Map(64), str(want))
    np.testing.assert_array_equal(np.asarray(Image.open(got)),
                                  np.asarray(Image.open(want)))


# --------------------------------------------------------- (c), (d): System

SMALL_VIZ = {
    "dataset": "synthetic",
    "camera": {"width": 320, "height": 240, "fx": 260.0, "fy": 260.0,
               "cx": 160.0, "cy": 120.0, "fps": 20.0},
    "tracking": {"num_features": 250},
    "runtime": {"max_keypoints": 256, "dust_points_cap": 128,
                "local_points_cap": 1024, "ba_kfs_cap": 32,
                "ba_points_cap": 1024, "ba_obs_cap": 4096,
                "init_ransac_iters": 60}}


def test_debug_artifacts(tmp_path):
    cfg = _merge_dataclass(Config(), SMALL_VIZ)
    ds = SyntheticDataset(cfg, n_frames=25, n_points=5000, seed=6,
                          pixel_noise=0.3)
    sys_ = System(cfg, device="cpu")
    sys_.set_debug_dir(str(tmp_path))
    sys_.spin(ds)

    frames = sorted(os.listdir(tmp_path / "frames"))
    maps = sorted(os.listdir(tmp_path / "map"))
    assert len(frames) == 25
    assert len(maps) >= 1
    img = np.asarray(Image.open(tmp_path / "frames" / frames[-1]))
    assert img.shape == (240, 320, 3)
    assert img.max() > 0
    mp_img = np.asarray(Image.open(tmp_path / "map" / maps[-1]))
    assert mp_img.ndim == 3 and mp_img.shape[0] > 100
    # dust-status colours once tracking is established (yellow not in
    # view, red unmatched, green matched boxes)
    assert _colored(img).sum() > 50
    assert sys_.report()["n_lost"] == 0

    sys_.set_debug_dir(None)  # off again: no more files
    sys_.spin(SyntheticDataset(cfg, n_frames=3, n_points=5000, seed=6,
                               pixel_noise=0.3))
    assert len(os.listdir(tmp_path / "frames")) == 25


def test_run_vo_debug_dir(tmp_path, capsys):
    from sp_orb_slam_tpu_torch import run_vo

    out = tmp_path / "viz"
    assert run_vo.main(["--dataset", "synthetic", "--device", "cpu",
                        "--synthetic-frames", "12", "--debug-dir", str(out),
                        "--output", str(tmp_path / "traj")]) == 0
    assert len(os.listdir(out / "frames")) == 12
    assert "000000.png" in os.listdir(out / "map")
    assert '"n_frames"' in capsys.readouterr().out
