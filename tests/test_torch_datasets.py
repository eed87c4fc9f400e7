"""The port's on-disk loaders (sp_orb_slam_tpu_torch/io/dataset.py)
against the JAX package's (tests/test_datasets.py): each tree is written
once in `tmp_path` and read through both packages, and the frames they
yield (images, timestamps, injected features, global descriptors) and
the ground-truth arrays are equal exactly.  A reference-export tree then
drives the port's tracking (the JAX package's
test_reference_export_drives_tracking)."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from sp_orb_slam_tpu.config import Config as JConfig
from sp_orb_slam_tpu.config import _merge_dataclass as jmerge
from sp_orb_slam_tpu.io import dataset as jds
from sp_orb_slam_tpu_torch.config import Config, _merge_dataclass
from sp_orb_slam_tpu_torch.io import dataset as tds


torch.set_num_threads(2)


def _img(seed, h=48, w=64):
    return np.random.default_rng(seed).integers(0, 256, (h, w), np.uint8)


def _same_frames(a, b):
    """Two loaders' RawFrame lists are equal field by field."""
    assert len(a) == len(b)
    for fa, fb in zip(a, b):
        assert fa.timestamp == fb.timestamp
        for name in ("image", "gt_pose", "global_desc"):
            xa, xb = getattr(fa, name), getattr(fb, name)
            assert (xa is None) == (xb is None), name
            if xa is not None:
                assert xa.dtype == xb.dtype, name
                np.testing.assert_array_equal(xa, xb)
        assert (fa.injected is None) == (fb.injected is None)
        if fa.injected is not None:
            assert sorted(fa.injected) == sorted(fb.injected)
            for k, v in fa.injected.items():
                w = fb.injected[k]
                assert np.asarray(v).dtype == np.asarray(w).dtype, k
                np.testing.assert_array_equal(v, w, err_msg=k)


def _write_euroc(root, seq="MH_01", n=5):
    cam0 = os.path.join(root, seq, "mav0", "cam0")
    os.makedirs(os.path.join(cam0, "data"))
    stamps_ns = [1403636579763555584 + i * 50_000_000 for i in range(n)]
    with open(os.path.join(cam0, "data.csv"), "w") as f:
        f.write("#timestamp [ns],filename\n")
        for i, ts in enumerate(stamps_ns):
            name = f"{ts}.png"
            Image.fromarray(_img(i), mode="L").save(
                os.path.join(cam0, "data", name))
            f.write(f"{ts},{name}\n")
    return stamps_ns


def test_euroc_tree(tmp_path):
    stamps_ns = _write_euroc(str(tmp_path))
    ours = list(tds.EurocDataset(str(tmp_path), "MH_01"))
    _same_frames(ours, list(jds.EurocDataset(str(tmp_path), "MH_01")))
    assert len(ours) == len(stamps_ns)
    for i, (fr, ts) in enumerate(zip(ours, stamps_ns)):
        assert abs(fr.timestamp - ts * 1e-9) < 1e-6
        np.testing.assert_array_equal(fr.image, _img(i))
    np.testing.assert_array_equal(tds.EurocDataset.RAW_K,
                                  jds.EurocDataset.RAW_K)
    np.testing.assert_array_equal(tds.EurocDataset.DIST,
                                  jds.EurocDataset.DIST)


def test_euroc_direct_cam0_path(tmp_path):
    """<root>/<seq> may point straight at a cam0 directory."""
    _write_euroc(str(tmp_path))
    direct = os.path.join(str(tmp_path), "direct")
    os.makedirs(direct)
    os.rename(os.path.join(str(tmp_path), "MH_01", "mav0", "cam0"),
              os.path.join(direct, "cam0"))
    ours = list(tds.EurocDataset(direct, "cam0"))
    assert len(ours) == 5
    _same_frames(ours, list(jds.EurocDataset(direct, "cam0")))


def _write_tsukuba(root, n=12, pad=None, start=1):
    left = os.path.join(root, "left")
    os.makedirs(left, exist_ok=True)
    for i in range(start, start + n):
        name = f"frame_{i:0{pad}d}.png" if pad else f"frame_{i}.png"
        Image.fromarray(_img(i), mode="L").save(os.path.join(left, name))


@pytest.mark.parametrize("layout", ["frame_%d", "0-based fallback"])
def test_tsukuba_tree(tmp_path, layout):
    """frame_%d.png from 1, and the fallback for other layouts in numeric
    order (frame_2 before frame_10); synthetic 20 fps stamps."""
    if layout == "frame_%d":
        _write_tsukuba(str(tmp_path), n=12)
        n_frames, first = 12, 1
    else:
        _write_tsukuba(str(tmp_path), n=12, start=0)
        n_frames, first = 0, 0
    ours = list(tds.TsukubaDataset(str(tmp_path), n_frames=n_frames))
    _same_frames(ours, list(jds.TsukubaDataset(str(tmp_path),
                                               n_frames=n_frames)))
    assert len(ours) == 12
    for i, fr in enumerate(ours):
        assert abs(fr.timestamp - i / 20.0) < 1e-9
        np.testing.assert_array_equal(fr.image, _img(i + first))


def test_tsukuba_shared_gt(tmp_path):
    """gt.txt one level above the variant directory."""
    variant = os.path.join(str(tmp_path), "daylight")
    _write_tsukuba(variant, n=4)
    rows = ["{:.6f} {} 0 0 0 0 0 1".format(i / 20.0, i * 0.1)
            for i in range(4)]
    with open(os.path.join(str(tmp_path), "gt.txt"), "w") as f:
        f.write("# t x y z qx qy qz qw\n" + "\n".join(rows) + "\n")
    ts, pos = tds.TsukubaDataset(variant, n_frames=4).gt_trajectory()
    jts, jpos = jds.TsukubaDataset(variant, n_frames=4).gt_trajectory()
    np.testing.assert_array_equal(ts, jts)
    np.testing.assert_array_equal(pos, jpos)
    assert len(ts) == 4 and abs(pos[2][0] - 0.2) < 1e-6
    lone = tmp_path / "a" / "b"  # no gt.txt beside it or one level up
    os.makedirs(lone)
    with pytest.raises(FileNotFoundError):
        tds.TsukubaDataset(str(lone), n_frames=1).gt_trajectory()


def _synthetic_cfgs():
    return (_merge_dataclass(Config(), {"dataset": "synthetic"}),
            jmerge(JConfig(), {"dataset": "synthetic"}))


def test_npz_export_tree(tmp_path):
    """ExportDataset's npz schema with timestamps.txt and gt.txt."""
    cfg, _ = _synthetic_cfgs()
    ds = tds.SyntheticDataset(cfg, n_frames=4, seed=5)
    rng = np.random.default_rng(1)
    with open(tmp_path / "timestamps.txt", "w") as f:
        for i, raw in enumerate(ds):
            inj = {k: v for k, v in raw.injected.items() if k != "count"}
            tds.ExportDataset.save_frame(
                str(tmp_path), i, inj,
                global_desc=rng.normal(size=64).astype(np.float32))
            f.write(f"{raw.timestamp}\n")
    np.savetxt(tmp_path / "gt.txt", np.c_[np.arange(4) / 20.0,
                                          rng.normal(size=(4, 7))])
    ours = list(tds.ExportDataset(str(tmp_path)))
    _same_frames(ours, list(jds.ExportDataset(str(tmp_path))))
    for a, b in zip(tds.ExportDataset(str(tmp_path)).gt_trajectory(),
                    jds.ExportDataset(str(tmp_path)).gt_trajectory()):
        np.testing.assert_array_equal(a, b)
    for fr, raw in zip(ours, ds):
        assert fr.injected["count"] == raw.injected["count"]
        np.testing.assert_array_equal(fr.injected["desc"],
                                      raw.injected["desc"])


def _export_reference_tree(root, cfg, n_frames=30):
    """A synthetic-rail sequence in the reference's export byte layout
    (raw <f4 blobs, size files, vlad bins, cam0/data.csv), written by the
    port."""
    ds = tds.SyntheticDataset(cfg, n_frames=n_frames, seed=5)
    stamps_ns, frames = [], []
    rng = np.random.default_rng(3)
    for i, raw in enumerate(ds):
        t_ns = int(raw.timestamp * 1e9) + 1403636579763555584
        stamps_ns.append(t_ns)
        inj = raw.injected
        v = inj["valid"]
        gd = rng.normal(size=257).astype(np.float32)  # < 4096: zero-padded
        tds.ReferenceExportDataset.save_frame(
            str(root), i, uv=inj["uv"][v], score=inj["score"][v],
            desc=inj["desc"][v], dust=inj["dust"],
            heat=np.abs(rng.normal(size=(cfg.camera.height,
                                         cfg.camera.width))
                        ).astype(np.float32),
            global_desc=gd, t_ns=t_ns)
        frames.append((raw, gd))
    tds.ReferenceExportDataset.save_index(str(root), stamps_ns)
    return frames, stamps_ns


@pytest.mark.parametrize("cov_from_heat", [False, True])
def test_reference_export_tree(tmp_path, cov_from_heat):
    """The reference byte layout through both readers (with the covariance
    recomputed from the exported heat, and without); the round trip is
    lossless for every field the layout carries."""
    cfg, _ = _synthetic_cfgs()
    frames, stamps_ns = _export_reference_tree(tmp_path, cfg, n_frames=3)
    kw = dict(height=cfg.camera.height, width=cfg.camera.width,
              max_keypoints=cfg.runtime.max_keypoints,
              cov_from_heat=cov_from_heat)
    ours = list(tds.ReferenceExportDataset(str(tmp_path), **kw))
    _same_frames(ours, list(jds.ReferenceExportDataset(str(tmp_path), **kw)))
    for (orig, gd), got, t_ns in zip(frames, ours, stamps_ns):
        assert abs(got.timestamp - t_ns / 1e9) < 1e-6
        for k in ("valid", "uv", "score", "desc", "dust"):
            np.testing.assert_array_equal(got.injected[k], orig.injected[k])
        assert got.injected["count"] == orig.injected["count"]
        np.testing.assert_array_equal(got.global_desc[:257], gd)
        assert np.all(got.global_desc[257:] == 0)


def test_make_dataset_branches(tmp_path):
    """make_dataset picks the same loader as the JAX package's for each
    dataset name, export names before the family prefixes."""
    _write_euroc(str(tmp_path / "euroc"))
    _write_tsukuba(str(tmp_path / "tsukuba" / "daylight"), n=3)
    cfg, jcfg = _synthetic_cfgs()
    _export_reference_tree(tmp_path / "ref", cfg, n_frames=2)
    os.makedirs(tmp_path / "npz" / "frames")
    cases = [("euroc", str(tmp_path / "euroc"), "MH_01", "EurocDataset"),
             ("tsukuba", str(tmp_path / "tsukuba"), "daylight",
              "TsukubaDataset"),
             ("euroc_export", str(tmp_path), "ref",
              "ReferenceExportDataset"),
             ("kitti_export", str(tmp_path / "npz"), "", "ExportDataset"),
             ("synthetic", "", "", "SyntheticDataset")]
    for name, path, seq, cls in cases:
        over = {"dataset": name, "data_path": path, "seq": seq}
        ours = tds.make_dataset(_merge_dataclass(cfg, over))
        theirs = jds.make_dataset(jmerge(jcfg, over))
        assert type(ours).__name__ == type(theirs).__name__ == cls, name
        assert len(ours) == len(theirs), name
    with pytest.raises(ValueError, match="unknown dataset"):
        tds.make_dataset(_merge_dataclass(cfg, {"dataset": "nope"}))


def test_reference_export_drives_tracking(tmp_path):
    """make_dataset finds the reference export tree and the port's SLAM
    pipeline consumes it as it is (at the online rail's 320x240, K=256,
    for the test's time)."""
    from sp_orb_slam_tpu_torch.slam import tracking as tr
    from sp_orb_slam_tpu_torch.slam.system import System

    cfg = _merge_dataclass(Config(), {
        "dataset": "synthetic",
        "camera": {"width": 320, "height": 240, "fx": 260.0, "fy": 260.0,
                   "cx": 160.0, "cy": 120.0, "fps": 20.0},
        "tracking": {"num_features": 250},
        "runtime": {"max_keypoints": 256, "dust_points_cap": 128,
                    "local_points_cap": 1024, "ba_kfs_cap": 32,
                    "ba_points_cap": 1024, "ba_obs_cap": 4096,
                    "init_ransac_iters": 60}})
    _export_reference_tree(tmp_path, cfg, n_frames=30)
    cfg2 = _merge_dataclass(cfg, {"dataset": "euroc_export",
                                  "data_path": str(tmp_path), "seq": ""})
    ds = tds.make_dataset(cfg2)
    assert isinstance(ds, tds.ReferenceExportDataset)
    sys_ = System(cfg2, device="cpu")
    n_ok = sum(sys_.run(raw) is not None for raw in ds)
    assert sys_.tracker.state == tr.OK
    assert n_ok >= 20, n_ok
    rep = sys_.report()
    assert rep["n_keyframes"] >= 2 and rep["n_lost"] == 0, rep
