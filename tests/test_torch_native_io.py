"""The port's native PNG loader (sp_orb_slam_tpu_torch/io/native_loader.py,
built from native/dataio.cpp into its own build directory) against the
JAX package's copy (tests/test_native_io.py): the same bytes, in order,
with early close, the PIL fallback and missing-file errors."""

import os

import numpy as np
import pytest
from PIL import Image

from sp_orb_slam_tpu.io import native_loader as jnl
from sp_orb_slam_tpu_torch.io import native_loader as nl

pytestmark = pytest.mark.skipif(
    not (nl.available() and jnl.available()),
    reason="native dataio (g++ and libpng) not buildable here")


def _write_pngs(tmp_path, n=12, w=96, h=64, mode="L"):
    rng = np.random.default_rng(7)
    paths = []
    for i in range(n):
        arr = rng.integers(0, 256, (h, w), dtype=np.uint8)
        if mode == "RGB":
            arr = np.stack([arr, arr // 2, arr // 3], -1)
        p = os.path.join(tmp_path, f"f{i:04d}.png")
        Image.fromarray(arr, mode=mode).save(p)
        paths.append(p)
    return paths


def test_library_builds_apart_from_the_jax_copy():
    assert nl._LIB_PATH != jnl._LIB_PATH
    assert os.path.join("build", "torch_native") in nl._LIB_PATH
    assert os.path.exists(nl._LIB_PATH)


@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_png_gray_same_bytes(tmp_path, mode):
    for p in _write_pngs(str(tmp_path), n=3, mode=mode):
        ours = nl.png_gray(p)
        np.testing.assert_array_equal(ours, jnl.png_gray(p))
        assert ours.dtype == np.uint8
    if mode == "L":  # gray PNGs decode exactly as PIL does
        np.testing.assert_array_equal(
            ours, np.asarray(Image.open(p).convert("L")))


def test_prefetcher_same_bytes_in_order(tmp_path):
    paths = _write_pngs(str(tmp_path), n=12)
    got = list(nl.PngPrefetcher(paths, ring=3, threads=4))
    ref = list(jnl.PngPrefetcher(paths, ring=3, threads=4))
    assert len(got) == len(ref) == 12
    for g, r, p in zip(got, ref, paths):
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(g, np.asarray(Image.open(p)))


def test_prefetcher_early_close(tmp_path):
    paths = _write_pngs(str(tmp_path), n=12)
    pf = nl.PngPrefetcher(paths, ring=2, threads=2)
    first = [next(pf), next(pf)]
    pf.close()  # joins the workers without a deadlock
    np.testing.assert_array_equal(first[1], jnl.png_gray(paths[1]))
    with pytest.raises(StopIteration):
        next(pf)


def test_iter_gray_images_fallback(tmp_path, monkeypatch):
    paths = _write_pngs(str(tmp_path), n=3)
    monkeypatch.setattr(nl, "available", lambda: False)
    monkeypatch.setattr(jnl, "available", lambda: False)
    got = list(nl.iter_gray_images(paths))
    ref = list(jnl.iter_gray_images(paths))
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def test_missing_file_errors(tmp_path):
    missing = os.path.join(str(tmp_path), "nope.png")
    with pytest.raises(IOError):
        nl.png_gray(missing)
    with pytest.raises(IOError):
        jnl.png_gray(missing)
