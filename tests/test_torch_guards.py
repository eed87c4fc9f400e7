"""Guards of the port: it imports neither JAX nor the JAX package, and its
entry points and kernel wrappers never fall back to the CPU for a tensor
or device that is not on the CPU."""

import importlib
import importlib.util
import os
import re
import subprocess
import sys

import pytest
import torch

from sp_orb_slam_tpu_torch.config import Config
from sp_orb_slam_tpu_torch.extractor import make_extractor
from sp_orb_slam_tpu_torch.ops import (_build, cuda_cov, cuda_desc,
                                       cuda_match, cuda_nms, cuda_pair1,
                                       cuda_pair1t)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import sys
import sp_orb_slam_tpu_torch
import sp_orb_slam_tpu_torch.config, sp_orb_slam_tpu_torch.extractor
import sp_orb_slam_tpu_torch.io.dataset, sp_orb_slam_tpu_torch.io.render
import sp_orb_slam_tpu_torch.io.native_loader
sp_orb_slam_tpu_torch.io.native_loader.available()
import sp_orb_slam_tpu_torch.models.superpoint
import sp_orb_slam_tpu_torch.models.weights
import sp_orb_slam_tpu_torch.ops._build, sp_orb_slam_tpu_torch.ops.covariance
import sp_orb_slam_tpu_torch.ops.cuda_cov, sp_orb_slam_tpu_torch.ops.cuda_match
import sp_orb_slam_tpu_torch.ops.cuda_nms, sp_orb_slam_tpu_torch.ops.cuda_pair1t
import sp_orb_slam_tpu_torch.ops.matching, sp_orb_slam_tpu_torch.ops.nms
import sp_orb_slam_tpu_torch.utils.precision
import sp_orb_slam_tpu_torch.ops.cuda_desc, sp_orb_slam_tpu_torch.ops.cuda_pair1
import sp_orb_slam_tpu_torch.geometry.se3, sp_orb_slam_tpu_torch.geometry.camera
import sp_orb_slam_tpu_torch.geometry.triangulation
import sp_orb_slam_tpu_torch.geometry.twoview
import sp_orb_slam_tpu_torch.optim.lm, sp_orb_slam_tpu_torch.optim.pose
import sp_orb_slam_tpu_torch.optim.ba
import sp_orb_slam_tpu_torch.slam.frame, sp_orb_slam_tpu_torch.slam.map
import sp_orb_slam_tpu_torch.slam.depth_filter
import sp_orb_slam_tpu_torch.slam.kernels, sp_orb_slam_tpu_torch.slam.tracking
import sp_orb_slam_tpu_torch.slam.local_mapping
import sp_orb_slam_tpu_torch.slam.system
import sp_orb_slam_tpu_torch.slam.serialize, sp_orb_slam_tpu_torch.slam.fleet
import sp_orb_slam_tpu_torch.eval.ate, sp_orb_slam_tpu_torch.utils.timing
import sp_orb_slam_tpu_torch.run_vo
import sp_orb_slam_tpu_torch.optim.sim3, sp_orb_slam_tpu_torch.models.netvlad
import sp_orb_slam_tpu_torch.slam.loop_closing
import sp_orb_slam_tpu_torch.eval.batch, sp_orb_slam_tpu_torch.evaluate
import sp_orb_slam_tpu_torch.train.superpoint_train
import sp_orb_slam_tpu_torch.viz, sp_orb_slam_tpu_torch.viz.frame_drawer
import sp_orb_slam_tpu_torch.viz.map_drawer, sp_orb_slam_tpu_torch.viz.live
import sp_orb_slam_tpu_torch.parallel, sp_orb_slam_tpu_torch.parallel.mesh
import sp_orb_slam_tpu_torch.scripts, sp_orb_slam_tpu_torch.scripts._rail
import sp_orb_slam_tpu_torch.scripts.fit_vlad_centroids
import sp_orb_slam_tpu_torch.scripts.validate_weights
import sp_orb_slam_tpu_torch.scripts.vlad_rendered_stats
import sp_orb_slam_tpu_torch.scripts.replay_degenerate
import sp_orb_slam_tpu_torch.scripts.accuracy_sweep

def banned(name):
    # the port's own name starts with "sp_orb_slam_tpu": match the JAX
    # package exactly or as a parent package, never as a bare prefix
    return (name in ("jax", "sp_orb_slam_tpu")
            or name.startswith(("jax.", "sp_orb_slam_tpu.")))

print(sorted(m for m in sys.modules if banned(m)))
print(sorted(m for m in sys.modules if m.startswith("sp_orb_slam_tpu_torch")))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout.splitlines()
    assert out[0] == "[]", out[0]
    for mod in ("extractor", "slam.system", "run_vo", "ops.cuda_desc",
                "ops.cuda_pair1", "slam.serialize", "slam.fleet",
                "optim.sim3", "models.netvlad", "slam.loop_closing",
                "io.dataset", "io.native_loader", "eval.batch",
                "evaluate", "train.superpoint_train", "viz.frame_drawer",
                "viz.map_drawer", "viz.live", "parallel.mesh",
                "scripts._rail", "scripts.fit_vlad_centroids",
                "scripts.validate_weights", "scripts.vlad_rendered_stats",
                "scripts.replay_degenerate", "scripts.accuracy_sweep"):
        assert f"sp_orb_slam_tpu_torch.{mod}" in out[1], mod


def test_make_extractor_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card path")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_extractor(Config(), {}, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_extractor(Config(), {})  # the default device is the card


@pytest.mark.parametrize("entry", ["system", "tracking_kernels", "run_vo",
                                   "fleet", "load_map", "heat_epi_system",
                                   "heat_fleet", "evaluate"])
def test_slam_entry_points_default_to_the_card(entry):
    """System, TrackingKernels, StreamFleet (also with the heat coarse
    tracker and the epipolar walk), serialize.load_map and the run_vo and
    evaluate command lines run on the card unless told otherwise, and
    raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card path")
    from sp_orb_slam_tpu_torch import evaluate, run_vo
    from sp_orb_slam_tpu_torch.config import _merge_dataclass
    from sp_orb_slam_tpu_torch.slam import serialize
    from sp_orb_slam_tpu_torch.slam.fleet import StreamFleet
    from sp_orb_slam_tpu_torch.slam.kernels import TrackingKernels
    from sp_orb_slam_tpu_torch.slam.system import System

    variants = _merge_dataclass(Config(), {
        "tracking": {"coarse_method": "heat"},
        "mapping": {"matching_method": 2}})
    call = {"system": lambda: System(Config()),
            "tracking_kernels": lambda: TrackingKernels(Config()),
            "run_vo": lambda: run_vo.main(["--dataset", "synthetic",
                                           "--synthetic-frames", "2"]),
            "fleet": lambda: StreamFleet(Config(), 2, params=None),
            "load_map": lambda: serialize.load_map("no_such_map.npz"),
            "heat_epi_system": lambda: System(variants),
            "heat_fleet": lambda: StreamFleet(variants, 2, params=None),
            "evaluate": lambda: evaluate.main(["--runs", "1", "--seqs", "1",
                                               "--max-frames", "2"])}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call[entry]()


@pytest.mark.parametrize("entry", ["make_mesh", "sharded_step",
                                   "mesh_fleet", "viz_system"])
def test_mesh_and_viewer_entry_points_default_to_the_card(entry):
    """make_mesh and build_sharded_step (whose default mesh is every card),
    StreamFleet with a mesh, and the System the viewer drives run on the
    card unless told otherwise, and raise without one: a mesh never falls
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card path")
    from sp_orb_slam_tpu_torch.parallel import mesh
    from sp_orb_slam_tpu_torch.slam.fleet import StreamFleet
    from sp_orb_slam_tpu_torch.slam.system import System

    call = {"make_mesh": lambda: mesh.make_mesh(2),
            "sharded_step": lambda: mesh.build_sharded_step(
                None, {}, num_features=100, max_keypoints=128),
            "mesh_fleet": lambda: StreamFleet(
                Config(), 2, params=None, mesh=mesh.make_mesh(2, "cpu")),
            "viz_system": lambda: System(Config()).set_debug_dir(None)}
    with pytest.raises((RuntimeError, ValueError), match="CUDA device"):
        call[entry]()


@pytest.mark.parametrize("tool", ["fit_vlad_centroids", "validate_weights",
                                  "vlad_rendered_stats", "replay_degenerate",
                                  "accuracy_sweep"])
def test_tools_default_to_the_card(tool):
    """Every tool of sp_orb_slam_tpu_torch/scripts/ runs on the card unless
    given --device cpu, and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card path")
    module = importlib.import_module(f"sp_orb_slam_tpu_torch.scripts.{tool}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([])


def _loop_config():
    from sp_orb_slam_tpu_torch.config import _merge_dataclass

    return _merge_dataclass(Config(), {"use_loop": True,
                                       "loop": {"use_loop": True}})


@pytest.mark.parametrize("entry", ["system_loop", "netvlad", "run_vo_loop"])
def test_loop_entry_points_default_to_the_card(entry):
    """System with loop closing, the NetVLAD module and run_vo --loop run
    on the card unless told otherwise, and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card path")
    from sp_orb_slam_tpu_torch import run_vo
    from sp_orb_slam_tpu_torch.models import netvlad
    from sp_orb_slam_tpu_torch.slam.system import System

    call = {"system_loop": lambda: System(_loop_config()),
            "netvlad": lambda: netvlad.NetVLAD(
                netvlad.init_params(0, out_dim=64)),
            "run_vo_loop": lambda: run_vo.main(
                ["--dataset", "synthetic", "--loop", "--synthetic-frames",
                 "2"])}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call[entry]()


def test_loop_modules_run_on_the_given_device():
    """NetVLAD keeps its buffers and computes on the device it is given
    (the meta device: nothing may move to the CPU), and the System's loop
    closer and place-recognition hook run on the System's device."""
    import numpy as np

    from sp_orb_slam_tpu_torch.models import netvlad
    from sp_orb_slam_tpu_torch.slam.system import System

    model = netvlad.NetVLAD(netvlad.init_params(0, out_dim=64),
                            device="meta")
    assert {b.device.type for b in model.buffers()} == {"meta"}
    out = model(_meta(3, 16, 256), _meta(3, 16, dtype=torch.bool))
    assert out.device.type == "meta" and out.shape == (3, 64)

    sys_ = System(_loop_config(), device="cpu")
    assert sys_.looper.device == sys_.kernels.device == torch.device("cpu")
    assert sys_.mapper.looper is sys_.looper
    from sp_orb_slam_tpu_torch.slam.frame import FrameData

    K = 8
    f = FrameData(frame_id=0, timestamp=0.0, uv=np.zeros((K, 2), np.float32),
                  score=np.zeros(K, np.float32),
                  response=np.zeros(K, np.float32), valid=np.ones(K, bool),
                  cov2_inv=np.ones((K, 2), np.float32),
                  occ_grid=np.zeros((2, 2), np.int32), count=K,
                  desc_dev=torch.nn.functional.normalize(
                      torch.ones(K, 256), dim=-1),
                  dust_dev=None, occ_grid_dev=None)
    gd = sys_.map.global_desc_fn(f)
    assert isinstance(gd, np.ndarray) and gd.shape == (4096,)


def test_launch_counts_are_exact_across_threads(monkeypatch):
    """`launch` counts under its lock: threads launching at once (the
    online mode's tracking, mapping and loop closing) lose no count, here
    with more threads than cores and the interpreter switching threads
    every microsecond.  The entry point, device and stream are stubs, so
    this runs without a card."""
    import contextlib
    import threading
    import types

    monkeypatch.setattr(_build, "function", lambda *a: lambda *args: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setitem(_build.LAUNCHES, "noop", 0)
    n, n_threads = 4000, (os.cpu_count() or 1) + 2
    start = threading.Barrier(n_threads)

    def launches():
        start.wait()
        for _ in range(n):
            _build.launch("noop", "noop_launch", (), device="stub")

    threads = [threading.Thread(target=launches) for _ in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert _build.LAUNCHES["noop"] == n_threads * n


def test_full_f32_blocks_are_counted_across_threads():
    """TF32 stays off while any thread is inside a full_f32 block: a block
    that ends on one thread does not turn it back on under another's, and
    the switches come back as they were once the last block ends."""
    import threading

    from sp_orb_slam_tpu_torch.utils.precision import full_f32

    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    inside, leave = threading.Event(), threading.Event()

    def other():
        with full_f32():
            inside.set()
            leave.wait(timeout=60)

    t = threading.Thread(target=other)
    try:
        torch.backends.cudnn.allow_tf32 = True
        with full_f32():
            t.start()
            assert inside.wait(timeout=60)
        # this thread's block ended inside the other's
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
        leave.set()
        t.join(timeout=60)
        assert torch.backends.cudnn.allow_tf32
    finally:
        leave.set()
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def test_run_vo_writes_inside_the_repository_by_default():
    """run_vo's default output is out/run_vo/ beside the package, not the
    config's fixed /tmp default; an output_path a config sets is kept."""
    import dataclasses
    import os

    from sp_orb_slam_tpu_torch import run_vo

    root = os.path.dirname(os.path.dirname(os.path.abspath(run_vo.__file__)))
    assert run_vo.default_output(Config()) == os.path.join(root, "out",
                                                           "run_vo")
    cfg = dataclasses.replace(Config(), output_path="elsewhere/traj")
    assert run_vo.default_output(cfg) == "elsewhere/traj"


def _meta(*shape, dtype=torch.float32):
    # a tensor that is not on the CPU: the wrappers must launch or raise
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("call", [
    lambda: cuda_pair1t.fused_pair1t(
        _meta(2, 16, 32), _meta(64, 1, 3, 3), _meta(64), _meta(64, 64, 3, 3),
        _meta(64)),
    lambda: cuda_pair1.fused_pair1(
        _meta(2, 16, 32), _meta(64, 1, 3, 3), _meta(64), _meta(64, 64, 3, 3),
        _meta(64)),
    lambda: cuda_nms.batched_grid_nms(
        _meta(2, 4, 6), _meta(2, 4, 6, 2, dtype=torch.int32),
        _meta(2, 4, 6, dtype=torch.bool)),
    lambda: cuda_cov.batched_covariance(
        _meta(2, 32, 32), _meta(2, 16, 2), _meta(2, 16, dtype=torch.bool)),
    lambda: cuda_match.match_init_batch(
        _meta(2, 16, 256), _meta(2, 16, dtype=torch.bool), _meta(2, 16, 2),
        _meta(2, 16, 256), _meta(2, 16, 2), _meta(2, 16, dtype=torch.bool)),
    lambda: cuda_desc.sample_descriptors_sparse(
        _meta(2, 4, 6, 256), _meta(2, 16, 2), _meta(2, 16, dtype=torch.bool),
        (32, 48)),
    lambda: cuda_desc.sample_descriptors_sparse(
        _meta(2, 4, 6, 256, dtype=torch.bfloat16), _meta(2, 16, 2),
        _meta(2, 16, dtype=torch.bool), (32, 48)),
    lambda: cuda_desc.sample_descriptors_dense_batch(
        _meta(2, 4, 6, 256), _meta(2, 4, 6, 2, dtype=torch.int32), (32, 48)),
], ids=["pair1t", "pair1", "nms", "cov", "match", "desc_sparse",
        "desc_sparse_bf16", "desc_dense"])
def test_wrappers_never_fall_back(call):
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        call()
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("raw,match", [
    (_meta(2, 4, 6, 256, dtype=torch.float16), "float32 or bfloat16"),
    (_meta(2, 4, 6, 256, dtype=torch.float64), "float32 or bfloat16"),
    (_meta(2, 4, 6, 128), "needs a"),
    (_meta(2, 1, 6, 256), "needs a"),
    (_meta(4, 6, 256), "needs a"),
], ids=["float16", "float64", "width", "one_row", "no_batch"])
def test_desc_sparse_refuses_what_the_kernel_does_not_take(raw, match):
    """Off the CPU the sparse sampler takes a (B, hc, wc, 256) float32 or
    bfloat16 map with hc, wc >= 2 and raises on anything else, before any
    launch."""
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        cuda_desc.sample_descriptors_sparse(
            raw, _meta(2, 16, 2), _meta(2, 16, dtype=torch.bool), (32, 48))
    assert _build.LAUNCHES == before


def test_wrappers_check_dtype_shape_contiguity():
    t = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        _build.check(t, "t", torch.float32, (2, 3))
    # the remaining checks in order, on a tensor that passes is_cuda
    class FakeCuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    f = t.as_subclass(FakeCuda)
    with pytest.raises(ValueError, match="expected torch.int32"):
        _build.check(f, "t", torch.int32, (2, 3))
    with pytest.raises(ValueError, match="expected shape"):
        _build.check(f, "t", torch.float32, (3, 2))
    with pytest.raises(ValueError, match="contiguous"):
        _build.check(f.t(), "t", torch.float32, (3, 2))
    _build.check(f, "t", torch.float32, (None, 3))


def test_build_needs_nvcc(monkeypatch, tmp_path):
    """Without the CUDA toolkit the build raises instead of doing anything
    else; nothing is built at import time."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(force=True)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_kernel_source_is_built():
    found = sorted(f[:-3] for f in os.listdir(_build.CSRC)
                   if f.endswith(".cu"))
    assert found == sorted(_build.KERNELS)


@pytest.mark.parametrize("source", _build.KERNELS)
def test_profile_groups_follow_the_sources(source):
    """Every __global__ function of csrc/<source>.cu lands in <source>'s
    group of chip_smoke.GROUPS under the profile's first-match rule (a
    kernel named like a GEMM must not count as cuDNN / cuBLAS, one named
    after no fragment not as another PyTorch kernel); the profiler shows
    the demangled name with its namespace and arguments."""
    smoke = _chip_smoke()
    with open(os.path.join(_build.CSRC, f"{source}.cu")) as f:
        # attributes such as __cluster_dims__(...) and __launch_bounds__(...)
        # may stand between `void` and the name
        names = re.findall(r"__global__\s+void\s+(?:__\w+__\([^)]*\)\s+)*"
                           r"(\w+)\s*\(", f.read())
    assert names
    for name in names:
        shown = f"void (anonymous namespace)::{name}<8, 8>(float const*)"
        assert smoke.group_of(shown) == source, name


def test_ptxas_entries_reads_each_instantiation():
    """chip_smoke's reading of nvcc's -Xptxas -v: registers and spill
    bytes of every entry function whose name holds the kernel's, here a
    template's two instantiations, and none of another kernel."""
    log = """ptxas info    : Compiling entry function '_Z8other_kPf' for 'sm_90a'
ptxas info    : Function properties for _Z8other_kPf
    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 255 registers, 380 bytes cmem[0]
ptxas info    : Compiling entry function '_Z18desc_sparse_kernelIfEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _Z18desc_sparse_kernelIfEvPKT_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 4096 bytes smem, 424 bytes cmem[0]
ptxas info    : Compiling entry function '_Z18desc_sparse_kernelItEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _Z18desc_sparse_kernelItEvPKT_
    0 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 38 registers, 4096 bytes smem, 424 bytes cmem[0]
"""
    smoke = _chip_smoke()
    assert smoke.ptxas_entries(log, "desc_sparse_kernel") == {
        "_Z18desc_sparse_kernelIfEvPKT_": [40, 0, 0],
        "_Z18desc_sparse_kernelItEvPKT_": [38, 4, 4]}
    assert smoke.ptxas_report(log, "other_k") == (255, 8, 8)
    assert smoke.ptxas_report(log, "desc_sparse_kernel") == (None,) * 3


@pytest.mark.parametrize("B,M,N,tile", [
    (32, 896, 896, 0), (8, 896, 896, 0), (6, 896, 896, 0), (4, 896, 896, 1),
    (1, 896, 896, 1), (1, 200, 136, 1)])
def test_match_tile_plan(B, M, N, tile):
    """The largest tile whose grid fills 132 SMs twice, else the smallest:
    the step's B=32 takes 128 x 128, the SLAM and fleet init's B=1 the
    64 x 32 split-column tiles."""
    assert cuda_match.plan(B, M, N, 132) == tile
    bm, bn = cuda_match.TILES[tile]
    blocks = B * -(-M // bm) * -(-N // bn)
    assert blocks >= 2 * 132 or tile == len(cuda_match.TILES) - 1
