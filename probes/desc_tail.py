"""The descriptor tail of a checkout on the card: everything from convDb's
output to `Features.desc`, before and after the fused sampler.

In a checkout whose `cuda_desc.sample_descriptors_sparse` takes `valid`,
the tail is that one kernel on the raw map; in an older one it is the
map's cast, L2 norm and division, the sampler on the unit map, and the
valid mask, as that checkout's forward and extractor ran them.  Prints
the tail's device ms and launches at B=1 f32 (frame 0 of the SLAM room)
and B=32 bf16 (the step's images), L2 cold (flushed before each call) and
warm (back to back); then the step's profile (chip_smoke phase 5) and one
SLAM frame's device events (frame 11 of room 5, after 11 unprofiled
frames).  To compare two checkouts on one card, run it from the root of
each in turns (new, old, old, new):

    cd <checkout> && python3 <this file>
"""
import inspect
import os
import sys
import time

sys.path.insert(0, os.getcwd())
import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from sp_orb_slam_tpu_torch.config import Config  # noqa: E402
from sp_orb_slam_tpu_torch.extractor import extract  # noqa: E402
from sp_orb_slam_tpu_torch.models.superpoint import PAIRS, SuperPoint  # noqa: E402
from sp_orb_slam_tpu_torch.models.weights import load_checkpoint  # noqa: E402
from sp_orb_slam_tpu_torch.ops import cuda_desc, cuda_pair1  # noqa: E402
from sp_orb_slam_tpu_torch.slam.system import System  # noqa: E402
from sp_orb_slam_tpu_torch.utils.precision import full_f32  # noqa: E402

H, W = 480, 752
FUSED = "valid" in inspect.signature(
    cuda_desc.sample_descriptors_sparse).parameters
TAG = os.path.basename(os.getcwd()) + (" (fused)" if FUSED else " (unfused)")
model = None  # set in main: spawned render workers import this file


def raw_map(images, dtype):
    """convDb's output as the forward writes it (NHWC view)."""
    with torch.inference_mode(), full_f32():
        if dtype == torch.bfloat16:  # conv_packing="auto" on the card
            x = cuda_pair1.fused_pair1(
                images, model.conv1a.weight, model.conv1a.bias,
                model.conv1b.weight, model.conv1b.bias).permute(0, 3, 1, 2)
            pairs = PAIRS[1:]
        else:
            x = images[:, None].contiguous(memory_format=torch.channels_last)
            pairs = PAIRS
        for na, nb in pairs:
            x = F.max_pool2d(model._conv(model._conv(x, na), nb), 2)
        x = model._conv(model._conv(x, "conv4a"), "conv4b")
        return model._conv(model._conv(x, "convDa"), "convDb",
                           relu=False).permute(0, 2, 3, 1)


def tail(raw, uv, valid):
    """From convDb's output to Features.desc, as this checkout runs it."""
    if FUSED:
        return cuda_desc.sample_descriptors_sparse(raw, uv, valid, (H, W))
    coarse = raw.float()
    coarse = coarse / torch.linalg.vector_norm(coarse, dim=-1, keepdim=True)
    desc = cuda_desc.sample_descriptors_sparse(coarse.contiguous(), uv,
                                               (H, W))
    return torch.where(valid[..., None], desc, 0.0)


def tail_profile(fn, flush, iters=20):
    """(device ms a call, launches a call, {kernel: ms}) of fn's kernels,
    L2 flushed before each call (its events left out) or back to back."""
    skip = cs.flush_keys() if flush else frozenset()
    fn()
    torch.cuda.synchronize()
    for _ in range(cs.PROFILE_WINDOWS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if flush:
                    cs.flush_l2()
                fn()
            torch.cuda.synchronize()
        rows = [ev for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA
                and not ev.key.startswith("ProfilerStep")
                and ev.key not in skip]
        if rows and all(ev.count % iters == 0 for ev in rows):
            return (sum(cs.event_device_us(ev) for ev in rows) / 1e3 / iters,
                    sum(ev.count for ev in rows) / iters,
                    {cs.short_name(ev.key)[:60]: cs.event_device_us(ev) / 1e3
                     / iters for ev in rows})
    raise AssertionError("profiler: events missing")


def main():
    global model
    dev = torch.device("cuda", 0)
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    state = load_checkpoint("weights/sp_rendered.npz")
    model = SuperPoint({k: v.to(dev) for k, v in state.items()}).eval()
    t0 = time.perf_counter()
    frames = cs.render_all({5: (220, 12)})[5]
    print(f"[{TAG}] {smi} | torch {torch.__version__} | rendered in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    cfg = Config()
    ex = cfg.extractor
    slam_img = torch.as_tensor(np.stack([frames[0].image]).astype(np.float32)
                               / 255.0, device=dev)
    step_img = torch.as_tensor(np.random.default_rng(0).random((32, H, W),
                                                              np.float32),
                               device=dev)
    for what, images, dtype in (("B=1 f32", slam_img, torch.float32),
                                ("B=32 bf16", step_img, torch.bfloat16)):
        with torch.inference_mode():
            feats = extract(model, images, num_features=cfg.tracking.num_features,
                            max_keypoints=cfg.runtime.max_keypoints,
                            conf_thresh=ex.conf_thresh, nms_dist=ex.nms_dist,
                            border=ex.border, compute_dtype=dtype)
            raw = raw_map(images, dtype)
            uv, valid = feats.uv.contiguous(), feats.valid.contiguous()
            got = tail(raw, uv, valid)
            err = float((got - feats.desc).abs().max())
            cold = tail_profile(lambda: tail(raw, uv, valid), flush=True)
            warm = tail_profile(lambda: tail(raw, uv, valid), flush=False)
        print(f"[{TAG}] tail {what}: valid {valid.sum(1).tolist()[:4]}..., vs "
              f"extract's desc {err:.2e}; cold {cold[0]:.4f} dev ms, "
              f"{cold[1]:.0f} launches; warm {warm[0]:.4f} dev ms, "
              f"{warm[1]:.0f} launches | by kernel, cold: "
              + ", ".join(f"{k} {v:.4f}" for k, v in cold[2].items()), flush=True)

    step = cs.make_step(state, dev)
    stats, carry = cs.step_fps(step)
    print(f"[{TAG}] step: {stats}")
    print("\n".join(f"[{TAG}] {line}" for line in cs.profile_step(step, carry)[:14]),
          flush=True)

    sys_ = System(cfg, params=state, device=dev)
    sys_.spin(frames[:11])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        sys_.spin(frames[11:12])
        torch.cuda.synchronize()
        win = (time.perf_counter() - t1) * 1e3
    kern = [ev for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA
            and not ev.key.startswith("ProfilerStep")]
    print(f"[{TAG}] SLAM frame 11: {sum(ev.count for ev in kern)} device events, "
          f"busy {sum(cs.event_device_us(ev) for ev in kern) / 1e3:.3f} ms, "
          f"wall {win:.1f} ms (profiler on), report {sys_.report()}", flush=True)


if __name__ == "__main__":
    main()
