"""Design variants of the fused sparse descriptor sampler on the card.

Builds probes/desc_sparse_variants.cu (A: two warps a keypoint, one per
corner pair, combined through shared memory, 1 or 4 keypoints a block;
B: one warp for 1 or 2 keypoints, all four corners) and times each beside
the package's kernel, in turns, cold (L2 flushed before each call, device
events) and warm (back to back), at the batches and types of its paths;
each output is held against the plain version.  Needs a CUDA card and
nvcc; run from the root of a checkout:

    python3 probes/desc_sparse_variants.py
"""
import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from sp_orb_slam_tpu_torch.ops import _build, cuda_desc  # noqa: E402

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "desc_sparse_variants.cu")
LIB = os.path.join(_build.BUILD_DIR, "libdesc_sparse_variants.so")

os.makedirs(_build.BUILD_DIR, exist_ok=True)
r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", LIB, SOURCE],
                   capture_output=True, text=True)
print(r.stdout + r.stderr)
if r.returncode:
    raise RuntimeError("the variants did not build")
fn = ctypes.CDLL(LIB).variant_launch
fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
               + [ctypes.c_int] * 7 + [ctypes.c_void_p])
fn.restype = ctypes.c_int

dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(0)
H, W, K, hc, wc = 480, 752, 896, 60, 94
raw32 = torch.randn((32, hc, wc, 256), generator=gen, device=dev) * (
    torch.rand((32, hc, wc, 1), generator=gen, device=dev) * 8 + 0.5)
# keypoints inside the NMS border; a valid prefix of 700-800 slots an image
raws = {"f32": raw32, "bf16": raw32.to(torch.bfloat16)}
uv = torch.stack([8 + torch.rand((32, K), generator=gen, device=dev) * (W - 16),
                  8 + torch.rand((32, K), generator=gen, device=dev) * (H - 16)],
                 -1).contiguous()
n = torch.randint(700, 801, (32, 1), generator=gen, device=dev)
valid = torch.arange(K, device=dev)[None] < n


def warm_ms(call, iters=50):
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    return sum(cs.event_device_us(ev) for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA
               and not ev.key.startswith("ProfilerStep")) / 1e3 / iters


def caller(name, dt, nb):
    raw, u, v = raws[dt][:nb], uv[:nb], valid[:nb]
    if name == "repo":
        return lambda: cuda_desc.sample_descriptors_sparse(raw, u, v, (H, W))
    variant, kpb = {"A1": (0, 1), "A4": (0, 4), "B1": (1, 0),
                    "B2": (2, 0)}[name]
    out = torch.empty((nb, K, 256), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call():
        err = fn(variant, kpb, raw.data_ptr(), u.data_ptr(), v.data_ptr(),
                 out.data_ptr(), nb, K, hc, wc, H, W, int(dt == "bf16"),
                 stream)
        if err:
            raise RuntimeError(f"variant {name}: CUDA error {err}")
        return out
    return call


smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
               "--format=csv,noheader").read().strip()
print("variant probe |", smi, flush=True)
names = ("repo", "A1", "A4", "B1", "B2")
for dt, nb in (("f32", 1), ("f32", 2), ("bf16", 8), ("f32", 32),
               ("bf16", 32)):
    want = cuda_desc.sample_descriptors_sparse_plain(raws[dt][:nb], uv[:nb],
                                                     valid[:nb], (H, W))
    res = {}
    for name in names + names[::-1]:
        call = caller(name, dt, nb)
        got = call()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if err > 1e-5:
            raise AssertionError(f"{name} {dt} B={nb}: max_abs_err {err}")
        res.setdefault(name, []).append((cs.device_ms(call), warm_ms(call)))
    print(f"{dt} B={nb} dev ms cold / warm: " + "; ".join(
        f"{k} " + " ".join(f"{c:.4f}/{w:.4f}" for c, w in v)
        for k, v in res.items()), flush=True)
