// Sparse bilinear descriptor sampling: one L2-renormalised 256-d descriptor
// per keypoint from the coarse descriptor map.
//
// Replaces the TPU kernel sp_orb_slam_tpu/ops/pallas_desc.py
// (`pallas_sample_descriptors_sparse`), with its semantics: for keypoint (u, v)
//   gx = u (wc - 1) / W,  gy = v (hc - 1) / H,
//   x0 = clamp(floor(gx), 0, wc - 2),  y0 = clamp(floor(gy), 0, hc - 2),
//   du = clamp(gx - x0, 0, 1),  dv = clamp(gy - y0, 0, 1),
// the bilinear sum of the four corner rows r0, r0 + 1, r0 + wc, r0 + wc + 1
// (r0 = y0 wc + x0) of the flattened (hc wc, 256) map, then the row scaled
// by rsqrt of its squared norm where that is > 0, else 0.  For keypoints
// inside the image the clamps never bind and this is the plain version,
// models/superpoint.py `sample_descriptors`.
//
// Bound on the card: bytes.  Per keypoint at most four 1 KiB rows read
// (fewer where keypoints share corners) plus 8 B of uv and one 1 KiB row
// written; at B=32, K=896 about 147 MB, ~0.044 ms at 3.35 TB/s.  The
// arithmetic (~2.5 kFLOP per keypoint) is negligible.
//
// Design: one warp per keypoint, 8 warps per block.  Lane l owns channels
// 4l..4l+3 and 128+4l..128+4l+3, so each corner row is two coalesced
// 512-byte float4 sweeps of the warp.  The weights are computed per lane
// (no staging in shared memory), the squared norm is a shuffle reduction,
// and the output row is two float4 stores per lane.  The TPU kernel's
// 16-row aligned windows and masked reduces existed only for Mosaic's
// sublane alignment and have no counterpart here.

#include <cuda_runtime.h>

namespace {

constexpr int D = 256;
constexpr int WARPS = 8;

__device__ __forceinline__ float4 axpy4(float a, float4 x, float4 y) {
  return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y), fmaf(a, x.z, y.z),
                     fmaf(a, x.w, y.w));
}

__global__ void __launch_bounds__(WARPS * 32)
desc_sparse_kernel(const float* __restrict__ coarse,
                   const float* __restrict__ uv, float* __restrict__ out,
                   int n_kp, int K, int hc, int wc, int H, int W) {
  const int kp = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (kp >= n_kp) return;
  const int b = kp / K;
  const float u = uv[2 * size_t(kp)], v = uv[2 * size_t(kp) + 1];
  // same rounding order as the plain version: (u * (wc - 1)) / W
  const float gx = __fdiv_rn(__fmul_rn(u, float(wc - 1)), float(W));
  const float gy = __fdiv_rn(__fmul_rn(v, float(hc - 1)), float(H));
  const int x0 = min(max(int(floorf(gx)), 0), wc - 2);
  const int y0 = min(max(int(floorf(gy)), 0), hc - 2);
  const float du = fminf(fmaxf(gx - float(x0), 0.f), 1.f);
  const float dv = fminf(fmaxf(gy - float(y0), 0.f), 1.f);
  const float w00 = (1.f - du) * (1.f - dv), w01 = du * (1.f - dv);
  const float w10 = (1.f - du) * dv, w11 = du * dv;

  const float4* r0 = reinterpret_cast<const float4*>(
      coarse + (size_t(b) * hc * wc + size_t(y0) * wc + x0) * D);
  const float4* r1 = r0 + size_t(wc) * (D / 4);   // the row below
  float4 acc[2];
  float ss = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = h * 32 + lane;                  // float4 index in the row
    float4 top = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 bot = top;
    top = axpy4(w00, __ldg(r0 + c), top);
    top = axpy4(w01, __ldg(r0 + D / 4 + c), top);
    bot = axpy4(w10, __ldg(r1 + c), bot);
    bot = axpy4(w11, __ldg(r1 + D / 4 + c), bot);
    acc[h] = make_float4(top.x + bot.x, top.y + bot.y, top.z + bot.z,
                         top.w + bot.w);
    ss += acc[h].x * acc[h].x + acc[h].y * acc[h].y + acc[h].z * acc[h].z +
          acc[h].w * acc[h].w;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float s = ss > 0.f ? rsqrtf(ss) : 0.f;
  float4* o4 = reinterpret_cast<float4*>(out + size_t(kp) * D);
#pragma unroll
  for (int h = 0; h < 2; ++h)
    o4[h * 32 + lane] =
        make_float4(acc[h].x * s, acc[h].y * s, acc[h].z * s, acc[h].w * s);
}

}  // namespace

// coarse (B, hc, wc, 256) f32, uv (B, K, 2) f32 pixel coords of an (H, W)
// image; out (B, K, 256) f32.  All contiguous; hc, wc >= 2.
extern "C" int desc_sparse_launch(const void* coarse, const void* uv,
                                  void* out, int B, int K, int hc, int wc,
                                  int H, int W, void* stream) {
  const int n_kp = B * K;
  if (n_kp == 0) return 0;
  desc_sparse_kernel<<<(n_kp + WARPS - 1) / WARPS, WARPS * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coarse), static_cast<const float*>(uv),
      static_cast<float*>(out), n_kp, K, hc, wc, H, W);
  return int(cudaGetLastError());
}
