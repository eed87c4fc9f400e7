// Dense bilinear descriptor sampling: every cell's candidate descriptor,
// L2-renormalised, from the coarse descriptor map.
//
// Replaces the TPU kernel sp_orb_slam_tpu/ops/pallas_desc.py
// (`pallas_sample_descriptors_dense`); same semantics as
// models/superpoint.py `sample_descriptors_dense` (the plain version): for
// the candidate (u, v) of cell (i, j)
//   gx = u (wc - 1) / W,  gy = v (hc - 1) / H,
//   x0 = clamp(floor(gx), 0, wc - 1),  x1 = min(x0 + 1, wc - 1)  (same in y),
//   du = gx - x0,  dv = gy - y0,
// corner weights (1-du)(1-dv), du(1-dv), (1-du)dv, du dv on rows (y0, x0),
// (y0, x1), (y1, x0), (y1, x1).  As in the TPU kernel, the weights are
// folded onto the 3x3 stencil around the cell: a corner outside it, or
// with weight <= 0, contributes exactly 0 and its row is never read.  The
// row is then scaled by rsqrt of its squared norm where that is > 0,
// else 0.
//
// Bound on the card: bytes, one read of the map and the candidates and one
// write of the sampled map: at B=32, 752x480 (60 x 94 cells) about 2 x
// 185 MB, ~0.11 ms at 3.35 TB/s.  Neighbouring cells share corner rows;
// those repeat reads come from L2.
//
// Design: one warp per cell, 8 warps per block; lane l owns channels
// 4l..4l+3 and 128+4l..128+4l+3 (two coalesced float4 sweeps per row), a
// shuffle reduction for the norm.  The TPU kernel's 3-chunk VMEM window
// existed only for Mosaic's alignment rules and has no counterpart here.

#include <cuda_runtime.h>

namespace {

constexpr int D = 256;
constexpr int WARPS = 8;

__global__ void __launch_bounds__(WARPS * 32)
desc_dense_kernel(const float* __restrict__ coarse,
                  const int* __restrict__ cand_uv, float* __restrict__ out,
                  int n_cells, int hc, int wc, int H, int W) {
  const int cell = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (cell >= n_cells) return;
  const int per_img = hc * wc;
  const int b = cell / per_img, r = cell % per_img;
  const int i = r / wc, j = r % wc;
  const float u = float(cand_uv[2 * size_t(cell)]);
  const float v = float(cand_uv[2 * size_t(cell) + 1]);
  const float gx = __fdiv_rn(__fmul_rn(u, float(wc - 1)), float(W));
  const float gy = __fdiv_rn(__fmul_rn(v, float(hc - 1)), float(H));
  const int x0 = min(max(int(floorf(gx)), 0), wc - 1);
  const int y0 = min(max(int(floorf(gy)), 0), hc - 1);
  const int x1 = min(x0 + 1, wc - 1), y1 = min(y0 + 1, hc - 1);
  const float du = gx - float(x0), dv = gy - float(y0);
  const int cy[4] = {y0, y0, y1, y1};
  const int cx[4] = {x0, x1, x0, x1};
  const float cw[4] = {(1.f - du) * (1.f - dv), du * (1.f - dv),
                       (1.f - du) * dv, du * dv};

  const float4* base =
      reinterpret_cast<const float4*>(coarse + size_t(b) * per_img * D);
  float4 acc[2] = {make_float4(0.f, 0.f, 0.f, 0.f),
                   make_float4(0.f, 0.f, 0.f, 0.f)};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool tap = cw[k] > 0.f && abs(cy[k] - i) <= 1 && abs(cx[k] - j) <= 1;
    if (!tap) continue;  // uniform across the warp: no divergence
    const float4* row = base + (size_t(cy[k]) * wc + cx[k]) * (D / 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 x = __ldg(row + h * 32 + lane);
      acc[h].x = fmaf(cw[k], x.x, acc[h].x);
      acc[h].y = fmaf(cw[k], x.y, acc[h].y);
      acc[h].z = fmaf(cw[k], x.z, acc[h].z);
      acc[h].w = fmaf(cw[k], x.w, acc[h].w);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h)
    ss += acc[h].x * acc[h].x + acc[h].y * acc[h].y + acc[h].z * acc[h].z +
          acc[h].w * acc[h].w;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float s = ss > 0.f ? rsqrtf(ss) : 0.f;
  float4* o4 = reinterpret_cast<float4*>(out + size_t(cell) * D);
#pragma unroll
  for (int h = 0; h < 2; ++h)
    o4[h * 32 + lane] =
        make_float4(acc[h].x * s, acc[h].y * s, acc[h].z * s, acc[h].w * s);
}

}  // namespace

// coarse (B, hc, wc, 256) f32, cand_uv (B, hc, wc, 2) int32 pixel coords of
// an (H, W) image; out (B, hc, wc, 256) f32.  All contiguous.
extern "C" int desc_dense_launch(const void* coarse, const void* cand_uv,
                                 void* out, int B, int hc, int wc, int H,
                                 int W, void* stream) {
  const int n_cells = B * hc * wc;
  if (n_cells == 0) return 0;
  desc_dense_kernel<<<(n_cells + WARPS - 1) / WARPS, WARPS * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coarse), static_cast<const int*>(cand_uv),
      static_cast<float*>(out), n_cells, hc, wc, H, W);
  return int(cudaGetLastError());
}
