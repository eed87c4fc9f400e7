// Sparse bilinear descriptor sampling straight from the raw descriptor map:
// one masked, L2-renormalised 256-d descriptor per keypoint slot, from
// convDb's output as it is written (float32 or bfloat16, not normalised).
//
// Replaces the TPU kernel sp_orb_slam_tpu/ops/pallas_desc.py:203
// `pallas_sample_descriptors_sparse` (pallas_call at :272) together with
// the passes around it on the JAX package's path: the map's float32 cast
// and L2 normalisation before it (models/superpoint.py:247-248) and the
// valid mask after it (extractor.py:155).  For slot k with pixel coords
// (u, v) of an (H, W) image:
//   gx = u (wc - 1) / W,  gy = v (hc - 1) / H,
//   x0 = clamp(floor(gx), 0, wc - 2),  y0 = clamp(floor(gy), 0, hc - 2),
//   du = clamp(gx - x0, 0, 1),  dv = clamp(gy - y0, 0, 1);
// each of the four corner rows r0, r0 + 1, r0 + wc, r0 + wc + 1
// (r0 = y0 wc + x0) of the flattened (hc wc, 256) map is cast to float32
// and divided by its own L2 norm, the four are summed with the bilinear
// weights, and the sum is scaled by rsqrt of its squared norm where that
// is > 0, else 0.  An invalid slot is a row of zeros and reads no corner.
// For keypoints inside the image the clamps never bind and this is
// ops/cuda_desc.py `sample_descriptors_sparse_plain`:
// where(valid, sample_descriptors(unit_rows(raw.float()), uv), 0).
//
// Bound on the card: bytes.  A valid slot reads at most four rows of
// 256 x 4 B (float32) or 256 x 2 B (bfloat16), fewer where slots share
// corners; every slot reads 8 B of uv and 1 B of valid and writes 1 KiB.
// With every slot valid, at B=32, K=896 in bfloat16 about 70 MB (~0.021
// ms at 3.35 TB/s), at B=1 in float32 about 3.5 MB (~0.0011 ms).  The
// arithmetic (~5 kFLOP a slot) is negligible.  Reading the raw map here
// removes the passes the map took before: its cast, its norm and its
// division (each over all 5,640 rows of an image, of which the keypoints
// touch about half), and the mask's passes over the output.
//
// Design: one warp a keypoint, 8 warps a block.  A lane owns 8 channels of
// each row: 4l..4l+3 and 128+4l..128+4l+3 in float32 (two 16-byte loads a
// row), 8l..8l+7 in bfloat16 (one 16-byte load a row), so each row is one
// or two coalesced sweeps of the warp.  The warp loads the slot's uv and
// valid in one trip, then issues all four rows' loads at once; the four
// squared norms are one interleaved shuffle reduction, each corner's
// bilinear weight is divided by its norm, and the weighted sum, its
// squared norm (a second reduction) and the scaled row stay in registers.
// No shared memory, no barrier; plain vector loads (Hopper's TMA has no
// row gather).  Two warps a keypoint (one per corner pair, combined
// through shared memory, 1 or 4 keypoints a block) were 4-14 % slower
// than this on the H100, timed in turns at every batch of its paths
// (B=1, 2, 8, 32; probes/desc_sparse_variants.py).  A B=1 call's time is
// the dependent chain of trips (uv, then the corners, then the store) and
// the launch, not the number of SMs it reaches (112 blocks fill fewer
// than the 132 SMs and still beat 896 blocks of two warps); at B=32 the
// barrier and the shared-memory pass cost more than the extra warps gain.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int D = 256;
constexpr int WARPS = 8;

using bf16 = uint16_t;  // bfloat16 bits: the upper half of a float32

// The 8 channels of `row` that lane `lane` owns, as float32.
__device__ __forceinline__ void load_row(const float* row, int lane,
                                         float (&x)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(row) + lane);
  const float4 b = __ldg(reinterpret_cast<const float4*>(row) + 32 + lane);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load_row(const bf16* row, int lane,
                                         float (&x)[8]) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(row) + lane);
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // the lower address in the lower half
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
desc_sparse_kernel(const T* __restrict__ raw, const float* __restrict__ uv,
                   const bool* __restrict__ valid, float* __restrict__ out,
                   int n_kp, int K, int hc, int wc, int H, int W) {
  const int kp = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (kp >= n_kp) return;
  const float2 p = __ldg(reinterpret_cast<const float2*>(uv) + kp);
  float acc[8];
  if (valid[kp]) {
    // same rounding order as the plain version: (u * (wc - 1)) / W
    const float gx = __fdiv_rn(__fmul_rn(p.x, float(wc - 1)), float(W));
    const float gy = __fdiv_rn(__fmul_rn(p.y, float(hc - 1)), float(H));
    const int x0 = min(max(int(floorf(gx)), 0), wc - 2);
    const int y0 = min(max(int(floorf(gy)), 0), hc - 2);
    const float du = fminf(fmaxf(gx - float(x0), 0.f), 1.f);
    const float dv = fminf(fmaxf(gy - float(y0), 0.f), 1.f);
    const T* r0 = raw + (size_t(kp / K) * hc * wc + size_t(y0) * wc + x0) * D;
    const T* r1 = r0 + size_t(wc) * D;  // the row below
    float x[4][8];
    load_row(r0, lane, x[0]);
    load_row(r0 + D, lane, x[1]);
    load_row(r1, lane, x[2]);
    load_row(r1 + D, lane, x[3]);
    float s[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[j] = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) s[j] = fmaf(x[j][i], x[j][i], s[j]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[j] += __shfl_xor_sync(0xffffffffu, s[j], o);
    }
    // each corner's bilinear weight over its norm: w (x / |x|) = (w / |x|) x
    const float k0 = (1.f - du) * (1.f - dv) / sqrtf(s[0]);
    const float k1 = du * (1.f - dv) / sqrtf(s[1]);
    const float k2 = (1.f - du) * dv / sqrtf(s[2]);
    const float k3 = du * dv / sqrtf(s[3]);
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc[i] = fmaf(k0, x[0][i], k1 * x[1][i]) +
               fmaf(k2, x[2][i], k3 * x[3][i]);
      ss = fmaf(acc[i], acc[i], ss);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float sc = ss > 0.f ? rsqrtf(ss) : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] *= sc;
  } else {  // an invalid slot reads no corner
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  }
  // the lane's channels, as load_row read them
  float4* o4 = reinterpret_cast<float4*>(out + size_t(kp) * D);
  const bool f32 = std::is_same<T, float>::value;
  o4[f32 ? lane : 2 * lane] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  o4[f32 ? 32 + lane : 2 * lane + 1] =
      make_float4(acc[4], acc[5], acc[6], acc[7]);
}

template <typename T>
void launch(const void* raw, const void* uv, const void* valid, void* out,
            int n_kp, int K, int hc, int wc, int H, int W,
            cudaStream_t stream) {
  desc_sparse_kernel<T><<<(n_kp + WARPS - 1) / WARPS, WARPS * 32, 0,
                          stream>>>(
      static_cast<const T*>(raw), static_cast<const float*>(uv),
      static_cast<const bool*>(valid), static_cast<float*>(out), n_kp, K, hc,
      wc, H, W);
}

}  // namespace

// raw (B, hc, wc, 256) float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1),
// uv (B, K, 2) float32 pixel coords of an (H, W) image, valid (B, K) bool;
// out (B, K, 256) float32.  All contiguous, raw on 16 bytes and uv on 8;
// hc, wc >= 2.
extern "C" int desc_sparse_launch(const void* raw, const void* uv,
                                  const void* valid, void* out, int B, int K,
                                  int hc, int wc, int H, int W, int is_bf16,
                                  void* stream) {
  const int n_kp = B * K;
  if (n_kp == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch<bf16>(raw, uv, valid, out, n_kp, K, hc, wc, H, W, s);
  else
    launch<float>(raw, uv, valid, out, n_kp, K, hc, wc, H, W, s);
  return int(cudaGetLastError());
}
