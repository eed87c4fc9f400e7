// Per-keypoint covariance flood fill, one warp per keypoint.
//
// Replaces the TPU kernel sp_orb_slam_tpu/ops/pallas_cov.py
// (`pallas_covariance`, body `_cov_kernel`); same semantics as
// ops/covariance.py `keypoint_covariance`: a (2r+1)^2 window of heat_inv at
// u0 = clip(u - r, 0, W - size), v0 likewise; starting from the window
// centre, `iters` Jacobi rounds of 4-neighbour growth into pixels that are
// positive and strictly below the neighbour they are reached from; then
// wsum = max(sum w, 1e-12), cov = (sum w dx^2, sum w dy^2) / wsum clamped
// to >= 1, response = the centre value; invalid slots get (1, 1) and 0.
//
// Bound on the card: bytes, the windows read from heat_inv (~33 MB at B=32,
// K=896), i.e. about 10 us; the fill itself is tiny, but at the old kernel's
// runtime radius its per-pixel loops were instruction-bound.  Design:
// - the radius is a template parameter (one instance per radius 0-15), so
//   every loop over the window is unrolled with constant indices;
// - the warp loads its window into shared memory with coalesced loads, all
//   issued before the first store (lanes along the flattened window);
// - lane i owns window row i as 32-bit masks over the columns (reach, and
//   the four loop-invariant "neighbour is higher and I am positive"
//   masks); a round is two warp shuffles (the rows above and below) and
//   two shifts (left and right), all in registers;
// - the fill stops at its fixed point: a round is a function of the reach
//   mask alone, so once no lane grew (__any_sync) no later round would;
//   `iters` still caps the rounds exactly;
// - an invalid slot skips the load and the fill and writes its constants;
// - blocks of 4 warps, so that B=1's 896 keypoints spread over the SMs.
// The moments are f32 sums in another order than the plain version's.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;
constexpr unsigned FULL = 0xffffffffu;

template <int R>
__global__ void __launch_bounds__(WARPS * 32)
cov_kernel(const float* __restrict__ heat, const float* __restrict__ uv,
           const unsigned char* __restrict__ valid, float* __restrict__ cov2,
           float* __restrict__ cov2_inv, float* __restrict__ resp, int total,
           int K, int H, int W, int iters) {
  constexpr int S = 2 * R + 1, N = S * S, NL = (N + 31) / 32;
  __shared__ float wins[WARPS][N];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = blockIdx.x * WARPS + warp;  // keypoint b * K + k
  if (g >= total) return;  // whole warps only; no block barrier below
  if (!valid[g]) {
    if (lane == 0) {
      reinterpret_cast<float2*>(cov2)[g] = make_float2(1.f, 1.f);
      reinterpret_cast<float2*>(cov2_inv)[g] = make_float2(1.f, 1.f);
      resp[g] = 0.f;
    }
    return;
  }
  float* win = wins[warp];
  const float2 kp = reinterpret_cast<const float2*>(uv)[g];
  const int u0 = min(max(int(kp.x) - R, 0), W - S);
  const int v0 = min(max(int(kp.y) - R, 0), H - S);
  const float* hb = heat + size_t(g / K) * H * W + size_t(v0) * W + u0;
  float x[NL];
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    const int i = lane + 32 * k;
    if (i < N) x[k] = hb[(i / S) * W + i % S];
  }
#pragma unroll
  for (int k = 0; k < NL; ++k)
    if (lane + 32 * k < N) win[lane + 32 * k] = x[k];
  __syncwarp();

  // lane = window row: its pixels and the four descent masks
  const int row = min(lane, S - 1);
  const float* wr = win + row * S;
  const float* wu = win + max(row - 1, 0) * S;
  const float* wd = win + min(row + 1, S - 1) * S;
  const bool up_ok = lane > 0 && lane < S, dn_ok = lane < S - 1;
  unsigned m_up = 0, m_dn = 0, m_lf = 0, m_rt = 0;
  float w[S];
#pragma unroll
  for (int j = 0; j < S; ++j) w[j] = wr[j];
#pragma unroll
  for (int j = 0; j < S; ++j) {  // no branch: every load is in the window
    const bool pos = w[j] > 0.f;
    m_up |= unsigned(pos & up_ok & (w[j] < wu[j])) << j;
    m_dn |= unsigned(pos & dn_ok & (w[j] < wd[j])) << j;
    if (j > 0) m_lf |= unsigned(pos & (w[j] < w[j - 1])) << j;
    if (j < S - 1) m_rt |= unsigned(pos & (w[j] < w[j + 1])) << j;
  }
  if (lane >= S) m_up = m_dn = m_lf = m_rt = 0;

  unsigned reach = lane == R ? 1u << R : 0u;
  for (int it = 0; it < iters; ++it) {
    unsigned up = __shfl_up_sync(FULL, reach, 1);    // row lane - 1
    const unsigned dn = __shfl_down_sync(FULL, reach, 1);  // row lane + 1
    if (lane == 0) up = 0;
    const unsigned grown = reach | (m_up & up) | (m_dn & dn) |
                           (m_lf & (reach << 1)) | (m_rt & (reach >> 1));
    const bool grew = grown != reach;
    reach = grown;
    if (!__any_sync(FULL, grew)) break;  // the fixed point
  }

  float s0 = 0.f, sx = 0.f;
  if (lane < S) {
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const float v = (reach >> j) & 1u ? w[j] : 0.f;
      s0 += v;
      sx = fmaf(v, float((j - R) * (j - R)), sx);
    }
  }
  float sy = s0 * float((lane - R) * (lane - R));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s0 += __shfl_xor_sync(FULL, s0, o);
    sx += __shfl_xor_sync(FULL, sx, o);
    sy += __shfl_xor_sync(FULL, sy, o);
  }
  if (lane == 0) {
    const float wsum = fmaxf(s0, 1e-12f);
    const float cx = fmaxf(sx / wsum, 1.f), cy = fmaxf(sy / wsum, 1.f);
    reinterpret_cast<float2*>(cov2)[g] = make_float2(cx, cy);
    reinterpret_cast<float2*>(cov2_inv)[g] = make_float2(1.f / cx, 1.f / cy);
    resp[g] = win[R * S + R];
  }
}

template <int R>
int launch(const void* heat, const void* uv, const void* valid, void* cov2,
           void* cov2_inv, void* resp, int B, int K, int H, int W, int radius,
           int iters, cudaStream_t stream) {
  if (radius != R) {
    if constexpr (R > 0)
      return launch<R - 1>(heat, uv, valid, cov2, cov2_inv, resp, B, K, H, W,
                           radius, iters, stream);
    return int(cudaErrorInvalidValue);
  }
  const int total = B * K;
  cov_kernel<R><<<(total + WARPS - 1) / WARPS, WARPS * 32, 0, stream>>>(
      static_cast<const float*>(heat), static_cast<const float*>(uv),
      static_cast<const unsigned char*>(valid), static_cast<float*>(cov2),
      static_cast<float*>(cov2_inv), static_cast<float*>(resp), total, K, H, W,
      iters);
  return int(cudaGetLastError());
}

}  // namespace

// heat (B, H, W) f32; uv (B, K, 2) f32; valid (B, K) bool;
// cov2, cov2_inv (B, K, 2) f32 and resp (B, K) f32 out.  One instance per
// radius 0-15 (MAX_RADIUS); any other radius returns cudaErrorInvalidValue.
extern "C" int cov_launch(const void* heat, const void* uv, const void* valid,
                          void* cov2, void* cov2_inv, void* resp, int B, int K,
                          int H, int W, int radius, int iters, void* stream) {
  return launch<15>(heat, uv, valid, cov2, cov2_inv, resp, B, K, H, W, radius,
                    iters, static_cast<cudaStream_t>(stream));
}
