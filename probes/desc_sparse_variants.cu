// Design variants of the fused sparse sampler (csrc/desc_sparse.cu), for
// the timing probe probes/desc_sparse_variants.py; not part of the package.
// B with one keypoint a warp is the design the package's kernel took.
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {
constexpr int D = 256;
using bf16 = uint16_t;

__device__ __forceinline__ void load_row(const float* row, int lane, float (&x)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(row) + lane);
  const float4 b = __ldg(reinterpret_cast<const float4*>(row) + 32 + lane);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load_row(const bf16* row, int lane, float (&x)[8]) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(row) + lane);
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
template <typename T>
__device__ __forceinline__ void store_row(float* row, int lane, const float (&x)[8]) {
  float4* o4 = reinterpret_cast<float4*>(row);
  const int q0 = std::is_same<T, float>::value ? lane : 2 * lane;
  const int q1 = std::is_same<T, float>::value ? 32 + lane : 2 * lane + 1;
  o4[q0] = make_float4(x[0], x[1], x[2], x[3]);
  o4[q1] = make_float4(x[4], x[5], x[6], x[7]);
}
__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}
struct Corner { int r0; float du, dv; };
__device__ __forceinline__ Corner corner(float u, float v, int hc, int wc, int H, int W) {
  const float gx = __fdiv_rn(__fmul_rn(u, float(wc - 1)), float(W));
  const float gy = __fdiv_rn(__fmul_rn(v, float(hc - 1)), float(H));
  const int x0 = min(max(int(floorf(gx)), 0), wc - 2);
  const int y0 = min(max(int(floorf(gy)), 0), hc - 2);
  Corner c;
  c.r0 = y0 * wc + x0;
  c.du = fminf(fmaxf(gx - float(x0), 0.f), 1.f);
  c.dv = fminf(fmaxf(gy - float(y0), 0.f), 1.f);
  return c;
}

// A: two warps a keypoint (a corner pair each), kpb keypoints a block; uv
// and valid loaded together.
template <typename T>
__global__ void __launch_bounds__(256) var_a(const T* __restrict__ raw, const float* __restrict__ uv,
    const bool* __restrict__ valid, float* __restrict__ out, int n_kp, int K, int hc, int wc, int H, int W) {
  __shared__ float bottom[4][8][32];
  const int lane = threadIdx.x & 31, pair = (threadIdx.x >> 5) & 1, slot = threadIdx.x >> 6;
  const int kp = blockIdx.x * (blockDim.x >> 6) + slot;
  bool live = false;
  float acc[8];
  if (kp < n_kp) {
    const float2 p = __ldg(reinterpret_cast<const float2*>(uv) + kp);
    live = valid[kp];
    if (live) {
      const Corner c = corner(p.x, p.y, hc, wc, H, W);
      const float wy = pair ? c.dv : 1.f - c.dv;
      const T* r = raw + (size_t(kp / K) * hc * wc + c.r0 + size_t(pair) * wc) * D;
      float a[8], b[8];
      load_row(r, lane, a);
      load_row(r + D, lane, b);
      float sa = 0.f, sb = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) { sa = fmaf(a[i], a[i], sa); sb = fmaf(b[i], b[i], sb); }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        sa += __shfl_xor_sync(0xffffffffu, sa, o);
        sb += __shfl_xor_sync(0xffffffffu, sb, o);
      }
      const float ka = (1.f - c.du) * wy / sqrtf(sa), kb = c.du * wy / sqrtf(sb);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = fmaf(ka, a[i], kb * b[i]);
      if (pair) {
#pragma unroll
        for (int i = 0; i < 8; ++i) bottom[slot][i][lane] = acc[i];
      }
    }
  }
  __syncthreads();
  if (pair || kp >= n_kp) return;
  if (live) {
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) { acc[i] += bottom[slot][i][lane]; ss = fmaf(acc[i], acc[i], ss); }
    ss = warp_sum(ss);
    const float s = ss > 0.f ? rsqrtf(ss) : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] *= s;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  }
  store_row<T>(out + size_t(kp) * D, lane, acc);
}

// B: one warp for G keypoints (all four corners of each), 8 warps a block;
// the G keypoints' uv and valid in one trip, then all 4G rows at once.
template <typename T, int G>
__global__ void __launch_bounds__(256) var_b(const T* __restrict__ raw, const float* __restrict__ uv,
    const bool* __restrict__ valid, float* __restrict__ out, int n_kp, int K, int hc, int wc, int H, int W) {
  const int lane = threadIdx.x & 31;
  const int kp0 = (blockIdx.x * 8 + (threadIdx.x >> 5)) * G;
  float2 p[G];
  bool live[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int kp = kp0 + g;
    live[g] = false;
    if (kp < n_kp) {
      p[g] = __ldg(reinterpret_cast<const float2*>(uv) + kp);
      live[g] = valid[kp];
    }
  }
  float x[G][4][8];
  float w[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (!live[g]) continue;
    const Corner c = corner(p[g].x, p[g].y, hc, wc, H, W);
    const T* r = raw + (size_t((kp0 + g) / K) * hc * wc + c.r0) * D;
    load_row(r, lane, x[g][0]);
    load_row(r + D, lane, x[g][1]);
    load_row(r + size_t(wc) * D, lane, x[g][2]);
    load_row(r + size_t(wc + 1) * D, lane, x[g][3]);
    w[g][0] = (1.f - c.du) * (1.f - c.dv); w[g][1] = c.du * (1.f - c.dv);
    w[g][2] = (1.f - c.du) * c.dv; w[g][3] = c.du * c.dv;
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int kp = kp0 + g;
    if (kp >= n_kp) break;
    float acc[8];
    if (live[g]) {
      float s[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[j] = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) s[j] = fmaf(x[g][j][i], x[g][j][i], s[j]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[j] += __shfl_xor_sync(0xffffffffu, s[j], o);
      }
      float k[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) k[j] = w[g][j] / sqrtf(s[j]);
      float ss = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i] = fmaf(k[0], x[g][0][i], k[1] * x[g][1][i]) + fmaf(k[2], x[g][2][i], k[3] * x[g][3][i]);
        ss = fmaf(acc[i], acc[i], ss);
      }
      ss = warp_sum(ss);
      const float sc = ss > 0.f ? rsqrtf(ss) : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] *= sc;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = 0.f;
    }
    store_row<T>(out + size_t(kp) * D, lane, acc);
  }
}

template <typename T>
void go(int variant, int kpb, const void* raw, const void* uv, const void* valid, void* out,
        int n_kp, int K, int hc, int wc, int H, int W, cudaStream_t s) {
  const T* r = static_cast<const T*>(raw);
  const float* u = static_cast<const float*>(uv);
  const bool* v = static_cast<const bool*>(valid);
  float* o = static_cast<float*>(out);
  if (variant == 0) {
    var_a<T><<<(n_kp + kpb - 1) / kpb, 64 * kpb, 0, s>>>(r, u, v, o, n_kp, K, hc, wc, H, W);
  } else if (variant == 1) {
    var_b<T, 1><<<(n_kp + 7) / 8, 256, 0, s>>>(r, u, v, o, n_kp, K, hc, wc, H, W);
  } else {
    var_b<T, 2><<<(n_kp + 15) / 16, 256, 0, s>>>(r, u, v, o, n_kp, K, hc, wc, H, W);
  }
}
}  // namespace

extern "C" int variant_launch(int variant, int kpb, const void* raw, const void* uv,
                              const void* valid, void* out, int B, int K, int hc, int wc,
                              int H, int W, int is_bf16, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16) go<bf16>(variant, kpb, raw, uv, valid, out, B * K, K, hc, wc, H, W, s);
  else go<float>(variant, kpb, raw, uv, valid, out, B * K, K, hc, wc, H, W, s);
  return int(cudaGetLastError());
}
