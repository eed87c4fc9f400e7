// Fused init matcher (SearchForInitialization): distances, best / second,
// ratio test and mutual resolution without a distance matrix in HBM.
//
// Replaces the TPU kernel sp_orb_slam_tpu/ops/pallas_match.py
// (`match_init_batch`, body `_match_kernel`); same semantics as
// ops/matching.py `init_match`: d = sqrt(max(2 - 2 a.b, 0)) in full f32,
// BIG outside the window |du|, |dv| < window or where either side is
// invalid; per row the best, its first minimal column and the second best
// over the other columns; row_ok = valid & best <= th & best < ratio * second;
// each column keeps the claim with the smallest distance, then the
// smallest row.
//
// Bound on the card: operations, 2*M*N*D f32 FLOPs (13.2 GFLOP at B=32,
// M=N=896, D=256: ~0.2 ms at 67 TFLOP/s outside the tensor cores; ~59 MB
// of descriptors).  Full f32 with `fmaf` only (no TF32): the match indices
// must equal the plain version's, which rests on full-f32 distances.
//
// Design, three kernels on one stream:
// 1. match_tile_kernel: a block owns a BM x BN tile of (row, column) pairs
//    of one batch item, 256 threads as 16 x 16, each RM rows x RN columns
//    held in registers (in runs of 4 consecutive rows or columns, 64
//    apart).  The tile's descriptor rows, BK = 32 dims at a time, come in
//    by 16-byte cp.async into a 2-slot ring in shared memory (row-major,
//    as they lie in memory, at a 144-byte pitch).  Each landed slot is
//    transposed once into a k-major slice, which frees the slot for the
//    next copy; then every k step reads a thread's rows and columns as
//    float4 runs (RM / 4 + RN / 4 vector loads for RM x RN FMAs: 16 FMAs a
//    load at 8 x 8, a half warp's row loads one broadcast).  `fmaf` only.
//    The epilogue masks and takes the distance of each pair exactly as the
//    plain version does, folds each thread's columns in increasing order
//    into a per-row (best, first index, second), reduces the 16 threads of
//    a row with shuffles, and writes one partial per (row, column tile).
//    The blocks of the first row tile also clear the column claims and the
//    counts, so no memset runs before it.
// 2. match_merge_kernel: a warp per row folds its partials (the merge does
//    not depend on their order), applies row_ok and claims its column
//    with a 64-bit atomicMin on (float bits of the distance << 32) | row:
//    distances are >= 0, so their bits order like the floats, and equal
//    distances fall to the smaller row.
// 3. match_finalize_kernel: match12, n and match21 from the claims.
// The wrapper (ops/cuda_match.py) picks the tile so that the grid has at
// least two blocks an SM where it can: 128 x 128 (8 x 8 a thread, two
// blocks an SM at 106,496 B of dynamic shared memory) at the step's B=32,
// 64 x 32 (4 x 2) at the SLAM init's B=1, where 128 x 128 would leave 83
// of 132 SMs idle.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int TX = 16, TY = 16;  // thread t: tx = t % 16, ty = t / 16
constexpr int BK = 32;           // descriptor dims a stage
constexpr int PITCH = BK + 4;    // floats a staged row
constexpr int STAGES = 2;    // ring slots
constexpr float BIG = 1e9f;

struct Best {
  float best, second;
  int idx;
};

// merge two partial (best, first index, second) results
__device__ __forceinline__ Best merge(Best a, Best b) {
  if (b.best < a.best || (b.best == a.best && b.idx < a.idx)) {
    b.second = fminf(b.second, a.best);
    return b;
  }
  a.second = fminf(a.second, b.best);
  return a;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// a thread's RM rows (RN columns) come in runs of up to 4 consecutive
// rows (columns), one vector load a run: run r of thread u starts at
// r * 16 * RUN + u * RUN
template <int R>
constexpr int RUN = R < 4 ? R : 4;
template <int R>
__device__ __forceinline__ int lane_of(int u, int i) {
  return (i / RUN<R>) * 16 * RUN<R> + u * RUN<R> + i % RUN<R>;
}

template <int W>
__device__ __forceinline__ void load_run(float* dst, const float* src) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
  } else if constexpr (W == 2) {
    *reinterpret_cast<float2*>(dst) = *reinterpret_cast<const float2*>(src);
  } else {
    *dst = *src;
  }
}

template <int RM, int RN>
constexpr int smem_bytes() {
  // the cp.async ring (row-major) and the k-major slice
  return (STAGES * PITCH + BK) * (TY * RM + TX * RN) * int(sizeof(float));
}

template <int RM, int RN>
__global__ void __launch_bounds__(THREADS, 2)
match_tile_kernel(const float* __restrict__ d1, const float* __restrict__ uv1,
                  const unsigned char* __restrict__ v1,
                  const float* __restrict__ d2, const float* __restrict__ uv2,
                  const unsigned char* __restrict__ v2,
                  Best* __restrict__ part, unsigned long long* __restrict__ colkey,
                  int* __restrict__ n, int M, int N, int D, float window) {
  constexpr int BM = TY * RM, BN = TX * RN, R = BM + BN;
  constexpr int WA = RUN<RM>, WB = RUN<RN>;
  static_assert(R % 32 == 0 && R * (BK / 4) % THREADS == 0, "whole warps");
  extern __shared__ __align__(16) float smem[];
  float* km = smem + STAGES * R * PITCH;  // [BK][R]: rows, then columns
  __shared__ float cu_s[BN], cv_s[BN];
  __shared__ bool cok_s[BN];

  const int b = blockIdx.z, row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int t = threadIdx.x, tx = t % TX, ty = t / TX;
  d1 += size_t(b) * M * D;
  d2 += size_t(b) * N * D;
  uv1 += size_t(b) * M * 2;
  uv2 += size_t(b) * N * 2;
  v1 += size_t(b) * M;
  v2 += size_t(b) * N;

  // the ring: STAGES slots of R rows x PITCH floats, the tile's rows of
  // desc1 then its columns of desc2, BK dims a slot.  A thread's 16-byte
  // copies: dims 4 (t % 8) .. + 3 of slot rows t / 8 + 32 i, as element
  // offsets into desc1 (i < CA) or desc2; a row past the edge copies the
  // last row, whose values are never folded
  constexpr int CA = BM * (BK / 4) / THREADS, CB = BN * (BK / 4) / THREADS;
  static_assert(CA * THREADS == BM * (BK / 4) && CB * THREADS == BN * (BK / 4),
                "whole copies a thread");
  int src[CA + CB];
#pragma unroll
  for (int i = 0; i < CA + CB; ++i) {
    const int r = t / 8 + 32 * i;
    src[i] = (i < CA ? min(row0 + r, M - 1) : min(col0 + r - BM, N - 1)) * D +
             4 * (t % 8);
  }
  const uint32_t ring = uint32_t(__cvta_generic_to_shared(smem)) +
                        ((t / 8) * PITCH + 4 * (t % 8)) * 4;
  auto stage = [&](int slot, int k0) {
#pragma unroll
    for (int i = 0; i < CA + CB; ++i)
      cp_async16(ring + (slot * R + 32 * i) * PITCH * 4,
                 (i < CA ? d1 : d2) + src[i] + k0);
  };
  const int KT = D / BK;
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    if (s < KT) stage(s, s * BK);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  // the tile's columns: window centre and validity (read after a barrier);
  // the first row tile also clears their claims (all ones: unclaimed) and
  // the batch item's count, which the next two kernels fill in
  for (int c = t; c < BN; c += THREADS) {
    const int col = col0 + c;
    const bool in = col < N;
    cu_s[c] = in ? uv2[2 * col] : 0.f;
    cv_s[c] = in ? uv2[2 * col + 1] : 0.f;
    cok_s[c] = in && v2[col] != 0;
    if (in && blockIdx.y == 0) colkey[size_t(b) * N + col] = ~0ull;
  }
  if (t == 0 && blockIdx.x == 0 && blockIdx.y == 0) n[b] = 0;

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < KT; ++kt) {
    // slot kt % STAGES has landed, and every thread is done with the
    // k-major slice of stage kt - 1
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 1) : "memory");
    __syncthreads();
    // transpose the slot into the k-major slice: a thread reads 4 dims of
    // a row (a quarter warp's 8 rows at the 144-byte pitch hit 32 banks)
    // and writes them down 4 k rows (a warp's 32 rows are consecutive)
    const float* slot = smem + (kt % STAGES) * R * PITCH;
#pragma unroll
    for (int i = 0; i < R * (BK / 4) / THREADS; ++i) {
      const int c = t + i * THREADS, r = c % R, q = c / R;
      const float4 v = *reinterpret_cast<const float4*>(slot + r * PITCH + 4 * q);
      km[(4 * q + 0) * R + r] = v.x;
      km[(4 * q + 1) * R + r] = v.y;
      km[(4 * q + 2) * R + r] = v.z;
      km[(4 * q + 3) * R + r] = v.w;
    }
    __syncthreads();
    // the slot is free: refill it with stage kt + STAGES
    if (kt + STAGES < KT) stage(kt % STAGES, (kt + STAGES) * BK);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    // a k step: the thread's RM row values and RN column values as
    // vectors (a half warp's row loads are one broadcast, its column loads
    // consecutive), then RM x RN FMAs
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[RM], bv[RN];
#pragma unroll
      for (int i = 0; i < RM; i += WA)
        load_run<WA>(a + i, km + k * R + lane_of<RM>(ty, i));
#pragma unroll
      for (int j = 0; j < RN; j += WB)
        load_run<WB>(bv + j, km + k * R + BM + lane_of<RN>(tx, j));
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
  }

  // epilogue: the distances of the thread's pairs, folded per row
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = row0 + lane_of<RM>(ty, i);
    const bool in = row < M;
    const float ru = in ? uv1[2 * row] : 0.f, rv = in ? uv1[2 * row + 1] : 0.f;
    const bool rok = in && v1[row] != 0;
    Best x = {INFINITY, INFINITY, 0x7fffffff};
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int c = lane_of<RN>(tx, j), col = col0 + c;
      if (col < N) {
        float d = BIG;
        if (rok && cok_s[c] && fabsf(ru - cu_s[c]) < window &&
            fabsf(rv - cv_s[c]) < window)
          d = __fsqrt_rn(fmaxf(__fsub_rn(2.f, __fmul_rn(2.f, acc[i][j])), 0.f));
        // columns arrive in increasing order: a tie keeps the first index
        if (d < x.best) {
          x.second = x.best;
          x.best = d;
          x.idx = col;
        } else {
          x.second = fminf(x.second, d);
        }
      }
    }
    // the 16 threads of a half warp share the row
#pragma unroll
    for (int o = TX / 2; o > 0; o >>= 1) {
      Best y;
      y.best = __shfl_xor_sync(0xffffffffu, x.best, o);
      y.second = __shfl_xor_sync(0xffffffffu, x.second, o);
      y.idx = __shfl_xor_sync(0xffffffffu, x.idx, o);
      x = merge(x, y);
    }
    if (tx == 0 && in)
      part[(size_t(b) * M + row) * gridDim.x + blockIdx.x] = x;
  }
}

// a warp per row: the lanes fold the row's T partials, then shuffles
__global__ void match_merge_kernel(const Best* __restrict__ part,
                                   const unsigned char* __restrict__ v1,
                                   int* __restrict__ best_idx,
                                   unsigned char* __restrict__ row_ok,
                                   unsigned long long* colkey, int B, int M,
                                   int N, int T, float ratio, float th) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (i >= B * M) return;  // whole warps
  const Best* p = part + size_t(i) * T;
  Best x = {INFINITY, INFINITY, 0x7fffffff};
  for (int k = lane; k < T; k += 32) x = merge(x, p[k]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    Best y;
    y.best = __shfl_xor_sync(0xffffffffu, x.best, o);
    y.second = __shfl_xor_sync(0xffffffffu, x.second, o);
    y.idx = __shfl_xor_sync(0xffffffffu, x.idx, o);
    x = merge(x, y);
  }
  if (lane) return;
  const bool good =
      v1[i] != 0 && x.best <= th && x.best < __fmul_rn(ratio, x.second);
  best_idx[i] = x.idx;
  row_ok[i] = good;
  if (good) {
    const int b = i / M, row = i % M;
    const unsigned bits = __float_as_uint(x.best) & 0x7fffffffu;
    atomicMin(&colkey[size_t(b) * N + x.idx],
              (static_cast<unsigned long long>(bits) << 32) |
                  static_cast<unsigned>(row));
  }
}

__global__ void match_finalize_kernel(
    const int* __restrict__ best_idx, const unsigned char* __restrict__ row_ok,
    const unsigned long long* __restrict__ colkey, int* __restrict__ match12,
    int* __restrict__ n, int* __restrict__ match21, int B, int M, int N) {
  const int L = max(M, N);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * L) return;
  const int b = i / L, j = i % L;
  if (j < M) {
    const int idx = best_idx[size_t(b) * M + j];
    const bool win =
        row_ok[size_t(b) * M + j] &&
        int(colkey[size_t(b) * N + idx] & 0xffffffffu) == j;
    match12[size_t(b) * M + j] = win ? idx : -1;
    if (win) atomicAdd(&n[b], 1);
  }
  if (j < N) {
    // the claiming row, or -1 from the all-ones key of an unclaimed column
    match21[size_t(b) * N + j] = int(colkey[size_t(b) * N + j] & 0xffffffffu);
  }
}

template <int RM, int RN>
cudaError_t launch_tiles(const float* d1, const float* uv1,
                         const unsigned char* v1, const float* d2,
                         const float* uv2, const unsigned char* v2, Best* part,
                         unsigned long long* colkey, int* n, int B, int M,
                         int N, int D, float window, cudaStream_t s) {
  constexpr int SMEM = smem_bytes<RM, RN>();
  cudaError_t err = cudaFuncSetAttribute(
      match_tile_kernel<RM, RN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(match_tile_kernel<RM, RN>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             int(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + TX * RN - 1) / (TX * RN), (M + TY * RM - 1) / (TY * RM),
                  B);
  match_tile_kernel<RM, RN><<<grid, THREADS, SMEM, s>>>(
      d1, uv1, v1, d2, uv2, v2, part, colkey, n, M, N, D, window);
  return cudaGetLastError();
}

}  // namespace

// desc1 (B, M, D), uv1 (B, M, 2), valid1 (B, M) bool; desc2 (B, N, D),
// uv2 (B, N, 2), valid2 (B, N) bool; outputs match12 (B, M), n (B,),
// match21 (B, N) int32; scratch part (B, M, T) of (f32 best, f32 second,
// i32 index) with T = ceil(N / tile columns), best_idx (B, M) int32, row_ok
// (B, M) u8, colkey (B, N) u64, 8-byte aligned.  `tile` picks the block's
// tile (rows x columns): 0 = 128 x 128, 1 = 64 x 32.  D % 32 == 0, the
// descriptors 16-byte aligned, B, M, N >= 1.
extern "C" int match_launch(const void* desc1, const void* uv1,
                            const void* valid1, const void* desc2,
                            const void* uv2, const void* valid2, void* match12,
                            void* n, void* match21, void* part,
                            void* best_idx, void* row_ok, void* colkey, int B,
                            int M, int N, int D, int tile, float window,
                            float ratio, float th, void* stream) {
  if (D % BK || B < 1 || M < 1 || N < 1 || tile < 0 || tile > 1)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* d1 = static_cast<const float*>(desc1);
  const auto* d2 = static_cast<const float*>(desc2);
  const auto* u1 = static_cast<const float*>(uv1);
  const auto* u2 = static_cast<const float*>(uv2);
  const auto* a1 = static_cast<const unsigned char*>(valid1);
  const auto* a2 = static_cast<const unsigned char*>(valid2);
  Best* p = static_cast<Best*>(part);
  auto* key = static_cast<unsigned long long*>(colkey);
  int* cnt = static_cast<int*>(n);
  cudaError_t err;
  if (tile == 0)
    err = launch_tiles<8, 8>(d1, u1, a1, d2, u2, a2, p, key, cnt, B, M, N, D,
                             window, s);
  else
    err = launch_tiles<4, 2>(d1, u1, a1, d2, u2, a2, p, key, cnt, B, M, N, D,
                             window, s);
  const int cols = tile == 0 ? 128 : 32;
  if (err != cudaSuccess) return int(err);
  const int rows = B * M;
  match_merge_kernel<<<(rows + 7) / 8, 256, 0, s>>>(
      p, a1, static_cast<int*>(best_idx), static_cast<unsigned char*>(row_ok),
      key, B, M, N, (N + cols - 1) / cols, ratio, th);
  const int nfin = B * (M > N ? M : N);
  match_finalize_kernel<<<(nfin + 255) / 256, 256, 0, s>>>(
      static_cast<const int*>(best_idx),
      static_cast<const unsigned char*>(row_ok),
      static_cast<const unsigned long long*>(colkey),
      static_cast<int*>(match12), cnt, static_cast<int*>(match21), B, M, N);
  return int(cudaGetLastError());
}
