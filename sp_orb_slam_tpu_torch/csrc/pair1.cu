// SuperPoint first conv pair on Hopper in the row-pair formulation:
// maxpool2(relu(conv1b(relu(conv1a(x))))), 1 -> 64 -> 64 channels, 3x3, zero
// padding; (B, H, W) f32 in [0, 1] -> (B, H/2, W/2, 64) bf16 NHWC.
//
// Replaces the TPU kernel sp_orb_slam_tpu/ops/pallas_pair1.py (`fused_pair1`,
// body `_pair1_kernel`), keeping its formulation but not its block layout:
// - conv1a is an im2col product: the 9 taps of each y1 pixel, padded to 16,
//   times the (16, 64) tap matrix, on bf16 WMMA with f32 accumulators;
// - conv1b packs the two full-resolution rows of a pooled row into the
//   output columns: the four y1 rows 2r-1 .. 2r+2 of pooled row r (64
//   channels each) are contracted against a (256, 128) right-hand side per
//   dx, RHS_dx[64q + ci][64h + co] = w1b[q - h][dx][ci][co], zero where q - h
//   leaves the 3x3 kernel.  The zero blocks are skipped, so each non-zero
//   block is one slice of w1b and only one dx of w1b (3 x 64 x 64) is staged
//   in shared memory at a time;
// - bias + relu on the f32 accumulators, then the 2x2 max: the row max is
//   the max of the two output-column halves (h = 0, 1), the column max that
//   of neighbouring M rows; bf16 store.
// Numerics as the TPU kernel's: bf16 input and weights, f32 sums, f32 bias +
// relu, y1 rounded to bf16, bf16 output; a y1 position outside the image is
// conv1b's zero padding, not relu(b1a).
//
// Bound on the card: operations (about 852 GFLOP of conv1b at B=32, 752x480,
// on the bf16 tensor cores, against ~0.4 GB of HBM traffic).  One block
// computes a tile of 4 pooled rows x 16 pooled columns of one image; it
// holds the 10 x 34 y1 tile, one dx of the conv1b weights and the im2col
// matrix in 97,600 bytes of shared memory, so two blocks fit on an SM (the
// pair1t kernel, csrc/pair1t.cu, holds all nine taps and fits one).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int C = 64;           // channels of the pair
constexpr int TP = 4;           // pooled rows per tile (row pairs, one per 2 warps)
constexpr int TR = 2 * TP;      // full-resolution rows per tile
constexpr int TC = 32;          // full-resolution columns per tile
constexpr int YR = TR + 2;      // y1 tile rows (halo 1)
constexpr int YC = TC + 2;      // y1 tile columns
constexpr int XR = TR + 4;      // input tile rows (halo 2)
constexpr int XC = TC + 4;
constexpr int NPIX = YR * YC;   // y1 pixels of the tile
constexpr int MPIX = 352;       // NPIX padded to 16-row WMMA tiles
constexpr int YLD = 80;         // y1 pixel stride in bf16: 32-byte aligned rows
constexpr int WLD = 72;         // conv1b weight row stride in bf16 (64 + pad)
constexpr int THREADS = 256;    // 8 warps

constexpr size_t Y_BYTES = size_t(NPIX) * YLD * 2;   // y1 tile
constexpr size_t W_BYTES = size_t(3) * C * WLD * 2;  // conv1b weights, one dx
constexpr size_t X9_BYTES = size_t(MPIX) * 16 * 2;   // im2col matrix
constexpr size_t A_BYTES = size_t(16) * C * 2;       // conv1a tap matrix
constexpr size_t XS_BYTES = size_t(XR) * XC * 4;     // input tile
constexpr size_t SMEM = Y_BYTES + W_BYTES + X9_BYTES + A_BYTES + XS_BYTES +
                        2 * C * 4;                    // + b1a, b1b
static_assert(MPIX >= NPIX && MPIX % 16 == 0, "im2col padding");
static_assert(size_t(THREADS / 32) * 2 * 256 * 4 <= W_BYTES,
              "per-warp staging aliases the weight buffer");
static_assert(Y_BYTES % 128 == 0 && W_BYTES % 128 == 0 &&
                  X9_BYTES % 128 == 0 && A_BYTES % 128 == 0,
              "alignment");
static_assert(SMEM <= 113 * 1024, "two blocks an SM");

__global__ void __launch_bounds__(THREADS, 2)
pair1_kernel(const float* __restrict__ images,
             const __nv_bfloat16* __restrict__ w1a16,
             const float* __restrict__ b1a,
             const __nv_bfloat16* __restrict__ w1b,
             const float* __restrict__ b1b, __nv_bfloat16* __restrict__ out,
             int H, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(smem);  // [NPIX][YLD]
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem + Y_BYTES);
  float* stage = reinterpret_cast<float*>(smem + Y_BYTES);  // aliases ws
  __nv_bfloat16* x9 =
      reinterpret_cast<__nv_bfloat16*>(smem + Y_BYTES + W_BYTES);  // [MPIX][16]
  __nv_bfloat16* wa = x9 + MPIX * 16;                              // [16][64]
  float* xs = reinterpret_cast<float*>(smem + Y_BYTES + W_BYTES + X9_BYTES +
                                       A_BYTES);  // [XR][XC]
  float* ba = xs + XR * XC;
  float* bb = ba + C;

  const int b = blockIdx.z;
  const int r0 = blockIdx.y * TR;  // first full-resolution row of the tile
  const int c0 = blockIdx.x * TC;  // first full-resolution column
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // input tile rounded to bf16, zero outside the image (conv1a padding)
  const float* img = images + size_t(b) * H * W;
  for (int i = tid; i < XR * XC; i += THREADS) {
    const int y = r0 - 2 + i / XC, x = c0 - 2 + i % XC;
    float v = 0.f;
    if (y >= 0 && y < H && x >= 0 && x < W)
      v = __bfloat162float(__float2bfloat16_rn(img[size_t(y) * W + x]));
    xs[i] = v;
  }
  for (int i = tid; i < 16 * C; i += THREADS) wa[i] = w1a16[i];
  if (tid < C) {
    ba[tid] = b1a[tid];
    bb[tid] = b1b[tid];
  }
  __syncthreads();

  // im2col: row p = y1 pixel (yr, yc) of the tile, column t = tap
  // (dy, dx) = (t / 3, t % 3); taps 9..15 and rows past NPIX are zero
  for (int i = tid; i < MPIX * 16; i += THREADS) {
    const int p = i >> 4, t = i & 15;
    float v = 0.f;
    if (p < NPIX && t < 9)
      v = xs[(p / YC + t / 3) * XC + p % YC + t % 3];
    x9[i] = __float2bfloat16_rn(v);
  }
  __syncthreads();

  // conv1a: (MPIX, 16) x (16, 64) on the tensor cores, bias + relu on the
  // f32 accumulators staged per warp, bf16 y1; zero outside the image
  float* wst = stage + warp * 256;
  for (int m = warp; m < MPIX / 16; m += THREADS / 32) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
        a;
    wmma::load_matrix_sync(a, x9 + m * 256, 16);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          bw;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(bw, wa + n * 16, C);
      wmma::fill_fragment(acc, 0.f);
      wmma::mma_sync(acc, a, bw, acc);
      wmma::store_matrix_sync(wst, acc, 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int p = m * 16 + (e >> 4), ch = n * 16 + (e & 15);
        if (p < NPIX) {
          const int y = r0 - 1 + p / YC, x = c0 - 1 + p % YC;
          float v = 0.f;
          if (y >= 0 && y < H && x >= 0 && x < W)
            v = fmaxf(wst[e] + ba[ch], 0.f);
          ys[p * YLD + ch] = __float2bfloat16_rn(v);
        }
      }
      __syncwarp();
    }
  }

  // conv1b: warp w owns row pair rp = w / 2, 16 columns; output columns
  // 64h + co hold full-resolution row 2 rp + h of the tile
  const int rp = warp >> 1, half = warp & 1;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[h][n], 0.f);
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
  for (int dx = 0; dx < 3; ++dx) {
    __syncthreads();  // y1 complete; the previous dx's weights consumed
    // this dx's weights: ws[64 dy + ci][co] = w1b[dy][dx][ci][co]
    for (int i = tid; i < 3 * C * 8; i += THREADS) {
      const int row = i >> 3, seg = i & 7;
      const int dy = row >> 6, ci = row & (C - 1);
      *reinterpret_cast<uint4*>(ws + row * WLD + seg * 8) =
          *reinterpret_cast<const uint4*>(w1b + ((dy * 3 + dx) * C + ci) * C +
                                          seg * 8);
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        wmma::load_matrix_sync(
            a, ys + ((2 * rp + q) * YC + half * 16 + dx) * YLD + kc * 16, YLD);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int dy = q - h;  // the RHS block (q, h); zero outside 0..2
          if (dy < 0 || dy > 2) continue;
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            wmma::load_matrix_sync(bf, ws + (dy * C + kc * 16) * WLD + n * 16,
                                   WLD);
            wmma::mma_sync(acc[h][n], a, bf, acc[h][n]);
          }
        }
      }
    }
  }
  __syncthreads();  // every warp is done with ws: reuse it as staging

  // bias + relu + 2x2 max (relu and the bias commute with max), bf16 NHWC
  float* s0 = stage + warp * 512;  // row 2 rp     (h = 0), 16 x 16
  float* s1 = s0 + 256;            // row 2 rp + 1 (h = 1)
  const int W2 = W / 2, pr = r0 / 2 + rp, pc0 = c0 / 2 + half * 8;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    wmma::store_matrix_sync(s0, acc[0][n], 16, wmma::mem_row_major);
    wmma::store_matrix_sync(s1, acc[1][n], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 128; e += 32) {
      const int pc = e >> 4, co = e & 15;
      if (pc0 + pc < W2) {
        const int m0 = 2 * pc * 16 + co, m1 = m0 + 16;
        const float m = fmaxf(fmaxf(s0[m0], s0[m1]), fmaxf(s1[m0], s1[m1]));
        out[((size_t(b) * (H / 2) + pr) * W2 + pc0 + pc) * C + n * 16 + co] =
            __float2bfloat16_rn(fmaxf(m + bb[n * 16 + co], 0.f));
      }
    }
    __syncwarp();
  }
}

cudaError_t configure() {
  cudaError_t err = cudaFuncSetAttribute(
      pair1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(pair1_kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              int(cudaSharedmemCarveoutMaxShared));
}

}  // namespace

// images (B, H, W) f32; w1a16 (16, 64) bf16, rows = taps dy*3+dx, rows 9..15
// zero; b1a (64,) f32; w1b (9, 64, 64) bf16 as [dy*3+dx][ci][co]; b1b (64,)
// f32; out (B, H/2, W/2, 64) bf16.  Needs H % 8 == 0 and W % 2 == 0.
extern "C" int pair1_launch(const void* images, const void* w1a16,
                            const void* b1a, const void* w1b, const void* b1b,
                            void* out, int B, int H, int W, void* stream) {
  cudaError_t err = configure();
  if (err != cudaSuccess) return int(err);
  const dim3 grid((W + TC - 1) / TC, H / TR, B);
  pair1_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(images),
      static_cast<const __nv_bfloat16*>(w1a16),
      static_cast<const float*>(b1a), static_cast<const __nv_bfloat16*>(w1b),
      static_cast<const float*>(b1b), static_cast<__nv_bfloat16*>(out), H, W);
  return int(cudaGetLastError());
}

// Resident blocks of pair1_kernel an SM holds at its shared-memory size.
extern "C" int pair1_occupancy(int* blocks_per_sm, void* /*stream*/) {
  cudaError_t err = configure();
  if (err != cudaSuccess) return int(err);
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, pair1_kernel, THREADS, SMEM));
}
