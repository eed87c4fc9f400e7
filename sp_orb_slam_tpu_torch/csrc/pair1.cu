// SuperPoint first conv pair on Hopper:
// maxpool2(relu(conv1b(relu(conv1a(x))))), 1 -> 64 -> 64 channels, 3x3, zero
// padding; (B, H, W) f32 in [0, 1] -> (B, H/2, W/2, 64) bf16 NHWC.
//
// Replaces the TPU kernel sp_orb_slam_tpu/ops/pallas_pair1.py:250
// (`fused_pair1`).  Numerics as the TPU kernel's: bf16 input and weights,
// f32 sums, f32 bias + relu, y1 rounded to bf16, bf16 output; a y1 position
// outside the image is conv1b's zero padding, not relu(b1a).
//
// Bound on the card: operations.  conv1b is 2 * 64 * 576 FLOP a pixel, about
// 852 GFLOP at B=32, 752x480 (0.87 ms on the bf16 tensor cores at 989
// TFLOP/s), against 46 MB of images in and 370 MB of pooled output.
//
// Design: a persistent grid (one block an SM walks tiles in a static
// stride), warp-specialised, 512 threads.  A tile is 4 full-resolution rows
// x 64 columns of one image (2 pooled rows x 32 pooled columns); the ragged
// right band (752 = 11 x 64 + 48) is masked.  Warpgroups 0 and 1
// (consumers) run conv1b, one row pair each; warpgroups 2 and 3
// (producers) load the next tile's input and run its conv1a into the other
// y1 buffer meanwhile.  Shared memory, from a 1024-byte aligned base:
//   conv1b weights  [tap][co][ci] bf16, 128-byte swizzle     73,728 B
//   y1 tiles        2 x 6 rows x 66 slots x 144 B            114,048 B
//   input tiles     2 x 8 rows x 68 cols f32                   4,352 B
//   conv1a weights  [co][16 taps] bf16, biases b1a, b1b        2,560 B
//   mbarriers       weights, y1 full x 2, y1 empty x 2            40 B
// = 194,728 B (+ 1,024 B alignment slack): one block an SM.
//
// What the design does about what held the first version back:
// - weights re-read for every tile: the wrapper packs conv1b's weights once
//   (cached) with the 128-byte swizzle pre-applied (16-byte chunk j of row
//   co stored at j ^ (co % 8)); each block copies all 73,728 B into shared
//   memory with one cp.async.bulk that completes on an mbarrier, and never
//   reads them from global memory again;
// - one fragment load per MMA, legacy WMMA: conv1b is an implicit GEMM over
//   the 9 taps (M = pixels, N = 64, K = 576 as 36 k16 steps) on
//   wgmma.mma_async.m64n64k16 with A from registers and B from a
//   shared-memory descriptor into the resident swizzled weights (128-byte
//   swizzle, stride byte offset 1024).  A warp's A fragment (16 pixels) is
//   loaded by ldmatrix.x4 with one pixel row address per lane, so a tap's
//   (dy, dx) shift is an address offset and no im2col of conv1b is built;
//   the next k step's fragments load while the current step's wgmma runs
//   (two register sets, at most two groups in flight).  The y1 tile stores
//   each row's even columns and then its odd ones, 144 B a pixel: the 8
//   rows of one ldmatrix matrix are 8 consecutive slots and hit 8 distinct
//   bank groups;
// - epilogues through shared memory: row i and i + 8 of a warp's 16 M rows
//   hold columns 2c and 2c + 1, and the pair's second row sits in a second
//   accumulator with the same B, so the 2x2 max is a max of four registers
//   of one thread; then + b1b, relu, bf16, a 4x4 transpose in each lane
//   quad by shuffles, and two 16-byte stores a lane.  conv1a's epilogue
//   writes bf16 y1 straight from its accumulators;
// - serial phases: y1 is double-buffered between the producers and the
//   consumers, with mbarriers (full / empty) and no block-wide barrier in
//   the loop; the producers prefetch the next input tile by cp.async
//   (4-byte zero-filling copies) and the weight copy overlaps the first
//   tile's conv1a.  conv1a is latency-bound (a short dependent chain per
//   m16 tile), so it has two warpgroups: with one it took longer than
//   conv1b and set the kernel's time;
// - weights repacked on every call: the wrapper caches the packing.
// conv1a (3 % of the FLOPs) is a K = 16 product on mma.sync: its A fragment
// is built in registers from the input tile (9 taps, 7 zeros; each lane's
// tap offsets computed once), its halo recomputed per tile, positions
// outside the image zeroed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 64;          // channels of the pair
constexpr int TR = 4;          // full-resolution rows of a tile
constexpr int TC = 64;         // full-resolution columns of a tile
constexpr int YR = TR + 2;     // y1 tile rows (halo 1)
constexpr int YS = TC + 2;     // y1 tile slots a row: 33 even + 33 odd columns
constexpr int YHALF = YS / 2;  // first odd-column slot
constexpr int YPIX = YR * YS;  // y1 tile pixels
constexpr int YLD = 72;        // y1 pixel stride in bf16 (144 B)
constexpr int XR = TR + 4;     // input tile rows (halo 2)
constexpr int XC = TC + 4;     // input tile columns
constexpr int CONSUMERS = 256;  // warpgroups 0, 1: conv1b
constexpr int PRODUCERS = 256;  // warpgroups 2, 3: input + conv1a
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int A_TILES = (YPIX + 15) / 16;  // conv1a m16 tiles

constexpr int WB_BYTES = 9 * C * C * 2;        // 73,728
constexpr int Y_BYTES = YPIX * YLD * 2;        // 57,024 (one buffer)
constexpr int XS_BYTES = XR * XC * 4;          // 2,176 (one buffer)
constexpr int WA_BYTES = C * 16 * 2;           // 2,048
constexpr int OFF_Y = WB_BYTES;
constexpr int OFF_XS = OFF_Y + 2 * Y_BYTES;
constexpr int OFF_WA = OFF_XS + 2 * XS_BYTES;
constexpr int OFF_BA = OFF_WA + WA_BYTES;
constexpr int OFF_BB = OFF_BA + C * 4;
constexpr int OFF_BAR = OFF_BB + C * 4;  // weights, full[2], empty[2]
constexpr int SMEM_USED = OFF_BAR + 5 * 8;
constexpr int SMEM = SMEM_USED + 1024;   // slack to align the base
static_assert(OFF_Y % 16 == 0 && Y_BYTES % 16 == 0 && OFF_XS % 16 == 0 &&
                  OFF_WA % 16 == 0 && OFF_BAR % 8 == 0,
              "alignment");
static_assert(SMEM <= 232448, "one block an SM");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 operands, f32 accumulators
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d (64 x 64 over the warpgroup) += a (this warp's 16 rows, registers) * b,
// b a K-major 16 x 64 bf16 operand in shared memory behind `desc`
__device__ __forceinline__ void wgmma_64x64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator accesses across a wgmma fence
__device__ __forceinline__ void fence_operands(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// descriptor of a K-major bf16 operand with the 128-byte swizzle: 8-row
// atoms of 128-byte rows, 1024 bytes apart (stride byte offset)
__device__ __forceinline__ uint64_t swizzled_desc(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

struct Tile {
  int b, r0, c0;
};

__device__ __forceinline__ Tile tile_at(int t, int bands_y, int bands_x) {
  Tile s;
  s.b = t / (bands_y * bands_x);
  const int rem = t - s.b * bands_y * bands_x;
  s.r0 = (rem / bands_x) * TR;
  s.c0 = (rem % bands_x) * TC;
  return s;
}

// the input tile (rows r0-2 .. r0+5, columns c0-2 .. c0+65), zero outside
// the image, into `dst` by the producer's 4-byte cp.async; one commit group
__device__ __forceinline__ void load_input(const float* __restrict__ images,
                                           Tile s, int H, int W, uint32_t dst,
                                           int ptid) {
  const float* img = images + size_t(s.b) * H * W;
  for (int i = ptid; i < XR * XC; i += PRODUCERS) {
    const int y = s.r0 - 2 + i / XC, x = s.c0 - 2 + i % XC;
    const bool in = y >= 0 && y < H && x >= 0 && x < W;
    cp_async4(dst + 4 * i, in ? img + size_t(y) * W + x : images, in ? 4 : 0);
  }
}

// (row, column) in the y1 tile of slot s: even columns first, then odd
__device__ __forceinline__ int2 slot_pixel(int s) {
  const int yr = s / YS, sl = s - yr * YS;
  return make_int2(yr, sl < YHALF ? 2 * sl : 2 * (sl - YHALF) + 1);
}

// bf16 pair of the input at taps (k, k + 1) of the y1 pixel whose input
// tile offset is `base`; `off` holds the taps' offsets, negative for a
// tap >= 9 (zero)
__device__ __forceinline__ uint32_t tap_pair(const float* xs, int base,
                                             int2 off) {
  const float lo = off.x >= 0 ? xs[base + off.x] : 0.f;
  const float hi = off.y >= 0 ? xs[base + off.y] : 0.f;
  return pack_bf16(lo, hi);
}

__global__ void __launch_bounds__(THREADS, 1)
pair1_kernel(const float* __restrict__ images,
             const __nv_bfloat16* __restrict__ w1a,   // [co][16]
             const float* __restrict__ b1a,
             const __nv_bfloat16* __restrict__ w1b,  // [tap][co][ci] swizzled
             const float* __restrict__ b1b, __nv_bfloat16* __restrict__ out,
             int B, int H, int W) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* ys0 = reinterpret_cast<__nv_bfloat16*>(smem + OFF_Y);
  const float* xs0 = reinterpret_cast<const float*>(smem + OFF_XS);
  const __nv_bfloat16* wa = reinterpret_cast<__nv_bfloat16*>(smem + OFF_WA);
  float* ba = reinterpret_cast<float*>(smem + OFF_BA);
  float* bb = reinterpret_cast<float*>(smem + OFF_BB);
  const uint32_t wb_s = smem_addr(smem);
  const uint32_t ys_s = smem_addr(ys0);
  const uint32_t xs_s = smem_addr(xs0);
  const uint32_t bar_w = smem_addr(smem + OFF_BAR);
  const uint32_t bar_full = bar_w + 8, bar_empty = bar_w + 24;  // [2] each

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int bands_y = H / TR, bands_x = (W + TC - 1) / TC;
  const int n_tiles = B * bands_y * bands_x;

  if (tid == 0) {
    mbar_init(bar_w, 1);
    for (int i = 0; i < 2; ++i) {
      mbar_init(bar_full + 8 * i, PRODUCERS);    // every producer thread
      mbar_init(bar_empty + 8 * i, CONSUMERS / 32);  // one lane a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // conv1b's weights: one bulk copy, completion on bar_w
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            bar_w),
        "r"(WB_BYTES)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(wb_s),
        "l"(w1b), "r"(WB_BYTES), "r"(bar_w)
        : "memory");
  }
  for (int i = tid; i < C * 16 / 8; i += THREADS)
    reinterpret_cast<uint4*>(smem + OFF_WA)[i] =
        reinterpret_cast<const uint4*>(w1a)[i];
  if (tid < C) {
    ba[tid] = b1a[tid];
    bb[tid] = b1b[tid];
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {
    // ---------------- producer: input tiles and conv1a into y1[it % 2]
    const int ptid = tid - CONSUMERS, pw = warp - CONSUMERS / 32;
    uint32_t bw[8][2];  // conv1a's B fragments, n8 tile j
    float bias[8][2];   // b1a of this lane's channels 8 j + 2 q (+1)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t* row =
          reinterpret_cast<const uint32_t*>(wa + (8 * j + g) * 16);
      bw[j][0] = row[q];
      bw[j][1] = row[q + 4];
      bias[j][0] = ba[8 * j + 2 * q];
      bias[j][1] = ba[8 * j + 2 * q + 1];
    }
    // input-tile offsets of this lane's taps 2q, 2q+1 (a0) and 2q+8,
    // 2q+9 (a2): tap k = dy*3+dx is dy rows and dx columns on
    int2 tap_lo, tap_hi;
    {
      auto off = [](int k) { return k < 9 ? (k / 3) * XC + k % 3 : -1; };
      tap_lo = make_int2(off(2 * q), off(2 * q + 1));
      tap_hi = make_int2(off(2 * q + 8), off(2 * q + 9));
    }
    if (blockIdx.x < n_tiles)
      load_input(images, tile_at(blockIdx.x, bands_y, bands_x), H, W, xs_s,
                 ptid);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    int it = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
      const Tile s = tile_at(t, bands_y, bands_x);
      const int buf = it & 1;
      // the other input buffer is free once every producer has finished
      // the previous tile's conv1a
      asm volatile("bar.sync 1, %0;\n" ::"n"(PRODUCERS) : "memory");
      if (t + gridDim.x < n_tiles)
        load_input(images, tile_at(t + gridDim.x, bands_y, bands_x), H, W,
                   xs_s + (buf ^ 1) * XS_BYTES, ptid);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      asm volatile("bar.sync 1, %0;\n" ::"n"(PRODUCERS) : "memory");
      if (it >= 2) mbar_wait(bar_empty + 8 * buf, ((it >> 1) - 1) & 1);

      const float* xs = xs0 + buf * (XR * XC);
      __nv_bfloat16* ys = ys0 + buf * (Y_BYTES / 2);
      for (int mt = pw; mt < A_TILES; mt += PRODUCERS / 32) {
        const int s0 = mt * 16 + g, s1 = s0 + 8;
        // slots past the tile read pixel 0 and are never stored
        const int2 p0 = slot_pixel(s0 < YPIX ? s0 : 0);
        const int2 p1 = slot_pixel(s1 < YPIX ? s1 : 0);
        const int base0 = p0.x * XC + p0.y, base1 = p1.x * XC + p1.y;
        uint32_t a[4];
        a[0] = tap_pair(xs, base0, tap_lo);
        a[1] = tap_pair(xs, base1, tap_lo);
        a[2] = tap_pair(xs, base0, tap_hi);
        a[3] = tap_pair(xs, base1, tap_hi);
        float acc[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
          mma16816(acc[j], a, bw[j][0], bw[j][1]);
        }
        // bias + relu, zero outside the image (conv1b's padding), bf16 y1
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int sp = h ? s1 : s0;
          if (sp >= YPIX) continue;
          const int2 p = h ? p1 : p0;
          const int yi = s.r0 - 1 + p.x, xi = s.c0 - 1 + p.y;
          const bool in = yi >= 0 && yi < H && xi >= 0 && xi < W;
          uint32_t* dst = reinterpret_cast<uint32_t*>(ys + sp * YLD);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float v0 = in ? fmaxf(acc[j][2 * h] + bias[j][0], 0.f)
                                : 0.f;
            const float v1 = in ? fmaxf(acc[j][2 * h + 1] + bias[j][1], 0.f)
                                : 0.f;
            dst[4 * j + q] = pack_bf16(v0, v1);
          }
        }
      }
      mbar_arrive(bar_full + 8 * buf);  // release: y1[buf] is written
    }
  } else {
    // ---------------- consumers: conv1b on y1[it % 2], pool, store
    // Warpgroup cw owns row pair cw (rows 2cw, 2cw+1 of the tile); warp wi
    // of it the columns 16 wi .. 16 wi + 15: row m of its m16 fragment holds
    // column 16 wi + 2 (m % 8) + m / 8.  Lane l addresses row
    // (l % 8) + 8 ((l / 8) % 2) at k offset 8 (l / 16) (ldmatrix.x4 order).
    const int cw = warp >> 2, wi = warp & 3;
    uint32_t a_off[3];
    {
      const int am = lane & 7, ahi = (lane >> 3) & 1, akoff = (lane >> 4) * 8;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int par = (ahi + dx) & 1, sh = (ahi + dx) >> 1;
        const int slot = par * YHALF + 8 * wi + am + sh;
        a_off[dx] = ((2 * cw * YS + slot) * YLD + akoff) * 2;
      }
    }
    const uint64_t desc0 = swizzled_desc(wb_s);
    const int W2 = W / 2, H2 = H / 2;
    int it = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
      const Tile s = tile_at(t, bands_y, bands_x);
      const int buf = it & 1;
      mbar_wait(bar_full + 8 * buf, (it >> 1) & 1);
      if (it == 0) mbar_wait(bar_w, 0);
      __syncwarp();
      const uint32_t yb = ys_s + buf * Y_BYTES;

      float acc[2][32];  // [row of the pair][wgmma fragment]
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[hr][i] = 0.f;
      uint32_t a[2][2][4];  // [k-step parity][row of the pair]
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        ldmatrix_x4(a[0][hr], yb + a_off[0] + (hr * YS * YLD) * 2);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) fence_operands(acc[hr]);
#pragma unroll
      for (int st = 0; st < 36; ++st) {
        const int tap = st >> 2, kc = st & 3;
        wgmma_fence();
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          wgmma_64x64(acc[hr], a[st & 1][hr],
                      desc0 + uint64_t((tap * (C * 128) + kc * 32) >> 4));
        wgmma_commit();
        if (st + 1 < 36) {
          // step st - 1 read the other register set: wait for it, refill
          wgmma_wait<1>();
          const int tn = (st + 1) >> 2, kn = (st + 1) & 3;
          const int dy = tn / 3, dx = tn % 3;
#pragma unroll
          for (int hr = 0; hr < 2; ++hr)
            ldmatrix_x4(a[(st + 1) & 1][hr],
                        yb + a_off[dx] + ((hr + dy) * YS * YLD) * 2 + kn * 32);
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) fence_operands(acc[hr]);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * buf);  // y1[buf] read

      // 2x2 max in registers, + b1b, relu (both commute with the max),
      // bf16; a 4x4 transpose in each lane quad so that lane q holds
      // channels 16 q .. 16 q + 15 of its pooled pixel; two 16-byte stores
      uint32_t v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ch = 8 * j + 2 * q;
        const float m0 = fmaxf(fmaxf(acc[0][4 * j], acc[0][4 * j + 2]),
                               fmaxf(acc[1][4 * j], acc[1][4 * j + 2]));
        const float m1 = fmaxf(fmaxf(acc[0][4 * j + 1], acc[0][4 * j + 3]),
                               fmaxf(acc[1][4 * j + 1], acc[1][4 * j + 3]));
        v[j] = pack_bf16(fmaxf(m0 + bb[ch], 0.f), fmaxf(m1 + bb[ch + 1], 0.f));
      }
      // element e of lane q is (v[2e], v[2e+1]) = channels 16 e + 2 q (+8);
      // swap bit 0, then bit 1, of (lane q, element e)
#pragma unroll
      for (int bit = 1; bit <= 2; bit <<= 1) {
        const bool up = (q & bit) != 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (e & bit) continue;
          const int lo = e, hi = e | bit;
#pragma unroll
          for (int w = 0; w < 2; ++w) {
            const uint32_t send = up ? v[2 * lo + w] : v[2 * hi + w];
            const uint32_t got = __shfl_xor_sync(0xffffffffu, send, bit);
            if (up)
              v[2 * lo + w] = got;
            else
              v[2 * hi + w] = got;
          }
        }
      }
      const int pr = s.r0 / 2 + cw, pc = (s.c0 + 16 * wi) / 2 + g;
      if (pc < W2) {
        uint4* dst = reinterpret_cast<uint4*>(
            out + ((size_t(s.b) * H2 + pr) * W2 + pc) * C + 16 * q);
        dst[0] = make_uint4(v[0], v[2], v[4], v[6]);
        dst[1] = make_uint4(v[1], v[3], v[5], v[7]);
      }
    }
  }
}

cudaError_t configure() {
  cudaError_t err = cudaFuncSetAttribute(
      pair1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(pair1_kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              int(cudaSharedmemCarveoutMaxShared));
}

// the persistent grid: min(tiles, SMs x resident blocks an SM)
cudaError_t grid_size(int B, int H, int W, int* grid, int* blocks_per_sm,
                      int* sms) {
  cudaError_t err = configure();
  if (err != cudaSuccess) return err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm,
                                                      pair1_kernel, THREADS,
                                                      SMEM);
  if (err != cudaSuccess) return err;
  const long tiles = long(B) * (H / TR) * ((W + TC - 1) / TC);
  const long cap = long(*sms) * *blocks_per_sm;
  *grid = int(tiles < cap ? tiles : cap);
  return cudaSuccess;
}

}  // namespace

// images (B, H, W) f32; w1a (64, 16) bf16 as [co][dy*3+dx], taps 9..15 zero;
// b1a (64,) f32; w1b (9, 64, 64) bf16 as [dy*3+dx][co][ci] with the 16-byte
// chunk j of each co row stored at j ^ (co % 8); b1b (64,) f32; out
// (B, H/2, W/2, 64) bf16.  Needs H % 4 == 0 (the wrapper asks H % 8 == 0)
// and W % 2 == 0; w1b 16-byte aligned.
extern "C" int pair1_launch(const void* images, const void* w1a,
                            const void* b1a, const void* w1b, const void* b1b,
                            void* out, int B, int H, int W, void* stream) {
  int grid = 0, blocks = 0, sms = 0;
  cudaError_t err = grid_size(B, H, W, &grid, &blocks, &sms);
  if (err != cudaSuccess) return int(err);
  if (grid == 0) return 0;
  pair1_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(images),
      static_cast<const __nv_bfloat16*>(w1a), static_cast<const float*>(b1a),
      static_cast<const __nv_bfloat16*>(w1b), static_cast<const float*>(b1b),
      static_cast<__nv_bfloat16*>(out), B, H, W);
  return int(cudaGetLastError());
}

// The launch's grid for (B, H, W), the resident blocks an SM holds at the
// kernel's shared-memory size, and the SM count.
extern "C" int pair1_grid(int B, int H, int W, int* grid, int* blocks_per_sm,
                          int* sms, void* /*stream*/) {
  return int(grid_size(B, H, W, grid, blocks_per_sm, sms));
}
