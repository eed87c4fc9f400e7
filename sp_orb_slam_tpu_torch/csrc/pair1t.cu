// SuperPoint first conv pair on Hopper, the transposed GEMM:
// maxpool2(relu(conv1b(relu(conv1a(x))))), 1 -> 64 -> 64 channels, 3x3, zero
// padding; (B, H, W) f32 in [0, 1] -> (B, H/2, W/2, 64) bf16 NHWC.
//
// Replaces the TPU kernel sp_orb_slam_tpu/ops/pallas_pair1t.py:257
// (`fused_pair1t`, body `_pair1t_kernel`).  Numerics as there: the input is
// rounded to bf16, conv1a runs on bf16 operands with f32 sums, f32 bias +
// relu, and y1 is rounded to bf16 before conv1b; conv1b sums in f32, adds
// the f32 bias, relu, 2x2 max, bf16 store.  A y1 position outside the image
// is conv1b's zero padding, not relu(b1a).
//
// Bound on the card: operations.  conv1b is 2 * 64 * 576 FLOP a pixel, about
// 852 GFLOP at B=32, 752x480 (0.87 ms on the bf16 tensor cores), against
// 46 MB of images in and 370 MB of pooled output.
//
// Design.  The TPU kernel keeps channels in sublanes and image columns in
// lanes, so conv1b is (co x ci*taps) @ (ci*taps x columns).  Here the same
// product runs on wgmma with the 64 output channels on M and the pixels on
// N: D (64 co x 128 pixels) += W_tap^T (64 co x 16 ci) * Y (16 ci x 128
// pixels), 36 k16 steps (9 taps x 4), both operands in shared memory by
// descriptor.  A tile is 2 full-resolution rows x 128 columns of one image
// (one pooled row x 64 pooled columns; the ragged right band, 752 = 5 x 128
// + 112, masked), and tiles are ordered down each 128-column band of an
// image.  A persistent grid (one block an SM) gives each block a
// contiguous run of tiles, so a block walks down a band, and the y1 rows a
// tile shares with the one above it are computed once.
//
// 512 threads.  Warpgroups 2 and 3 (producers) compute y1 a row pair at a
// time: pair m is y1 rows 2m-1 and 2m (130 pixels each, 1 of halo on
// either side), into a ring of 4 pair slots; a tile (rows 2m, 2m+1) reads
// pairs m and m+1, so a tile that continues the band above it needs one
// new pair and the first tile of a run two.  Warpgroups 0 and 1
// (consumers) take alternate tiles and each runs a whole tile, so one's
// epilogue overlaps the other's products.  setmaxnreg gives the consumers
// 152 registers a thread (a 64-register accumulator and a pooled row) and
// the producers 104.  Shared memory, from a 1024-byte aligned base:
//   conv1b weights  [tap][co][ci] bf16, 128-byte swizzle     73,728 B
//   y1 ring         4 pairs x 2 rows x 130 pixels x 128 B     133,120 B
//   staging         2 consumers x 64 pooled pixels x 128 B    16,384 B
//   input tiles     2 x 4 rows x 136 cols f32                   4,352 B
//   mbarriers       weights, pairs full / empty x 4, input x 2    104 B
// = 227,688 B (+ 1,024 B alignment slack): one block an SM.
//
// - A: the wrapper packs conv1b's weights once (shared with the pair1
//   kernel, ops/cuda_pair1.py `packed_weights`) as [tap][co][ci] with the
//   128-byte swizzle pre-applied; one cp.async.bulk on an mbarrier copies
//   them into shared memory, where they stay.  A k step's A is the tap's
//   64 x 16 slice: a descriptor start offset.
// - B: y1 is stored K-major, a pixel a 128-byte row of 64 ci, the pixels of
//   a y1 row consecutive, with the 128-byte swizzle taken from the address
//   (chunk j of the pixel at byte a goes to chunk j ^ ((a >> 7) & 7)).  The
//   card swizzles on the address bits, so B for tap (dy, dx) is the
//   descriptor of pixel dx of the tile's y1 row dy (+ 1 for the second
//   output row): a start offset of dx * 128 bytes inside the 1024-byte
//   swizzle atom, with the base-offset field 0 (setting that field to the
//   start's row phase gives wrong products).  No im2col is built.  A
//   consumer issues a row's 36 wgmma m64n128k16 back to back and waits
//   once.
// - The pool in registers: an accumulator fragment holds pixel columns
//   2c and 2c + 1 in one thread, so the horizontal max is a max of a
//   register pair; + b1b, relu and the bf16 rounding commute with the max,
//   so the first row is pooled to bf16 in registers before the second
//   row's products, and the vertical max is a bf16 max of two registers.
// - Transpose to NHWC: the accumulators hold (co, pixel).  One shuffle
//   with lane ^ 4 and two byte permutes pair adjacent channels, each
//   consumer writes its tile's 64 pooled pixels x 64 channels into its
//   staging area (128-byte rows, 16-byte chunks swizzled by the pixel:
//   conflict-free both ways) and reads it back as 16-byte chunks: a tile's
//   8 KB of output is one contiguous span of 16-byte stores.
// - conv1a (3 % of the FLOPs) is a K = 16 product on mma.sync: its A
//   fragment is built in registers from the input tile (9 taps, 7 zeros),
//   its weights and b1a sit in registers, and its epilogue writes bf16 y1
//   straight into the swizzled B layout (8 consecutive pixels hit 8
//   distinct chunks: conflict-free), then fence.proxy.async so that wgmma
//   sees it.  (On the CUDA cores, 18 fmaf a pixel a lane, it was slower.)
// - Overlap: mbarriers a pair slot (full: the producers wrote it; empty:
//   both tiles that read it are done) and an input tile, with no
//   block-wide barrier in the loop.  One producer thread loads the next
//   pair's input rows by TMA from a 3-D (W, H, B) tensor map: the card
//   zero-fills what lies outside the image (conv1a's padding) and no row of
//   a neighbouring image leaks in; the copy's first column must sit on 16
//   bytes, so a tile's input starts 4 columns left of its first pixel.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 64;           // channels of the pair
constexpr int TR = 2;           // full-resolution rows of a tile
constexpr int TC = 128;         // full-resolution columns of a tile (N)
constexpr int YS = TC + 2;      // y1 pixels a row (halo 1)
constexpr int XR = 4;           // input rows of a row pair (halo 1)
// input tile columns: halo 2, from c0 - 4 so that each TMA box starts on 16
// bytes (its first 2 columns are not read)
constexpr int XC = TC + 8;
constexpr int X0 = 2;           // input tile column of image column c0 - 2
constexpr int SLOTS = 4;        // row pairs in the ring
constexpr int XBUFS = 2;        // input tiles: the next loads during this
constexpr int CONSUMERS = 256;  // warpgroups 0, 1: conv1b
constexpr int PRODUCERS = 256;  // warpgroups 2, 3: input + conv1a
constexpr int THREADS = CONSUMERS + PRODUCERS;
// registers a thread after setmaxnreg: the consumers hold a 64 x 128 f32
// accumulator (64 a thread) and a pooled row (16); the register file is
// 64 K a block (one block an SM)
constexpr int PRODUCER_REGS = 104, CONSUMER_REGS = 152;
static_assert(PRODUCERS * PRODUCER_REGS + CONSUMERS * CONSUMER_REGS <= 65536,
              "register file");
constexpr int PAIR_PIX = 2 * YS;               // y1 pixels of a row pair
constexpr int A_TILES = (PAIR_PIX + 15) / 16;  // conv1a m16 tiles a pair
constexpr int PC = TC / 2;                     // pooled columns of a tile

constexpr int WB_BYTES = 9 * C * C * 2;       // 73,728
constexpr int ROW_BYTES = YS * C * 2;         // 16,640
constexpr int PAIR_BYTES = 2 * ROW_BYTES;     // 33,280
constexpr int ST_BYTES = PC * C * 2;          // 8,192 (one consumer)
constexpr int XS_BYTES = XR * XC * 4;         // 2,176: one input tile
constexpr int OFF_Y = WB_BYTES;
constexpr int OFF_ST = OFF_Y + SLOTS * PAIR_BYTES;
constexpr int OFF_XS = OFF_ST + 2 * ST_BYTES;
// mbarriers: weights, pair full[4], pair empty[4], input full[2], input
// empty[2]
constexpr int OFF_BAR = OFF_XS + XBUFS * XS_BYTES;
constexpr int SMEM_USED = OFF_BAR + (1 + 2 * SLOTS + 2 * XBUFS) * 8;
constexpr int SMEM = SMEM_USED + 1024;   // slack to align the base
static_assert(OFF_Y % 128 == 0 && ROW_BYTES % 128 == 0 &&
                  OFF_ST % 128 == 0 && OFF_XS % 128 == 0 &&
                  XS_BYTES % 128 == 0 &&
                  OFF_BAR % 8 == 0,
              "alignment");
static_assert(SMEM <= 232448, "one block an SM");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d = a (16x16, row) * b (16x8, col), bf16 operands, f32 sums from zero
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// d (64 x 128 over the warpgroup) += a * b, a a K-major 64 x 16 and b a
// K-major 16 x 128 bf16 operand, both in shared memory behind descriptors
// given by their low words (`desc_lo`; the high word is DESC_HI)
__device__ __forceinline__ void wgmma_64x128(float (&d)[64], uint32_t da,
                                             uint32_t db, uint32_t hi) {
  asm volatile(
      "{\n .reg .pred p;\n .reg .b64 da, db;\n setp.ne.b32 p, %67, 0;\n"
      " mov.b64 da, {%64, %66};\n mov.b64 db, {%65, %66};\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, da, db, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(da), "r"(db), "r"(hi), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator accesses across a wgmma fence
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// descriptor of a K-major bf16 operand with the 128-byte swizzle: 8-row
// atoms of 128-byte rows, 1024 bytes apart (stride byte offset 1024 and
// the swizzle mode in the high word, DESC_HI), the start address / 16 in
// the low word.  The start may sit anywhere on a 16-byte boundary: the
// card takes the swizzle phase from the address bits, so the base-offset
// field stays 0.  A k step of 16 bf16 (32 bytes) adds 2 to the low word.
constexpr uint32_t DESC_HI = (1024 >> 4) | (1u << 30);
__device__ __forceinline__ uint32_t desc_lo(uint32_t addr) {
  return ((addr & 0x3FFFF) >> 4) | (1u << 16);
}

// byte offset, from a 1024-aligned base, of the 16-byte chunk j of the
// 128-byte row at `row_off` (a multiple of 128) under the 128-byte swizzle
__device__ __forceinline__ uint32_t swizzled(uint32_t row_off, int j) {
  return row_off + 16 * (j ^ ((row_off >> 7) & 7));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t max_bf16x2(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hmax2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(count)
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

// the weights' bulk copy into shared memory, completion on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Tiles are numbered down each band: t = (b * bands_x + bx) * bands_y + ry,
// the tile's full-resolution rows 2 ry, 2 ry + 1 and columns 128 bx + ...
// Block i runs tiles [i * n / grid, (i + 1) * n / grid).  A tile is the
// first of a run when it starts the block's share or its band; it reads
// the y1 row pairs m = ry and ry + 1.
struct Tile {
  int b, bx, ry;
  bool first, last;  // of a run down a band in this block's share
};

struct Grid {
  int bands_x, bands_y, t0, t1;  // the block's share [t0, t1)

  __device__ Tile at(int t) const {
    Tile s;
    s.ry = t % bands_y;
    const int rest = t / bands_y;
    s.bx = rest % bands_x;
    s.b = rest / bands_x;
    s.first = t == t0 || s.ry == 0;
    s.last = t == t1 - 1 || s.ry == bands_y - 1;
    return s;
  }
};

// A row pair of the block's sequence: tile t's pair m = ry + e, where e is 0
// only at the first tile of a run (which reads two new pairs) and 1 after.
struct PairCursor {
  int t, e;
  __device__ void next(const Grid& grid) {
    if (e == 0) {
      e = 1;
    } else if (++t < grid.t1) {
      e = grid.at(t).first ? 0 : 1;
    }
  }
};

// input rows 2m-2 .. 2m+1 and columns c0-4 .. c0+131 of row pair p into
// `dst` by one TMA copy of the (W, H, B) tensor map, completion
// (XS_BYTES) on `bar`: the card fills what lies outside the image with 0,
// conv1a's zero padding, and no row of a neighbouring image comes in.  The
// box's first column is 16-byte aligned, as the copy requires.
__device__ __forceinline__ void load_input(const CUtensorMap* map,
                                           const PairCursor& p,
                                           const Grid& grid, uint32_t dst,
                                           uint32_t bar) {
  const Tile s = grid.at(p.t);
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(XS_BYTES)
      : "memory");
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(s.bx * TC - 2 - X0),
      "r"(2 * (s.ry + p.e) - 2), "r"(s.b), "r"(bar)
      : "memory");
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

// Producer warp pw: conv1a of the m16 tiles pw, pw + 8, ... of row pair m
// (y1 rows 2m-1, 2m, columns c0-1 .. c0+128: 260 pixels, 17 tiles) from
// input tile `xs` into the pair slot at byte offset `slot_off` of the
// 1024-aligned `smem`.  A fragment row is a pixel, built in registers from
// the input (9 taps and 7 zeros), B the conv1a weights; the f32 sum + b1a
// is rounded to bf16 and relu'd as a pair (rounding and relu commute), 0
// outside the image, and stored as one 4-byte word of the pixel's 128-byte
// row (8 consecutive pixels hit 8 distinct chunks: conflict-free).
__device__ __forceinline__ void conv1a_pair(
    const float* xs, unsigned char* smem, uint32_t slot_off, int m, int c0,
    int H, int W, int pw, int g, int q, const uint32_t (&bw)[8][2],
    const float (&bias)[8][2], int2 tap_lo, int2 tap_hi) {
  for (int mt = pw; mt < A_TILES; mt += PRODUCERS / 32) {
    const int s0 = mt * 16 + g, s1 = s0 + 8;
    // pixels past the pair read pixel 0 and are never stored
    const int p0 = s0 < PAIR_PIX ? s0 : 0, p1 = s1 < PAIR_PIX ? s1 : 0;
    const int u0 = p0 >= YS, u1 = p1 >= YS;  // y1 row of the pair
    const int base0 = u0 * XC + X0 + p0 - u0 * YS;
    const int base1 = u1 * XC + X0 + p1 - u1 * YS;
    uint32_t a[4];
    a[0] = tap_pair(xs, base0, tap_lo);
    a[1] = tap_pair(xs, base1, tap_lo);
    a[2] = tap_pair(xs, base0, tap_hi);
    a[3] = tap_pair(xs, base1, tap_hi);
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) mma16816(acc[j], a, bw[j][0], bw[j][1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int sp = h ? s1 : s0;
      if (sp >= PAIR_PIX) continue;
      const int u = sp >= YS;
      const int yi = 2 * m - 1 + u, xi = c0 - 1 + sp - u * YS;
      const uint32_t keep =
          yi >= 0 && yi < H && xi >= 0 && xi < W ? 0xFFFFFFFFu : 0u;
      const uint32_t row = slot_off + sp * 128;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t v = max_bf16x2(pack_bf16(acc[j][2 * h] + bias[j][0],
                                                acc[j][2 * h + 1] + bias[j][1]),
                                      0u);
        *reinterpret_cast<uint32_t*>(smem + swizzled(row, j) + 4 * q) =
            v & keep;
      }
    }
  }
}

// relu(max of the accumulator's column pairs + b1b) as bf16: word j holds
// pooled column 4 j + q of channels co and co + 8 (co = 16 wi + g)
__device__ __forceinline__ void pool_row(const float (&acc)[64], float b_lo,
                                         float b_hi, uint32_t (&pk)[16]) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
    pk[j] = pack_bf16(
        fmaxf(fmaxf(acc[4 * j], acc[4 * j + 1]) + b_lo, 0.f),
        fmaxf(fmaxf(acc[4 * j + 2], acc[4 * j + 3]) + b_hi, 0.f));
}

__global__ void __launch_bounds__(THREADS, 1)
pair1t_kernel(const __grid_constant__ CUtensorMap images,  // (W, H, B) f32
              const __nv_bfloat16* __restrict__ w1a,    // [co][16]
              const float* __restrict__ b1a,
              const __nv_bfloat16* __restrict__ w1b,  // [tap][co][ci] swizzled
              const float* __restrict__ b1b, __nv_bfloat16* __restrict__ out,
              int B, int H, int W) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const float* xs0 = reinterpret_cast<const float*>(smem + OFF_XS);
  const uint32_t smem_s = smem_addr(smem);
  const uint32_t xs_s = smem_s + OFF_XS;
  const uint32_t bar_w = smem_s + OFF_BAR;
  const uint32_t bar_full = bar_w + 8, bar_empty = bar_full + 8 * SLOTS;
  const uint32_t bar_in_full = bar_empty + 8 * SLOTS;
  const uint32_t bar_in_empty = bar_in_full + 8 * XBUFS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  Grid grid;
  grid.bands_y = H / TR;
  grid.bands_x = (W + TC - 1) / TC;
  const long n_tiles = long(B) * grid.bands_y * grid.bands_x;
  grid.t0 = int(n_tiles * blockIdx.x / gridDim.x);
  grid.t1 = int(n_tiles * (blockIdx.x + 1) / gridDim.x);

  if (tid == 0) {
    mbar_init(bar_w, 1);
    for (int i = 0; i < SLOTS; ++i) {
      mbar_init(bar_full + 8 * i, PRODUCERS);  // every producer thread
      // one lane of each of the 4 warps of the two tiles that read a pair
      // (the tile at either end of a run arrives for both)
      mbar_init(bar_empty + 8 * i, 2 * 4);
    }
    for (int i = 0; i < XBUFS; ++i) {
      mbar_init(bar_in_full + 8 * i, 1);             // the TMA issuer
      mbar_init(bar_in_empty + 8 * i, PRODUCERS / 32);  // one lane a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    bulk_load(smem_s, w1b, WB_BYTES, bar_w);
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {
    // ---------------- producers: row pair n of the block into slot n % 4
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int ptid = tid - CONSUMERS, pw = ptid >> 5;
    uint32_t bw[8][2];  // conv1a's B fragments, n8 tile j
    float bias[8][2];   // b1a of this lane's channels 8 j + 2 q (+1)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t* row =
          reinterpret_cast<const uint32_t*>(w1a + (8 * j + g) * 16);
      bw[j][0] = row[q];
      bw[j][1] = row[q + 4];
      bias[j][0] = b1a[8 * j + 2 * q];
      bias[j][1] = b1a[8 * j + 2 * q + 1];
    }
    // input-tile offsets of this lane's taps 2q, 2q+1 (a0) and 2q+8,
    // 2q+9 (a2): tap k = dy*3+dx is dy rows and dx columns on
    int2 tap_lo, tap_hi;
    {
      auto off = [](int k) { return k < 9 ? (k / 3) * XC + k % 3 : -1; };
      tap_lo = make_int2(off(2 * q), off(2 * q + 1));
      tap_hi = make_int2(off(2 * q + 8), off(2 * q + 9));
    }
    // producer thread 0 issues the input copies, a pair ahead
    const bool issuer = ptid == 0;
    PairCursor ld{grid.t0, 0};
    for (int i = 0; i < XBUFS - 1 && ld.t < grid.t1; ++i, ld.next(grid))
      if (issuer)
        load_input(&images, ld, grid, xs_s + i * XS_BYTES, bar_in_full + 8 * i);
    PairCursor cur{grid.t0, 0};
    for (int n = 0; cur.t < grid.t1; ++n, cur.next(grid)) {
      const Tile s = grid.at(cur.t);
      const int m = s.ry + cur.e, buf = n % XBUFS;
      if (ld.t < grid.t1) {
        // pair n + 1 into the buffer of pair n - 1, once that is read
        const int nb = (n + XBUFS - 1) % XBUFS;
        if (issuer) {
          if (n >= 1) mbar_wait(bar_in_empty + 8 * nb, ((n - 1) / XBUFS) & 1);
          load_input(&images, ld, grid, xs_s + nb * XS_BYTES,
                     bar_in_full + 8 * nb);
        }
        ld.next(grid);
      }
      mbar_wait(bar_in_full + 8 * buf, (n / XBUFS) & 1);
      const int slot = n % SLOTS;
      if (n >= SLOTS) mbar_wait(bar_empty + 8 * slot, ((n / SLOTS) - 1) & 1);
      conv1a_pair(xs0 + buf * (XS_BYTES / 4), smem, OFF_Y + slot * PAIR_BYTES,
                  m, s.bx * TC, H, W, pw, g, q, bw, bias, tap_lo, tap_hi);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_in_empty + 8 * buf, 1);  // input read
      // y1 is read by wgmma (the async proxy): make the stores visible to
      // it, then release the slot
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(bar_full + 8 * slot, 1);
    }
  } else {
    // ---------------- consumers: warpgroup cw runs the tiles k = cw, cw+2,
    // ... of the block's share.  Warp wi of it holds output channels
    // 16 wi + g (+8); accumulator 4 j + e is pixel column 8 j + 2 q + (e & 1)
    // of channel 16 wi + g + 8 (e >> 1).
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int cw = warp >> 2, wi = warp & 3, wtid = tid & 127;
    const uint32_t wdesc = desc_lo(smem_s), hi = DESC_HI;
    const float b_lo = b1b[16 * wi + g], b_hi = b1b[16 * wi + g + 8];
    unsigned char* stage = smem + OFF_ST + cw * ST_BYTES;
    const int W2 = W / 2, H2 = H / 2;
    const bool odd = g & 1;
    bool waited_w = false;
    int n = 0;  // the first pair of tile k in the block's pair sequence
    for (int t = grid.t0, k = 0; t < grid.t1; ++t, ++k) {
      const Tile s = grid.at(t);
      if (k > 0) n += s.first ? 2 : 1;
      if ((k & 1) != cw) continue;
      const int s0 = n % SLOTS, s1 = (n + 1) % SLOTS;
      mbar_wait(bar_full + 8 * s0, (n / SLOTS) & 1);
      mbar_wait(bar_full + 8 * s1, ((n + 1) / SLOTS) & 1);
      if (!waited_w) {
        mbar_wait(bar_w, 0);
        waited_w = true;
      }
      // the tile's y1 rows u = 0..3: pair n rows 0, 1, pair n + 1 rows 0, 1
      const uint32_t y0 = desc_lo(smem_s + OFF_Y + s0 * PAIR_BYTES);
      const uint32_t y2 = desc_lo(smem_s + OFF_Y + s1 * PAIR_BYTES);
      constexpr uint32_t R = ROW_BYTES >> 4;  // one y1 row in the low word

      uint32_t pk[16];
#pragma unroll 1
      for (int rr = 0; rr < 2; ++rr) {
        // y1 rows rr, rr + 1, rr + 2 of the tile: the taps' dy
        const uint32_t yr[3] = {rr ? y0 + R : y0, rr ? y2 : y0 + R,
                                rr ? y2 + R : y2};
        float acc[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.f;
        fence_operands(acc);
        wgmma_fence();
#pragma unroll
        for (int st = 0; st < 36; ++st) {
          const int tap = st >> 2, kc = st & 3;
          const int dy = tap / 3, dx = tap % 3;
          wgmma_64x128(acc, wdesc + ((tap * (C * 128) + kc * 32) >> 4),
                       yr[dy] + ((dx * 128 + kc * 32) >> 4), hi);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_operands(acc);
        if (rr == 0) {
          pool_row(acc, b_lo, b_hi, pk);
        } else {
          uint32_t pk1[16];
          pool_row(acc, b_lo, b_hi, pk1);
#pragma unroll
          for (int j = 0; j < 16; ++j) pk[j] = max_bf16x2(pk[j], pk1[j]);
        }
      }
      // both pairs read: release them (an end of a run counts twice)
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(bar_empty + 8 * s0, s.first ? 2 : 1);
        mbar_arrive(bar_empty + 8 * s1, s.last ? 2 : 1);
      }

      // pair channels (c, c + 1) across lanes g, g ^ 1: the even-g lane
      // takes even j, the odd-g lane odd j, two 4-byte words each; staging
      // row pc (128 B) holds chunk c at c ^ (pc % 8)
      asm volatile("bar.sync %0, 128;\n" ::"r"(2 + cw) : "memory");
      const int cb = 16 * wi + (g & ~1);  // first channel of the words
#pragma unroll
      for (int mm = 0; mm < 8; ++mm) {
        const uint32_t mine = odd ? pk[2 * mm + 1] : pk[2 * mm];
        const uint32_t got =
            __shfl_xor_sync(0xffffffffu, odd ? pk[2 * mm] : pk[2 * mm + 1], 4);
        const uint32_t x = odd ? got : mine, y = odd ? mine : got;
        const int pc = 4 * (2 * mm + odd) + q;
        unsigned char* row = stage + pc * 128 + 4 * ((cb & 7) >> 1);
        *reinterpret_cast<uint32_t*>(row + 16 * ((cb >> 3) ^ (pc & 7))) =
            __byte_perm(x, y, 0x5410);  // channels cb, cb + 1
        *reinterpret_cast<uint32_t*>(row + 16 * (((cb >> 3) + 1) ^ (pc & 7))) =
            __byte_perm(x, y, 0x7632);  // channels cb + 8, cb + 9
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(2 + cw) : "memory");
      const int pr = s.ry, pc0 = s.bx * PC;
#pragma unroll
      for (int i4 = 0; i4 < 4; ++i4) {
        const int i = wtid + 128 * i4;  // 0 .. 511
        const int pc = i >> 3, ch = i & 7;
        const uint4 v = *reinterpret_cast<const uint4*>(
            stage + pc * 128 + 16 * (ch ^ (pc & 7)));
        if (pc0 + pc < W2)
          *reinterpret_cast<uint4*>(
              out + ((size_t(s.b) * H2 + pr) * W2 + pc0 + pc) * C + 8 * ch) =
              v;
      }
    }
  }
}

// One warpgroup: D (64 co x 128 pixels) = A (64 co x 64 ci, [co][ci] with
// the 128-byte swizzle) times pixels shift .. shift + 127 of a row of y
// (n_pix x 64 ci), stored as the kernel stores y1 and read through the same
// descriptor: the one-pixel shifts of conv1b's taps, alone.
__global__ void __launch_bounds__(128)
pair1t_row_product_kernel(const __nv_bfloat16* __restrict__ w,
                   const __nv_bfloat16* __restrict__ y, int n_pix, int shift,
                   float* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  for (int i = tid; i < C * C / 8; i += 128)
    reinterpret_cast<uint4*>(smem)[i] = reinterpret_cast<const uint4*>(w)[i];
  for (int i = tid; i < n_pix * 8; i += 128)
    *reinterpret_cast<uint4*>(smem + swizzled(C * C * 2 + (i >> 3) * 128,
                                              i & 7)) =
        reinterpret_cast<const uint4*>(y)[i];
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  fence_operands(acc);
  wgmma_fence();
  const uint32_t da = desc_lo(smem_addr(smem));
  const uint32_t db = desc_lo(smem_addr(smem) + C * C * 2 + shift * 128);
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
    wgmma_64x128(acc, da + 2 * kc, db + 2 * kc, DESC_HI);
  wgmma_commit();
  wgmma_wait0();
  fence_operands(acc);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[(16 * warp + g + 8 * (e >> 1)) * TC + 8 * j + 2 * q + (e & 1)] =
          acc[4 * j + e];
}

// cuTensorMapEncodeTiled, a libcuda function, looked up through the
// runtime's entry-point query (no -lcuda at build time)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the (W, H, B) f32 images as a TMA tensor map, box XC x XR x 1, zeros
// outside; needs W % 4 == 0 (row strides of 16 bytes)
cudaError_t image_map(const void* images, int B, int H, int W,
                      CUtensorMap* map) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr || W % 4 != 0) return cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {cuuint64_t(W), cuuint64_t(H), cuuint64_t(B)};
  const cuuint64_t strides[2] = {cuuint64_t(W) * 4, cuuint64_t(H) * W * 4};
  const cuuint32_t box[3] = {XC, XR, 1}, elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(images),
      dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t configure() {
  cudaError_t err = cudaFuncSetAttribute(
      pair1t_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(pair1t_kernel,
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
                                                      pair1t_kernel, THREADS,
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
// (B, H/2, W/2, 64) bf16, 16-byte aligned.  Needs H % 2 == 0 (the wrapper
// asks H % 8 == 0) and W % 4 == 0; images and w1b 16-byte aligned.
extern "C" int pair1t_launch(const void* images, const void* w1a,
                             const void* b1a, const void* w1b, const void* b1b,
                             void* out, int B, int H, int W, void* stream) {
  int grid = 0, blocks = 0, sms = 0;
  cudaError_t err = grid_size(B, H, W, &grid, &blocks, &sms);
  if (err != cudaSuccess) return int(err);
  if (grid == 0) return 0;
  CUtensorMap map;
  err = image_map(images, B, H, W, &map);
  if (err != cudaSuccess) return int(err);
  pair1t_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      map,
      static_cast<const __nv_bfloat16*>(w1a), static_cast<const float*>(b1a),
      static_cast<const __nv_bfloat16*>(w1b), static_cast<const float*>(b1b),
      static_cast<__nv_bfloat16*>(out), B, H, W);
  return int(cudaGetLastError());
}

// The launch's grid for (B, H, W), the resident blocks an SM holds at the
// kernel's shared-memory size, and the SM count.
extern "C" int pair1t_grid(int B, int H, int W, int* grid, int* blocks_per_sm,
                           int* sms, void* /*stream*/) {
  return int(grid_size(B, H, W, grid, blocks_per_sm, sms));
}

// w (64, 64) bf16 [co][ci] swizzled as w1b's taps; y (n_pix, 64) bf16,
// n_pix >= shift + 128 and <= 512; out (64, 128) f32.
extern "C" int pair1t_row_product(const void* w, const void* y, int n_pix,
                                  int shift, void* out, void* stream) {
  const int smem = 1024 + C * C * 2 + n_pix * 128;
  cudaError_t err = cudaFuncSetAttribute(
      pair1t_row_product_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return int(err);
  pair1t_row_product_kernel<<<1, 128, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(y), n_pix, shift,
      static_cast<float*>(out));
  return int(cudaGetLastError());
}
