// Exact greedy grid NMS as a bit-sliced commit/reject fixed point, one
// thread block cluster per image.
//
// Replaces the TPU kernel sp_orb_slam_tpu/ops/pallas_nms.py
// (`batched_grid_nms`, body `_nms_kernel`); same semantics as
// ops/nms.py `greedy_grid_nms`: a candidate conflicts with a valid neighbour
// in its 3x3 cell neighbourhood when both pixel offsets are <= dist;
// priority is score desc, ties by raster index asc; each round, an
// undecided candidate commits when every conflicting higher-priority
// neighbour is rejected and is rejected when a conflicting neighbour is kept.
//
// The rounds are Jacobi, as in the JAX fixed point: every cell reads the
// previous round's state, kept in two buffers that swap after a barrier.
// An in-place update would converge differently on long chains.
//
// Bound on the card: neither bytes (~2.5 MB at B=32, 60x94 cells) nor
// operations; the latency of the serial rounds, and of the loads and mask
// instructions of an image.  Design:
// - C blocks an image (a cluster: 8 where the batch leaves most SMs idle,
//   B <= 8 on the H100, else 1; ops/cuda_nms.py `cluster_size`): each
//   stages its band of rows, and the row below, into shared memory with
//   cp.async and builds the band's masks; the masks go into the first
//   block's shared memory with st.async, counted on an mbarrier there, and
//   the first block alone runs the rounds.  At B=1 one block alone spends
//   most of its time on the staging and the masks (PERF.md);
// - the loop-invariant masks are bit-sliced as the TPU kernel's whole-vector
//   shifts are: one 32-bit word holds 32 columns of one row, built with
//   __ballot_sync (lanes as columns, no branch).  Conflict and priority are
//   computed for four directions (E, SW, S, SE) only; the other four are
//   the same pairs seen from the neighbour, read from the neighbour's word
//   (conflict is symmetric, "higher priority" from the far side is "lower
//   priority" from the near side);
// - a round is one thread per word (180 words at 60x94, in the first
//   warps, which meet at a named barrier): for each of the 8 directions,
//   the neighbour row's (kept, rejected) pair of words shifted by du with
//   the carry bit of the adjacent word, then kept |= und & ~blocked and
//   rejected |= und & any_kept, both from the old state;
// - the words sit in a zero-bordered grid, so the image's edges and the
//   padding bits past wc (never valid) need no test;
// - the loop stops at the fixed point: a round is a function of the state
//   alone, so once a round changes no word (bar.red.or) no later round
//   would; `iters` still caps the rounds exactly;
// - the mask is written back 4 cells a thread, in raster order.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;
// the four forward directions d = 0-3, (dv, du) = (0, 1), (1, -1), (1, 0),
// (1, 1); the other four are their opposites
__host__ __device__ constexpr int fdv(int d) { return d == 0 ? 0 : 1; }
__host__ __device__ constexpr int fdu(int d) { return d == 0 ? 1 : d - 2; }
// fields of a word's mask slot: valid, then per forward direction d its
// conflict (PN + d), conflict & neighbour higher (PH + d) and conflict &
// neighbour lower (PL + d); 16 words, 64 bytes
constexpr int F_VAL = 0, F_PN = 1, F_PH = 5, F_PL = 9, SLOT = 16;

__host__ __device__ constexpr int round16(int b) { return (b + 15) & ~15; }

// Shared-memory layout of one image (hc x wc cells), every part 16-byte
// aligned: score f32[n], uv int2[n], valid u8[n], then a zero-bordered
// grid of (hc + 2) x (nwr + 2) word slots: the masks (SLOT words a slot)
// and the (kept, rejected) state twice.
struct Layout {
  int n, nwr, pitch, grid, off_uv, off_val, off_mask, off_state, bytes;
  __host__ __device__ Layout(int hc, int wc)
      : n(hc * wc), nwr((wc + 31) / 32), pitch(nwr + 2),
        grid((hc + 2) * pitch), off_uv(round16(4 * n)),
        off_val(off_uv + round16(8 * n)), off_mask(off_val + round16(n)),
        off_state(off_mask + grid * SLOT * 4),
        bytes(off_state + 2 * grid * 8) {}
};

// x / d for 0 <= x, x * d < 2^32, d >= 1, as one multiply: m = ceil(2^32 / d)
__device__ __forceinline__ unsigned magic(unsigned d) {
  return 0xffffffffu / d + 1u;
}
__device__ __forceinline__ int div_by(int x, unsigned d, unsigned m) {
  return d == 1 ? x : int(__umulhi(unsigned(x), m));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int N>
__device__ __forceinline__ void cp_async(unsigned dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(src), "n"(N));
}

// Copy `bytes` from global `src` into shared `dst` with the widest
// cp.async both addresses' alignment allows, all in flight.
__device__ void stage(void* dst, const void* src, int bytes) {
  const unsigned d = smem_addr(dst);
  const char* s = static_cast<const char*>(src);
  const unsigned a = static_cast<unsigned>(reinterpret_cast<uintptr_t>(s)) |
                     d | static_cast<unsigned>(bytes);
  const int t = threadIdx.x;
  if ((a & 15) == 0) {
    for (int i = 16 * t; i < bytes; i += 16 * THREADS)
      cp_async<16>(d + i, s + i);
  } else if ((a & 7) == 0) {
    for (int i = 8 * t; i < bytes; i += 8 * THREADS) cp_async<8>(d + i, s + i);
  } else if ((a & 3) == 0) {
    for (int i = 4 * t; i < bytes; i += 4 * THREADS) cp_async<4>(d + i, s + i);
  } else {
    char* dc = static_cast<char*>(dst);
    for (int i = t; i < bytes; i += THREADS) dc[i] = s[i];
  }
}

// Field f of the mask slots around p, seen from (dv, du): bit c holds
// column c + du of row r + dv; zeros come in past the grid's edges.
template <int DV, int DU>
__device__ __forceinline__ unsigned nbr_mask(const unsigned* m, int p,
                                             int pitch, int f) {
  const unsigned* a = m + (p + DV * pitch) * SLOT + f;
  if (DU == 0) return a[0];
  if (DU > 0) return (a[0] >> 1) | (a[SLOT] << 31);
  return (a[0] << 1) | (a[-SLOT] >> 31);
}

// The (kept, rejected) words around p, seen from (dv, du) as above.
template <int DV, int DU>
__device__ __forceinline__ uint2 nbr_state(const uint2* s, int p, int pitch) {
  const uint2* a = s + p + DV * pitch;
  const uint2 x = a[0];
  if (DU == 0) return x;
  if (DU > 0) {
    const uint2 y = a[1];
    return make_uint2((x.x >> 1) | (y.x << 31), (x.y >> 1) | (y.y << 31));
  }
  const uint2 y = a[-1];
  return make_uint2((x.x << 1) | (y.x >> 31), (x.y << 1) | (y.y >> 31));
}

// One round's contribution of direction e (0-3 forward, 4-7 opposite).
template <int E>
__device__ __forceinline__ void step(const uint2* s, int p, int pitch,
                                     unsigned conf, unsigned blk,
                                     unsigned& blocked, unsigned& any_kept) {
  constexpr int sg = E < 4 ? 1 : -1;
  const uint2 n = nbr_state<sg * fdv(E & 3), sg * fdu(E & 3)>(s, p, pitch);
  blocked |= blk & ~n.y;
  any_kept |= conf & n.x;
}

// The address of shared-memory address `a` in the cluster's first block.
__device__ __forceinline__ unsigned in_first_block(unsigned a) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, 0;\n" : "=r"(r) : "r"(a));
  return r;
}

// 16 bytes into the first block's shared memory, counted on its mbarrier.
__device__ __forceinline__ void store_first(unsigned dst, uint4 v,
                                            unsigned mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(dst),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(mbar)
      : "memory");
}

// Barrier `id` over the first `nthreads` threads of the block (whole
// warps): true when `pred` holds in any of them.  Orders their shared
// memory accesses as __syncthreads does.
__device__ __forceinline__ bool bar_or(int id, int nthreads, bool pred) {
  int any;
  asm volatile(
      "{\n\t.reg .pred p, q;\n\tsetp.ne.s32 p, %1, 0;\n\t"
      "bar.red.or.pred q, %2, %3, p;\n\tselp.s32 %0, 1, 0, q;\n\t}\n"
      : "=r"(any)
      : "r"(int(pred)), "r"(id), "r"(nthreads)
      : "memory");
  return any != 0;
}

template <int C>
__global__ void __cluster_dims__(C, 1, 1) __launch_bounds__(THREADS)
nms_kernel(const float* __restrict__ score, const int* __restrict__ uv,
           const unsigned char* __restrict__ valid, unsigned char* kept,
           int hc, int wc, int dist, int iters) {
  extern __shared__ __align__(16) unsigned char sm[];
  __shared__ int final_state;
  const Layout L(hc, wc);
  const float* S = reinterpret_cast<const float*>(sm);
  const int2* UV = reinterpret_cast<const int2*>(sm + L.off_uv);
  const unsigned char* V = sm + L.off_val;
  unsigned* M = reinterpret_cast<unsigned*>(sm + L.off_mask);
  uint2* ST = reinterpret_cast<uint2*>(sm + L.off_state);  // [2][grid]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = int(cluster.block_rank());
  const int nw = hc * L.nwr;
  // the first block counts the mask bytes the bands send it on `landed`;
  // every block arrives now and waits before its first store there, so
  // that all have started and the count is set up
  __shared__ __align__(8) unsigned long long landed;
  if (rank == 0 && threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
        smem_addr(&landed)));
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem_addr(&landed)),
        "r"(nw * SLOT * 4)
        : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // this block's band of rows, and the row below it, staged in place
  const int r0 = rank * hc / C, r1 = (rank + 1) * hc / C;
  const int c0 = r0 * wc, c1 = min(r1 + 1, hc) * wc;
  const size_t off = size_t(blockIdx.x / C) * L.n;
  stage(sm + 4 * c0, score + off + c0, 4 * (c1 - c0));
  stage(sm + L.off_uv + 8 * c0, uv + 2 * (off + c0), 8 * (c1 - c0));
  stage(sm + L.off_val + c0, valid + off + c0, c1 - c0);
  if (rank == 0) {
    // zeros: both states, and the mask grid's border slots (the bands
    // write the inner ones)
    uint4* z = reinterpret_cast<uint4*>(ST);
    for (int i = threadIdx.x; i < L.grid; i += THREADS)
      z[i] = make_uint4(0, 0, 0, 0);
    z = reinterpret_cast<uint4*>(M);  // 4 uint4 a slot
    const int nrow = 2 * L.pitch, nslot = nrow + 2 * hc;
    for (int i = threadIdx.x; i < 4 * nslot; i += THREADS) {
      const int k = i >> 2;  // rows 0 and hc + 1, then columns 0 and last
      const int p = k < L.pitch ? k
                    : k < nrow  ? hc * L.pitch + k
                                : (1 + (k - nrow) / 2) * L.pitch +
                                     ((k - nrow) & 1) * (L.pitch - 1);
      z[4 * p + (i & 3)] = make_uint4(0, 0, 0, 0);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // masks of the band's words into the first block's grid: a warp a word,
  // lanes as columns.  The forward neighbour j of cell i is later in
  // raster order, so "higher priority" is sj > s and "lower" sj <= s (both
  // false for a NaN, as the plain test gives).
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  const unsigned m0 = in_first_block(smem_addr(M));
  const unsigned landed0 = in_first_block(smem_addr(&landed));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned m_nwr = magic(L.nwr);
  for (int w = r0 * L.nwr + warp; w < r1 * L.nwr; w += THREADS / 32) {
    const int r = div_by(w, L.nwr, m_nwr), wd = w - r * L.nwr;
    const int c = 32 * wd + lane, i = r * wc + c;
    const bool in = c < wc;
    const int ii = in ? i : c0;  // every load below stays inside the band
    const bool val = in & (V[ii] != 0);
    const float s = S[ii];
    const int2 q = UV[ii];
    const bool down = r + 1 < hc;
    const bool inb[4] = {c + 1 < wc, down & (c >= 1) & in, down & in,
                         down & (c + 1 < wc)};
    unsigned pn[4], ph[4], pl[4];
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const int j = inb[d] ? i + fdv(d) * wc + fdu(d) : c0;
      const bool vj = V[j] != 0;
      const int2 qj = UV[j];
      const float sj = S[j];
      const bool near = val & inb[d] & vj & (abs(qj.x - q.x) <= dist) &
                        (abs(qj.y - q.y) <= dist);
      pn[d] = __ballot_sync(FULL, near);
      ph[d] = __ballot_sync(FULL, near & (sj > s));
      pl[d] = __ballot_sync(FULL, near & (sj <= s));
    }
    const unsigned vw = __ballot_sync(FULL, val);
    if (lane == 0) {
      const unsigned dst = m0 + ((r + 1) * L.pitch + wd + 1) * SLOT * 4;
      store_first(dst, make_uint4(vw, pn[0], pn[1], pn[2]), landed0);
      store_first(dst + 16, make_uint4(pn[3], ph[0], ph[1], ph[2]), landed0);
      store_first(dst + 32, make_uint4(ph[3], pl[0], pl[1], pl[2]), landed0);
      store_first(dst + 48, make_uint4(pl[3], 0, 0, 0), landed0);
    }
  }
  if (rank != 0) {
    // stay until the first block has every band's masks (it arrives then)
    asm volatile(
        "barrier.cluster.arrive.relaxed.aligned;\n\t"
        "barrier.cluster.wait.aligned;\n" ::: "memory");
    return;
  }
  {  // the first block: wait for every band's mask bytes, then let the
     // others go (a relaxed arrival, no wait)
    const unsigned mb = smem_addr(&landed);
    for (int spin = 0;; ++spin) {
      unsigned done;
      asm volatile(
          "{\n\t.reg .pred p;\n\t"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n\t"
          "selp.u32 %0, 1, 0, p;\n\t}\n"
          : "=r"(done)
          : "r"(mb)
          : "memory");
      if (done) break;
      if (spin == 1 << 22) __trap();  // bytes lost: fail, never hang
    }
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  }

  // rounds, in the first block: a thread a word, its masks in registers;
  // only the warps that own words take part, through barrier 1, the rest
  // wait below
  const int round_warps = (nw + 31) / 32;
  if (warp < round_warps) {
    const int t = threadIdx.x;
    const bool own = t < nw;
    int p = 0;
    unsigned val = 0, conf[8], blk[8];
    uint2 st = make_uint2(0, 0);  // (kept, rejected) of the own word
    if (own) {
      const int r = div_by(t, L.nwr, m_nwr), wd = t - r * L.nwr;
      p = (r + 1) * L.pitch + wd + 1;
      const unsigned* slot = M + p * SLOT;
      val = slot[F_VAL];
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        conf[d] = slot[F_PN + d];
        blk[d] = slot[F_PH + d];
      }
      // the opposite directions: the pair as the neighbour at -d saw it
      conf[4] = nbr_mask<0, -1>(M, p, L.pitch, F_PN + 0);
      conf[5] = nbr_mask<-1, 1>(M, p, L.pitch, F_PN + 1);
      conf[6] = nbr_mask<-1, 0>(M, p, L.pitch, F_PN + 2);
      conf[7] = nbr_mask<-1, -1>(M, p, L.pitch, F_PN + 3);
      blk[4] = nbr_mask<0, -1>(M, p, L.pitch, F_PL + 0);
      blk[5] = nbr_mask<-1, 1>(M, p, L.pitch, F_PL + 1);
      blk[6] = nbr_mask<-1, 0>(M, p, L.pitch, F_PL + 2);
      blk[7] = nbr_mask<-1, -1>(M, p, L.pitch, F_PL + 3);
    }
    int cur = 0;
    for (int it = 0; it < iters; ++it) {
      bool changed = false;
      if (own) {
        const uint2* s = ST + cur * L.grid;
        unsigned blocked = 0, any_kept = 0;
        step<0>(s, p, L.pitch, conf[0], blk[0], blocked, any_kept);
        step<1>(s, p, L.pitch, conf[1], blk[1], blocked, any_kept);
        step<2>(s, p, L.pitch, conf[2], blk[2], blocked, any_kept);
        step<3>(s, p, L.pitch, conf[3], blk[3], blocked, any_kept);
        step<4>(s, p, L.pitch, conf[4], blk[4], blocked, any_kept);
        step<5>(s, p, L.pitch, conf[5], blk[5], blocked, any_kept);
        step<6>(s, p, L.pitch, conf[6], blk[6], blocked, any_kept);
        step<7>(s, p, L.pitch, conf[7], blk[7], blocked, any_kept);
        const unsigned und = val & ~st.x & ~st.y;
        const uint2 nx = make_uint2(st.x | (und & ~blocked),
                                    st.y | (und & any_kept));
        changed = nx.x != st.x || nx.y != st.y;
        st = nx;
        ST[(cur ^ 1) * L.grid + p] = st;
      }
      cur ^= 1;
      if (!bar_or(1, 32 * round_warps, changed)) break;  // the fixed point
    }
    if (threadIdx.x == 0) final_state = cur;
  }
  __syncthreads();

  // out: 4 cells a thread in raster order (one 32-bit store where the
  // image's mask is 4-byte aligned, else a byte a thread)
  const uint2* K = ST + final_state * L.grid;
  const unsigned m_wc = magic(wc);
  unsigned char* out = kept + off;
  auto bit = [&](int i) -> unsigned {
    const int r = div_by(i, wc, m_wc), c = i - r * wc;
    return (K[(r + 1) * L.pitch + (c >> 5) + 1].x >> (c & 31)) & 1u;
  };
  if (((reinterpret_cast<uintptr_t>(out) | L.n) & 3) == 0) {
    for (int q = threadIdx.x; q < L.n / 4; q += THREADS)
      reinterpret_cast<unsigned*>(out)[q] =
          bit(4 * q) | bit(4 * q + 1) << 8 | bit(4 * q + 2) << 16 |
          bit(4 * q + 3) << 24;
  } else {
    for (int i = threadIdx.x; i < L.n; i += THREADS) out[i] = bit(i);
  }
}

template <int C>
int launch(const void* score, const void* uv, const void* valid, void* kept,
           int B, int hc, int wc, int dist, int iters, int bytes,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      nms_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return int(err);
  nms_kernel<C><<<B * C, THREADS, bytes, stream>>>(
      static_cast<const float*>(score), static_cast<const int*>(uv),
      static_cast<const unsigned char*>(valid),
      static_cast<unsigned char*>(kept), hc, wc, dist, iters);
  return int(cudaGetLastError());
}

}  // namespace

// score (B, hc, wc) f32; uv (B, hc, wc, 2) int32; valid (B, hc, wc) bool;
// kept (B, hc, wc) bool out; `cluster` blocks an image: 1 or 8.
// hc * ceil(wc / 32) <= 1024 words and the layout within the card's shared
// memory a block (ops/cuda_nms.py checks both first and says which).
extern "C" int nms_launch(const void* score, const void* uv, const void* valid,
                          void* kept, int B, int hc, int wc, int dist,
                          int iters, int cluster, void* stream) {
  const Layout L(hc, wc);
  if (hc * L.nwr > THREADS) return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cluster) {
    case 1: return launch<1>(score, uv, valid, kept, B, hc, wc, dist, iters,
                             L.bytes, st);
    case 8: return launch<8>(score, uv, valid, kept, B, hc, wc, dist, iters,
                             L.bytes, st);
  }
  return int(cudaErrorInvalidValue);
}
