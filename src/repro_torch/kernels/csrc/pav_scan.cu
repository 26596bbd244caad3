// Divide-and-conquer Pool-Adjacent-Violators (isotonic regression, paper
// §5) across threads, for Hopper (sm_90a), in the quadratic (l2) and the
// entropic (kl) form.
//
// Replaces the Pallas TPU kernels src/repro/kernels/pav.py::pav_l2 and
// ::pav_kl (_pav_l2_kernel, _pav_kl_kernel), as the parallel form of the
// reference's "scan" backend src/repro/kernels/pav_scan.py (_merge_level,
// _dac_pav); its plain versions are repro_torch/kernels/pav_scan.py::
// pav_l2_scan and ::pav_kl_scan.
//
// Algorithm.  Level l merges adjacent solved segments of 2^l positions.
// Each solved segment is kept compact: its blocks, left to right, as
// (r1, r2, start) in consecutive slots from the segment's first position,
// and its block count.  The registers are the algebra's (Op): l2 (sum,
// count), value sum / count; kl (LSE s, LSE w), value LSE s - LSE w.  A
// pair merges by the reference's rules: if the left segment's last block
// value is strictly below the right segment's first (a violation), the two
// form a pool, which then absorbs its left neighbour block if that block's
// value is < the pool's and its right neighbour if the pool's value is <
// that block's, both decided against the same pool value, until neither
// holds.  The merged segment is the left blocks kept, the pool, and the
// right blocks kept, moved left.  Registers are only ever merged, never
// differenced (l2 by addition, kl by logaddexp), in the plain version's
// order.  Rows are not padded to a power of two: the reference's sentinels
// (l2: the row minimum; kl: min(s) - max(w) - log n - 1) never pool with
// real blocks, since comparisons are strict, so segments are cut at n.
//
// Exactness.  l2 equals pav_l2_scan bit for bit (counts are integers,
// exact in f32 up to 2^24).  kl merges with torch.logaddexp's formula on
// the card, max(a, b) + log1pf(expf(-|a - b|)) without --use_fast_math,
// so it equals pav_kl_scan run on the card as long as PyTorch's build of
// expf / log1pf rounds as this one does.  It does with PyTorch 2.11 /
// CUDA 12.8: chip_smoke.py finds no element that differs on any of its
// inputs (it counts them, and would hold an ulp within 1e-5 * (1 +
// max|plain|) with the same blocks).
//
// Kernels.
//   * tile_kernel: one CTA per tile of up to kTile = 16384 positions of a
//     row (the whole row when n <= kTile) runs every level inside the tile
//     in shared memory: a slot is the f32 r1, r2 (l2: a u16 count; kl: an
//     f32 LSE) and a u16 start, 8 bytes (l2) or 10 (kl), plus 4 bytes a
//     position of pair and segment bookkeeping: 192 KB (l2) or 224 KB (kl,
//     229,376 bytes of the 232,448 a CTA may opt in to) for a full tile, so
//     kl keeps the 16384-position tile and (128, 10000) stays one tile a
//     row.  One thread per pair walks the pool; then the CTA moves the
//     right blocks left in chunks ordered by slot (a block only moves
//     left, so a chunk never overwrites a slot a later chunk still reads).
//     When the row is one tile the CTA writes the output itself.
//   * merge_kernel / move_kernel: each level above the tile, two launches
//     over device memory (about 6 levels for 2^20).  One warp per pair walks
//     the pool with the next 32 neighbour blocks of each side held one per
//     lane (loaded together, read by shuffles), so a long absorption waits
//     on memory once per 32 blocks; then every slot is copied to its place
//     in a second buffer.
//   * expand_kernel: each position finds its block by binary search over
//     the row's block starts and writes the block's value: one and the same
//     float for every position of a block, which the scatter backward reads
//     blocks from.
//
// What bounds it on this card.  The bytes are microseconds (12 bytes a
// position for kl: 12 MB on a 2^20 row); the depth is log2(n) levels, each
// a few launches or CTA barriers, and inside a level the longest
// absorption chain, which is serial: a pool absorbs one block per step, a
// dependent value (l2: a division; kl: a subtraction), compare and merge
// (kl: two logaddexp, each an expf and a log1pf) of some tens of cycles.
// On an input whose top level pools most of the row (two decreasing ramps,
// the right one above the left) that is about n / 2 serial steps; on random
// rows and on the main path's rows the chains are short.  chip_smoke.py
// measures (H100 80GB HBM3, 700 W) kl at 0.014 ms of device time at
// (128, 1000), 0.059 ms at (128, 10000) and 0.157 ms on a 2^20 row, l2 at
// 0.013, 0.052 and 0.157 ms; on the adversarial 2^20 row l2 takes 73 ms
// and kl 249 ms, the two logaddexp of each serial step.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kTile = 16384;         // positions per tile, a power of two
constexpr int kTileLog = 14;
constexpr int kChunkItems = 4;       // slots per thread per move chunk

// The aggregate algebra of a block, and its slot layout.  A block is two
// registers: r1 (f32) and r2 (R2; S2 in a tile's shared memory).
//   l2: (sum, count), merged by addition, value sum / count; counts are
//       integers (u16 in a tile, which holds at most 16384 positions).
//   kl: (LSE s, LSE w), merged by a stable logaddexp, value their
//       difference.
struct L2Algebra {
  using R2 = int;
  using S2 = uint16_t;
  __device__ static R2 init2(const float*, int64_t) { return 1; }
  __device__ static float value(float sum, R2 count) {
    return sum / fmaxf(static_cast<float>(count), 1e-30f);
  }
  __device__ static float merge1(float a, float b) { return a + b; }
  __device__ static R2 merge2(R2 a, R2 b) { return a + b; }
};

struct KlAlgebra {
  using R2 = float;
  using S2 = float;
  __device__ static R2 init2(const float* w, int64_t i) { return w[i]; }
  __device__ static float value(float lse_s, R2 lse_w) {
    return lse_s - lse_w;
  }
  // max(a, b) + log1p(exp(-|a - b|)), torch.logaddexp's formula on the
  // card; equal infinities return themselves (their difference is nan).
  __device__ static float merge1(float a, float b) {
    if (a == b && isinf(a)) return a;
    return fmaxf(a, b) + log1pf(expf(-fabsf(a - b)));
  }
  __device__ static R2 merge2(R2 a, R2 b) { return merge1(a, b); }
};

template <class Op>
struct TileSmem {
  float* r1;
  typename Op::S2* r2;
  uint16_t* start;
  uint16_t* nb;      // block count of each segment
  uint16_t* dst0;    // per pair: slot of its first kept right block
  uint16_t* j;       // per pair: right blocks absorbed into the pool
  uint16_t* b;       // per pair: right blocks before the merge
};

// Merges pair p of level lvl (segments of m slots at base) in shared memory
// by the reference's rules; writes the pool into its slot.
template <class Op>
__device__ void tile_merge_pair(const TileSmem<Op>& t, int base, int m,
                                int a, int b, int p) {
  using R2 = typename Op::R2;
  int dst0 = a, jj = 0;
  if (b > 0) {
    const int la = base + a - 1, rb = base + m;
    const float lv = Op::value(t.r1[la], t.r2[la]);
    const float rv = Op::value(t.r1[rb], t.r2[rb]);
    if (lv < rv) {
      float p1 = Op::merge1(t.r1[la], t.r1[rb]);
      R2 p2 = Op::merge2(t.r2[la], t.r2[rb]);
      int li = a - 1;
      jj = 1;
      while (true) {
        const float gamma = Op::value(p1, p2);
        const bool absorb_l =
            li > 0 && Op::value(t.r1[base + li - 1], t.r2[base + li - 1]) <
                          gamma;
        const bool absorb_r =
            jj < b && gamma < Op::value(t.r1[rb + jj], t.r2[rb + jj]);
        if (!absorb_l && !absorb_r) break;
        if (absorb_l) {
          --li;
          p1 = Op::merge1(p1, t.r1[base + li]);
          p2 = Op::merge2(p2, t.r2[base + li]);
        }
        if (absorb_r) {
          p1 = Op::merge1(p1, t.r1[rb + jj]);
          p2 = Op::merge2(p2, t.r2[rb + jj]);
          ++jj;
        }
      }
      t.r1[base + li] = p1;
      t.r2[base + li] = static_cast<typename Op::S2>(p2);
      dst0 = li + 1;
    }
  }
  t.dst0[p] = static_cast<uint16_t>(dst0);
  t.j[p] = static_cast<uint16_t>(jj);
  t.b[p] = static_cast<uint16_t>(b);
}

// One CTA per (tile, row): every level inside the tile, then either the
// output (the row is one tile) or the tile's compact blocks in device memory.
// x0 / x1: the row's inputs for the singleton registers (l2: y and none;
// kl: s and w).
template <class Op>
__global__ void __launch_bounds__(kThreads)
tile_kernel(const float* __restrict__ x0, const float* __restrict__ x1,
            float* __restrict__ out, float* __restrict__ g_r1,
            typename Op::R2* __restrict__ g_r2, int* __restrict__ g_start,
            int* __restrict__ g_nb, int64_t n, int tile, int n_tiles) {
  using S2 = typename Op::S2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int row = blockIdx.y;
  const int64_t off = static_cast<int64_t>(blockIdx.x) * tile;
  const int nt = static_cast<int>(min(static_cast<int64_t>(tile), n - off));
  TileSmem<Op> t;
  t.r1 = reinterpret_cast<float*>(smem_raw);
  t.r2 = reinterpret_cast<S2*>(t.r1 + tile);
  t.start = reinterpret_cast<uint16_t*>(t.r2 + tile);
  const int half = (tile + 1) / 2;   // pairs, and segments after level 0
  t.nb = t.start + tile;
  t.dst0 = t.nb + half;
  t.j = t.dst0 + half;
  t.b = t.j + half;

  const int64_t g0 = row * n + off;
  for (int i = threadIdx.x; i < nt; i += kThreads) {
    t.r1[i] = x0[g0 + i];
    t.r2[i] = static_cast<S2>(Op::init2(x1, g0 + i));
    t.start[i] = static_cast<uint16_t>(i);
  }
  __syncthreads();

  int lvl = 0;
  for (int m = 1; m < nt; m *= 2, ++lvl) {
    const int npairs = (nt + 2 * m - 1) / (2 * m);
    for (int p = threadIdx.x; p < npairs; p += kThreads) {
      const int base = 2 * m * p;
      const int a = lvl == 0 ? 1 : t.nb[2 * p];
      const int b = base + m >= nt ? 0 : (lvl == 0 ? 1 : t.nb[2 * p + 1]);
      tile_merge_pair<Op>(t, base, m, a, b, p);
    }
    __syncthreads();
    for (int p = threadIdx.x; p < npairs; p += kThreads) {
      t.nb[p] = static_cast<uint16_t>(t.dst0[p] + t.b[p] - t.j[p]);
    }
    // Move each pair's kept right blocks left, chunk by chunk in slot order.
    for (int c0 = 0; c0 < nt; c0 += kThreads * kChunkItems) {
      float s_r1[kChunkItems];
      S2 s_r2[kChunkItems];
      uint16_t s_start[kChunkItems];
      int dest[kChunkItems];
#pragma unroll
      for (int q = 0; q < kChunkItems; ++q) {
        const int i = c0 + q * kThreads + threadIdx.x;
        dest[q] = -1;
        if (i >= nt) continue;
        const int p = i >> (lvl + 1);
        const int base = 2 * m * p;
        const int r = i - base - m;
        if (r >= t.j[p] && r < t.b[p]) {
          const int d = base + t.dst0[p] + r - t.j[p];
          if (d != i) {
            dest[q] = d;
            s_r1[q] = t.r1[i];
            s_r2[q] = t.r2[i];
            s_start[q] = t.start[i];
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kChunkItems; ++q) {
        if (dest[q] < 0) continue;
        t.r1[dest[q]] = s_r1[q];
        t.r2[dest[q]] = s_r2[q];
        t.start[dest[q]] = s_start[q];
      }
      __syncthreads();
    }
  }

  const int nb = nt == 1 ? 1 : t.nb[0];
  if (n_tiles == 1) {
    float* o = out + row * n;
    for (int i = threadIdx.x; i < nt; i += kThreads) {
      int lo = 0, hi = nb - 1;      // the last block starting at or before i
      while (lo < hi) {
        const int mid = (lo + hi + 1) / 2;
        if (t.start[mid] <= i) lo = mid; else hi = mid - 1;
      }
      o[i] = Op::value(t.r1[lo], t.r2[lo]);
    }
    return;
  }
  for (int k = threadIdx.x; k < nb; k += kThreads) {
    g_r1[g0 + k] = t.r1[k];
    g_r2[g0 + k] = t.r2[k];
    g_start[g0 + k] = static_cast<int>(off) + t.start[k];
  }
  if (threadIdx.x == 0) g_nb[row * n_tiles + blockIdx.x] = nb;
}

// One warp per (pair, row) of a level above the tile: walks the pool and
// writes it into its slot of the input buffer, the pair's (dst0, j, b) and
// the merged segment's block count.
template <class Op>
__global__ void __launch_bounds__(256)
merge_kernel(float* __restrict__ g_r1, typename Op::R2* __restrict__ g_r2,
             const int* __restrict__ nb_in, int* __restrict__ nb_out,
             int* __restrict__ pair_info, int64_t n, int lvl, int nseg0,
             int64_t npairs) {
  using R2 = typename Op::R2;
  const int64_t w = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.y;
  if (w >= npairs) return;
  const int64_t m = int64_t{1} << lvl;
  const int64_t base = 2 * m * w;
  const int a = nb_in[row * nseg0 + 2 * w];
  const int b = base + m >= n ? 0 : nb_in[row * nseg0 + 2 * w + 1];
  const int64_t ro = row * n;
  float* r1 = g_r1 + ro + base;
  R2* r2 = g_r2 + ro + base;
  int dst0 = a, jj = 0;
  if (b > 0) {
    const float lv = Op::value(r1[a - 1], r2[a - 1]);
    const float rv = Op::value(r1[m], r2[m]);
    if (lv < rv) {
      float p1 = Op::merge1(r1[a - 1], r1[m]);
      R2 p2 = Op::merge2(r2[a - 1], r2[m]);
      int li = a - 1;   // leftmost left block in the pool
      jj = 1;           // right blocks in the pool
      // Windows: lane q holds left block li - 1 - q and right block jj + q.
      int wl = 0, wr = 0;
      float l1 = 0.f, rr1 = 0.f, lval = 0.f, rval = 0.f;
      R2 l2 = 0, rr2 = 0;
      auto load_l = [&] {
        const int k = li - 1 - lane;
        if (k >= 0) {
          l1 = r1[k];
          l2 = r2[k];
          lval = Op::value(l1, l2);
        }
        wl = 0;
      };
      auto load_r = [&] {
        const int k = jj + lane;
        if (k < b) {
          rr1 = r1[m + k];
          rr2 = r2[m + k];
          rval = Op::value(rr1, rr2);
        }
        wr = 0;
      };
      load_l();
      load_r();
      while (true) {
        const float gamma = Op::value(p1, p2);
        const float nl = __shfl_sync(0xffffffffu, lval, wl);
        const float nr = __shfl_sync(0xffffffffu, rval, wr);
        const float sl = __shfl_sync(0xffffffffu, l1, wl);
        const float sr = __shfl_sync(0xffffffffu, rr1, wr);
        const R2 cl = __shfl_sync(0xffffffffu, l2, wl);
        const R2 cr = __shfl_sync(0xffffffffu, rr2, wr);
        const bool absorb_l = li > 0 && nl < gamma;
        const bool absorb_r = jj < b && gamma < nr;
        if (!absorb_l && !absorb_r) break;
        if (absorb_l) {
          p1 = Op::merge1(p1, sl);
          p2 = Op::merge2(p2, cl);
          --li;
          if (++wl == 32) load_l();
        }
        if (absorb_r) {
          p1 = Op::merge1(p1, sr);
          p2 = Op::merge2(p2, cr);
          ++jj;
          if (++wr == 32) load_r();
        }
      }
      if (lane == 0) {
        r1[li] = p1;
        r2[li] = p2;
      }
      dst0 = li + 1;
    }
  }
  if (lane == 0) {
    int* info = pair_info + (static_cast<int64_t>(row) * nseg0 + w) * 3;
    info[0] = dst0;
    info[1] = jj;
    info[2] = b;
    nb_out[row * nseg0 + w] = dst0 + b - jj;
  }
}

// Every slot of a level above the tile to its place in the other buffer.
template <class Op>
__global__ void __launch_bounds__(256)
move_kernel(const float* __restrict__ in_r1,
            const typename Op::R2* __restrict__ in_r2,
            const int* __restrict__ in_start, float* __restrict__ out_r1,
            typename Op::R2* __restrict__ out_r2, int* __restrict__ out_start,
            const int* __restrict__ pair_info,
            int64_t n, int lvl, int nseg0) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int row = blockIdx.y;
  if (i >= n) return;
  const int64_t m = int64_t{1} << lvl;
  const int64_t p = i >> (lvl + 1);
  const int64_t base = 2 * m * p;
  const int* info = pair_info + (static_cast<int64_t>(row) * nseg0 + p) * 3;
  const int dst0 = info[0], jj = info[1], b = info[2];
  const int64_t k = i - base;
  int64_t d = -1;
  if (k < m) {
    if (k < dst0) d = i;   // kept left blocks and the pool
  } else if (k - m >= jj && k - m < b) {
    d = base + dst0 + (k - m) - jj;
  }
  if (d < 0) return;
  const int64_t ro = row * n;
  out_r1[ro + d] = in_r1[ro + i];
  out_r2[ro + d] = in_r2[ro + i];
  out_start[ro + d] = in_start[ro + i];
}

// Each position the value of its block (the last block starting at or
// before it).
template <class Op>
__global__ void __launch_bounds__(256)
expand_kernel(const float* __restrict__ g_r1,
              const typename Op::R2* __restrict__ g_r2,
              const int* __restrict__ g_start, const int* __restrict__ nb,
              float* __restrict__ out, int64_t n, int nseg0) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int row = blockIdx.y;
  if (i >= n) return;
  const int64_t ro = row * n;
  int lo = 0, hi = nb[row * nseg0] - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (g_start[ro + mid] <= i) lo = mid; else hi = mid - 1;
  }
  out[ro + i] = Op::value(g_r1[ro + lo], g_r2[ro + lo]);
}

template <class Op>
size_t tile_smem_bytes(int tile) {
  return static_cast<size_t>(tile) * (4 + sizeof(typename Op::S2) + 2) +
         static_cast<size_t>((tile + 1) / 2) * 2 * 4;
}

// Device scratch for a (rows, n) problem of more than one tile: two
// buffers of (r1, r2, start) slots (4 bytes each), two of segment block
// counts, and the pairs' (dst0, j, b).  The same for both algebras.
template <class Op>
struct Work {
  float* r1[2];
  typename Op::R2* r2[2];
  int* start[2];
  int* nb[2];
  int* pair_info;
};

int64_t n_tiles_of(int64_t n) { return (n + kTile - 1) / kTile; }

// Merge levels above the tile: log2(n) rounded up, less kTileLog.
int levels_above_tile(int64_t n) {
  int levels = 0;
  while ((int64_t{1} << (kTileLog + levels)) < n) ++levels;
  return levels;
}

size_t work_bytes(int64_t rows, int64_t n) {
  if (n <= kTile) return 0;
  const int64_t nseg0 = n_tiles_of(n);
  return static_cast<size_t>(rows) *
         (2 * n * 12 + 2 * nseg0 * 4 + nseg0 * 12);
}

template <class Op>
Work<Op> carve(void* work, int64_t rows, int64_t n) {
  static_assert(sizeof(typename Op::R2) == 4, "4-byte second registers");
  const int64_t nseg0 = n_tiles_of(n);
  char* p = static_cast<char*>(work);
  Work<Op> w;
  for (int k = 0; k < 2; ++k) {
    w.r1[k] = reinterpret_cast<float*>(p);
    p += rows * n * 4;
    w.r2[k] = reinterpret_cast<typename Op::R2*>(p);
    p += rows * n * 4;
    w.start[k] = reinterpret_cast<int*>(p);
    p += rows * n * 4;
  }
  for (int k = 0; k < 2; ++k) {
    w.nb[k] = reinterpret_cast<int*>(p);
    p += rows * nseg0 * 4;
  }
  w.pair_info = reinterpret_cast<int*>(p);
  return w;
}

template <class Op>
int launch(const float* x0, const float* x1, float* out, void* work,
           int64_t rows, int64_t n, cudaStream_t stream) {
  if (rows == 0 || n == 0) return 0;
  if (rows > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int tile = static_cast<int>(n <= kTile ? n : kTile);
  const int n_tiles = static_cast<int>(n_tiles_of(n));
  const size_t smem = tile_smem_bytes<Op>(tile);
  cudaError_t err = cudaFuncSetAttribute(
      tile_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 tgrid(n_tiles, static_cast<unsigned>(rows));
  if (n_tiles == 1) {
    tile_kernel<Op><<<tgrid, kThreads, smem, stream>>>(
        x0, x1, out, nullptr, nullptr, nullptr, nullptr, n, tile, 1);
    return static_cast<int>(cudaGetLastError());
  }
  Work<Op> w = carve<Op>(work, rows, n);
  tile_kernel<Op><<<tgrid, kThreads, smem, stream>>>(
      x0, x1, out, w.r1[0], w.r2[0], w.start[0], w.nb[0], n, tile, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int cur = 0;
  const int top = kTileLog + levels_above_tile(n);
  for (int lvl = kTileLog; lvl < top; ++lvl) {
    const int64_t npairs = (n + (int64_t{2} << lvl) - 1) >> (lvl + 1);
    const dim3 mgrid(static_cast<unsigned>((npairs * 32 + 255) / 256),
                     static_cast<unsigned>(rows));
    merge_kernel<Op><<<mgrid, 256, 0, stream>>>(
        w.r1[cur], w.r2[cur], w.nb[cur], w.nb[1 - cur], w.pair_info, n, lvl,
        n_tiles, npairs);
    const dim3 vgrid(static_cast<unsigned>((n + 255) / 256),
                     static_cast<unsigned>(rows));
    move_kernel<Op><<<vgrid, 256, 0, stream>>>(
        w.r1[cur], w.r2[cur], w.start[cur], w.r1[1 - cur], w.r2[1 - cur],
        w.start[1 - cur], w.pair_info, n, lvl, n_tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    cur = 1 - cur;
  }
  const dim3 egrid(static_cast<unsigned>((n + 255) / 256),
                   static_cast<unsigned>(rows));
  expand_kernel<Op><<<egrid, 256, 0, stream>>>(
      w.r1[cur], w.r2[cur], w.start[cur], w.nb[cur], out, n, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes.  y, s, w and out are (rows, n)
// f32, C-contiguous, on the current device; `work` holds at least
// pav_scan_<reg>_work_bytes(rows, n) bytes, 16-byte aligned (none when
// n <= 16384).  Returns the first launch's cudaError_t that is not 0.
// CUDA kernels one launch makes on rows of n (either instantiation): the
// tile kernel alone where a row fits one tile, else the tile kernel, a
// merge and a move kernel for each level above the tile, and the expand
// kernel.
extern "C" int pav_scan_kernels(int64_t n) {
  return n <= kTile ? 1 : 2 + 2 * levels_above_tile(n);
}

extern "C" int64_t pav_scan_l2_work_bytes(int64_t rows, int64_t n) {
  return static_cast<int64_t>(work_bytes(rows, n));
}

extern "C" int pav_scan_l2_launch(const float* y, float* out, void* work,
                                  int64_t rows, int64_t n,
                                  cudaStream_t stream) {
  return launch<L2Algebra>(y, nullptr, out, work, rows, n, stream);
}

extern "C" int64_t pav_scan_kl_work_bytes(int64_t rows, int64_t n) {
  return static_cast<int64_t>(work_bytes(rows, n));
}

extern "C" int pav_scan_kl_launch(const float* s, const float* w, float* out,
                                  void* work, int64_t rows, int64_t n,
                                  cudaStream_t stream) {
  return launch<KlAlgebra>(s, w, out, work, rows, n, stream);
}
