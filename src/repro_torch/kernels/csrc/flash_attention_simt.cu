// Flash attention forward for every dtype and width that the wgmma kernel
// (csrc/flash_attention.cu) is not built for, on Hopper (sm_90a): f32 or
// bf16 in, the input dtype out, any (D, Dv) that are multiples of 8 up to
// 256, any G = H / Hkv, causal or not, a causal sliding window, a logit
// soft-cap and a query offset.  Two paths, one by dtype:
//
//   * f32 ("ffma"): a register-tiled flash attention on the CUDA cores,
//     every product and sum an FFMA in f32 (no TF32, no tensor cores), so
//     that an f32 model on the card matches the same model on the CPU to
//     f32 rounding;
//   * bf16 ("mma"): the same algorithm on the tensor cores with
//     mma.sync.m16n8k16 (bf16 operands, f32 accumulators), at every
//     multiple of 8 that the wgmma kernel's five instantiations lack.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_tpu (body _flash_kernel) wherever the wgmma kernel cannot:
// that kernel takes bf16 alone (wgmma has no f32 operands, only TF32, which
// keeps 10 bits of mantissa) and is instantiated for five (D, Dv) widths.
// The TPU kernel casts q, k and v to f32 inside and takes any width, and so
// do the reference's models, whose f32 configs (every smoke config, the
// example programs, any `--set dtype=float32`) run attention at widths 16,
// (24, 16), 32 and 64.  kernels/flash_attention.py::route picks the kernel
// by one static rule on (dtype, D, Dv), and simt_plan picks this kernel's
// launch plan (path, rows a block, keys a tile, stages, shared bytes) on the
// host; the entry point refuses a plan it cannot run.
//
// Layout (the JAX one): q (B, Sq, H, D), k (B, Skv, Hkv, D),
// v (B, Skv, Hkv, Dv), out (B, Sq, H, Dv), C-contiguous and 16-byte
// aligned; query head h = hkv * G + g attends to kv head hkv; scores scaled
// by 1 / sqrt(D).  Query i sits at position p = q_offset + i; causal keeps
// the keys at positions <= p; a window W > 0 (causal only) keeps
// p - W + 1 .. p; a soft-cap c > 0 replaces each scaled score s by
// c * tanh(s / c) before the mask.  Every query must see a key (the
// wrapper checks it).
//
// Shared design.  A block takes one (batch, kv head) and `rows`
// consecutive rows of its (position, group) pairs (row = position * G + g,
// so the G query heads of a kv head share every K/V tile), the last rows
// first (under the causal mask they see the most keys).  Q stays in shared
// memory; K and V go through a ring of `stages` tiles of 64 keys, copied
// with 16-byte cp.async.cg straight into the layout that is read (each
// thread's chunk walk set up once, no division a tile).  One block barrier
// a tile: after it, the next tile's copies go into the stage that the last
// tile used, in flight while this one is computed.  Only the tiles that
// the block's rows can see are loaded (causal stops at the last position, a
// window starts at the first position's first key).  The online softmax
// keeps each row's running max m and sum l in f32, all the thread's rows
// side by side with no branch (a row still at -inf takes 0 as its base, so
// its p and rescale come out 0, and a row with no key in a tile keeps its
// state); the soft-cap and the mask run in loops of their own, tested once
// a tile (a tile that no row needs masked skips the mask), so that the
// unrolled score loops are not cut into a block a score.
//
// f32 path ("ffma"): what bounds it is FFMA issue, 2 (D + Dv) FLOPs a
// (query, key) pair against ~67 TFLOP/s, and the shared-memory loads that
// feed them.  128 threads are 8 row groups x 16 lanes.  For S = Q K^T a
// thread owns M rows (ty + 8 i; M = 8, 4 or 2 for 64-, 32- and 16-row
// blocks) x 4 keys (tx + 16 j) and walks D four columns at a time with one
// pointer a row and a key: M + 4 float4 loads feed 16 M FFMA (M = 8: 12
// loads, 128 FFMA; the old kernel did 1 load for 4 FFMA and a shuffle per
// key and row).  Rows are padded to D + 4 floats, so the 16-byte reads of
// 8 lanes fall in distinct banks.  The tile's P goes to shared memory
// once, and is read back by the half-warp that wrote it (a __syncwarp, no
// block barrier); then O += P V is a second register-tiled outer product
// in which the thread owns the same M rows x 4 NG columns (a lane past Dv
// reads the last 4 columns and never stores them), so the softmax's
// rescaling stays in its registers.  A row's max is reduced by 4 shuffles
// over the 16 lanes that share it; its sum is kept per lane and reduced
// once at the end.  expf, not exp2 of a rescaled score, keeps the CPU's
// rounding of the weights.
//
// bf16 path ("mma"): what bounds it at these widths is bytes or, for long
// rows, the tensor cores.  4 warps; each owns MT m16 tiles of rows (MT = 2
// in 128-row blocks, where Dv <= 128, so that each K and V fragment feeds
// two products).  S = Q K^T is mma.sync with Q and K fragments from
// ldmatrix (rows padded by 16 bytes, conflict-free); where D is a multiple
// of 8 but not of 16 the last k-step reads zero columns written once at the
// start.  The softmax runs on the f32 accumulators in place (ex2.approx of
// scores pre-scaled by log2 e); P is rounded to bf16 and fed back as the A
// operand of O += P V, whose V fragments come from ldmatrix.trans in pairs
// of n8 tiles (Dv / 8 rounded up to even; an odd Dv's last tile is never
// stored).  A grid too small to fill the card takes 32- or 16-row blocks
// whose 2 or 4 warps of a row group split the keys, a step of the ring
// holding one 64-key tile for each, and merge their (m, l, O) through
// shared memory at the end.  The output is rounded once.

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWidth = 256;
constexpr int kKeys = 64;                  // keys a tile, both paths
constexpr int kSmemLimit = 232448;         // 227 KB a block on the H100
constexpr int kFfmaThreads = 128;          // 8 row groups x 16 lanes
constexpr int kRowGroups = kFfmaThreads / 16;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  int b, sq, skv, h, hkv, d, dv;
  int causal, window, q_offset;
  float scale, softcap;
  int rows;        // query rows a block
  int stages;      // K/V tiles in flight
  int row_tiles;   // row blocks a (batch, kv head)
};

// Where a block's rows and keys lie, shared by both paths.
struct BlockRange {
  int bi, kh, row0, rows_total, g, t_begin, t_end;
};

__device__ __forceinline__ BlockRange block_range(const Params& p) {
  BlockRange r;
  r.g = p.h / p.hkv;
  const int pairs = p.b * p.hkv;
  r.bi = (blockIdx.x % pairs) / p.hkv;
  r.kh = blockIdx.x % p.hkv;
  const int tile = p.row_tiles - 1 - static_cast<int>(blockIdx.x / pairs);
  r.rows_total = p.sq * r.g;
  r.row0 = tile * p.rows;
  const int last_row = min(r.row0 + p.rows, r.rows_total) - 1;
  const int p_lo = p.q_offset + r.row0 / r.g;
  const int p_hi = p.q_offset + last_row / r.g;
  const int k_end = p.causal ? min(p.skv, p_hi + 1) : p.skv;
  const int k_begin = p.window > 0 ? max(0, p_lo - p.window + 1) : 0;
  r.t_begin = k_begin / kKeys;
  r.t_end = (k_end + kKeys - 1) / kKeys;
  return r;
}

__device__ __forceinline__ bool key_seen(const Params& p, int kp, int pos) {
  return kp < p.skv && (!p.causal || kp <= pos) &&
         (p.window == 0 || kp > pos - p.window);
}

// True when every key of [k0, k0 + kKeys) is seen by every position in
// [pos_lo, pos_hi]: the tile needs no mask.
__device__ __forceinline__ bool tile_unmasked(const Params& p, int k0,
                                              int pos_lo, int pos_hi) {
  return k0 + kKeys <= p.skv && (!p.causal || k0 + kKeys - 1 <= pos_lo) &&
         (p.window == 0 || k0 > pos_hi - p.window);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;   // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}



// A 16-byte cp.async copy of key rows [first, first + nrows) of one (batch,
// kv head) from device memory (row r at base + r * pitch, `width` elements)
// into shared memory (row stride `stride`); rows at or past `limit` are
// zero-filled.  Each thread's (row, chunk) walk is set up once, so a tile
// costs no division.
template <typename T>
struct TileCopy {
  static constexpr int kPer = 16 / sizeof(T);
  const T* base;
  int64_t pitch;
  int stride, chunks, r0, c0, dr, dc;

  __device__ TileCopy(const T* base_, int64_t pitch_, int stride_, int width)
      : base(base_), pitch(pitch_), stride(stride_), chunks(width / kPer) {
    r0 = threadIdx.x / chunks;
    c0 = threadIdx.x % chunks;
    dr = blockDim.x / chunks;
    dc = blockDim.x % chunks;
  }

  __device__ __forceinline__ void operator()(T* dst, int first, int nrows,
                                             int limit) const {
    int r = r0, c = c0;
    while (r < nrows) {
      const int kp = first + r;
      const bool ok = kp < limit;
      cp_async16(dst + r * stride + c * kPer,
                 ok ? base + kp * pitch + c * kPer : base, ok);
      r += dr;
      c += dc;
      if (c >= chunks) {
        c -= chunks;
        ++r;
      }
    }
  }
};

// The block's Q rows: row r -> position r / G, head kh * G + r % G.
template <typename T>
__device__ __forceinline__ void copy_q_rows(T* dst, int stride, const T* q,
                                            const Params& p,
                                            const BlockRange& br) {
  constexpr int kPer = 16 / sizeof(T);
  const int chunks = p.d / kPer;
  for (int i = threadIdx.x; i < p.rows * chunks; i += blockDim.x) {
    const int r = i / chunks, c = (i % chunks) * kPer;
    const int row = br.row0 + r;
    const bool ok = row < br.rows_total;
    const T* src = q;
    if (ok) {
      const int64_t pos = row / br.g, head = br.kh * br.g + row % br.g;
      src = q + ((br.bi * static_cast<int64_t>(p.sq) + pos) * p.h + head) *
                    p.d + c;
    }
    cp_async16(dst + r * stride + c, src, ok);
  }
}

// ---------------------------------------------------------------------------
// f32: register-tiled FFMA.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// M: rows a thread (ty + 8 i, i < M: rows = 8 M); NG: float4 column groups
// of O a thread (columns 4 (tx + 16 j), j < NG, so Dv <= 64 NG).
template <int M, int NG>
__global__ void __launch_bounds__(kFfmaThreads, 2)
attention_simt_ffma(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out,
                    Params p) {
  constexpr int kKeysPerLane = kKeys / 16;
  extern __shared__ __align__(16) float smem[];
  const int qstride = p.d + 4, kstride = p.d + 4, vstride = p.dv;
  constexpr int pstride = kKeys + 4;
  float* qs = smem;                                   // rows x (d + 4)
  float* ks = qs + p.rows * qstride;                  // stages x 64 x (d + 4)
  float* vs = ks + p.stages * kKeys * kstride;        // stages x 64 x dv
  float* ps = vs + p.stages * kKeys * vstride;        // rows x 68

  const BlockRange br = block_range(p);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t kv_row = static_cast<int64_t>(br.bi) * p.skv * p.hkv + br.kh;
  const TileCopy<float> kcopy(k + kv_row * p.d, p.hkv * p.d, kstride, p.d);
  const TileCopy<float> vcopy(v + kv_row * p.dv, p.hkv * p.dv, vstride,
                              p.dv);

  copy_q_rows(qs, qstride, q, p, br);
  kcopy(ks, br.t_begin * kKeys, kKeys, p.skv);
  vcopy(vs, br.t_begin * kKeys, kKeys, p.skv);
  cp_async_commit();

  int pos[M];
  float m[M], l[M];
  float4 o[M][NG];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const int row = min(br.row0 + ty + kRowGroups * i, br.rows_total - 1);
    pos[i] = p.q_offset + row / br.g;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NG; ++j) o[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  bool col_ok[NG];
  int col[NG];
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    col_ok[j] = 4 * (tx + 16 * j) < p.dv;
    col[j] = min(4 * (tx + 16 * j), p.dv - 4);
  }
  const int pos_lo = p.q_offset + br.row0 / br.g;
  const int pos_hi =
      p.q_offset + (min(br.row0 + p.rows, br.rows_total) - 1) / br.g;

  for (int t = br.t_begin; t < br.t_end; ++t) {
    const int stage = (t - br.t_begin) % p.stages;
    const int k0 = t * kKeys;
    cp_async_wait_all();
    // This tile (and Q) landed in every thread's view, and every thread is
    // done with the last one: with two stages the next tile goes into its
    // stage now, in flight while this one is computed.
    __syncthreads();
    if (p.stages == 2 && t + 1 < br.t_end) {
      kcopy(ks + (1 - stage) * kKeys * kstride, (t + 1) * kKeys, kKeys, p.skv);
      vcopy(vs + (1 - stage) * kKeys * vstride, (t + 1) * kKeys, kKeys, p.skv);
      cp_async_commit();
    }
    const float* kt = ks + stage * kKeys * kstride;
    const float* vt = vs + stage * kKeys * vstride;

    // S = Q K^T on the thread's M rows x 4 keys, 8 columns a step.
    float s[M][kKeysPerLane];
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int j = 0; j < kKeysPerLane; ++j) s[i][j] = 0.f;
    }
    // One pointer a row and a key, stepped along D.
    const float* qp[M];
    const float* kp[kKeysPerLane];
#pragma unroll
    for (int i = 0; i < M; ++i) qp[i] = qs + (ty + kRowGroups * i) * qstride;
#pragma unroll
    for (int j = 0; j < kKeysPerLane; ++j) kp[j] = kt + (tx + 16 * j) * kstride;
    for (int c = 0; c < p.d; c += 8) {
#pragma unroll
      for (int half = 0; half < 8; half += 4) {
        float4 qv[M], kv[kKeysPerLane];
#pragma unroll
        for (int i = 0; i < M; ++i) {
          qv[i] = *reinterpret_cast<const float4*>(qp[i] + half);
        }
#pragma unroll
        for (int j = 0; j < kKeysPerLane; ++j) {
          kv[j] = *reinterpret_cast<const float4*>(kp[j] + half);
        }
#pragma unroll
        for (int i = 0; i < M; ++i) {
#pragma unroll
          for (int j = 0; j < kKeysPerLane; ++j) {
            s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
            s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
            s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
            s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < M; ++i) qp[i] += 8;
#pragma unroll
      for (int j = 0; j < kKeysPerLane; ++j) kp[j] += 8;
    }

    // Online softmax, the M rows side by side (no branch, so that their
    // shuffle and exp chains overlap); P to shared memory.  A row whose
    // max is still -inf takes 0 as its base: its p and alpha come out 0,
    // and a row with no key in this tile keeps its state (alpha 1, p 0).
    // The soft-cap and the mask each in a loop of its own, tested once a
    // tile: a test inside the unrolled loop would cut it into a block a
    // score.
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int j = 0; j < kKeysPerLane; ++j) s[i][j] *= p.scale;
    }
    if (p.softcap > 0.f) {
#pragma unroll
      for (int i = 0; i < M; ++i) {
#pragma unroll
        for (int j = 0; j < kKeysPerLane; ++j) {
          s[i][j] = p.softcap * tanhf(s[i][j] / p.softcap);
        }
      }
    }
    if (!tile_unmasked(p, k0, pos_lo, pos_hi)) {
#pragma unroll
      for (int i = 0; i < M; ++i) {
#pragma unroll
        for (int j = 0; j < kKeysPerLane; ++j) {
          if (!key_seen(p, k0 + tx + 16 * j, pos[i])) s[i][j] = -INFINITY;
        }
      }
    }
    float tile_max[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      tile_max[i] = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
#pragma unroll
      for (int i = 0; i < M; ++i) {
        tile_max[i] = fmaxf(tile_max[i],
                            __shfl_xor_sync(0xffffffffu, tile_max[i], off));
      }
    }
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const float m_new = fmaxf(m[i], tile_max[i]);
      const float base = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - base);
      float pj[kKeysPerLane];
      float* prow = ps + (ty + kRowGroups * i) * pstride + tx;
#pragma unroll
      for (int j = 0; j < kKeysPerLane; ++j) {
        pj[j] = expf(s[i][j] - base);
        prow[16 * j] = pj[j];
      }
      l[i] = l[i] * alpha + ((pj[0] + pj[1]) + (pj[2] + pj[3]));
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        o[i][j].x *= alpha;
        o[i][j].y *= alpha;
        o[i][j].z *= alpha;
        o[i][j].w *= alpha;
      }
    }
    __syncwarp();   // a row's P is written and read by its own half-warp

    // O += P V on the thread's M rows x 4 NG columns, 4 keys a step.  A
    // lane past Dv reads the last 4 columns instead (never stored), so
    // that no load is predicated.
    const float* prow = ps + ty * pstride;
    const float* vrow = vt;
    // Keys past the last one seen: P is 0 there (and V too past Skv).
    const int k_last = min(min(kKeys, p.skv - k0),
                           p.causal ? pos_hi + 1 - k0 : kKeys);
    for (int kk = 0; kk < k_last; kk += 4) {
      float4 pv[M];
#pragma unroll
      for (int i = 0; i < M; ++i) {
        pv[i] = *reinterpret_cast<const float4*>(
            prow + kRowGroups * i * pstride + kk);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e, vrow += vstride) {
        float4 vv[NG];
#pragma unroll
        for (int j = 0; j < NG; ++j) {
          vv[j] = *reinterpret_cast<const float4*>(vrow + col[j]);
        }
#pragma unroll
        for (int i = 0; i < M; ++i) {
          const float pe = e == 0   ? pv[i].x
                           : e == 1 ? pv[i].y
                           : e == 2 ? pv[i].z
                                    : pv[i].w;
#pragma unroll
          for (int j = 0; j < NG; ++j) {
            o[i][j].x = fmaf(pe, vv[j].x, o[i][j].x);
            o[i][j].y = fmaf(pe, vv[j].y, o[i][j].y);
            o[i][j].z = fmaf(pe, vv[j].z, o[i][j].z);
            o[i][j].w = fmaf(pe, vv[j].w, o[i][j].w);
          }
        }
      }
    }
    if (p.stages == 1 && t + 1 < br.t_end) {
      __syncthreads();   // every thread is done with the one stage
      kcopy(ks, (t + 1) * kKeys, kKeys, p.skv);
      vcopy(vs, (t + 1) * kKeys, kKeys, p.skv);
      cp_async_commit();
    }
  }

#pragma unroll
  for (int i = 0; i < M; ++i) {
    const float total = half_warp_sum(l[i]);
    const int row = br.row0 + ty + kRowGroups * i;
    if (row >= br.rows_total) continue;
    const int64_t head = br.kh * br.g + row % br.g;
    float* o_row = out + ((br.bi * static_cast<int64_t>(p.sq) + row / br.g) *
                              p.h + head) * p.dv;
    const float inv = 1.f / total;
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      if (!col_ok[j]) continue;
      const float4 r = make_float4(o[i][j].x * inv, o[i][j].y * inv,
                                   o[i][j].z * inv, o[i][j].w * inv);
      *reinterpret_cast<float4*>(o_row + 4 * (tx + 16 * j)) = r;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync.m16n8k16 on the tensor cores.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c += a b: a 16x16 (row), b 16x8 (col), bf16; c 16x8 f32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float ex2(float x) {   // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__host__ __device__ __forceinline__ int round16(int x) {
  return (x + 15) / 16 * 16;
}
// Row strides in bf16 elements: a multiple of 8 whose 16-byte count is odd,
// so the 8 rows of an ldmatrix fall in distinct banks.
__host__ __device__ __forceinline__ int mma_qk_stride(int d) {
  return round16(d) + 8;
}
__host__ __device__ __forceinline__ int mma_v_stride(int dv) {
  return (dv / 8) % 2 ? dv : dv + 8;
}

constexpr int kMmaWarps = 4;
// n8 tiles of O a warp holds: Dv / 8 rounded up to even, so that P V reads
// V in pairs of tiles (ldmatrix x4); where Dv / 8 is odd the last tile reads
// the next 8 columns (of the next row, or of 16 bytes past the ring) and is
// never stored.
__host__ __device__ __forceinline__ int mma_o_tiles(int dv) {
  return (dv / 8 + 1) / 2 * 2;
}
// Floats a lane of a split warp hands to its row group's first warp for
// one m16 tile: its O fragments (NT n8 tiles x 4), m and l of its two rows.
__host__ __device__ __forceinline__ int mma_merge_floats(int nt) {
  return 4 * nt + 4;
}

// NT: n8 tiles of O a warp holds (mma_o_tiles); MT: m16 tiles of rows a
// warp holds (2 only where NT <= 16: its S and O registers), so that each
// K and V fragment feeds MT products.  The block's 4 warps are
// rows / (16 MT) row groups x splits = 64 MT / rows key splits: a step of
// the ring holds 64 splits keys, split s of each row group takes the step's
// s-th tile of 64, and at the end the splits of a row group merge their
// (m, l, O) through shared memory.
template <int NT, int MT>
__global__ void __launch_bounds__(kMmaWarps * 32)
attention_simt_mma(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ out, Params p) {
  constexpr int kNt = kKeys / 8;     // n8 tiles of S
  extern __shared__ __align__(16) __nv_bfloat16 smem_h[];
  const int splits = kKeys * MT / p.rows;
  const int step_keys = kKeys * splits;
  const int d16 = round16(p.d);
  const int qstride = mma_qk_stride(p.d), kstride = qstride;
  const int vstride = mma_v_stride(p.dv);
  __nv_bfloat16* qs = smem_h;                          // rows x qstride
  __nv_bfloat16* ks = qs + p.rows * qstride;   // stages x step_keys x kstride
  __nv_bfloat16* vs = ks + p.stages * step_keys * kstride;

  const BlockRange br = block_range(p);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp / splits, sp = warp % splits;
  const int gid = lane / 4, tig = lane % 4;
  const int64_t kv_row = static_cast<int64_t>(br.bi) * p.skv * p.hkv + br.kh;
  const TileCopy<__nv_bfloat16> kcopy(k + kv_row * p.d, p.hkv * p.d,
                                      kstride, p.d);
  const TileCopy<__nv_bfloat16> vcopy(v + kv_row * p.dv, p.hkv * p.dv,
                                      vstride, p.dv);
  const int k_limit = min(p.skv, br.t_end * kKeys);
  const int steps = (br.t_end - br.t_begin + splits - 1) / splits;

  // Zero columns d .. d16 of Q and of every K row of the ring: cp.async
  // never writes them, and the last k-step of Q K^T reads them.
  if (d16 != p.d) {
    const int nrows = p.rows + p.stages * step_keys;
    for (int r = threadIdx.x; r < nrows; r += blockDim.x) {
      __nv_bfloat16* row = r < p.rows ? qs + r * qstride
                                      : ks + (r - p.rows) * kstride;
      *reinterpret_cast<uint4*>(row + p.d) = make_uint4(0, 0, 0, 0);
    }
  }
  copy_q_rows(qs, qstride, q, p, br);
  kcopy(ks, br.t_begin * kKeys, step_keys, k_limit);
  vcopy(vs, br.t_begin * kKeys, step_keys, k_limit);
  cp_async_commit();

  // The thread's rows: gid and gid + 8 of each of its warp's m16 tiles.
  const int wrow0 = br.row0 + rg * 16 * MT;
  const int last = br.rows_total - 1;
  int pos[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      pos[mt][r] =
          p.q_offset + min(wrow0 + 16 * mt + gid + 8 * r, last) / br.g;
    }
  }
  const int wpos_lo = p.q_offset + min(wrow0, last) / br.g;
  const int wpos_hi = p.q_offset + min(wrow0 + 16 * MT - 1, last) / br.g;
  const float scale2 = p.scale * kLog2e;
  const float sc = p.softcap > 0.f ? 1.f : scale2;
  // m: the running max of the raw scores (log2 units under a soft-cap).
  float m[MT][2], l[MT][2], o[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      o[mt][j][0] = o[mt][j][1] = o[mt][j][2] = o[mt][j][3] = 0.f;
    }
  }
  const __nv_bfloat16* qa =
      qs + (rg * 16 * MT + lane % 16) * qstride + (lane / 16) * 8;

  for (int step = 0; step < steps; ++step) {
    const int stage = step % p.stages;
    cp_async_wait_all();
    __syncthreads();   // as in the f32 kernel
    if (p.stages == 2 && step + 1 < steps) {
      const int first = (br.t_begin + (step + 1) * splits) * kKeys;
      kcopy(ks + (1 - stage) * step_keys * kstride, first, step_keys,
            k_limit);
      vcopy(vs + (1 - stage) * step_keys * vstride, first, step_keys,
            k_limit);
      cp_async_commit();
    }
    const int t = br.t_begin + step * splits + sp;
    if (t < br.t_end) {
      const int k0 = t * kKeys;
      const __nv_bfloat16* kt =
          ks + (stage * step_keys + sp * kKeys) * kstride;
      const __nv_bfloat16* vt =
          vs + (stage * step_keys + sp * kKeys) * vstride;

      // S = Q K^T: 16 MT rows x 64 keys.
      float s[MT][kNt][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
          s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
        }
      }
      const __nv_bfloat16* kb = kt +
                                ((lane % 8) + 8 * (lane / 16)) * kstride +
                                8 * ((lane / 8) % 2);
#pragma unroll 2
      for (int c = 0; c < d16; c += 16) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          ldmatrix_x4(a[mt], qa + mt * 16 * qstride + c);
        }
#pragma unroll
        for (int j = 0; j < kNt; j += 2) {
          uint32_t bk[4];
          ldmatrix_x4(bk, kb + j * 8 * kstride + c);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(s[mt][j], a[mt], bk[0], bk[1]);
            mma_bf16(s[mt][j + 1], a[mt], bk[2], bk[3]);
          }
        }
      }

      // Online softmax on the accumulators: s[mt][j][0..1] row gid,
      // s[mt][j][2..3] row gid + 8, keys k0 + 8 j + 2 tig (+1).
      // p = 2^(x sc - m sc), with x the raw score (sc = scale log2 e) or,
      // under a soft-cap, the capped score in log2 units (sc = 1).
      // The 2 MT rows side by side, with no branch, as in the f32 kernel.
      const bool unmasked = tile_unmasked(p, k0, wpos_lo, wpos_hi);
      float tile_max[MT][2];
      if (p.softcap > 0.f) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int j = 0; j < kNt; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              s[mt][j][e] = p.softcap *
                            tanhf(s[mt][j][e] * p.scale / p.softcap) * kLog2e;
            }
          }
        }
      }
      if (!unmasked) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int j = 0; j < kNt; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (!key_seen(p, k0 + 8 * j + 2 * tig + e % 2, pos[mt][e / 2])) {
                s[mt][j][e] = -INFINITY;
              }
            }
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float x[kNt];
#pragma unroll
          for (int j = 0; j < kNt; ++j) {
            x[j] = fmaxf(s[mt][j][2 * r], s[mt][j][2 * r + 1]);
          }
#pragma unroll
          for (int w = kNt / 2; w > 0; w /= 2) {
#pragma unroll
            for (int j = 0; j < w; ++j) x[j] = fmaxf(x[j], x[j + w]);
          }
          tile_max[mt][r] = x[0];
        }
      }
#pragma unroll
      for (int o2 = 1; o2 <= 2; o2 *= 2) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            tile_max[mt][r] = fmaxf(tile_max[mt][r],
                                    __shfl_xor_sync(0xffffffffu,
                                                    tile_max[mt][r], o2));
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m_new = fmaxf(m[mt][r], tile_max[mt][r]);
          const float ms = m_new == -INFINITY ? 0.f : m_new * sc;
          alpha[r] = ex2(m[mt][r] * sc - ms);
          float x[kNt];
#pragma unroll
          for (int j = 0; j < kNt; ++j) {
            const float p0 = ex2(fmaf(s[mt][j][2 * r], sc, -ms));
            const float p1 = ex2(fmaf(s[mt][j][2 * r + 1], sc, -ms));
            s[mt][j][2 * r] = p0;
            s[mt][j][2 * r + 1] = p1;
            x[j] = p0 + p1;
          }
#pragma unroll
          for (int w = kNt / 2; w > 0; w /= 2) {
#pragma unroll
            for (int j = 0; j < w; ++j) x[j] += x[j + w];
          }
          l[mt][r] = l[mt][r] * alpha[r] + x[0];
          m[mt][r] = m_new;
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          o[mt][j][0] *= alpha[0];
          o[mt][j][1] *= alpha[0];
          o[mt][j][2] *= alpha[1];
          o[mt][j][3] *= alpha[1];
        }
      }

      // O += P V: P (bf16) from the accumulators, V^T fragments by
      // ldmatrix.trans, each feeding the MT m16 tiles; 16 keys a k-step.
      const __nv_bfloat16* vb = vt +
                                ((lane % 8) + 8 * ((lane / 8) % 2)) * vstride +
                                8 * (lane / 16);
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          a[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
          a[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
          a[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
          a[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
        }
        const __nv_bfloat16* vk = vb + kk * 16 * vstride;
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vk + j * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(o[mt][j], a[mt], bv[0], bv[1]);
            mma_bf16(o[mt][j + 1], a[mt], bv[2], bv[3]);
          }
        }
      }
    }
    if (p.stages == 1 && step + 1 < steps) {
      __syncthreads();   // every warp is done with the one stage
      const int first = (br.t_begin + (step + 1) * splits) * kKeys;
      kcopy(ks, first, step_keys, k_limit);
      vcopy(vs, first, step_keys, k_limit);
      cp_async_commit();
    }
  }

  if (splits > 1) {
    // Splits 1.. of each row group hand (O, m, l) to split 0 through the
    // ring, once every warp is done with it.
    __syncthreads();
    float* xs = reinterpret_cast<float*>(ks);
    const int per_lane = MT * mma_merge_floats(NT);
    if (sp > 0) {
      float* mine = xs + ((rg * (splits - 1) + sp - 1) * 32 + lane) * per_lane;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float* part = mine + mt * mma_merge_floats(NT);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          *reinterpret_cast<float4*>(part + 4 * j) = make_float4(
              o[mt][j][0], o[mt][j][1], o[mt][j][2], o[mt][j][3]);
        }
        *reinterpret_cast<float4*>(part + 4 * NT) =
            make_float4(m[mt][0], m[mt][1], l[mt][0], l[mt][1]);
      }
    }
    __syncthreads();
    if (sp > 0) return;
    for (int s2 = 1; s2 < splits; ++s2) {
      const float* other =
          xs + ((rg * (splits - 1) + s2 - 1) * 32 + lane) * per_lane;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* part = other + mt * mma_merge_floats(NT);
        const float4 ml = *reinterpret_cast<const float4*>(part + 4 * NT);
        const float mo[2] = {ml.x, ml.y}, lo[2] = {ml.z, ml.w};
        float a[2], b[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m_new = fmaxf(m[mt][r], mo[r]);
          a[r] = m[mt][r] == -INFINITY ? 0.f : ex2((m[mt][r] - m_new) * sc);
          b[r] = mo[r] == -INFINITY ? 0.f : ex2((mo[r] - m_new) * sc);
          l[mt][r] = l[mt][r] * a[r] + lo[r] * b[r];
          m[mt][r] = m_new;
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float4 x = *reinterpret_cast<const float4*>(part + 4 * j);
          o[mt][j][0] = o[mt][j][0] * a[0] + x.x * b[0];
          o[mt][j][1] = o[mt][j][1] * a[0] + x.y * b[0];
          o[mt][j][2] = o[mt][j][2] * a[1] + x.z * b[1];
          o[mt][j][3] = o[mt][j][3] * a[1] + x.w * b[1];
        }
      }
    }
  }

  const int nv = p.dv / 8;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float inv = 1.f / quad_sum(l[mt][r]);
      const int row = wrow0 + 16 * mt + gid + 8 * r;
      if (row >= br.rows_total) continue;
      const int64_t head = br.kh * br.g + row % br.g;
      __nv_bfloat16* o_row =
          out + ((br.bi * static_cast<int64_t>(p.sq) + row / br.g) * p.h +
                 head) * p.dv + 2 * tig;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j < nv) {
          *reinterpret_cast<__nv_bfloat162*>(o_row + 8 * j) =
              __floats2bfloat162_rn(o[mt][j][2 * r] * inv,
                                    o[mt][j][2 * r + 1] * inv);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: the plan's shared bytes, its check, the launch.
// ---------------------------------------------------------------------------

// Shared bytes of a plan (kernels/flash_attention.py::simt_smem_bytes
// counts the same).  f32: Q, the K/V ring and P, padded rows.  bf16: Q and
// the ring of steps of 64 * splits keys, or Q and the splits' merge area
// if that is larger, and 16 bytes that an odd Dv / 8's last V read may
// touch.
int64_t smem_bytes(int bf16, int rows, int stages, int d, int dv) {
  if (bf16) {
    const int64_t mt = rows == 128 ? 2 : 1;
    const int64_t splits = kKeys * mt / rows;
    const int64_t ring = stages * kKeys * splits *
                         (mma_qk_stride(d) + mma_v_stride(dv));
    const int64_t merge = 2 * (rows / (16 * mt)) * (splits - 1) * 32 * mt *
                          mma_merge_floats(mma_o_tiles(dv));
    return 2 * (static_cast<int64_t>(rows) * mma_qk_stride(d) +
                (ring > merge ? ring : merge)) + 16;
  }
  return 4 * (static_cast<int64_t>(rows) * (d + 4) +
              static_cast<int64_t>(stages) * kKeys * (d + 4 + dv) +
              static_cast<int64_t>(rows) * (kKeys + 4));
}

template <typename Kernel>
int set_smem(Kernel kernel, int64_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

template <int M, int NG>
int launch_ffma(const void* q, const void* k, const void* v, void* out,
                const Params& p, int blocks, int64_t bytes,
                cudaStream_t stream) {
  auto kernel = attention_simt_ffma<M, NG>;
  const int err = set_smem(kernel, bytes);
  if (err) return err;
  kernel<<<blocks, kFfmaThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

template <int NT, int MT>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               const Params& p, int blocks, int64_t bytes,
               cudaStream_t stream) {
  auto kernel = attention_simt_mma<NT, MT>;
  const int err = set_smem(kernel, bytes);
  if (err) return err;
  kernel<<<blocks, kMmaWarps * 32, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes.  q (b, sq, h, d), k (b, skv, hkv,
// d), v (b, skv, hkv, dv), out (b, sq, h, dv), C-contiguous, 16-byte
// aligned, on the current device, all of one dtype: bf16 when `bf16` is 1
// (the mma path), else f32 (the ffma path).  hkv divides h; d and dv are
// multiples of 8 in [8, 256].  Query i sits at position q_offset + i
// (q_offset >= 0).  window > 0 (causal only) keeps the keys of positions
// p - window + 1 .. p, and every query must see one; 0 keeps all.  softcap
// > 0 caps the scaled scores at softcap * tanh(s / softcap); 0 leaves them.
// The plan (kernels/flash_attention.py::simt_plan): `rows` query rows a
// block (ffma 16, 32 or 64, 64 only for dv <= 128; mma 16, 32, 64 or 128,
// 128 only for dv <= 128, the 4 warps of a 16- or 32-row block splitting
// the keys), `keys` a tile (64), `stages` in the ring (1 or 2) and `smem`
// shared bytes, which must equal this file's count and fit in 227 KB.
// Returns the launch's cudaError_t; cudaErrorInvalidValue for arguments or
// a plan it cannot run.
extern "C" int flash_attention_simt_launch(
    const void* q, const void* k, const void* v, void* out, int bf16, int b,
    int sq, int skv, int h, int hkv, int d, int dv, int causal, int window,
    int q_offset, float scale, float softcap, int rows, int keys, int stages,
    int smem, cudaStream_t stream) {
  constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);
  if (b < 0 || sq < 0 || hkv < 1 || h < hkv || h % hkv || skv < 1 ||
      d < 8 || d > kMaxWidth || d % 8 || dv < 8 || dv > kMaxWidth ||
      dv % 8 || window < 0 || q_offset < 0 || !(softcap >= 0.f) ||
      (window > 0 && !causal) ||
      (window > 0 && q_offset + sq - window >= skv)) {
    return kInvalid;
  }
  const bool rows_ok =
      bf16 ? (rows == 16 || rows == 32 || rows == 64 ||
              (rows == 128 && mma_o_tiles(dv) <= 16))
           : (rows == 16 || rows == 32 || (rows == 64 && dv <= 128));
  const int64_t bytes = smem_bytes(bf16, rows, stages, d, dv);
  if (!rows_ok || keys != kKeys || (stages != 1 && stages != 2) ||
      bytes != smem || bytes > kSmemLimit) {
    return kInvalid;
  }
  if (b == 0 || sq == 0) return 0;
  const int64_t row_tiles =
      (static_cast<int64_t>(sq) * (h / hkv) + rows - 1) / rows;
  const int64_t blocks = row_tiles * b * hkv;
  if (blocks > 0x7fffffff) return kInvalid;
  const Params p{b,      sq,     skv,     h,     hkv,    d,
                 dv,     causal, window,  q_offset, scale, softcap,
                 rows,   stages, static_cast<int>(row_tiles)};
  const int nb = static_cast<int>(blocks);
  if (bf16 && rows == 128) {
    switch (mma_o_tiles(dv)) {
#define REPRO_SIMT_MMA(NT) \
  case NT:                 \
    return launch_mma<NT, 2>(q, k, v, out, p, nb, bytes, stream);
      REPRO_SIMT_MMA(2) REPRO_SIMT_MMA(4) REPRO_SIMT_MMA(6) REPRO_SIMT_MMA(8)
      REPRO_SIMT_MMA(10) REPRO_SIMT_MMA(12) REPRO_SIMT_MMA(14)
      REPRO_SIMT_MMA(16)
#undef REPRO_SIMT_MMA
    }
    return kInvalid;
  }
  if (bf16) {
    switch (mma_o_tiles(dv)) {
#define REPRO_SIMT_MMA(NT) \
  case NT:                 \
    return launch_mma<NT, 1>(q, k, v, out, p, nb, bytes, stream);
      REPRO_SIMT_MMA(2) REPRO_SIMT_MMA(4) REPRO_SIMT_MMA(6) REPRO_SIMT_MMA(8)
      REPRO_SIMT_MMA(10) REPRO_SIMT_MMA(12) REPRO_SIMT_MMA(14)
      REPRO_SIMT_MMA(16) REPRO_SIMT_MMA(18) REPRO_SIMT_MMA(20)
      REPRO_SIMT_MMA(22) REPRO_SIMT_MMA(24) REPRO_SIMT_MMA(26)
      REPRO_SIMT_MMA(28) REPRO_SIMT_MMA(30) REPRO_SIMT_MMA(32)
#undef REPRO_SIMT_MMA
    }
    return kInvalid;
  }
  const int groups = (dv + 63) / 64;   // 64-column groups of O
#define REPRO_SIMT_FFMA(M, NG)                                          \
  if (rows == kRowGroups * M && groups == NG) {                         \
    return launch_ffma<M, NG>(q, k, v, out, p, nb, bytes, stream);      \
  }
  REPRO_SIMT_FFMA(2, 1)
  REPRO_SIMT_FFMA(2, 2)
  REPRO_SIMT_FFMA(2, 3)
  REPRO_SIMT_FFMA(2, 4)
  REPRO_SIMT_FFMA(4, 1)
  REPRO_SIMT_FFMA(4, 2)
  REPRO_SIMT_FFMA(4, 3)
  REPRO_SIMT_FFMA(4, 4)
  REPRO_SIMT_FFMA(8, 1)
  REPRO_SIMT_FFMA(8, 2)
#undef REPRO_SIMT_FFMA
  return kInvalid;
}
