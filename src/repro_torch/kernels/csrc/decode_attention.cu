// Decode attention on Hopper (sm_90a): one query position a sequence
// against its (B, S, Hkv, D) key and value caches, split over the keys
// ("FlashDecoding"), f32 or bf16 in, the input dtype out, with the f32 row
// log-sum-exp beside it.
//
// Replaces no TPU kernel: the reference's decode attention
// (src/repro/models/layers.py::decode_attention) is plain ops, and so was
// the port's until this kernel.  On the card those ops cost far more than
// the work: the two einsums of models/layers.py::_decode_block copy each
// layer's whole cache into batched-matmul layout (at grok-1's (32, 6144, 8,
// 128) bf16, ~9.7 GB read and written a decode step of 6 layers), and the
// products and the softmax run over every position of the cache, valid or
// not.  This kernel reads each valid key and value once, where it lies.
//
// What bounds it: bytes.  A position's K and V are 2 D elements that G = H /
// Hkv query heads each use once for Q K^T and once for P V, so the
// arithmetic is G multiply-adds an element, far below the H100's ~295
// FLOPs a byte for any G a model has.  The least time is the valid K and V
// bytes over 3.35 TB/s.  The design answers that:
//
//   * Grid (blocks of parts, Hkv x row groups, B).  A warp takes one part:
//     a contiguous run of `part_keys` valid positions of one (batch, kv
//     head) for a row group of query heads (16 on the bf16 path, 8 on the
//     f32 one; G > 16 or > 8 takes more row groups), so each K/V tile is
//     read from device memory once for all G heads of its kv head.  The
//     host plan (kernels/decode_attention.py::split_plan) picks the parts
//     from B, Hkv, G and the valid length so that the grid runs several
//     waves of the 132 SMs.
//   * Only the valid positions are visited: [start, start + length), which
//     the wrapper computes from cache_len, the window and the block's
//     offset on a sharded cache.  Skipping masked positions changes no
//     result: the plain path gives them weight exactly 0.
//   * Each warp keeps its own ring of `stages` tiles of 16 positions in
//     shared memory, copied with 16-byte cp.async.cg straight from the
//     cache (a position's D elements are contiguous; the position, head and
//     batch strides are arguments, so a cache is read in place, a sharded
//     block's local tensor too).  A warp waits only on its own copies
//     (cp.async.wait_group, then __syncwarp): no block barrier after the
//     start, so 4 warps a block and 2 or more blocks an SM keep ~2 tiles
//     each in flight.
//   * bf16 (the serving path): S = Q K^T and O += P V on the tensor cores,
//     mma.sync.m16n8k16 with bf16 operands and f32 accumulators, Q (the
//     row group's 16 heads, zero rows past G) and K by ldmatrix, V by
//     ldmatrix.trans, P rounded to bf16 from the accumulators in place.  At
//     G = 6 most of the 16 rows are padding, but the tensor cores have
//     ~100 x the rate the bytes need, and mma keeps the instruction count a
//     byte low (CUDA-core FMAs at G = 6 would take ~70% of the instruction
//     slots at full bandwidth).
//   * f32 (the smoke configs and tests): the same walk on the CUDA cores,
//     every product an FFMA in f32, a lane a key (two lanes a key, each
//     half of D) for the scores, a lane 4 columns of O for P V.
//   * Scores, the online softmax and the partials are f32; scale 1 /
//     sqrt(D); a soft-cap c > 0 applies c tanh(s / c) first.  Each warp
//     writes its unnormalized O, its max m and its sum l to scratch that
//     the wrapper allocates; a second small launch combines a row's parts
//     (weights exp(m_i - m)), writes o in the input dtype and the row's
//     log-sum-exp m + log l.  An empty range gives o = 0 and lse = -inf.
//
// Layout: q (B, H, D) C-contiguous; k and v (B, S, Hkv, D) with the last
// dim contiguous and the other strides (elements) given; o (B, H, D), lse
// (B, H) f32.  Query head h = kv_head * G + g.  Every pointer and stride
// 16-byte aligned.

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;              // parts a block
constexpr int kTileKeys = 16;          // positions a tile
constexpr int kMaxWidth = 256;
constexpr int kSmemLimit = 232448;     // 227 KB a block on the H100
constexpr int kMmaRows = 16;           // query heads a row group, bf16
constexpr int kFfmaRows = 8;           // query heads a row group, f32
constexpr int kCombineThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  int b, h, hkv, d;
  int64_t k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;   // strides, elements
  int start, length;     // valid positions [start, start + length)
  int part_keys, parts;  // positions a part, parts a (batch, head)
  int rows, row_groups, stages;
  float scale, softcap;
};

__host__ __device__ __forceinline__ int round16(int x) {
  return (x + 15) / 16 * 16;
}
// Row strides in elements.  bf16: a multiple of 8 whose 16-byte count is
// odd, so the 8 rows of an ldmatrix fall in distinct banks.  f32: D + 4,
// so that the 16-byte reads of 8 lanes on 8 rows fall in distinct banks.
__host__ __device__ __forceinline__ int row_stride(int bf16, int d) {
  return bf16 ? round16(d) + 8 : d + 4;
}

// Shared bytes of a block (kernels/decode_attention.py::smem_bytes counts
// the same): the row group's Q rows, each warp's ring of `stages` K and V
// tiles and, f32, each warp's P tile (16 keys x 8 heads).
int64_t smem_bytes(int bf16, int d, int stages) {
  const int64_t stride = row_stride(bf16, d);
  if (bf16) {
    return 2 * (kMmaRows * stride +
                static_cast<int64_t>(kWarps) * stages * 2 * kTileKeys * stride);
  }
  return 4 * (kFfmaRows * stride +
              kWarps * (static_cast<int64_t>(stages) * 2 * kTileKeys * stride +
                        kTileKeys * kFfmaRows));
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
// Wait until at most n of this thread's groups are pending (n < 3).
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n >= 2) {
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  } else if (n == 1) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
}

// A warp's 16-byte cp.async copy of one tile: rows [0, kTileKeys) of `d`
// elements from src + r * pitch into dst + r * stride; rows at or past
// `valid` are zero-filled.  Each lane's (row, chunk) walk is set up once.
template <typename T>
struct WarpTileCopy {
  static constexpr int kPer = 16 / sizeof(T);
  int chunks, r0, c0, dr, dc;

  __device__ WarpTileCopy(int d, int lane) : chunks(d / kPer) {
    r0 = lane / chunks;
    c0 = lane % chunks;
    dr = 32 / chunks;
    dc = 32 % chunks;
  }

  __device__ __forceinline__ void operator()(T* dst, int stride, const T* src,
                                             int64_t pitch, int valid) const {
    int r = r0, c = c0;
    while (r < kTileKeys) {
      const bool ok = r < valid;
      cp_async16(dst + r * stride + c * kPer,
                 ok ? src + r * pitch + c * kPer : src, ok);
      r += dr;
      c += dc;
      if (c >= chunks) {
        c -= chunks;
        ++r;
      }
    }
  }
};

// What a warp works on: its batch, kv head, row group, part and the
// positions [k_begin, k_end) of the part.
struct WarpRange {
  int bi, kh, rg, part, g, k_begin, k_end, tiles;
};

__device__ __forceinline__ WarpRange warp_range(const Params& p) {
  WarpRange w;
  w.bi = blockIdx.z;
  w.kh = blockIdx.y / p.row_groups;
  w.rg = blockIdx.y % p.row_groups;
  w.part = blockIdx.x * kWarps + threadIdx.x / 32;
  w.g = p.h / p.hkv;
  const int end = p.start + p.length;
  w.k_begin = min(end, p.start + w.part * p.part_keys);
  w.k_end = min(end, w.k_begin + p.part_keys);
  w.tiles = (w.k_end - w.k_begin + kTileKeys - 1) / kTileKeys;
  return w;
}

// The block's Q rows (the row group's heads; rows past G zero-filled) into
// shared memory, and zero columns d .. stride of every row of Q and of the
// rings that a read past D may touch.  Ends in a block barrier.
template <typename T>
__device__ __forceinline__ void load_q(T* smem, const T* q, const Params& p,
                                       int rows, int ring_rows) {
  constexpr int kPer = 16 / sizeof(T);
  const int stride = row_stride(sizeof(T) == 2, p.d);
  const int chunks = p.d / kPer;
  const int g = p.h / p.hkv;
  const int kh = blockIdx.y / p.row_groups, rg = blockIdx.y % p.row_groups;
  const int pad = round16(p.d) - p.d;   // bf16: 0 or 8 columns read past D
  if (sizeof(T) == 2 && pad) {
    for (int r = threadIdx.x; r < rows + ring_rows; r += blockDim.x) {
      *reinterpret_cast<uint4*>(smem + r * stride + p.d) =
          make_uint4(0, 0, 0, 0);
    }
  }
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int r = i / chunks, c = (i % chunks) * kPer;
    const int head = rg * rows + r;
    const bool ok = head < g;
    const T* src = ok ? q + (static_cast<int64_t>(blockIdx.z) * p.h +
                             kh * g + head) * p.d + c
                      : q;
    cp_async16(smem + r * stride + c, src, ok);
  }
  cp_async_commit();
  cp_async_wait(0);
  __syncthreads();
}

// The warp's tile t of K and V into ring stage s.
template <typename T>
__device__ __forceinline__ void copy_tile(T* ks, T* vs, int stride,
                                          const WarpTileCopy<T>& cp,
                                          const T* k, const T* v,
                                          const Params& p, const WarpRange& w,
                                          int t) {
  const int k0 = w.k_begin + t * kTileKeys;
  const int valid = min(kTileKeys, w.k_end - k0);
  cp(ks, stride, k + w.bi * p.k_sb + k0 * p.k_ss + w.kh * p.k_sh, p.k_ss,
     valid);
  cp(vs, stride, v + w.bi * p.v_sb + k0 * p.v_ss + w.kh * p.v_sh, p.v_ss,
     valid);
}

// A score x (already times the scale) capped and masked: key kk of a tile
// whose first `valid` keys lie in the part.
__device__ __forceinline__ float cap_mask(float x, const Params& p, int kk,
                                          int valid) {
  if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
  return kk < valid ? x : -INFINITY;
}

// Where a part's (O, m, l) for head g of the warp's kv head goes.
__device__ __forceinline__ int64_t part_index(const Params& p,
                                              const WarpRange& w, int g) {
  const int64_t head = static_cast<int64_t>(w.bi) * p.h + w.kh * w.g + g;
  return head * p.parts + w.part;
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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
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

// KS: k16 steps of D (D rounded up to 16, over 16); O holds 2 KS n8 tiles
// (D / 8 rounded up to even; an odd D / 8's last tile reads the zero
// columns past D and is never stored).  A lane holds S and O for heads
// gid and gid + 8 of the row group (gid = lane / 4), keys and columns
// 2 (lane % 4) + {0, 1} of each n8 tile.
template <int KS>
__global__ void __launch_bounds__(kWarps * 32)
decode_split_mma(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 float* __restrict__ part_o, float* __restrict__ part_m,
                 float* __restrict__ part_l, Params p) {
  constexpr int kNt = 2 * KS;
  extern __shared__ __align__(16) __nv_bfloat16 smem_h[];
  const int stride = row_stride(1, p.d);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ring = p.stages * 2 * kTileKeys;   // rows of a warp's ring
  __nv_bfloat16* qs = smem_h;
  __nv_bfloat16* mine = qs + (kMmaRows + warp * ring) * stride;
  load_q(smem_h, q, p, kMmaRows, kWarps * ring);

  const WarpRange w = warp_range(p);
  if (w.part >= p.parts) return;
  const WarpTileCopy<__nv_bfloat16> cp(p.d, lane);
  const int gid = lane / 4, tig = lane % 4;

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[kNt][4];
#pragma unroll
  for (int j = 0; j < kNt; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int s = 0; s < p.stages - 1; ++s) {
    if (s < w.tiles) {
      copy_tile(mine + s * 2 * kTileKeys * stride,
                mine + (s * 2 + 1) * kTileKeys * stride, stride, cp, k, v, p,
                w, s);
    }
    cp_async_commit();
  }
  const __nv_bfloat16* qa = qs + (lane % 16) * stride + (lane / 16) * 8;
  const int k_off =
      ((lane % 8) + 8 * (lane / 16)) * stride + 8 * ((lane / 8) % 2);
  const int v_off =
      ((lane % 8) + 8 * ((lane / 8) % 2)) * stride + 8 * (lane / 16);
  for (int t = 0; t < w.tiles; ++t) {
    const int next = t + p.stages - 1;
    if (next < w.tiles) {
      const int sn = next % p.stages;
      copy_tile(mine + sn * 2 * kTileKeys * stride,
                mine + (sn * 2 + 1) * kTileKeys * stride, stride, cp, k, v, p,
                w, next);
    }
    cp_async_commit();
    cp_async_wait(p.stages - 1);
    __syncwarp();
    const int st = t % p.stages;
    const __nv_bfloat16* kt = mine + st * 2 * kTileKeys * stride;
    const __nv_bfloat16* vt = kt + kTileKeys * stride;
    const int valid = w.k_end - (w.k_begin + t * kTileKeys);

    // S = Q K^T: 16 heads x 16 keys, two n8 tiles.
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int c = 0; c < KS; ++c) {
      uint32_t a[4], bk[4];
      ldmatrix_x4(a, qa + 16 * c);
      ldmatrix_x4(bk, kt + k_off + 16 * c);
      mma_bf16(s[0], a, bk[0], bk[1]);
      mma_bf16(s[1], a, bk[2], bk[3]);
    }

    // Online softmax on the accumulators: s[j][0..1] head gid, s[j][2..3]
    // head gid + 8, keys 8 j + 2 tig (+1); natural-log units.
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = cap_mask(s[j][e] * p.scale, p, 8 * j + 2 * tig + e % 2,
                           valid);
        tmax[e / 2] = fmaxf(tmax[e / 2], s[j][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(tmax[r]));
      const float base = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = ex2((m[r] - base) * kLog2e);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[j][2 * r + e] = ex2((s[j][2 * r + e] - base) * kLog2e);
          sum += s[j][2 * r + e];
        }
      }
      l[r] = l[r] * alpha[r] + sum;
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P V: P (bf16) from the accumulators, V^T fragments by
    // ldmatrix.trans, n8 tiles of O in pairs.
    uint32_t a[4];
    a[0] = pack_bf16(s[0][0], s[0][1]);
    a[1] = pack_bf16(s[0][2], s[0][3]);
    a[2] = pack_bf16(s[1][0], s[1][1]);
    a[3] = pack_bf16(s[1][2], s[1][3]);
#pragma unroll
    for (int j = 0; j < kNt; j += 2) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, vt + v_off + 8 * j);
      mma_bf16(o[j], a, bv[0], bv[1]);
      mma_bf16(o[j + 1], a, bv[2], bv[3]);
    }
    __syncwarp();   // every lane is done with this stage before its refill
  }

  const int nv = p.d / 8;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lsum = quad_sum(l[r]);
    const int g = w.rg * kMmaRows + gid + 8 * r;
    if (g >= w.g) continue;
    const int64_t idx = part_index(p, w, g);
    float* orow = part_o + idx * p.d + 2 * tig;
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
      if (j < nv) {
        *reinterpret_cast<float2*>(orow + 8 * j) =
            make_float2(o[j][2 * r], o[j][2 * r + 1]);
      }
    }
    if (tig == 0) {
      part_m[idx] = m[r];
      part_l[idx] = lsum;
    }
  }
}

// ---------------------------------------------------------------------------
// f32: FFMA on the CUDA cores.
// ---------------------------------------------------------------------------

// NC: groups of 128 columns of O (D up to 128 or 256).  For the scores lane
// i takes key i % 16 and half i / 16 of D; for P V a lane owns columns
// 4 lane + 128 c (c < NC) of each of the 8 heads.
template <int NC>
__global__ void __launch_bounds__(kWarps * 32)
decode_split_ffma(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ part_o,
                  float* __restrict__ part_m, float* __restrict__ part_l,
                  Params p) {
  extern __shared__ __align__(16) float smem_f[];
  const int stride = row_stride(0, p.d);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ring = p.stages * 2 * kTileKeys * stride + kTileKeys * kFfmaRows;
  float* qs = smem_f;
  float* mine = qs + kFfmaRows * stride + warp * ring;
  float* ps = mine + p.stages * 2 * kTileKeys * stride;   // [key][head]
  load_q(smem_f, q, p, kFfmaRows, 0);

  const WarpRange w = warp_range(p);
  if (w.part >= p.parts) return;
  const WarpTileCopy<float> cp(p.d, lane);
  const int key = lane % 16, half = p.d / 2, h0 = (lane / 16) * half;

  float m[kFfmaRows], l[kFfmaRows];
  float4 o[kFfmaRows][NC];
#pragma unroll
  for (int g = 0; g < kFfmaRows; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[g][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int s = 0; s < p.stages - 1; ++s) {
    if (s < w.tiles) {
      copy_tile(mine + s * 2 * kTileKeys * stride,
                mine + (s * 2 + 1) * kTileKeys * stride, stride, cp, k, v, p,
                w, s);
    }
    cp_async_commit();
  }
  for (int t = 0; t < w.tiles; ++t) {
    const int next = t + p.stages - 1;
    if (next < w.tiles) {
      const int sn = next % p.stages;
      copy_tile(mine + sn * 2 * kTileKeys * stride,
                mine + (sn * 2 + 1) * kTileKeys * stride, stride, cp, k, v, p,
                w, next);
    }
    cp_async_commit();
    cp_async_wait(p.stages - 1);
    __syncwarp();
    const int st = t % p.stages;
    const float* kt = mine + st * 2 * kTileKeys * stride;
    const float* vt = kt + kTileKeys * stride;
    const int valid = w.k_end - (w.k_begin + t * kTileKeys);

    // Scores: this lane's half of D for its key, then the two halves.
    float x[kFfmaRows];
#pragma unroll
    for (int g = 0; g < kFfmaRows; ++g) x[g] = 0.f;
    const float* krow = kt + key * stride + h0;
#pragma unroll 2
    for (int c = 0; c < half; c += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(krow + c);
#pragma unroll
      for (int g = 0; g < kFfmaRows; ++g) {
        const float4 qv =
            *reinterpret_cast<const float4*>(qs + g * stride + h0 + c);
        x[g] = fmaf(qv.x, kv.x, x[g]);
        x[g] = fmaf(qv.y, kv.y, x[g]);
        x[g] = fmaf(qv.z, kv.z, x[g]);
        x[g] = fmaf(qv.w, kv.w, x[g]);
      }
    }
    float alpha[kFfmaRows];
#pragma unroll
    for (int g = 0; g < kFfmaRows; ++g) {
      x[g] += __shfl_xor_sync(0xffffffffu, x[g], 16);
      x[g] = cap_mask(x[g] * p.scale, p, key, valid);
      float tmax = x[g];
#pragma unroll
      for (int s = 8; s > 0; s >>= 1) {
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, s));
      }
      const float m_new = fmaxf(m[g], tmax);
      const float base = m_new == -INFINITY ? 0.f : m_new;
      alpha[g] = expf(m[g] - base);
      x[g] = expf(x[g] - base);
      l[g] = l[g] * alpha[g] + x[g];   // this lane's key; summed at the end
      m[g] = m_new;
    }
    if (lane < kTileKeys) {
      *reinterpret_cast<float4*>(ps + lane * kFfmaRows) =
          make_float4(x[0], x[1], x[2], x[3]);
      *reinterpret_cast<float4*>(ps + lane * kFfmaRows + 4) =
          make_float4(x[4], x[5], x[6], x[7]);
    }
    __syncwarp();

    // O = alpha O + P V.
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 4 * lane + 128 * c;
      if (col >= p.d) continue;
#pragma unroll
      for (int g = 0; g < kFfmaRows; ++g) {
        o[g][c].x *= alpha[g];
        o[g][c].y *= alpha[g];
        o[g][c].z *= alpha[g];
        o[g][c].w *= alpha[g];
      }
      for (int j = 0; j < kTileKeys; ++j) {
        const float4 vv = *reinterpret_cast<const float4*>(vt + j * stride +
                                                           col);
        const float4 pa = *reinterpret_cast<const float4*>(ps + j * kFfmaRows);
        const float4 pb =
            *reinterpret_cast<const float4*>(ps + j * kFfmaRows + 4);
        const float pj[kFfmaRows] = {pa.x, pa.y, pa.z, pa.w,
                                     pb.x, pb.y, pb.z, pb.w};
#pragma unroll
        for (int g = 0; g < kFfmaRows; ++g) {
          o[g][c].x = fmaf(pj[g], vv.x, o[g][c].x);
          o[g][c].y = fmaf(pj[g], vv.y, o[g][c].y);
          o[g][c].z = fmaf(pj[g], vv.z, o[g][c].z);
          o[g][c].w = fmaf(pj[g], vv.w, o[g][c].w);
        }
      }
    }
    __syncwarp();   // every lane is done with this stage and P
  }

#pragma unroll
  for (int g = 0; g < kFfmaRows; ++g) {
    // Lanes 0-15 hold the 16 keys' sums (16-31 the same).
    float lsum = lane < kTileKeys ? l[g] : 0.f;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      lsum += __shfl_xor_sync(0xffffffffu, lsum, s);
    }
    const int head = w.rg * kFfmaRows + g;
    if (head >= w.g) continue;
    const int64_t idx = part_index(p, w, head);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 4 * lane + 128 * c;
      if (col < p.d) {
        *reinterpret_cast<float4*>(part_o + idx * p.d + col) = o[g][c];
      }
    }
    if (lane == 0) {
      part_m[idx] = m[g];
      part_l[idx] = lsum;
    }
  }
}

// ---------------------------------------------------------------------------
// The combine: one block a (batch, head) row.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
decode_combine(const float* __restrict__ part_o,
               const float* __restrict__ part_m,
               const float* __restrict__ part_l, T* __restrict__ out,
               float* __restrict__ lse, int parts, int d) {
  const int64_t row = blockIdx.x;
  const float* pm = part_m + row * parts;
  const float* pl = part_l + row * parts;
  float mx = -INFINITY;
  for (int i = 0; i < parts; ++i) mx = fmaxf(mx, pm[i]);
  float total = 0.f;
  for (int i = 0; i < parts; ++i) {
    if (pm[i] != -INFINITY) total += expf(pm[i] - mx) * pl[i];
  }
  const float inv = total > 0.f ? 1.f / total : 0.f;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float acc = 0.f;
    for (int i = 0; i < parts; ++i) {
      if (pm[i] != -INFINITY) {
        acc += expf(pm[i] - mx) * part_o[(row * parts + i) * d + c];
      }
    }
    store(out + row * d + c, acc * inv);
  }
  if (threadIdx.x == 0) lse[row] = total > 0.f ? mx + logf(total) : -INFINITY;
}

template <typename Kernel>
int set_smem(Kernel kernel, int64_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

template <typename Kernel, typename T>
int launch_split(Kernel kernel, const T* q, const T* k, const T* v,
                 float* part_o, float* part_m, float* part_l, const Params& p,
                 int64_t bytes, cudaStream_t stream) {
  const int err = set_smem(kernel, bytes);
  if (err) return err;
  const dim3 grid((p.parts + kWarps - 1) / kWarps, p.hkv * p.row_groups, p.b);
  kernel<<<grid, kWarps * 32, bytes, stream>>>(q, k, v, part_o, part_m,
                                               part_l, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes.  q (b, h, d) C-contiguous; k and
// v (b, s, hkv, d) with the last dim contiguous and the batch, position and
// head strides (elements) given; out (b, h, d) in q's dtype and lse (b, h)
// f32, C-contiguous; every pointer and stride 16-byte aligned, all on the
// current device; bf16 when `bf16` is 1, else f32.  hkv divides h; d is a
// multiple of 8 in [8, 256].  The valid positions are [start, start +
// length) of the cache.  The plan (kernels/decode_attention.py::
// split_plan): `part_keys` positions a part (a multiple of 16), `parts` =
// max(1, ceil(length / part_keys)), `stages` (1 to 3) and `smem` shared
// bytes, which must equal this file's count and fit in 227 KB.  part_o
// (b, h, parts, d), part_m and part_l (b, h, parts) f32 are the scratch.
// Two launches on `stream`; returns the first cudaError_t that is not 0,
// cudaErrorInvalidValue for arguments or a plan it cannot run.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, void* out, float* lse,
    float* part_o, float* part_m, float* part_l, int bf16, int b, int h,
    int hkv, int d, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
    int64_t v_ss, int64_t v_sh, int start, int length, int part_keys,
    int parts, int stages, int smem, float scale, float softcap,
    cudaStream_t stream) {
  constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);
  const int per = bf16 ? 8 : 4;   // elements in 16 bytes
  if (b < 0 || hkv < 1 || h < hkv || h % hkv || d < 8 || d > kMaxWidth ||
      d % 8 || start < 0 || length < 0 || part_keys < kTileKeys ||
      part_keys % kTileKeys || stages < 1 || stages > 3 ||
      !(softcap >= 0.f) || k_sb % per || k_ss % per || k_sh % per ||
      v_sb % per || v_ss % per || v_sh % per) {
    return kInvalid;
  }
  const int64_t want_parts =
      length > 0 ? (static_cast<int64_t>(length) + part_keys - 1) / part_keys
                 : 1;
  const int64_t bytes = smem_bytes(bf16, d, stages);
  if (parts != want_parts || bytes != smem || bytes > kSmemLimit) {
    return kInvalid;
  }
  if (b == 0) return 0;
  const int rows = bf16 ? kMmaRows : kFfmaRows;
  const int row_groups = (h / hkv + rows - 1) / rows;
  if (b > 65535 || static_cast<int64_t>(hkv) * row_groups > 65535) {
    return kInvalid;
  }
  const Params p{b,    h,     hkv,        d,      k_sb,      k_ss,
                 k_sh, v_sb,  v_ss,       v_sh,   start,     length,
                 part_keys, parts, rows, row_groups, stages, scale,
                 softcap};
  int err = kInvalid;
  if (bf16) {
    const auto* qh = static_cast<const __nv_bfloat16*>(q);
    const auto* kh = static_cast<const __nv_bfloat16*>(k);
    const auto* vh = static_cast<const __nv_bfloat16*>(v);
    switch (round16(d) / 16) {
#define REPRO_DECODE_MMA(KS)                                            \
  case KS:                                                              \
    err = launch_split(decode_split_mma<KS>, qh, kh, vh, part_o, part_m, \
                       part_l, p, bytes, stream);                       \
    break;
      REPRO_DECODE_MMA(1) REPRO_DECODE_MMA(2) REPRO_DECODE_MMA(3)
      REPRO_DECODE_MMA(4) REPRO_DECODE_MMA(5) REPRO_DECODE_MMA(6)
      REPRO_DECODE_MMA(7) REPRO_DECODE_MMA(8) REPRO_DECODE_MMA(9)
      REPRO_DECODE_MMA(10) REPRO_DECODE_MMA(11) REPRO_DECODE_MMA(12)
      REPRO_DECODE_MMA(13) REPRO_DECODE_MMA(14) REPRO_DECODE_MMA(15)
      REPRO_DECODE_MMA(16)
#undef REPRO_DECODE_MMA
    }
    if (err) return err;
    decode_combine<__nv_bfloat16><<<b * h, kCombineThreads, 0, stream>>>(
        part_o, part_m, part_l, static_cast<__nv_bfloat16*>(out), lse, parts,
        d);
  } else {
    const auto* qf = static_cast<const float*>(q);
    const auto* kf = static_cast<const float*>(k);
    const auto* vf = static_cast<const float*>(v);
    err = d <= 128 ? launch_split(decode_split_ffma<1>, qf, kf, vf, part_o,
                                  part_m, part_l, p, bytes, stream)
                   : launch_split(decode_split_ffma<2>, qf, kf, vf, part_o,
                                  part_m, part_l, p, bytes, stream);
    if (err) return err;
    decode_combine<float><<<b * h, kCombineThreads, 0, stream>>>(
        part_o, part_m, part_l, static_cast<float*>(out), lse, parts, d);
  }
  return static_cast<int>(cudaGetLastError());
}
