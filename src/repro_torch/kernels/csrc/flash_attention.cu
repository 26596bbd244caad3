// Flash attention forward (causal or not, GQA, D != Dv allowed) for Hopper
// (sm_90a), bf16 in and out, f32 softmax state.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_tpu (body _flash_kernel), and with it the attention of
// src/repro/models/layers.py::flash_attention on the serving path.
//
// Layout (the JAX one): q (B, Sq, H, D), k (B, Skv, Hkv, D),
// v (B, Skv, Hkv, Dv), out (B, Sq, H, Dv), all C-contiguous; H = G * Hkv and
// query head h = hkv * G + g attends to kv head hkv.  Scores are scaled by
// 1 / sqrt(D) (the q/k width, not Dv); causal masking is top-left aligned
// (key position <= query position), as in the reference with q_offset 0.
//
// Design: one block of 4 warps per (batch, kv head, query tile).  The block
// holds 64 query rows: all G query groups of its kv head for 64 / G query
// positions, so each K/V tile read from memory serves every group, as the
// TPU kernel's grid cell does.  Each warp owns 16 rows.  The block walks the
// kv tiles of 64 keys in order: K and V tiles go through shared memory
// (16-byte loads, zero-filled past Skv), S = Q K^T and O += P V run on the
// tensor cores with mma.sync m16n8k16 (bf16 operands, f32 accumulation), and
// each row keeps its running max m, sum l and accumulator in f32 registers
// (online softmax).  P is rounded to bf16 for the P V product only.  Under
// the causal mask the loop stops at the last kv tile that the block's last
// query row can see; masked entries inside a tile get probability 0.  A
// ragged Sq or Skv is handled by masking: rows past Sq are neither loaded
// nor stored, keys past Skv are masked.  Shared memory rows are padded by
// 8 elements so the fragment loads of a warp hit 32 distinct banks; at
// D = 192, Dv = 128 the block needs 67 KB, which takes the opt-in above
// 48 KB (cudaFuncSetAttribute).
//
// What bounds it on this card: at the serving prefill shape (8 x 512
// tokens, 16 heads, D 192, Dv 128) the causal work is about 10.7 GFLOP
// (11 us at 989 TFLOP/s) and the bytes that must move about 84 MB (25 us
// at 3.35 TB/s), so the bound is bytes.  This first version is far from
// both: loads are synchronous (no cp.async or TMA double buffering), the
// V fragments are gathered with 16-bit shared loads, and mma.sync reaches
// a fraction of the wgmma rate.  Each K/V tile is read once per query tile
// (8 times per kv head at Sq 512), from L2 after the first.  wgmma with TMA
// and a producer warp is the later step.

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 16 * kWarps;   // query rows per block
constexpr int kKv = 64;              // keys per kv tile
constexpr float kNeg = -1e30f;

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  __nv_bfloat162 h;
  h.x = lo;
  h.y = hi;
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copies `rows` rows of `width` bf16 (a multiple of 8) from global rows at
// src_row(r) into shared rows of `stride` elements; rows whose src_row is
// null are zero-filled.
template <int kWidth, class RowPtr>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int stride,
                                          RowPtr src_row) {
  constexpr int kChunks = kWidth / 8;
  for (int i = threadIdx.x; i < kRows * kChunks; i += kWarps * 32) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const __nv_bfloat16* src = src_row(r);
    uint4 val = make_uint4(0, 0, 0, 0);
    if (src) val = *reinterpret_cast<const uint4*>(src + c * 8);
    *reinterpret_cast<uint4*>(dst + r * stride + c * 8) = val;
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(kWarps * 32)
flash_kernel(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             __nv_bfloat16* __restrict__ out, int sq, int skv, int h,
             int hkv, int causal, float scale) {
  static_assert(kKv == kRows, "load_tile copies kRows rows per tile");
  static_assert(D % 16 == 0 && DV % 8 == 0, "mma tile widths");
  constexpr int kQS = D + 8;    // shared row strides, in elements
  constexpr int kVS = DV + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kRows * kQS;
  __nv_bfloat16* vs = ks + kKv * kQS;

  const int g_count = h / hkv;
  const int bq = kRows / g_count;             // query positions per block
  const int q0 = blockIdx.x * bq;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane / 4;                   // mma row group
  const int tig = lane % 4;                   // thread in group

  // Row r of the block: group r / bq, query position q0 + r % bq.
  load_tile<D>(qs, kQS, [&](int r) -> const __nv_bfloat16* {
    const int qp = q0 + r % bq;
    if (qp >= sq) return nullptr;
    const int head = kvh * g_count + r / bq;
    return q + ((static_cast<int64_t>(b) * sq + qp) * h + head) * D;
  });

  // This thread's two rows (gid and gid + 8 of the warp's 16).
  int qpos[2];
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + gid + 8 * i;
    qpos[i] = q0 + r % bq;
  }
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};
  float acc[DV / 8][4];
  for (int nt = 0; nt < DV / 8; ++nt)
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  const int n_tiles = (skv + kKv - 1) / kKv;
  int last = n_tiles;
  if (causal) {
    const int q_hi = min(q0 + bq, sq) - 1;   // the block's last query
    last = min(n_tiles, q_hi / kKv + 1);
  }

  const __nv_bfloat16* qw = qs + warp * 16 * kQS;
  for (int j = 0; j < last; ++j) {
    __syncthreads();   // the previous tile's K/V (and Q, first) are free
    const int kv0 = j * kKv;
    load_tile<D>(ks, kQS, [&](int r) -> const __nv_bfloat16* {
      const int kp = kv0 + r;
      if (kp >= skv) return nullptr;
      return k + ((static_cast<int64_t>(b) * skv + kp) * hkv + kvh) * D;
    });
    load_tile<DV>(vs, kVS, [&](int r) -> const __nv_bfloat16* {
      const int kp = kv0 + r;
      if (kp >= skv) return nullptr;
      return v + ((static_cast<int64_t>(b) * skv + kp) * hkv + kvh) * DV;
    });
    __syncthreads();

    // S = Q K^T for the warp's 16 rows and the tile's 64 keys.
    float s[kKv / 8][4];
    for (int nt = 0; nt < kKv / 8; ++nt)
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + tig * 2;
      uint32_t a[4];
      a[0] = ld32(qw + gid * kQS + c);
      a[1] = ld32(qw + (gid + 8) * kQS + c);
      a[2] = ld32(qw + gid * kQS + c + 8);
      a[3] = ld32(qw + (gid + 8) * kQS + c + 8);
      for (int nt = 0; nt < kKv / 8; ++nt) {
        const __nv_bfloat16* kr = ks + (nt * 8 + gid) * kQS + c;
        const uint32_t bf[2] = {ld32(kr), ld32(kr + 8)};
        mma_bf16(s[nt], a, bf);
      }
    }

    // Scale, mask, online softmax.  Element e of s[nt] is row gid + 8 *
    // (e / 2), key kv0 + nt * 8 + tig * 2 + e % 2.
    bool keep[kKv / 8][4];
    float row_max[2] = {kNeg, kNeg};
    for (int nt = 0; nt < kKv / 8; ++nt) {
      for (int e = 0; e < 4; ++e) {
        const int kp = kv0 + nt * 8 + tig * 2 + (e & 1);
        const int i = e >> 1;
        keep[nt][e] = kp < skv && (!causal || kp <= qpos[i]);
        s[nt][e] = keep[nt][e] ? s[nt][e] * scale : kNeg;
        row_max[i] = fmaxf(row_max[i], s[nt][e]);
      }
    }
    float alpha[2], row_sum[2] = {0.f, 0.f};
    for (int i = 0; i < 2; ++i) {
      row_max[i] = fmaxf(row_max[i], __shfl_xor_sync(0xffffffff, row_max[i], 1));
      row_max[i] = fmaxf(row_max[i], __shfl_xor_sync(0xffffffff, row_max[i], 2));
      const float m_new = fmaxf(m[i], row_max[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
    for (int nt = 0; nt < kKv / 8; ++nt) {
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        s[nt][e] = keep[nt][e] ? expf(s[nt][e] - m[i]) : 0.f;
        row_sum[i] += s[nt][e];
      }
    }
    for (int i = 0; i < 2; ++i) {
      row_sum[i] += __shfl_xor_sync(0xffffffff, row_sum[i], 1);
      row_sum[i] += __shfl_xor_sync(0xffffffff, row_sum[i], 2);
      l[i] = l[i] * alpha[i] + row_sum[i];
    }
    for (int nt = 0; nt < DV / 8; ++nt) {
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
    }

    // O += P V: the S accumulators of key columns 16 kk .. 16 kk + 15 are
    // exactly the A fragment of the next product.
    for (int kk = 0; kk < kKv / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* v0 = vs + (kk * 16 + tig * 2) * kVS + gid;
      for (int nt = 0; nt < DV / 8; ++nt) {
        const __nv_bfloat16* vc = v0 + nt * 8;
        const uint32_t bf[2] = {pack_bf16(vc[0], vc[kVS]),
                                pack_bf16(vc[8 * kVS], vc[9 * kVS])};
        mma_bf16(acc[nt], a, bf);
      }
    }
  }

  for (int i = 0; i < 2; ++i) {
    if (qpos[i] >= sq) continue;
    const int r = warp * 16 + gid + 8 * i;
    const int head = kvh * g_count + r / bq;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    __nv_bfloat16* o =
        out + ((static_cast<int64_t>(b) * sq + qpos[i]) * h + head) * DV;
    for (int nt = 0; nt < DV / 8; ++nt) {
      *reinterpret_cast<uint32_t*>(o + nt * 8 + tig * 2) =
          pack_bf16(acc[nt][2 * i] * inv, acc[nt][2 * i + 1] * inv);
    }
  }
}

template <int D, int DV>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int skv, int h, int hkv, int causal, float scale,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(__nv_bfloat16) * ((kRows + kKv) * (D + 8) + kKv * (DV + 8));
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bq = kRows / (h / hkv);
  const dim3 grid((sq + bq - 1) / bq, hkv, b);
  flash_kernel<D, DV><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), sq, skv, h, hkv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes.  q (b, sq, h, d), k (b, skv, hkv,
// d), v (b, skv, hkv, dv), out (b, sq, h, dv): bf16, C-contiguous, 16-byte
// aligned, on the current device; h / hkv divides 64.  (d, dv) is
// (192, 128), the MLA widths of the serving path; other widths are one
// more instantiation of the template.  Returns the launch's cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int b, int sq,
                                      int skv, int h, int hkv, int d, int dv,
                                      int causal, float scale,
                                      cudaStream_t stream) {
  if (b == 0 || sq == 0) return 0;
  if (hkv < 1 || h % hkv || kRows % (h / hkv) || skv < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (d == 192 && dv == 128)
    return launch<192, 128>(q, k, v, out, b, sq, skv, h, hkv, causal, scale,
                            stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
