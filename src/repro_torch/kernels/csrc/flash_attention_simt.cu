// Flash attention forward on the CUDA cores, in f32 arithmetic, for Hopper
// (sm_90a): f32 or bf16 in, the input dtype out, any (D, Dv) that are
// multiples of 8 up to 256, any G = H / Hkv, causal or not, a causal
// sliding window, a logit soft-cap and a query offset.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_tpu (body _flash_kernel) wherever the tensor-core kernel
// csrc/flash_attention.cu cannot: that kernel takes bf16 alone (wgmma has
// no f32 operands, only TF32, which keeps 10 bits of mantissa) and is
// instantiated for five (D, Dv) widths, each a shared-memory plan and a
// wgmma shape of its own.  The TPU kernel casts q, k and v to f32 inside
// and takes any width, and so do the reference's models, whose f32 configs
// (every smoke config, the example programs, any `--set dtype=float32`)
// run attention at widths 16, (24, 16), 32 and 64.  This kernel computes
// every product and sum with FFMA on the CUDA cores, never TF32, so that
// an f32 model on the card matches the same model on the CPU to f32
// rounding.  kernels/flash_attention.py::route picks the kernel by one
// static rule on (dtype, D, Dv): bf16 at a built width -> the wgmma
// kernel; f32, or bf16 at another multiple of 8 up to 256 -> this one;
// anything else raises before a launch.
//
// Layout (the JAX one): q (B, Sq, H, D), k (B, Skv, Hkv, D),
// v (B, Skv, Hkv, Dv), out (B, Sq, H, Dv), C-contiguous; query head
// h = hkv * G + g attends to kv head hkv; scores scaled by 1 / sqrt(D).
// Query i sits at position p = q_offset + i; causal keeps the keys at
// positions <= p; a window W > 0 (causal only) keeps p - W + 1 .. p; a
// soft-cap c > 0 replaces each scaled score s by c * tanh(s / c) before the
// mask.  Every query must see a key (the wrapper checks it).
//
// What bounds it on this card: f32 FLOPs.  Each (query, key) pair costs
// 2 (D + Dv) FLOPs of FFMA beside the softmax, against ~67 TFLOP/s of
// non-tensor f32 (NVIDIA's data sheet); the bytes are the inputs once and
// the output once.  At the example programs' shapes (8 x 128 or 8 x 64
// positions, widths 32 and 64) both bounds are microseconds and the
// launch costs more.
//
// Design: simple and right first.  A block of 8 warps takes one (batch,
// kv head) and kRows = 32 consecutive rows of its (position, group) pairs
// (row = position * G + g, so the G query heads of a kv head share every
// K/V tile), the last rows first (under the causal mask they see the most
// keys).  Its Q rows are converted to f32 in shared memory once.  The
// keys go in tiles of 32, one a lane: K (stride D + 4 floats, so that the
// 16-byte reads of 8 lanes hit distinct banks) and V are converted to f32
// into shared memory by the whole block.  Each warp owns 4 rows: lane j
// computes the 4 rows' scores against key j (float4 reads, the Q row a
// broadcast), the warp reduces the tile's max and sum by shuffles, and the
// online softmax (running max m and sum l in f32, expf) rescales each
// row's Dv / 32 accumulators a lane (column lane + 32 c) before adding
// P_j V_j with P_j shuffled from lane j.  Only the key tiles that the
// block's rows can see are loaded: causal stops at its last position,
// a window starts at its first position's first key.  A row with no key
// in a tile leaves its state as it was.

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;   // query rows a block
constexpr int kKeys = 32;                      // keys a tile, one a lane
constexpr int kMaxWidth = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// NC = ceil(Dv / 32): output columns a lane holds per row.
template <typename T, int NC>
__global__ void __launch_bounds__(kWarps * 32)
attention_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out, int b,
                      int sq, int skv, int h, int hkv, int d, int dv,
                      int causal, int window, int q_offset, float scale,
                      float softcap, int row_tiles) {
  extern __shared__ __align__(16) float smem[];
  const int kstride = d + 4;
  float* qs = smem;                        // kRows x d
  float* ks = qs + kRows * d;              // kKeys x (d + 4)
  float* vs = ks + kKeys * kstride;        // kKeys x dv

  const int g = h / hkv;
  const int pairs = b * hkv;
  const int bi = (blockIdx.x % pairs) / hkv;
  const int kh = blockIdx.x % hkv;
  const int tile = row_tiles - 1 - static_cast<int>(blockIdx.x / pairs);
  const int rows = sq * g;
  const int row0 = tile * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < kRows * d; i += blockDim.x) {
    const int r = row0 + i / d;
    float x = 0.f;
    if (r < rows) {
      const int64_t pos = r / g, head = kh * g + r % g;
      x = to_f32(q[((bi * static_cast<int64_t>(sq) + pos) * h + head) * d +
                   i % d]);
    }
    qs[i] = x;
  }

  // The block's positions and the key tiles they can see.
  const int last_row = min(row0 + kRows, rows) - 1;
  const int p_lo = q_offset + row0 / g;
  const int p_hi = q_offset + last_row / g;
  const int k_end = causal ? min(skv, p_hi + 1) : skv;
  const int k_begin = window > 0 ? max(0, p_lo - window + 1) : 0;

  int pos[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], o[kRowsPerWarp][NC];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    pos[r] = q_offset + (row0 + warp * kRowsPerWarp + r) / g;
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[r][c] = 0.f;
  }

  for (int k0 = (k_begin / kKeys) * kKeys; k0 < k_end; k0 += kKeys) {
    __syncthreads();   // the Q rows are written, the last tile is read
    for (int i = threadIdx.x; i < kKeys * d; i += blockDim.x) {
      const int j = i / d, kp = k0 + j;
      ks[j * kstride + i % d] =
          kp < skv ? to_f32(k[((bi * static_cast<int64_t>(skv) + kp) * hkv +
                               kh) * d + i % d])
                   : 0.f;
    }
    for (int i = threadIdx.x; i < kKeys * dv; i += blockDim.x) {
      const int kp = k0 + i / dv;
      vs[i] = kp < skv ? to_f32(v[((bi * static_cast<int64_t>(skv) + kp) *
                                   hkv + kh) * dv + i % dv])
                       : 0.f;
    }
    __syncthreads();

    // Scores of key k0 + lane against the warp's rows.
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    const float4* krow = reinterpret_cast<const float4*>(ks + lane * kstride);
    const float4* qrow = reinterpret_cast<const float4*>(
        qs + warp * kRowsPerWarp * d);
    for (int c4 = 0; c4 < d / 4; ++c4) {
      const float4 kx = krow[c4];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qx = qrow[r * (d / 4) + c4];
        s[r] = fmaf(qx.x, kx.x, s[r]);
        s[r] = fmaf(qx.y, kx.y, s[r]);
        s[r] = fmaf(qx.z, kx.z, s[r]);
        s[r] = fmaf(qx.w, kx.w, s[r]);
      }
    }

    // Online softmax, row by row; p[r] is lane j's weight of key k0 + j.
    const int kp = k0 + lane;
    float p[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      float x = s[r] * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      const bool seen = kp < skv && (!causal || kp <= pos[r]) &&
                        (window == 0 || kp > pos[r] - window);
      x = seen ? x : -INFINITY;
      const float tile_max = warp_max(x);
      p[r] = 0.f;
      if (tile_max == -INFINITY) continue;   // no key of this tile: as before
      const float m_new = fmaxf(m[r], tile_max);
      const float alpha = expf(m[r] - m_new);   // 0 while m is -inf
      p[r] = seen ? expf(x - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) o[r][c] *= alpha;
    }

    // O += P V: column lane + 32 c of each row.
    for (int j = 0; j < kKeys; ++j) {
      float vj[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = lane + 32 * c;
        vj[c] = col < dv ? vs[j * dv + col] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pj = __shfl_sync(kFull, p[r], j);
#pragma unroll
        for (int c = 0; c < NC; ++c) o[r][c] = fmaf(pj, vj[c], o[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + warp * kRowsPerWarp + r;
    if (row >= rows) continue;
    const int64_t head = kh * g + row % g;
    T* o_row = out + ((bi * static_cast<int64_t>(sq) + row / g) * h + head) *
                         dv;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (col < dv) store(o_row + col, o[r][c] / l[r]);
    }
  }
}

size_t smem_bytes(int d, int dv) {
  return sizeof(float) * (static_cast<size_t>(kRows) * d +
                          static_cast<size_t>(kKeys) * (d + 4 + dv));
}

template <typename T, int NC>
int launch_nc(const void* q, const void* k, const void* v, void* out, int b,
              int sq, int skv, int h, int hkv, int d, int dv, int causal,
              int window, int q_offset, float scale, float softcap,
              cudaStream_t stream) {
  const int64_t row_tiles =
      (static_cast<int64_t>(sq) * (h / hkv) + kRows - 1) / kRows;
  const int64_t blocks = row_tiles * b * hkv;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes(d, dv);
  auto kernel = attention_simt_kernel<T, NC>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(blocks), kWarps * 32, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), b, sq, skv, h, hkv, d,
      dv, causal, window, q_offset, scale, softcap,
      static_cast<int>(row_tiles));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_type(const void* q, const void* k, const void* v, void* out,
                int b, int sq, int skv, int h, int hkv, int d, int dv,
                int causal, int window, int q_offset, float scale,
                float softcap, cudaStream_t stream) {
#define REPRO_SIMT_NC(NC)                                                    \
  case NC:                                                                   \
    return launch_nc<T, NC>(q, k, v, out, b, sq, skv, h, hkv, d, dv, causal, \
                            window, q_offset, scale, softcap, stream);
  switch ((dv + 31) / 32) {
    REPRO_SIMT_NC(1)
    REPRO_SIMT_NC(2)
    REPRO_SIMT_NC(3)
    REPRO_SIMT_NC(4)
    REPRO_SIMT_NC(5)
    REPRO_SIMT_NC(6)
    REPRO_SIMT_NC(7)
    REPRO_SIMT_NC(8)
  }
#undef REPRO_SIMT_NC
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  q (b, sq, h, d), k (b, skv, hkv,
// d), v (b, skv, hkv, dv), out (b, sq, h, dv), C-contiguous, on the current
// device, all of one dtype: bf16 when `bf16` is 1, else f32.  hkv divides
// h; d and dv are multiples of 8 in [8, 256].  Query i sits at position
// q_offset + i (q_offset >= 0).  window > 0 (causal only) keeps the keys
// of positions p - window + 1 .. p, and every query must see one; 0 keeps
// all.  softcap > 0 caps the scaled scores at softcap * tanh(s / softcap);
// 0 leaves them.  Returns the launch's cudaError_t.
extern "C" int flash_attention_simt_launch(
    const void* q, const void* k, const void* v, void* out, int bf16, int b,
    int sq, int skv, int h, int hkv, int d, int dv, int causal, int window,
    int q_offset, float scale, float softcap, cudaStream_t stream) {
  if (b == 0 || sq == 0) return 0;
  if (b < 0 || sq < 0 || hkv < 1 || h < hkv || h % hkv || skv < 1 ||
      d < 8 || d > kMaxWidth || d % 8 || dv < 8 || dv > kMaxWidth ||
      dv % 8 || window < 0 || q_offset < 0 || !(softcap >= 0.f) ||
      (window > 0 && !causal) ||
      (window > 0 && q_offset + sq - window >= skv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bf16) {
    return launch_type<__nv_bfloat16>(q, k, v, out, b, sq, skv, h, hkv, d,
                                      dv, causal, window, q_offset, scale,
                                      softcap, stream);
  }
  return launch_type<float>(q, k, v, out, b, sq, skv, h, hkv, d, dv, causal,
                            window, q_offset, scale, softcap, stream);
}
