// Soft top-k router gate (the paper's projection onto the k-subset
// permutahedron, forward only) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/soft_topk.py::
// soft_topk_gates (body _soft_topk_kernel, sort _bitonic, isotonic fit
// _isotonic_minimax).  Per row of logits (T, E), E <= 128:
//   z = logits * (1 / eps);  s = z sorted descending, with its index;
//   y = s - w, w = (1^k 0^(E-k));  v = non-increasing isotonic fit of y;
//   gates[idx[p]] = s[p] - v[p]   (in [0, 1], row sum k).
//
// The fit is one pool.  y is non-increasing on [0, k) and again on [k, E)
// (s is sorted and rounding is monotone), so under the strict-< rule of the
// divide-and-conquer PAV (repro_torch/kernels/pav_scan.py::_merge_level)
// each piece is a solved segment of singleton blocks, and the whole fit is
// one merge of the pair [0, k) | [k, E): if y[k-1] < y[k] the two form a
// pool (sum y[k-1] + y[k], count 2), which absorbs its left neighbour while
// that one's value is below the pool's and its right neighbour while the
// pool's value is below that one's, both decided against the same pool
// value, sums only added.  Every position outside the pool keeps v = y, so
// its gate is s - fl(s - w), as the reference computes it (at |z| >= 2^24
// that is not w).
//
// Design: one warp owns one row, held in registers: lane l keeps the slots
// p = r * 32 + l, r < R, of the row padded to 32 R positions (R = 1, 2, 4
// for E <= 32, 64, 128) with -inf keys whose indices lie past E.  A bitonic
// network sorts the (key, index) pairs: stages of stride >= 32 swap a
// lane's own registers, the others exchange with lane ^ stride by
// __shfl_xor_sync; no shared memory and no barrier.  The order is key
// descending, ties by index ascending (a stable argsort of -z, the padding
// last).  Then the whole warp grows the pool, reading each neighbour by a
// shuffle from the lane that holds it, one division per step; then each
// lane writes its slots' gates to their original columns.  Four rows per
// block of 128 threads.
//
// Arithmetic: the scaling is a product with the f32 reciprocal of eps,
// which is what PyTorch's CUDA division of a tensor by a Python scalar
// computes; the pool's sums are added in the order of the plain version
// (repro_torch/kernels/soft_topk.py::soft_topk_gates_plain: left, then
// right, within a step) and divided by the count in IEEE f32.  On the card
// the two therefore give the same floats for every eps.
//
// What bounds it on this card: latency, not bytes or operations.  At the
// prefill shape (4096, 64) the row data are 1 MB each way (0.63 us at
// 3.35 TB/s) and the sort 21 compare-exchange stages of a few operations
// per element.  A row's time is one warp's dependent chain: the load, 20
// shuffle stages and one in-lane stage, a pool of a few steps (one
// division each), the store.  At decode (8 rows) the launch is one such
// chain; at prefill 1024 blocks overlap their chains on 132 SMs, one wave.
// chip_smoke.py measures (H100 80GB HBM3, 700 W) 0.008 ms of device time a
// launch at (4096, 64) and 0.003 ms at (8, 64): at decode close to the
// fixed cost of a launch, and the wrapper's host work (0.03-0.05 ms of
// event time) is most of a call.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kMaxE = 128;
constexpr unsigned kFull = 0xffffffffu;

// a precedes b in the sorted order: larger key first, ties by index.
__device__ __forceinline__ bool precedes(float ka, int ia, float kb, int ib) {
  return ka > kb || (ka == kb && ia < ib);
}

// Bitonic sort of the warp's 32 R (key, index) pairs, slot p = r * 32 +
// lane.  Pair p, p ^ stride of a stage ends with the preceding pair in the
// lower slot if bit `size` of p is clear, else in the upper one.
template <int R>
__device__ __forceinline__ void warp_sort(float (&key)[R], int (&idx)[R],
                                          int lane) {
  constexpr int kN = 32 * R;
#pragma unroll
  for (int size = 2; size <= kN; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 32) {   // both slots in this lane: registers r, r | d
        const int d = stride / 32;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if ((r & d) != 0) continue;
          const int u = r | d;
          const bool forward = ((r * 32) & size) == 0;
          const bool swap = forward ? precedes(key[u], idx[u], key[r], idx[r])
                                    : precedes(key[r], idx[r], key[u], idx[u]);
          if (swap) {
            const float tk = key[r];
            key[r] = key[u];
            key[u] = tk;
            const int ti = idx[r];
            idx[r] = idx[u];
            idx[u] = ti;
          }
        }
      } else {             // partner slot in lane ^ stride, same register
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float kp = __shfl_xor_sync(kFull, key[r], stride);
          const int ip = __shfl_xor_sync(kFull, idx[r], stride);
          const bool lower = (lane & stride) == 0;
          const bool forward = ((r * 32 + lane) & size) == 0;
          const bool take = lower == forward
                                ? precedes(kp, ip, key[r], idx[r])
                                : precedes(key[r], idx[r], kp, ip);
          if (take) {
            key[r] = kp;
            idx[r] = ip;
          }
        }
      }
    }
  }
}

// y at slot q (the same q in every lane), broadcast to the warp.
template <int R>
__device__ __forceinline__ float slot(const float (&y)[R], int q) {
  float v = y[0];
#pragma unroll
  for (int r = 1; r < R; ++r) {
    if ((q >> 5) == r) v = y[r];
  }
  return __shfl_sync(kFull, v, q & 31);
}

template <int R>
__global__ void __launch_bounds__(kWarps * 32)
soft_topk_kernel(const float* __restrict__ logits, float* __restrict__ out,
                 int64_t rows, int e, int k, float inv_eps) {
  const int lane = threadIdx.x % 32;
  const int64_t row = blockIdx.x * static_cast<int64_t>(kWarps) +
                      threadIdx.x / 32;
  if (row >= rows) return;   // whole warps only: rows map one to one
  const float* z_row = logits + row * e;

  float key[R];
  int idx[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int p = r * 32 + lane;
    key[r] = p < e ? z_row[p] * inv_eps : -INFINITY;
    idx[r] = p;
  }
  warp_sort<R>(key, idx, lane);

  float y[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    y[r] = key[r] - (r * 32 + lane < k ? 1.f : 0.f);
  }

  // The one pool, over slots [pl, pr], grown from the pair k - 1, k.
  bool pooled = false;
  int pl = k - 1, pr = k;
  float gamma = 0.f;
  if (k > 0 && k < e) {
    const float a = slot<R>(y, k - 1);
    const float b = slot<R>(y, k);
    if (a < b) {
      pooled = true;
      float psum = a + b;
      int count = 2;
      float nl = pl > 0 ? slot<R>(y, pl - 1) : 0.f;
      float nr = pr < e - 1 ? slot<R>(y, pr + 1) : 0.f;
      while (true) {
        gamma = psum / static_cast<float>(count);
        const bool absorb_l = pl > 0 && nl < gamma;
        const bool absorb_r = pr < e - 1 && gamma < nr;
        if (!absorb_l && !absorb_r) break;
        if (absorb_l) {
          psum = psum + nl;
          ++count;
          --pl;
        }
        if (absorb_r) {
          psum = psum + nr;
          ++count;
          ++pr;
        }
        if (absorb_l && pl > 0) nl = slot<R>(y, pl - 1);
        if (absorb_r && pr < e - 1) nr = slot<R>(y, pr + 1);
      }
    }
  }

  float* o_row = out + row * e;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int p = r * 32 + lane;
    if (p < e) {
      const bool in_pool = pooled && pl <= p && p <= pr;
      o_row[idx[r]] = key[r] - (in_pool ? gamma : y[r]);
    }
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  logits and out are (rows, e)
// float32, C-contiguous, on the current device; 1 <= e <= 128,
// 0 <= k <= e, eps > 0.  Returns the launch's cudaError_t.
extern "C" int soft_topk_launch(const float* logits, float* out, int64_t rows,
                                int e, int k, float eps,
                                cudaStream_t stream) {
  if (rows == 0) return 0;
  if (e < 1 || e > kMaxE || k < 0 || k > e || !(eps > 0.f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  const float inv_eps = 1.f / eps;
  if (e <= 32) {
    soft_topk_kernel<1><<<grid, kWarps * 32, 0, stream>>>(logits, out, rows,
                                                          e, k, inv_eps);
  } else if (e <= 64) {
    soft_topk_kernel<2><<<grid, kWarps * 32, 0, stream>>>(logits, out, rows,
                                                          e, k, inv_eps);
  } else {
    soft_topk_kernel<4><<<grid, kWarps * 32, 0, stream>>>(logits, out, rows,
                                                          e, k, inv_eps);
  }
  return static_cast<int>(cudaGetLastError());
}
