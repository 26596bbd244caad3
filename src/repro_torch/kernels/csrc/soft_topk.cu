// Soft top-k router gate (the paper's projection onto the k-subset
// permutahedron, forward only) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/soft_topk.py::
// soft_topk_gates (body _soft_topk_kernel, sort _bitonic, isotonic fit
// _isotonic_minimax).  Per row of logits (T, E), E <= 128:
//   z = logits * (1 / eps);  sort z descending with its index;
//   v = non-increasing isotonic fit of s - (1^k 0^(E-k));
//   gates[idx[p]] = s[p] - v[p]   (in [0, 1], row sum k).
//
// Design: one warp owns one row, four rows per block of 128 threads.  The
// row goes to shared memory, padded to a power of two with -inf keys whose
// indices lie past E, and a bitonic network sorts (key, index) pairs in
// place: each lane runs the compare-exchanges of its pairs and the warp
// synchronises between stages.  The order is key descending, ties by index
// ascending, so the sort is a stable argsort of -z and the padding sorts
// behind every real entry.  Lane 0 then runs the Pool-Adjacent-Violators
// stack machine over the E real entries and expands each block's value;
// all lanes write the gates back to their original columns.
//
// The isotonic fit is not the TPU's O(E^2) minimax closed form: that one
// forms interval means as differences of a running sum, which cancel.  PAV
// merges blocks as sums and counts with exactly the arithmetic of the pav_l2
// kernel (csrc/pav.cu) and of the plain stack machine
// (repro_torch/kernels/pav.py::pav_l2_stack): merge while the top's value is
// <= the current block's, sums as cur + popped, value sum / fmaxf(count,
// 1e-30f).  The scaling is a product with the f32 reciprocal of eps, which
// is what PyTorch's CUDA division of a tensor by a Python scalar computes.
// The plain version (sort -> pav_l2_stack -> un-sort) on the card
// therefore gives the same floats, for every eps; on the CPU, which
// divides, z may differ by an ulp when eps is not a power of two.
//
// What bounds it on this card: neither bytes nor operations.  At the serving
// shape (4096, 64) the row data are 1 MB each way (about 0.6 us at
// 3.35 TB/s) and the sort and fit some 40 operations per element.  The
// time is the latency of one warp's dependent steps: 21 bitonic stages with
// a warp barrier each, then up to 2E dependent shared-memory steps of the
// one lane that runs PAV.  4096 rows are 1024 blocks, several per SM, so
// the SMs overlap many rows' latencies; at decode (8 rows) the launch is
// one row's latency.  A warp-parallel PAV (pairwise interval sums across
// lanes) is the next step if the gate shows in the serving profile.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kMaxE = 128;

// a precedes b in the sorted order: larger key first, ties by index.
__device__ __forceinline__ bool precedes(float ka, int ia, float kb, int ib) {
  return ka > kb || (ka == kb && ia < ib);
}

__global__ void __launch_bounds__(kWarps * 32)
soft_topk_kernel(const float* __restrict__ logits, float* __restrict__ out,
                 int64_t rows, int e, int e_pad, int k, float inv_eps) {
  __shared__ float key_s[kWarps][kMaxE];
  __shared__ int idx_s[kWarps][kMaxE];
  __shared__ float val_s[kWarps][kMaxE];     // the fit v, by sorted slot
  __shared__ float sum_s[kWarps][kMaxE];
  __shared__ float cnt_s[kWarps][kMaxE];
  __shared__ int start_s[kWarps][kMaxE];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t row = blockIdx.x * static_cast<int64_t>(kWarps) + warp;
  if (row >= rows) return;   // whole warps only: rows map one to one
  float* key = key_s[warp];
  int* idx = idx_s[warp];
  float* val = val_s[warp];
  const float* z_row = logits + row * e;

  for (int p = lane; p < e_pad; p += 32) {
    key[p] = p < e ? z_row[p] * inv_eps : -INFINITY;
    idx[p] = p;
  }
  __syncwarp();

  // Bitonic network over e_pad (a power of two) slots, e_pad / 2 pairs a
  // stage.  Pair t of a stage joins slot i (bit `stride` clear) and
  // i + stride; the run of `size` slots holding i ends up in sorted order
  // if bit `size` of i is clear, else reversed.
  for (int size = 2; size <= e_pad; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < e_pad / 2; t += 32) {
        const int i = (t / stride) * 2 * stride + (t % stride);
        const int l = i + stride;
        const bool forward = (i & size) == 0;
        const float ki = key[i], kl = key[l];
        const int ii = idx[i], il = idx[l];
        const bool swap = forward ? precedes(kl, il, ki, ii)
                                  : precedes(ki, ii, kl, il);
        if (swap) {
          key[i] = kl; key[l] = ki;
          idx[i] = il; idx[l] = ii;
        }
      }
      __syncwarp();
    }
  }

  if (lane == 0) {
    // Stack machine of csrc/pav.cu (l2) on y[p] = key[p] - (p < k).
    float* sum = sum_s[warp];
    float* cnt = cnt_s[warp];
    int* st = start_s[warp];
    int top = -1;
    float top0 = 0.f, top1 = 0.f, top_val = 0.f;
    for (int p = 0; p < e; ++p) {
      float c0 = key[p] - (p < k ? 1.f : 0.f);
      float c1 = 1.f;
      int start = p;
      float c_val = c0 / fmaxf(c1, 1e-30f);
      while (top >= 0 && top_val <= c_val) {
        c0 = c0 + top0;
        c1 = c1 + top1;
        start = st[top];
        --top;
        c_val = c0 / fmaxf(c1, 1e-30f);
        if (top >= 0) {
          top0 = sum[top];
          top1 = cnt[top];
          top_val = top0 / fmaxf(top1, 1e-30f);
        }
      }
      ++top;
      sum[top] = c0;
      cnt[top] = c1;
      st[top] = start;
      top0 = c0;
      top1 = c1;
      top_val = c_val;
    }
    for (int b = 0; b <= top; ++b) {
      const float v = sum[b] / fmaxf(cnt[b], 1e-30f);
      const int end = b < top ? st[b + 1] : e;
      for (int p = st[b]; p < end; ++p) val[p] = v;
    }
  }
  __syncwarp();

  float* o_row = out + row * e;
  for (int p = lane; p < e; p += 32) o_row[idx[p]] = key[p] - val[p];
}

}  // namespace

// Plain C entry point, loaded with ctypes.  logits and out are (rows, e)
// float32, C-contiguous, on the current device; 1 <= e <= 128, e_pad the
// next power of two >= max(e, 2), 0 <= k <= e, eps > 0.  Returns the
// launch's cudaError_t.
extern "C" int soft_topk_launch(const float* logits, float* out, int64_t rows,
                                int e, int e_pad, int k, float eps,
                                cudaStream_t stream) {
  if (rows == 0) return 0;
  if (e < 1 || e > kMaxE || e_pad < e || e_pad > kMaxE ||
      (e_pad & (e_pad - 1)) || k < 0 || k > e || !(eps > 0.f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (rows + kWarps - 1) / kWarps;
  soft_topk_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                     stream>>>(logits, out, rows, e, e_pad, k, 1.f / eps);
  return static_cast<int>(cudaGetLastError());
}
