// Batched Pool-Adjacent-Violators for the entropic (kl) regularization
// (isotonic optimization, paper §5) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/pav.py::pav_kl
// (_pav_kl_kernel), built on the stack machine _pav_body and the pointer
// sweep _expand.  (The l2 kernel, ::pav_l2, is the divide-and-conquer
// kernel of pav_scan.cu.)
//
// Design: one thread owns one row (blockDim 128, grid ceil(rows / 128)).
// The thread keeps the current block's two registers and the cached top of
// the stack in its own registers; the stack of (reg0, reg1, start) lives in
// global work buffers of shape (rows, n) that the wrapper allocates.  A
// second loop in the same thread writes every block's value to its
// positions.
//
// What bounds it: not bytes and not operations, but the O(n) sequential,
// data-dependent depth of PAV per row.  The memory floor (read s and w once
// and write v once) is microseconds at the main path's shapes; each thread
// instead walks its row one dependent step after another, and 128 rows fill
// one block on one SM of 132.  The fix is the divide-and-conquer merge of
// pav_scan.cu, instantiated for the kl algebra (ROADMAP.md, queue 1).
//
// Semantics match the plain stack machine in repro_torch/kernels/pav.py
// exactly, because the backward recovers the block structure from equal
// adjacent output values:
//   * merge while block_value(top) <= block_value(cur), ties included;
//   * registers are (LSE s, LSE w), merged with a stable logaddexp; the
//     value is LSE s - LSE w;
//   * one and the same float is written to every position of a block.
// Build without --use_fast_math: its expf/log1pf approximations would move
// the kl block values.  The algebra is a template parameter (Op).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

struct KL {
  __device__ static float value(float lse_s, float lse_w) {
    return lse_s - lse_w;
  }
  // max(a, b) + log1p(exp(-|a - b|)); equal infinities return themselves
  // (their difference would be nan).  Never subtracts exponentials.
  __device__ static float merge(float a, float b) {
    if (a == b && isinf(a)) return a;
    return fmaxf(a, b) + log1pf(expf(-fabsf(a - b)));
  }
};

// reg0 / reg1: the row's inputs for the singleton registers (kl: s and w).
template <class Op>
__global__ void __launch_bounds__(kThreads)
pav_kernel(const float* __restrict__ reg0, const float* __restrict__ reg1,
           float* __restrict__ out, float* __restrict__ stack0,
           float* __restrict__ stack1, int* __restrict__ stack_start,
           int64_t rows, int64_t n) {
  const int64_t row = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                      threadIdx.x;
  if (row >= rows) return;
  const int64_t off = row * n;
  const float* a = reg0 + off;
  const float* b = reg1 + off;
  float* s0 = stack0 + off;
  float* s1 = stack1 + off;
  int* st = stack_start + off;
  float* o = out + off;

  int64_t top = -1;
  float top0 = 0.f, top1 = 0.f, top_val = 0.f;
  for (int64_t i = 0; i < n; ++i) {
    float c0 = a[i];
    float c1 = b[i];
    int start = static_cast<int>(i);
    float c_val = Op::value(c0, c1);
    while (top >= 0 && top_val <= c_val) {
      c0 = Op::merge(c0, top0);
      c1 = Op::merge(c1, top1);
      start = st[top];
      --top;
      c_val = Op::value(c0, c1);
      if (top >= 0) {
        top0 = s0[top];
        top1 = s1[top];
        top_val = Op::value(top0, top1);
      }
    }
    ++top;
    s0[top] = c0;
    s1[top] = c1;
    st[top] = start;
    top0 = c0;
    top1 = c1;
    top_val = c_val;
  }

  for (int64_t k = 0; k <= top; ++k) {
    const float v = Op::value(s0[k], s1[k]);
    const int64_t end = k < top ? st[k + 1] : n;
    for (int64_t p = st[k]; p < end; ++p) o[p] = v;
  }
}

template <class Op>
int launch(const float* reg0, const float* reg1, float* out, float* stack,
           int* stack_start, int64_t rows, int64_t n, cudaStream_t stream) {
  const int64_t blocks = (rows + kThreads - 1) / kThreads;
  pav_kernel<Op><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      reg0, reg1, out, stack, stack + rows * n, stack_start, rows, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Every array is (rows, n),
// C-contiguous, on the current device; `stack` holds 2 * rows * n floats
// and `stack_start` rows * n ints.  Returns the launch's cudaError_t.
extern "C" int pav_kl_launch(const float* s, const float* w, float* out,
                             float* stack, int* stack_start, int64_t rows,
                             int64_t n, cudaStream_t stream) {
  return launch<KL>(s, w, out, stack, stack_start, rows, n, stream);
}
