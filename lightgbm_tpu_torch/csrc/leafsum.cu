// The leaf refit's per-leaf sums, in a fixed order.
//
// Replaces the two f32 scatter-adds of the quantized grower's leaf refit
// (lightgbm_tpu/ops/grower.py:1745-1748, XLA, not Pallas):
//     out[v][l] = sum of vals[v][r] over the rows r with leaf id l
// for v = 0 (gradients) and 1 (hessians).  XLA:CPU's scatter, and the
// CPU index_add_ that is this kernel's plain twin, add each leaf's rows
// one by one in row order, starting from 0.  A CUDA index_add_ adds them
// with f32 atomics in the order they arrive, so its sums change from run
// to run.  Here the wrapper (ops/leafsum.py) sorts the leaf ids stably,
// gathers the values into that order and finds each leaf's segment; one
// thread per (leaf, value row) then walks its segment in order with
// __fadd_rn (no contraction), so every leaf's sum is rounded as the
// twin rounds it: bitwise equal, on every run.
//
// What bounds it on this card: the longest segment.  Each thread's adds
// depend on one another, so the largest leaf's rows take one add after
// the other; the bytes (the sorted values, read once) are a small part.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void leaf_sums_kernel(const float* __restrict__ sorted_vals,
                                 const int32_t* __restrict__ offsets,
                                 float* __restrict__ out, int V, int L,
                                 long long n) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= V * L) return;
  const int v = t / L, l = t % L;
  const float* src = sorted_vals + static_cast<long long>(v) * n;
  float acc = 0.f;
  for (int i = offsets[l]; i < offsets[l + 1]; ++i)
    acc = __fadd_rn(acc, src[i]);
  out[t] = acc;
}

}  // namespace

// sorted_vals: [V, n] f32 values in stable leaf-id order; offsets: [L + 1]
// int32 segment starts (leaf l's rows are [offsets[l], offsets[l + 1]));
// out: [V, L] f32.  Returns a cudaError_t (0 = launched).
extern "C" int lgbt_leaf_sums(const void* sorted_vals, const void* offsets,
                              void* out, int V, int L, long long n,
                              void* stream) {
  if (V < 1 || L < 1 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (V * L + kThreads - 1) / kThreads;
  leaf_sums_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sorted_vals),
      static_cast<const int32_t*>(offsets), static_cast<float*>(out), V, L, n);
  return static_cast<int>(cudaGetLastError());
}
