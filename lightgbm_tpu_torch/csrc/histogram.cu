// Kernel B1: the K-slot batched histogram.
//
// Replaces lightgbm_tpu/ops/histogram.py:_hist_pallas, variant
// "perfeature" (pallas_call at histogram.py:584, body
// kernel_perfeature_chunk at histogram.py:516).  For every row r whose
// leaf id equals slots[k] (a dead slot holds -1 and matches nothing) and
// every feature f it adds the row's S packed stat rows into
//     raw[f, bins[f, r], k, s]
// in f32 (int32 for the int8/int16 stats of the quantized precisions).
// The caller unpacks raw to (g, h, count) with _unpack_hist.
//
// The TPU kernel is a one-hot MXU contraction because the TPU has no
// scatter and no atomics; the work there is n*F*B*K*S multiply-adds.
// Here the rows are grouped by slot first and each live row is read once
// for all its features: the work is (live rows) x F x S adds.  The body,
// in one cooperative launch, is grouped_hist_kernel (grouped_hist.cuh),
// whose note gives the phases, how the f32 adds avoid contended
// compare-and-swap loops, and what bounds it.  It reads each leaf id
// twice and each live row's bins and stats once, in one launch.
//
// Kernel B4, the flat variant (lightgbm_tpu/ops/histogram.py:
// _hist_pallas, variant "flat", pallas_call at histogram.py:541; the
// tpu_hist_impl=pallas histogram), is at the end of this file.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grouped_hist.cuh"

// The card's limits that the wrapper's plan reads: SMs, the opt-in shared
// memory of a block, the shared memory of an SM.
extern "C" int lgbt_device_limits(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&out[1], cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return static_cast<int>(cudaDeviceGetAttribute(
      &out[2], cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev));
}

// bins_rm: [n, FR] row-major bins; scratch: [n] uint4 grouped stats, then
// [n] grouped rows, [K * grid] counts and [K + 1] offsets (int32 words);
// raw: [K][F][BSp] sums, BSp = B * S padded to 4, fully written (f32 for
// bf16/f32 stats, int32 for int8/int16).  group_only stops after the
// grouping (the tests read the list).  Returns a cudaError_t (0 =
// launched).
extern "C" int lgbt_hist_batched(const void* bins_rm, int FR,
                                 const void* stats, int stats_kind,
                                 const void* leaf, const void* slots,
                                 void* scratch, void* raw, int F, long long n,
                                 int S, int K, int B, const int* plan,
                                 int group_only, void* stream) {
  if (S < 1 || S > lgbt::kMaxS || K < 1 || B < 1 || B > 256 || F < 1
      || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  lgbt::HistArgs a{};
  a.bins_rm = static_cast<const uint8_t*>(bins_rm);
  a.stats = stats;
  a.leaf = static_cast<const int32_t*>(leaf);
  a.slots = static_cast<const int32_t*>(slots);
  a.gstats = static_cast<uint4*>(scratch);
  a.rows = reinterpret_cast<int32_t*>(a.gstats + n);
  a.counts = a.rows + n;
  a.offsets = a.counts + static_cast<long long>(plan[lgbt::kPlanGrid]) * K;
  a.raw = raw;
  a.n = n;
  a.FR = FR;
  a.kind = stats_kind;
  a.S = S;
  a.F = F;
  a.K = K;
  a.B = B;
  a.group_only = group_only;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  lgbt::NoTail::Args none{};
  if (stats_kind == lgbt::kI8 || stats_kind == lgbt::kI16)
    return lgbt::launch_grouped<int, lgbt::NoTail>(a, none, plan, st);
  if (stats_kind != lgbt::kBF16 && stats_kind != lgbt::kF32)
    return static_cast<int>(cudaErrorInvalidValue);
  return lgbt::launch_grouped<float, lgbt::NoTail>(a, none, plan, st);
}

extern "C" const char* lgbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace {

constexpr int kMaxS = 5;
// stat types (the wrapper's _STAT_KINDS)
constexpr int kBF16 = 0, kF32 = 1, kI8 = 2, kI16 = 3;

template <typename Acc>
__device__ __forceinline__ Acc load_stat(const void* stats, int kind,
                                         long long idx);

template <>
__device__ __forceinline__ float load_stat<float>(const void* stats,
                                                  int kind, long long idx) {
  if (kind == kF32) return static_cast<const float*>(stats)[idx];
  // bf16 -> f32 is exact: the bf16 bits are the high half of the f32
  const uint32_t b = static_cast<const uint16_t*>(stats)[idx];
  return __uint_as_float(b << 16);
}

template <>
__device__ __forceinline__ int load_stat<int>(const void* stats, int kind,
                                              long long idx) {
  if (kind == kI8) return static_cast<const int8_t*>(stats)[idx];
  return static_cast<const int16_t*>(stats)[idx];
}

}  // namespace

// Kernel B4: the flat variant of the batched histogram.
//
// Replaces lightgbm_tpu/ops/histogram.py:_hist_pallas, variant "flat"
// (pallas_call at histogram.py:541, body kernel_flat), which builds one
// [F*B, 256] one-hot per 256-row block and contracts it against the
// block's K-slot stats into a [F*B, K*S] accumulator resident in VMEM
// across the row grid.  Its contract is B1's: the same raw [F, B, K, S]
// sums of the same inputs, and the same plain twin.
//
// Here a block covers 256 rows for all features at once, one row per
// thread: the thread finds the row's slots among the K in shared memory,
// loads its S stats once, and for each feature adds them at
// raw[f, bin, k, s].  The whole [F, B, K, S] histogram (4 MB at 32 x 255
// x 25 x 5 f32) does not fit a block's shared memory, and a slice per
// block would not fit device memory, so the adds are global atomics on
// the zeroed output (the wrapper zeroes it).  Neighbouring threads read
// neighbouring bytes of each feature row.  Integer adds are exact in
// any order, so the int variant is bitwise equal to its twin; f32 global
// atomics add in the order the blocks arrive.
//
// What bounds it on this card: the atomics.  Each matched row issues
// F * S of them to L2, against B1's shared-memory atomics; the bytes
// read are B1's.

namespace {

constexpr int kFlatRows = 256;

template <typename Acc>
__global__ void hist_flat_kernel(const uint8_t* __restrict__ bins,
                                 const void* __restrict__ stats,
                                 int stats_kind,
                                 const int32_t* __restrict__ leaf,
                                 const int32_t* __restrict__ slots,
                                 Acc* __restrict__ raw, int F, long long n,
                                 int S, int K, int B) {
  extern __shared__ int fsl[];  // the K slot ids
  for (int i = threadIdx.x; i < K; i += blockDim.x) fsl[i] = slots[i];
  __syncthreads();
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (r >= n) return;
  const int l = leaf[r];
  Acc v[kMaxS];
  bool loaded = false;
  // every slot holding the row's leaf gets the row (a leaf id held by
  // two live slots adds to both, as the one-hot contraction does)
  for (int k = 0; k < K; ++k) {
    if (fsl[k] != l) continue;
    if (!loaded) {
#pragma unroll
      for (int s = 0; s < kMaxS; ++s)
        v[s] = s < S ? load_stat<Acc>(stats, stats_kind, s * n + r) : Acc(0);
      loaded = true;
    }
    for (int f = 0; f < F; ++f) {
      const int b = bins[static_cast<long long>(f) * n + r];
      if (b >= B) continue;
      Acc* dst = raw + ((static_cast<long long>(f) * B + b) * K + k) * S;
#pragma unroll
      for (int s = 0; s < kMaxS; ++s)
        if (s < S) atomicAdd(dst + s, v[s]);
    }
  }
}

}  // namespace

// raw: F * B * K * S sums (f32, or int32 for int8/int16 stats), zeroed by
// the caller.  Returns a cudaError_t (0 = launched).
extern "C" int lgbt_hist_flat(const void* bins, const void* stats,
                              int stats_kind, const void* leaf,
                              const void* slots, void* raw, int F,
                              long long n, int S, int K, int B,
                              void* stream) {
  if (S < 1 || S > kMaxS || K < 1 || B < 1 || F < 1 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((n + kFlatRows - 1)
                                                / kFlatRows);
  const size_t smem = static_cast<size_t>(K) * sizeof(int);
  if (stats_kind == kI8 || stats_kind == kI16) {
    hist_flat_kernel<int><<<blocks, kFlatRows, smem, st>>>(
        static_cast<const uint8_t*>(bins), stats, stats_kind,
        static_cast<const int32_t*>(leaf), static_cast<const int32_t*>(slots),
        static_cast<int*>(raw), F, n, S, K, B);
  } else if (stats_kind == kBF16 || stats_kind == kF32) {
    hist_flat_kernel<float><<<blocks, kFlatRows, smem, st>>>(
        static_cast<const uint8_t*>(bins), stats, stats_kind,
        static_cast<const int32_t*>(leaf), static_cast<const int32_t*>(slots),
        static_cast<float*>(raw), F, n, S, K, B);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
