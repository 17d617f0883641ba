// Kernel B1: the K-slot batched histogram.
//
// Replaces lightgbm_tpu/ops/histogram.py:_hist_pallas, variant
// "perfeature" (pallas_call at histogram.py:584, body
// kernel_perfeature_chunk at histogram.py:516), with its packed_rows
// branch (4-bit bins two rows a byte, unpacked at histogram.py:505 by
// unpack2d): here the packed instance of the same kernel.  For every row r whose
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
// _hist_pallas, variant "flat", pallas_call at histogram.py:541, with its
// packed_rows read at histogram.py:466; the tpu_hist_impl=pallas
// histogram), computes the same function on the same operands: the TPU
// kernel is a [F*B, 256] one-hot per 256-row block contracted against the
// block's K-slot stats, the TPU's answer to having no scatter and no
// atomics.  As a one-hot contraction on this card's tensor cores it would
// do n*F*B*8 multiply-adds (8: the mma n of S = 5 stats): 65.5 G at the
// root call of 1M rows, 0.13 ms at the dense bf16 peak, against the 160 M
// adds of the grouped body; int16 stats have no tensor-core type and f32
// stats would lose their contract in TF32.  So B4 is the grouped body
// too, launched under a type of its own (Flat), so that the library holds
// B4's instances apart from B1's and a profile names them.
//
// Wide bins (int32 bins_t, more than 256 bins a feature; the TPU kernels
// read them through _hist_pallas's per-dtype chunk table, histogram.py:
// 569, and the flat one-hot, :541): B1's and B4's WideBins instances,
// reading a 16-bit row-major copy, a slot's sums spread over a
// thread-block cluster, one tile of bins a block, so that each live
// row's bins and stats are read once per tile group (once at max_bin
// 511 and 1023) and its adds go to the tile's block through distributed
// shared memory (grouped_hist.cuh).  Bound as above, with the bins at 2
// bytes a feature.

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

namespace {

// launch the instance of stats type Acc and bin layout Bins under B1's
// type (NoTail) or B4's (Flat)
template <class Tail, class Bins>
int launch_stats(const lgbt::HistArgs& a, bool ints, const int* plan,
                 cudaStream_t st) {
  typename Tail::Args none{};
  return ints ? lgbt::launch_grouped<int, Tail, Bins>(a, none, plan, st)
              : lgbt::launch_grouped<float, Tail, Bins>(a, none, plan, st);
}

template <class Tail>
int launch_variant(const lgbt::HistArgs& a, bool ints, int bins,
                   const int* plan, cudaStream_t st) {
  if (bins == lgbt::PackedBins::kCode)
    return launch_stats<Tail, lgbt::PackedBins>(a, ints, plan, st);
  if (bins == lgbt::WideBins::kCode)
    return launch_stats<Tail, lgbt::WideBins>(a, ints, plan, st);
  return launch_stats<Tail, lgbt::U8Bins>(a, ints, plan, st);
}

}  // namespace

// Clusters of `cluster` blocks of the wide instance of B1 (flat = 0) or
// B4 (flat = 1), int32 sums (ints) or f32, that the card holds at once
// at threads and smem bytes a block, into out[0]: the plan's grid is at
// most this many clusters.  Returns a cudaError_t.
extern "C" int lgbt_hist_clusters(int ints, int flat, int threads, int smem,
                                  int cluster, int* out) {
  using lgbt::query_clusters;
  using lgbt::WideBins;
  if (flat)
    return ints ? query_clusters<int, lgbt::Flat, WideBins>(
                      threads, smem, cluster, out)
                : query_clusters<float, lgbt::Flat, WideBins>(
                      threads, smem, cluster, out);
  return ints ? query_clusters<int, lgbt::NoTail, WideBins>(
                    threads, smem, cluster, out)
              : query_clusters<float, lgbt::NoTail, WideBins>(
                    threads, smem, cluster, out);
}

// bins_rm: [n, FR] row-major bins, FR bytes a row; bins: the layout
// (0: bytes, B <= 256; 1: two 4-bit bins a byte, B <= 16; 2: 16-bit
// wide bins, B <= 65536); scratch: [n] uint4 grouped stats, then
// [n] grouped rows, [K * grid] counts and [K + 1] offsets (int32 words);
// raw: [K][F][BSp] sums, BSp = B * S padded to 4, fully written (f32 for
// bf16/f32 stats, int32 for int8/int16).  group_only stops after the
// grouping (the tests read the list).  flat: launch kernel B4's instance
// (the same body) in place of B1's.  Returns a cudaError_t (0 =
// launched).
extern "C" int lgbt_hist_batched(const void* bins_rm, int FR, int bins,
                                 const void* stats, int stats_kind,
                                 const void* leaf, const void* slots,
                                 void* scratch, void* raw, int F, long long n,
                                 int S, int K, int B, const int* plan,
                                 int group_only, int flat,
                                 void* stream) {
  const int top = bins == lgbt::PackedBins::kCode ? 16
                  : bins == lgbt::WideBins::kCode ? 65536 : 256;
  if (S < 1 || S > lgbt::kMaxS || K < 1 || B < 1 || B > top || F < 1
      || n < 1 || bins < 0 || bins > 2)
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
  const bool ints = stats_kind == lgbt::kI8 || stats_kind == lgbt::kI16;
  if (!ints && stats_kind != lgbt::kBF16 && stats_kind != lgbt::kF32)
    return static_cast<int>(cudaErrorInvalidValue);
  return flat ? launch_variant<lgbt::Flat>(a, ints, bins, plan, st)
              : launch_variant<lgbt::NoTail>(a, ints, bins, plan, st);
}

extern "C" const char* lgbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
