// Kernel B1: the K-slot batched histogram.
//
// Replaces lightgbm_tpu/ops/histogram.py:_hist_pallas, variant
// "perfeature" (pallas_call at histogram.py:584, body
// kernel_perfeature_chunk at histogram.py:516).  For every row r whose
// leaf id equals slots[k] (a dead slot holds -1 and matches nothing) and
// every feature f it adds the row's S packed stat rows into
//     raw[f, bins[f, r], k, s]
// in f32.  The caller unpacks raw to (g, h, count) with _unpack_hist.
//
// The TPU kernel is a one-hot MXU contraction because the TPU has no
// scatter and no atomics.  Hopper has fast shared-memory atomics, so this
// is the reference GPU learner's shape instead (reference
// src/treelearner/ocl/histogram256.cl:78-120): each block keeps a
// sub-histogram of a feature chunk x slot chunk in shared memory and
// sweeps a range of rows adding into it with shared-memory atomics.  The
// work is n*F*S adds, not the one-hot's n*F*B*K*S multiply-adds.
//
// What bounds it on this card: the bytes.  One call reads each bin byte,
// each packed stat and each leaf id once (about 46 MB at 1M rows x 32
// features, hilo) and does (rows in a slot) x F x S adds, far below the
// card's add rate.  At full width one feature's [255 bins, 25 slots, 5
// rows] f32 sub-histogram is 127,500 bytes: above the 48 KB static limit,
// so the shared memory is dynamic and cudaFuncSetAttribute raises the cap
// to the card's opt-in maximum, and a block holds one feature.  The
// feature and slot chunks are sized from that maximum, as _hist_pallas's
// fits() sizes them for VMEM.  Since every feature chunk sweeps all rows,
// a first pass writes each row's slot as one byte; the histogram pass
// then reads one byte per row, not a leaf id and K compares, and loads
// stats and bins only for rows that are in a slot, four rows per thread
// in flight.

// The grid has no order, so nothing carries across blocks the way the
// Pallas grid carries its VMEM accumulator.  Each block writes its whole
// sub-histogram to its own slice of a scratch buffer, and a second kernel
// adds the slices in a fixed order: no global atomics, and the f32 sums
// do not change from run to run.  The shared-memory atomics inside a
// block add in the order the warps arrive, which is the one
// order-dependence left (the tolerance is stated where the kernel is
// checked against its plain twin).  Blocks are sized so that one wave
// fills the card: fewer row ranges mean fewer scratch slices to add.
// hilo's five rows stay five separate f32 sums, as in the TPU kernel's
// raw output.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxS = 5;
constexpr int kThreads = 1024;
constexpr int kUnroll = 4;
constexpr uint8_t kNoSlot = 255;

__device__ __forceinline__ float load_stat(const void* stats, int f32,
                                           long long idx) {
  if (f32) return static_cast<const float*>(stats)[idx];
  // bf16 -> f32 is exact: the bf16 bits are the high half of the f32
  const uint32_t b = static_cast<const uint16_t*>(stats)[idx];
  return __uint_as_float(b << 16);
}

// First pass: each row's first slot (kNoSlot when its leaf is in none),
// so the histogram pass reads one byte per row instead of a leaf id and
// K compares for every feature chunk.
__global__ void hist_slot_kernel(const int32_t* __restrict__ leaf,
                                 const int32_t* __restrict__ slots,
                                 uint8_t* __restrict__ slot_of, long long n,
                                 int K) {
  extern __shared__ int ss[];
  for (int i = threadIdx.x; i < K; i += blockDim.x) ss[i] = slots[i];
  __syncthreads();
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x
                     + threadIdx.x;
       r < n; r += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int l = leaf[r];
    uint8_t s = kNoSlot;
    for (int k = 0; k < K; ++k) {
      if (ss[k] == l) {
        s = static_cast<uint8_t>(k);
        break;
      }
    }
    slot_of[r] = s;
  }
}

__global__ void hist_batched_kernel(const uint8_t* __restrict__ bins,
                                    const void* __restrict__ stats,
                                    int stats_f32,
                                    const uint8_t* __restrict__ slot_of,
                                    const int32_t* __restrict__ slots,
                                    float* __restrict__ partial,
                                    int F, long long n, int S, int K, int B,
                                    int fchunk, int kchunk,
                                    long long rows_per_block) {
  // [fchunk][B][kchunk][S] sums, then all K slot ids and a duplicate flag
  extern __shared__ float sh[];
  int* sl = reinterpret_cast<int*>(sh + fchunk * B * kchunk * S);
  int* dup = sl + K;
  const int f0 = blockIdx.x * fchunk;
  const int fc = min(fchunk, F - f0);
  const int k0 = blockIdx.z * kchunk;
  const int kc = min(kchunk, K - k0);
  const long long r0 = static_cast<long long>(blockIdx.y) * rows_per_block;
  const long long r1 = min(n, r0 + rows_per_block);
  const int used = fc * B * kc * S;

  if (threadIdx.x == 0) *dup = 0;
  for (int i = threadIdx.x; i < K; i += blockDim.x) sl[i] = slots[i];
  for (int i = threadIdx.x; i < used; i += blockDim.x) sh[i] = 0.f;
  __syncthreads();
  // a leaf id held by two live slots adds its rows to both (the JAX
  // kernel's slot one-hot does); rare, so the per-row check is skipped
  // unless some pair repeats
  for (int i = threadIdx.x; i < K * K; i += blockDim.x) {
    const int a = i / K, b = i % K;
    if (a < b && sl[a] >= 0 && sl[a] == sl[b]) *dup = 1;
  }
  __syncthreads();
  const bool has_dup = *dup != 0;

  for (long long base = r0 + threadIdx.x; base < r1;
       base += static_cast<long long>(kUnroll) * blockDim.x) {
    uint8_t su[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = base + static_cast<long long>(u) * blockDim.x;
      su[u] = r < r1 ? slot_of[r] : kNoSlot;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s0 = su[u];
      if (s0 == kNoSlot || s0 >= k0 + kc) continue;
      if (s0 < k0 && !has_dup) continue;
      const long long r = base + static_cast<long long>(u) * blockDim.x;
      float v[kMaxS];
#pragma unroll
      for (int s = 0; s < kMaxS; ++s)
        v[s] = s < S ? load_stat(stats, stats_f32, s * n + r) : 0.f;
      // the row's slots in this chunk: its first one, and with
      // duplicates every later slot holding the same leaf id
      for (int k = max(s0, k0); k < k0 + kc; ++k) {
        if (k != s0 && sl[k] != sl[s0]) continue;
        for (int f = 0; f < fc; ++f) {
          const int b = bins[static_cast<long long>(f0 + f) * n + r];
          if (b >= B) continue;
          float* dst = sh + ((f * B + b) * kc + (k - k0)) * S;
#pragma unroll
          for (int s = 0; s < kMaxS; ++s)
            if (s < S) atomicAdd(dst + s, v[s]);
        }
        if (!has_dup) break;
      }
    }
  }
  __syncthreads();

  // write the block's sub-histogram, zeros included, to its scratch
  // slice partial[blockIdx.y] of layout [F][B][K][S]
  float* part = partial + static_cast<long long>(blockIdx.y) * F * B * K * S;
  for (int i = threadIdx.x; i < used; i += blockDim.x) {
    const int s = i % S;
    int t = i / S;
    const int k = t % kc;
    t /= kc;
    const int b = t % B;
    const int f = t / B;
    part[((static_cast<long long>(f0 + f) * B + b) * K + k0 + k) * S + s] =
        sh[i];
  }
}

// raw[i] = sum over the row ranges y of partial[y][i], y ascending
__global__ void hist_reduce_kernel(const float* __restrict__ partial,
                                   float* __restrict__ raw, long long size,
                                   int ny) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                     + threadIdx.x;
       i < size; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float acc = partial[i];
    for (int y = 1; y < ny; ++y) acc += partial[y * size + i];
    raw[i] = acc;
  }
}

}  // namespace

// Geometry of one call: feature, row and slot chunks, and the rows per
// block.  The caller sizes the scratch buffer from ny before launching.
extern "C" int lgbt_hist_batched_plan(int F, long long n, int S, int K,
                                      int B, int* plan) {
  if (S < 1 || S > kMaxS || K < 1 || B < 1 || F < 1 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int smem_max = 0, smem_sm = 0, sms = 0;
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  cudaDeviceGetAttribute(&smem_sm,
                         cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (K >= kNoSlot) return static_cast<int>(cudaErrorInvalidValue);
  // the slot ids and the duplicate flag sit after the sums
  const long long ids = 4LL * (K + 1);
  const long long per_slot = static_cast<long long>(B) * S * 4;
  int kchunk = K;
  if (per_slot * kchunk + ids > smem_max)
    kchunk = static_cast<int>((smem_max - ids) / per_slot);
  if (kchunk < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long per_feature = per_slot * kchunk;
  int fchunk = static_cast<int>((smem_max - ids) / per_feature);
  if (fchunk > F) fchunk = F;
  if (fchunk < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long smem = per_feature * fchunk + ids;
  const int nx = (F + fchunk - 1) / fchunk;
  const int nz = (K + kchunk - 1) / kchunk;
  // one wave: as many blocks as the SMs hold at once
  long long per_sm = smem_sm / (smem + 1024);
  if (per_sm > 2048 / kThreads) per_sm = 2048 / kThreads;
  if (per_sm < 1) per_sm = 1;
  long long ny = sms * per_sm / (static_cast<long long>(nx) * nz);
  if (ny < 1) ny = 1;
  long long rows = (n + ny - 1) / ny;
  const long long step = static_cast<long long>(kThreads) * kUnroll;
  rows = (rows + step - 1) / step * step;
  ny = (n + rows - 1) / rows;
  plan[0] = fchunk;
  plan[1] = kchunk;
  plan[2] = static_cast<int>(ny);
  plan[3] = static_cast<int>(rows);
  plan[4] = static_cast<int>(smem);
  return 0;
}

// slot_of: scratch of n bytes; partial: scratch of plan[2] * F * B * K * S
// floats; raw: F * B * K * S floats, fully written.  Returns a
// cudaError_t (0 = launched).
extern "C" int lgbt_hist_batched(const void* bins, const void* stats,
                                 int stats_f32, const void* leaf,
                                 const void* slots, void* slot_of,
                                 void* partial, void* raw, int F, long long n,
                                 int S, int K, int B, const int* plan,
                                 void* stream) {
  const int fchunk = plan[0], kchunk = plan[1], ny = plan[2];
  const long long rows = plan[3];
  const size_t smem = static_cast<size_t>(plan[4]);
  cudaError_t err = cudaFuncSetAttribute(
      hist_batched_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long sblocks = (n + 255) / 256;
  if (sblocks > 8192) sblocks = 8192;
  hist_slot_kernel<<<static_cast<unsigned>(sblocks), 256, 4 * K, st>>>(
      static_cast<const int32_t*>(leaf), static_cast<const int32_t*>(slots),
      static_cast<uint8_t*>(slot_of), n, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((F + fchunk - 1) / fchunk, ny, (K + kchunk - 1) / kchunk);
  hist_batched_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const uint8_t*>(bins), stats, stats_f32,
      static_cast<const uint8_t*>(slot_of),
      static_cast<const int32_t*>(slots), static_cast<float*>(partial), F, n,
      S, K, B, fchunk, kchunk, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long size = static_cast<long long>(F) * B * K * S;
  long long blocks = (size + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  hist_reduce_kernel<<<static_cast<unsigned>(blocks), 256, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(raw), size, ny);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lgbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
