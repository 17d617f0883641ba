// Kernel B3: the K-way frontier row partition.
//
// Replaces lightgbm_tpu/ops/fused.py:partition_rows (pallas_call at
// fused.py:296), the tpu_partition_impl=kernel lowering.  For each row:
// among the K slots whose leaf equals the row's leaf and whose do flag is
// set, if numeric_go_left is false for that slot's feature and threshold
// the row moves to that slot's new leaf id (max over the moving slots);
// otherwise it keeps its leaf.  The integer math is the "vselect"
// lowering's (grower.py:1291-1343) and numeric_go_left's
// (split.py:41-51), so the result is bitwise equal to it:
//     MISSING_NAN  -> missing when col == num_bin - 1
//     MISSING_ZERO -> missing when col == default_bin
//     missing rows go to default_left, the rest left when col <= thr.
//
// What bounds it on this card: the bytes.  One thread per row reads its
// leaf id (4 B), writes its new one (4 B), and reads the chosen feature's
// bin byte only for rows of a splitting leaf.  The K slots' eight ints
// and feature ids sit in shared memory.  It reads the chosen feature rows
// of the uint8 bin matrix directly, where the JAX grower first gathers
// an int32 [K, n] copy (grower.py:1349).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// per-slot ints: sel, new_id, thr, default_left, missing_type, num_bin,
// default_bin, do
__global__ void partition_rows_kernel(const uint8_t* __restrict__ bins,
                                      long long n,
                                      const int32_t* __restrict__ feat,
                                      const int32_t* __restrict__ ints,
                                      const int32_t* __restrict__ leaf,
                                      int32_t* __restrict__ out, int K) {
  extern __shared__ int sp[];  // [K][8] ints, then K feature ids
  int* sf = sp + 8 * K;
  for (int i = threadIdx.x; i < 8 * K; i += blockDim.x) sp[i] = ints[i];
  for (int i = threadIdx.x; i < K; i += blockDim.x) sf[i] = feat[i];
  __syncthreads();
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x
                     + threadIdx.x;
       r < n; r += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int l = leaf[r];
    int moved = -1;
    for (int k = 0; k < K; ++k) {
      const int* p = sp + 8 * k;
      if (p[0] != l || p[7] == 0) continue;
      const int col = bins[static_cast<long long>(sf[k]) * n + r];
      const int mt = p[4];
      const bool miss = (mt == 2) ? (col == p[5] - 1)
                                  : (mt == 1 && col == p[6]);
      const bool left = miss ? (p[3] != 0) : (col <= p[2]);
      if (!left && p[1] > moved) moved = p[1];
    }
    out[r] = moved >= 0 ? moved : l;
  }
}

}  // namespace

// Returns a cudaError_t (0 = launched).
extern "C" int lgbt_partition_rows(const void* bins, long long n,
                                   const void* feat, const void* ints,
                                   const void* leaf, void* out, int K,
                                   void* stream) {
  if (K < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = 16LL * sms;
  if (blocks > cap) blocks = cap;
  const size_t smem = static_cast<size_t>(9) * K * sizeof(int);
  partition_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bins), n,
      static_cast<const int32_t*>(feat), static_cast<const int32_t*>(ints),
      static_cast<const int32_t*>(leaf), static_cast<int32_t*>(out), K);
  return static_cast<int>(cudaGetLastError());
}
