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
// What bounds it on this card: the bytes.  Each row's useful work is its
// leaf id read (4 B) and its new one written (4 B), plus the chosen
// feature's bin byte for rows of a splitting slot: 2.4 us at 1M rows and
// 3.35 TB/s.  The TPU kernel evaluates all K decisions for every row of a
// block as a [K, blk] broadcast; here
//   - each row finds its slot with one read of a leaf id -> slot byte
//     table in shared memory (ids below kTable; K compares above it, as
//     in grouped_hist.cuh), and a chain from each slot to the next slot
//     holding the same leaf id keeps the max over duplicated slots;
//     slots whose do flag is clear are in neither.  Every block builds
//     them before its rows, on the critical path of a call of a few
//     microseconds, so up to 32 slots take one warp match, not a loop;
//   - a thread takes 8 rows, as two 16-byte loads and stores of leaf ids
//     (a warp's load covers 512 contiguous bytes), and the grid covers
//     the rows in one pass (492 blocks of 256 threads at 1M rows, no cap
//     on the grid), so the card has the bytes in flight that its
//     bandwidth needs; a leaf id pointer that is not 16-byte aligned
//     (a sliced tensor) and the last rows of the array take scalar loads;
//   - a row's bin byte is loaded only when its leaf splits, and the 8
//     rows' loads are issued together, after the table lookups;
//   - the K parameters come from their own [K] tensors (bools as bytes)
//     into shared memory, so the host packs nothing per round.
// The bins are the [F, n] matrix, read in place (the JAX grower first
// gathers an int32 [K, n] copy, grower.py:1349): uint8, or int32 for wide
// bins (max_bin > 255; the kernel's Bin type), 4 bytes a row of the
// chosen feature, read only for rows of a splitting slot.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 2;   // 16-byte groups of 4 rows a thread
constexpr int kRows = 4 * kGroups;
// leaf ids below this find their first slot in a byte table
constexpr int kTable = 4096;
constexpr unsigned char kNone = 255;
constexpr int kMaxK = 254;
constexpr int kMissingZero = 1, kMissingNaN = 2;

struct SlotArgs {
  const int32_t* feat;
  const int32_t* sel;
  const int32_t* new_ids;
  const int32_t* thr;
  const uint8_t* dleft;
  const int32_t* mt;
  const int32_t* nbf;
  const int32_t* db;
  const uint8_t* do_k;
};

// the slot parameters in shared memory: [kFields][K] ints
enum Field { kSel, kNew, kThr, kDleft, kMt, kNb, kDb, kFeat, kDo, kNext,
             kFields };

__device__ __forceinline__ int first_slot(const int* sp,
                                          const unsigned char* tab, int K,
                                          int l) {
  if (l >= 0 && l < kTable) {
    const int t = tab[l];
    return t == kNone ? -1 : t;
  }
  for (int k = 0; k < K; ++k)
    if (sp[kDo * K + k] && sp[kSel * K + k] == l) return k;
  return -1;
}

// the row's new leaf id: slot k (the first live slot of its leaf, col its
// bin in k's feature), then every later slot of the same leaf
template <typename Bin>
__device__ __forceinline__ int resolve(const int* sp, const Bin* bins,
                                       long long n, long long r, int K,
                                       int l, int k, int col) {
  int moved = -1;
  while (k >= 0) {
    const int mt = sp[kMt * K + k];
    const bool miss = (mt == kMissingNaN) ? (col == sp[kNb * K + k] - 1)
                                          : (mt == kMissingZero
                                             && col == sp[kDb * K + k]);
    const bool left = miss ? (sp[kDleft * K + k] != 0)
                           : (col <= sp[kThr * K + k]);
    if (!left && sp[kNew * K + k] > moved) moved = sp[kNew * K + k];
    k = sp[kNext * K + k];
    if (k >= 0)
      col = static_cast<int>(
          __ldg(bins + static_cast<long long>(sp[kFeat * K + k]) * n + r));
  }
  return moved >= 0 ? moved : l;
}

template <typename Bin>
__global__ void __launch_bounds__(kThreads)
    partition_rows_kernel(const Bin* __restrict__ bins, long long n,
                          SlotArgs a, const int32_t* __restrict__ leaf,
                          int32_t* __restrict__ out, int K, int vec) {
  __shared__ unsigned int tab_words[kTable / 4];
  extern __shared__ int sp[];  // [kFields][K]
  const int tid = threadIdx.x;
  // group g of this thread: rows r0[g] .. r0[g] + 3; a block's groups g
  // cover 4 * kThreads contiguous rows.  The leaf ids are loaded first,
  // so that their latency hides the slot table's set-up.
  const long long blk = static_cast<long long>(blockIdx.x) * kThreads * kRows;
  long long r0[kGroups];
  int l[kRows];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    r0[g] = blk + (static_cast<long long>(g) * kThreads + tid) * 4;
    if (vec && r0[g] + 4 <= n) {
      const int4 v = *reinterpret_cast<const int4*>(leaf + r0[g]);
      l[4 * g] = v.x;
      l[4 * g + 1] = v.y;
      l[4 * g + 2] = v.z;
      l[4 * g + 3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        l[4 * g + j] = r0[g] + j < n ? leaf[r0[g] + j] : 0;
    }
  }
  for (int i = tid; i < kTable / 4; i += kThreads) tab_words[i] = ~0u;
  for (int k = tid; k < K; k += kThreads) {
    sp[kSel * K + k] = a.sel[k];
    sp[kNew * K + k] = a.new_ids[k];
    sp[kThr * K + k] = a.thr[k];
    sp[kDleft * K + k] = a.dleft[k];
    sp[kMt * K + k] = a.mt[k];
    sp[kNb * K + k] = a.nbf[k];
    sp[kDb * K + k] = a.db[k];
    sp[kFeat * K + k] = a.feat[k];
    sp[kDo * K + k] = a.do_k[k];
  }
  __syncthreads();
  unsigned char* tab = reinterpret_cast<unsigned char*>(tab_words);
  if (K <= 32) {
    // one warp, lane = slot: the live slots of each leaf id in one match,
    // so the table entry (the first of them) and each chain link (the
    // next) take a few instructions, not a loop over the slots
    if (tid < 32) {
      const bool live = tid < K && sp[kDo * K + tid] != 0;
      const int s = tid < K ? sp[kSel * K + tid] : 0;
      const unsigned peers = __match_any_sync(~0u, s)
                             & __ballot_sync(~0u, live);
      if (live) {
        const unsigned later = peers & ~((2u << tid) - 1u);
        sp[kNext * K + tid] = later ? __ffs(later) - 1 : -1;
        if ((peers & ((1u << tid) - 1u)) == 0 && s >= 0 && s < kTable)
          tab[s] = static_cast<unsigned char>(tid);
      } else if (tid < K) {
        sp[kNext * K + tid] = -1;
      }
    }
  } else {
    if (tid == 0)  // the last write of an id is its first live slot
      for (int k = K - 1; k >= 0; --k) {
        const int s = sp[kSel * K + k];
        if (sp[kDo * K + k] && s >= 0 && s < kTable)
          tab[s] = static_cast<unsigned char>(k);
      }
    for (int k = tid; k < K; k += kThreads) {
      int nx = -1;
      for (int k2 = k + 1; k2 < K; ++k2)
        if (sp[kDo * K + k2] && sp[kSel * K + k2] == sp[kSel * K + k]) {
          nx = k2;
          break;
        }
      sp[kNext * K + k] = nx;
    }
  }
  __syncthreads();

  int k0[kRows], col[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const long long r = r0[i / 4] + (i % 4);
    k0[i] = r < n ? first_slot(sp, tab, K, l[i]) : -1;
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const long long r = r0[i / 4] + (i % 4);
    col[i] = k0[i] >= 0
                 ? static_cast<int>(__ldg(
                       bins + static_cast<long long>(sp[kFeat * K + k0[i]])
                                  * n + r))
                 : 0;
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const long long r = r0[i / 4] + (i % 4);
    if (k0[i] >= 0) l[i] = resolve(sp, bins, n, r, K, l[i], k0[i], col[i]);
  }
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    if (vec && r0[g] + 4 <= n) {
      *reinterpret_cast<int4*>(out + r0[g]) =
          make_int4(l[4 * g], l[4 * g + 1], l[4 * g + 2], l[4 * g + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (r0[g] + j < n) out[r0[g] + j] = l[4 * g + j];
    }
  }
}

}  // namespace

// bins: [F, n] uint8, or int32 when wide; feat, sel, new_ids, thr, mt,
// nbf, db: [K] int32;
// dleft, do_k: [K] bool bytes; leaf, out: [n] int32.  vec: leaf and out
// are 16-byte aligned (the wrapper tests leaf's pointer; out is its own
// allocation), so whole groups of 4 rows take 16-byte loads and stores.
// Returns a cudaError_t (0 = launched).
extern "C" int lgbt_partition_rows(const void* bins, int wide, long long n,
                                   const void* feat, const void* sel,
                                   const void* new_ids, const void* thr,
                                   const void* dleft, const void* mt,
                                   const void* nbf, const void* db,
                                   const void* do_k, const void* leaf,
                                   void* out, int K, int vec, void* stream) {
  if (K < 1 || K > kMaxK || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && ((reinterpret_cast<uintptr_t>(leaf)
               | reinterpret_cast<uintptr_t>(out)) & 15u))
    return static_cast<int>(cudaErrorMisalignedAddress);
  SlotArgs a{static_cast<const int32_t*>(feat),
             static_cast<const int32_t*>(sel),
             static_cast<const int32_t*>(new_ids),
             static_cast<const int32_t*>(thr),
             static_cast<const uint8_t*>(dleft),
             static_cast<const int32_t*>(mt),
             static_cast<const int32_t*>(nbf),
             static_cast<const int32_t*>(db),
             static_cast<const uint8_t*>(do_k)};
  const long long per_block = static_cast<long long>(kThreads) * kRows;
  const long long blocks = (n + per_block - 1) / per_block;
  const size_t smem = static_cast<size_t>(kFields) * K * sizeof(int);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* lp = static_cast<const int32_t*>(leaf);
  auto* op = static_cast<int32_t*>(out);
  if (wide)
    partition_rows_kernel<int32_t>
        <<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
            static_cast<const int32_t*>(bins), n, a, lp, op, K, vec);
  else
    partition_rows_kernel<uint8_t>
        <<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
            static_cast<const uint8_t*>(bins), n, a, lp, op, K, vec);
  return static_cast<int>(cudaGetLastError());
}
