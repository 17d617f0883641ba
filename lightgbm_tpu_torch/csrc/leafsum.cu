// The leaf refit's per-leaf sums, in a fixed order: two kernels.
//
// Replaces the two f32 scatter-adds of the quantized grower's leaf refit
// (lightgbm_tpu/ops/grower.py:1745-1748, XLA, not Pallas):
//     out[v][l] = sum of vals[v][r] over the rows r with leaf id l
// for v = 0 (gradients) and 1 (hessians).  XLA:CPU's scatter, and the
// CPU index_add_ that is the plain twin (ops/leafsum.py), add each
// leaf's rows one by one in row order, starting from 0.  A CUDA
// index_add_ adds them with f32 atomics in the order they arrive, so its
// sums change from run to run.  Here every leaf's sum is one chain of
// __fadd_rn in row order from +0, rounded as the twin rounds it: bitwise
// equal, on every run.
//
// What bounds it on this card: the largest leaf.  Its rows are one chain
// of dependent adds (4 cycles each), whatever the design; the bytes (n
// leaf ids and 2n values read once, 2n values written and read back) are
// a small part at the grower's shapes.  So the design keeps every chain
// off global memory and spreads the grouping over the whole card:
//
//   leaf_group_kernel  one cooperative launch, the rows grouped by leaf
//      id, stable in row order (the count / offsets / stable scatter of
//      grouped_hist.cuh's phase_count and phase_group, keyed by the leaf
//      id itself, no slot table):
//      A  each warp counts the ids of its contiguous part of its block's
//         rows, one add per distinct leaf of 32 rows (__match_any_sync),
//         into its own [L] counters: in shared memory where the block's
//         8 x L fit, else in global scratch;
//      B  the [L][G] per-(leaf, block) counts are scanned in place into
//         each block's start in each leaf (exclusive, leaf-major): block
//         b sums its slice of L counts, and after a grid barrier scans it
//         from the sum of the slices before it;
//      C  each warp turns its counters into its start in each leaf (its
//         block's, plus the earlier warps' rows) and writes every row's
//         (g, h) pair, 8 bytes, at its place in the leaf-ordered list;
//         block 0 writes the [L + 1] offsets.
//   leaf_sums_kernel  one block of two warps a leaf (a grid of L), the
//      leaf's rows one contiguous segment of (g, h) pairs: warp 0's lane
//      0 streams it into a ring of kStages shared-memory stages, 512
//      rows a stage, one bulk copy (TMA, cp.async.bulk) a stage that
//      completes on the stage's "full" mbarrier, refilling a stage once
//      the consumer has released it on its "empty" one, and stores +0
//      for the stage's rows outside the leaf (its two ends, the last
//      stage's rest); warp 1's lane 0 runs the g and h chains
//      interleaved from float4 reads of the ring (two rows each), read
//      kPrefetch float4s ahead across the stages, so that each add waits
//      only on the previous add of its chain, never on memory, and every
//      stage takes the same unrolled adds.  x + (+0) is x for every sum
//      a chain can hold (it starts at +0, and a round-to-nearest sum is
//      -0 only when both terms are -0), so the padding leaves the sums
//      bitwise the twin's.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kGroupWarps = 8;
constexpr int kGroupThreads = 32 * kGroupWarps;
constexpr int kUnroll = 4;        // rows per lane in flight in phases A, C
constexpr int kUnitRows = kGroupThreads * kUnroll;
// a block of the grouping takes about kBlockUnits x max(L, kUnitRows)
// rows: the [L][G] counts stay near n / kBlockUnits words or fewer
constexpr int kBlockUnits = 4;
constexpr int kChunkVecs = 256;  // float4s a chunk of the sums: 512 rows
constexpr int kStages = 4;        // the sums' ring: stages of a chunk each
constexpr int kPrefetch = 8;      // float4s the sums' adds read ahead
static_assert(kPrefetch < kChunkVecs, "a stage holds the reads ahead");
constexpr int kPlanGrid = 0, kPlanRowsPerBlock = 1, kPlanSmem = 2,
              kPlanSmemCounts = 3, kPlanScratch = 4;

struct GroupArgs {
  const int32_t* leaf;     // [n] leaf ids; ids outside [0, L) are skipped
  const float* g;          // [n]
  const float* h;          // [n]
  float2* grouped;         // [n] (g, h) pairs in leaf order
  int32_t* offsets;        // [L + 1]
  int* counts;             // [L][G], scanned in place
  int* parts;              // [G] slice sums
  int* wcount;             // [G][nw][L] counters where they miss smem
  long long n;
  long long rows_per_block;
  int L;
  int smem_counts;
};

// the warp's part of the block's rows: [lo, hi)
__device__ __forceinline__ void warp_rows(const GroupArgs& a, long long* lo,
                                          long long* hi) {
  const long long per_warp = a.rows_per_block / kGroupWarps;
  const long long b0 = static_cast<long long>(blockIdx.x) * a.rows_per_block;
  *lo = b0 + (threadIdx.x >> 5) * per_warp;
  *hi = min(*lo + per_warp, a.n);
}

__device__ __forceinline__ int leaf_of(const GroupArgs& a, long long r,
                                       long long hi) {
  if (r >= hi) return -1;
  const int l = __ldg(a.leaf + r);
  return static_cast<unsigned>(l) < static_cast<unsigned>(a.L) ? l : -1;
}

// the block's sum of v (every thread gets it); red: 32 ints of shared
__device__ int block_sum(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  __syncthreads();               // red is free
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int t = 0;
  for (int w = 0; w < kGroupWarps; ++w) t += red[w];
  return t;
}

// the block's inclusive scan of v; *total: the sum of all v
__device__ int block_scan(int v, int* red, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  __syncthreads();               // red is free
  if (lane == 31) red[warp] = x;
  __syncthreads();
  int before = 0, t = 0;
  for (int w = 0; w < kGroupWarps; ++w) {
    if (w < warp) before += red[w];
    t += red[w];
  }
  *total = t;
  return before + x;
}

__global__ void __launch_bounds__(kGroupThreads)
    leaf_group_kernel(GroupArgs a) {
  extern __shared__ __align__(16) int smem[];
  __shared__ int red[32];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int L = a.L, G = gridDim.x, b = blockIdx.x;
  int* wc = a.smem_counts
                ? smem
                : a.wcount + static_cast<long long>(b) * kGroupWarps * L;
  int* mine = wc + warp * L;
  long long lo, hi;
  warp_rows(a, &lo, &hi);

  // ---- A: each warp's count of each leaf ----
  for (int i = tid; i < kGroupWarps * L; i += kGroupThreads) wc[i] = 0;
  __syncthreads();
  for (long long b0 = lo; b0 < hi; b0 += 32 * kUnroll) {
    int l[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) l[j] = leaf_of(a, b0 + 32 * j + lane, hi);
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const unsigned peers = __match_any_sync(0xffffffffu, l[j]);
      // one leader per distinct leaf: plain adds to distinct words
      if (l[j] >= 0 && lane == __ffs(peers) - 1) mine[l[j]] += __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();
  for (int k = tid; k < L; k += kGroupThreads) {
    int c = 0;
    for (int w = 0; w < kGroupWarps; ++w) c += wc[w * L + k];
    a.counts[static_cast<long long>(k) * G + b] = c;
  }
  grid.sync();

  // ---- B: the exclusive scan of counts [L][G], block b's slice being
  // the L words from b * L ----
  int* slice = a.counts + static_cast<long long>(b) * L;
  int s = 0;
  for (int i = tid; i < L; i += kGroupThreads) s += __ldcg(slice + i);
  s = block_sum(s, red);
  if (tid == 0) a.parts[b] = s;
  grid.sync();
  int carry = 0, all = 0;
  for (int i = tid; i < G; i += kGroupThreads) {
    const int p = __ldcg(a.parts + i);
    if (i < b) carry += p;
    all += p;
  }
  carry = block_sum(carry, red);
  all = block_sum(all, red);
  for (int i0 = 0; i0 < L; i0 += kGroupThreads) {
    const int i = i0 + tid;
    const int v = i < L ? __ldcg(slice + i) : 0;
    int total;
    const int incl = block_scan(v, red, &total);
    if (i < L) slice[i] = carry + incl - v;
    carry += total;
  }
  if (b == 0 && tid == 0) a.offsets[L] = all;
  grid.sync();

  // ---- C: each warp's start in each leaf, then the stable scatter ----
  for (int k = tid; k < L; k += kGroupThreads) {
    int run = __ldcg(a.counts + static_cast<long long>(k) * G + b);
    if (b == 0) a.offsets[k] = run;
    for (int w = 0; w < kGroupWarps; ++w) {
      const int c = wc[w * L + k];
      wc[w * L + k] = run;
      run += c;
    }
  }
  __syncthreads();
  const unsigned lt = (1u << lane) - 1u;
  for (long long b0 = lo; b0 < hi; b0 += 32 * kUnroll) {
    int l[kUnroll];
    float2 q[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) l[j] = leaf_of(a, b0 + 32 * j + lane, hi);
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long r = b0 + 32 * j + lane;
      q[j] = l[j] >= 0 ? make_float2(__ldg(a.g + r), __ldg(a.h + r))
                       : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const unsigned peers = __match_any_sync(0xffffffffu, l[j]);
      if (l[j] >= 0) a.grouped[mine[l[j]] + __popc(peers & lt)] = q[j];
      __syncwarp();
      if (l[j] >= 0 && lane == __ffs(peers) - 1) mine[l[j]] += __popc(peers);
      __syncwarp();
    }
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool bar_try_wait(unsigned bar, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// wait until the barrier's phase of the given parity has completed
__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  while (!bar_try_wait(bar, parity)) {
  }
}

// the consumer's arrive (count 1) on a stage's empty barrier
__device__ __forceinline__ void bar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// a stage's full barrier expects `bytes` more of bulk copies (the
// producer's arrive: a release of its own stores into the stage)
__device__ __forceinline__ void bar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes)
               : "memory");
}

// one bulk copy (TMA; 16-byte aligned, a multiple of 16 bytes) of global
// memory into shared memory, completing on the barrier
__device__ __forceinline__ void bulk_load(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void add4(const float4& x, float& g, float& h) {
  g = __fadd_rn(g, x.x);
  h = __fadd_rn(h, x.y);
  g = __fadd_rn(g, x.z);
  h = __fadd_rn(h, x.w);
}

// Two warps a leaf.  Warp 0's lane 0, the producer, fills the stage of
// chunk c (kChunkVecs float4s of the leaf's segment, the float4 at q0
// first) once the consumer has released its last use: a bulk copy of
// the float4s wholly inside the leaf, and its own stores of +0 for the
// rows outside it (the first float4's row before the leaf, the last
// one's row after it, the last chunk's float4s past the segment).  Warp
// 1's lane 0, the consumer, adds every float4 of every chunk the same
// way, kPrefetch float4s ahead in registers, across the chunks too.
__global__ void __launch_bounds__(64)
    leaf_sums_kernel(const float4* __restrict__ pairs,
                     const int32_t* __restrict__ offsets,
                     float* __restrict__ out, int L) {
  __shared__ __align__(128) float4 ring[kStages][kChunkVecs];
  __shared__ __align__(8) unsigned long long full[kStages], empty[kStages];
  const int l = blockIdx.x, tid = threadIdx.x;
  const int s = __ldg(offsets + l), e = __ldg(offsets + l + 1);
  const long long q0 = s >> 1;
  const long long q1 = (static_cast<long long>(e) + 1) >> 1;
  const int chunks =
      e > s ? static_cast<int>((q1 - q0 + kChunkVecs - 1) / kChunkVecs) : 0;
  if (tid == 0) {
    for (int k = 0; k < kStages; ++k) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(&full[k]))
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(&empty[k]))
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = 0; c < chunks; ++c) {
      const int st = c % kStages;
      if (c >= kStages)  // the consumer has added the stage's last use
        bar_wait(smem_addr(&empty[st]), ((c / kStages) - 1) & 1);
      float4* v = ring[st];
      const long long qa = q0 + static_cast<long long>(c) * kChunkVecs;
      const long long qb = q1 - qa < kChunkVecs ? q1 : qa + kChunkVecs;
      // [lo, hi): the float4s the bulk copy brings
      long long lo = qa, hi = qb;
      if (c == 0 && (s & 1)) {
        const float4 p = __ldg(pairs + q0);
        v[0] = make_float4(0.f, 0.f, p.z, p.w);
        lo = qa + 1;
      }
      if (qb == q1) {
        if (e & 1) {
          if (hi - 1 >= lo) {
            const float4 p = __ldg(pairs + q1 - 1);
            v[q1 - 1 - qa] = make_float4(p.x, p.y, 0.f, 0.f);
          }
          hi = q1 - 1;
        }
        for (long long k = qb - qa; k < kChunkVecs; ++k) v[k] = zero;
      }
      if (lo != qa || hi != qb || qb - qa < kChunkVecs)
        // its own stores and the bulk copy's share the stage
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const unsigned bytes =
          hi > lo ? static_cast<unsigned>((hi - lo) * 16) : 0u;
      bar_expect(smem_addr(&full[st]), bytes);
      if (bytes)
        bulk_load(smem_addr(v + (lo - qa)), pairs + lo, bytes,
                  smem_addr(&full[st]));
    }
  } else if (tid == 32) {
    // the g and h chains, interleaved; x + (+0) is x for every value a
    // chain holds (it starts at +0, and a round-to-nearest sum is -0 only
    // when both terms are), so the padding leaves them as the twin's
    float g = 0.f, h = 0.f;
    float4 buf[kPrefetch];
    if (chunks > 0) {
      bar_wait(smem_addr(&full[0]), 0);
#pragma unroll
      for (int j = 0; j < kPrefetch; ++j) buf[j] = ring[0][j];
    }
    for (int c = 0; c < chunks; ++c) {
      const float4* v = ring[c % kStages];
      const float4* vn = ring[(c + 1) % kStages];
      const bool more = c + 1 < chunks;
#pragma unroll
      for (int k = 0; k < kChunkVecs; ++k) {
        const float4 x = buf[k % kPrefetch];
        if (k + kPrefetch < kChunkVecs) {
          buf[k % kPrefetch] = v[k + kPrefetch];
        } else {
          if (k + kPrefetch == kChunkVecs) {
            // the next stage is full; this one is read to its end
            if (more)
              bar_wait(smem_addr(&full[(c + 1) % kStages]),
                       ((c + 1) / kStages) & 1);
            bar_arrive(smem_addr(&empty[c % kStages]));
          }
          if (more) buf[k % kPrefetch] = vn[k + kPrefetch - kChunkVecs];
        }
        add4(x, g, h);
      }
    }
    out[l] = g;
    out[L + l] = h;
  }
}

inline int returned(cudaError_t err) {
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}

// the grouping's plan for n rows and L leaves on the current device,
// cached a device (the attributes and the occupancy query cost host time)
int group_plan(long long n, int L, int* plan) {
  struct Limits {
    int sms = 0, smem_optin = 0, smem_set = 0;
  };
  static Limits lim[16];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 16) return static_cast<int>(cudaErrorInvalidDevice);
  Limits& d = lim[dev];
  if (d.sms == 0) {
    cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&d.smem_optin,
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  // the per-warp counters in shared memory where the block's fit
  const long long words = static_cast<long long>(kGroupWarps) * L;
  const int in_smem = words * 4 <= d.smem_optin - 1024 ? 1 : 0;
  const int smem = in_smem ? static_cast<int>(words * 4) : 0;
  auto* fn = leaf_group_kernel;
  if (smem > d.smem_set) {
    // with all of the SM's unified L1/shared storage as shared memory
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          fn, cudaFuncAttributePreferredSharedMemoryCarveout,
          static_cast<int>(cudaSharedmemCarveoutMaxShared));
    if (err != cudaSuccess) return static_cast<int>(err);
    d.smem_set = smem;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                      kGroupThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  // no more blocks than the card holds at once
  const long long unit = kUnitRows;
  const long long want =
      kBlockUnits * (L > unit ? static_cast<long long>(L) : unit);
  long long grid = (n + want - 1) / want;
  grid = grid < 1 ? 1 : grid;
  grid = grid > static_cast<long long>(per_sm) * d.sms
             ? static_cast<long long>(per_sm) * d.sms
             : grid;
  long long rpb = (n + grid - 1) / grid;
  rpb = (rpb + unit - 1) / unit * unit;
  rpb = rpb < unit ? unit : rpb;
  grid = n > 0 ? (n + rpb - 1) / rpb : 1;
  plan[kPlanGrid] = static_cast<int>(grid);
  plan[kPlanRowsPerBlock] = static_cast<int>(rpb);
  plan[kPlanSmem] = smem;
  plan[kPlanSmemCounts] = in_smem;
  const long long scratch =
      grid * L + grid + (in_smem ? 0 : grid * words);
  if (scratch > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  plan[kPlanScratch] = static_cast<int>(scratch);
  return 0;
}

}  // namespace

// The grouping's plan (see group_plan): out[0] the grid, out[1] rows a
// block, out[2] dynamic shared memory bytes, out[3] 1 where the per-warp
// counters are in shared memory, out[4] the int32 scratch words the
// caller allocates.  Returns a cudaError_t (0 = planned).
extern "C" int lgbt_leaf_group_plan(long long n, int L, int* out) {
  if (n < 0 || n > 0x7fffffffLL || L < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return returned(static_cast<cudaError_t>(group_plan(n, L, out)));
}

// leaf [n] int32, vals [2, n] f32 (g then h); grouped [n] float2 (8-byte
// aligned), offsets [L + 1] int32, scratch: plan[4] int32 words.  plan:
// lgbt_leaf_group_plan's for the same n and L.  One cooperative launch.
extern "C" int lgbt_leaf_group(const void* leaf, const void* vals,
                               long long n, int L, void* grouped,
                               void* offsets, void* scratch, const int* plan,
                               void* stream) {
  if (n < 0 || n > 0x7fffffffLL || L < 1 || plan[kPlanGrid] < 1
      || plan[kPlanRowsPerBlock] % kUnitRows != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  GroupArgs a;
  a.leaf = static_cast<const int32_t*>(leaf);
  a.g = static_cast<const float*>(vals);
  a.h = a.g + n;
  a.grouped = static_cast<float2*>(grouped);
  a.offsets = static_cast<int32_t*>(offsets);
  const long long G = plan[kPlanGrid];
  a.counts = static_cast<int*>(scratch);
  a.parts = a.counts + G * L;
  a.wcount = a.parts + G;
  a.n = n;
  a.rows_per_block = plan[kPlanRowsPerBlock];
  a.L = L;
  a.smem_counts = plan[kPlanSmemCounts];
  void* args[] = {&a};
  return returned(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(leaf_group_kernel),
      dim3(static_cast<unsigned>(G)), dim3(kGroupThreads), args,
      static_cast<size_t>(plan[kPlanSmem]),
      static_cast<cudaStream_t>(stream)));
}

// grouped: [n_even] (g, h) pairs in leaf order, 16-byte aligned, n_even
// >= offsets[L] rounded up to even; offsets [L + 1] int32; out [2, L] f32.
// A grid of L blocks of two warps.
extern "C" int lgbt_leaf_sums(const void* grouped, const void* offsets,
                              void* out, int L, void* stream) {
  if (L < 1) return static_cast<int>(cudaErrorInvalidValue);
  leaf_sums_kernel<<<L, 64, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(grouped),
      static_cast<const int32_t*>(offsets), static_cast<float*>(out), L);
  return returned(cudaGetLastError());
}
