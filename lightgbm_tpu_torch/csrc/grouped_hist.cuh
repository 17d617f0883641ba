// The grouped K-slot histogram: the body of kernels B1 (histogram.cu) and
// B2 (fused.cu).  One cooperative launch (all blocks resident), in three
// phases separated by grid-wide barriers:
//
//   A  count: each warp reads the leaf ids of its part of its block's
//      tile of rows once, finds each row's slot (the first slot holding
//      its leaf id: a byte table in shared memory for ids below kTable, K
//      compares above) and counts the live rows of each slot, one add per
//      distinct slot of a warp (__match_any_sync).  The blocks also zero
//      the output here.
//   B  group: every block adds up the [K, grid] per-block counts into the
//      [K+1] slot offsets and its own start in each slot; each warp then
//      writes the indices of its live rows, stable in row order, into a
//      list grouped by slot, with each row's packed stats (16 bytes)
//      beside it.  A leaf id held by two live slots is listed once, under
//      the first; the later slot gets the same sums at the flush.  Dead
//      slots and rows in no slot cost their leaf id and nothing more.
//   C  histogram: the list is cut into segments of at least seg_rows
//      rows, one per block at a time (segments x feature chunks of 32).
//      A block keeps one slot's [B][S][32] sums in shared memory and walks
//      the part of its segment that lies in each slot: a warp takes 32
//      list entries, lane e gathers entry e's bins (one 32-byte sector of
//      the row-major copy [n, FR]), a tile in shared memory turns them
//      around, and lane f adds each row's S stats at feature f's bin, so
//      no two lanes of a warp share an address.  At the end of each slot's
//      part the block adds its non-zero sums into the output [K][F][BSp]
//      (a slot's words contiguous, rows padded to 4 words) with global
//      atomics, a warp's 32 lanes on consecutive words.
//
// The adds.  int32 sums (int8/int16 stats) use the native shared ATOMS.ADD
// and global RED.ADD, exact in any order.  An f32 atomicAdd on shared
// memory compiles on sm_90a to a compare-and-swap loop (ATOMS.CAST.SPIN;
// 140 such sites in the previous B1 kernel, counted with cuobjdump), and
// under contention such a loop retries: with every row in one slot the
// previous kernel took 8.95 ms against 0.354 ms for the same call with
// int32 sums (NVIDIA H100 80GB HBM3, 700 W).  Here no two lanes of a warp
// share an address (lane = feature), the f32 sums keep lane f on bank f,
// and each lane sums runs of equal bins in registers before it adds
// them, so a bin that holds most rows (the padding features, a feature
// that is mostly zero or missing) costs one atomic per run, not one per
// row.  f32 sums then depend on the order in which the warps' runs and
// the blocks' flushes arrive: last-bit differences from run to run,
// within the tolerance stated where the kernel is checked against its
// plain twin (1e-6 of the slot's sum of |stat|).
//
// What bounds it on this card: the bytes, in principle (every leaf id,
// the bins and stats of the live rows, the output: 3.6 us at 9.4% of 1M
// rows live, 15 us at the root call).  In practice the dependent loads
// (list entry, then its row's bins) and the global atomics of the
// flushes, each block's B x S x 32 words per slot it touched.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lgbt {

namespace cg = cooperative_groups;

constexpr int kMaxS = 5;
constexpr int kChunk = 32;       // features per chunk: one per lane
// Shared sums of (bin, stat, feature) at ((bin * S + stat) * stride +
// feature).  The flush wants a warp's 32 global adds on 32 consecutive
// (bin, stat) words of one feature.  int32 sums: stride 33, so those 32
// words sit on 32 banks and the flush reads them directly; the native
// shared adds of phase C do not mind the bank conflicts that this gives
// lanes with different bins.  f32 sums: their compare-and-swap loops do
// mind (a bank conflict serializes each load and compare-and-swap), so
// stride 32 keeps lane f on bank f, and the flush transposes 32 x 32
// tiles through a per-warp staging buffer (kStageWarps warps flush).
template <typename Acc>
struct Layout {
  static constexpr int kStride = kChunk + 1;
};
template <>
struct Layout<float> {
  static constexpr int kStride = kChunk;
};
constexpr int kStageWarps = 8;
constexpr int kStageWords = kChunk * (kChunk + 1);
// phase C's per-warp tile of 32 entries' bins: 8 words and a pad each
constexpr int kTileStride = 9;
constexpr int kTileWords = 32 * kTileStride;
constexpr int kGroupUnroll = 4;  // rows per lane in flight in phases A, B
constexpr int kMaxThreads = 1024;
// stat types (the wrapper's _STAT_KINDS)
constexpr int kBF16 = 0, kF32 = 1, kI8 = 2, kI16 = 3;
// plan fields (ops/histogram.py HistPlan order)
constexpr int kPlanThreads = 0, kPlanSmem = 1, kPlanChunks = 2,
              kPlanGrid = 3, kPlanSegRows = 4, kPlanTileRows = 5,
              kPlanFields = 6;

struct HistArgs {
  const uint8_t* bins_rm;  // [n, FR] row-major bins
  const void* stats;       // [S, n]
  const int32_t* leaf;     // [n]
  const int32_t* slots;    // [K]
  uint4* gstats;           // scratch [n] packed stats, grouped
  int32_t* rows;           // scratch [n] row indices, grouped
  int32_t* counts;         // scratch [K, grid] per-block slot counts
  int32_t* offsets;        // scratch [K + 1] slot offsets (for the tests)
  void* raw;               // out [K, F, BSp]: B * S words padded to 4
  long long n;
  int FR, kind, S, F, K, B;
  int chunks, seg_rows, tile_rows;
  int group_only;          // stop after phase B (the tests' entry)
};

// leaf ids below this find their slot in a table in shared memory; the
// others compare against the K slot ids
constexpr int kTable = 4096;
constexpr int kTableWords = kTable / 4;
constexpr unsigned char kNone = 255;

// shared memory: persistent part, then a union of the phases' parts
struct Persist {
  int* sl;    // [K] slot ids
  int* nxt;   // [K] next slot with the same leaf id, -1 = none
  int* off;   // [K + 1] slot offsets
  int* base;  // [K] this block's next write position in each slot
};

__device__ __forceinline__ int persist_words(int K) { return 4 * K + 1; }

// words of one (slot, feature) row of raw: B * S padded to 4, so that
// the f32 flush's 16-byte atomics stay aligned
__host__ __device__ __forceinline__ int padded_row(int B, int S) {
  return (B * S + 3) & ~3;
}

__device__ __forceinline__ Persist persist_of(int* smem, int K) {
  return Persist{smem, smem + K, smem + 2 * K, smem + 3 * K + 1};
}

// the first slot holding leaf id l, -1 if none (negative ids are dead)
__device__ __forceinline__ int slot_of(const int* sl, const unsigned char* tab,
                                       int K, int l) {
  if (l < 0) return -1;
  if (l < kTable) {
    const int t = tab[l];
    return t == kNone ? -1 : t;
  }
  for (int k = 0; k < K; ++k)
    if (sl[k] == l) return k;
  return -1;
}

__device__ __forceinline__ uint4 pack_stats(const void* stats, int kind,
                                            int S, long long n,
                                            long long r) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (kind == kF32) {
    const float* p = static_cast<const float*>(stats);
    for (int s = 0; s < 4; ++s)
      if (s < S) w[s] = __float_as_uint(p[s * n + r]);
  } else if (kind == kI8) {
    const uint8_t* p = static_cast<const uint8_t*>(stats);
    for (int s = 0; s < 4; ++s)
      if (s < S) w[0] |= static_cast<uint32_t>(p[s * n + r]) << (8 * s);
    // S <= 4 bytes fit one word; a fifth goes to the next
    if (S > 4) w[1] = p[4 * n + r];
  } else {  // bf16 or int16: 2 bytes each
    const uint16_t* p = static_cast<const uint16_t*>(stats);
    for (int s = 0; s < kMaxS; ++s)
      if (s < S) w[s >> 1] |= static_cast<uint32_t>(p[s * n + r])
                              << (16 * (s & 1));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename Acc>
__device__ __forceinline__ void unpack_stats(uint4 q, int kind, Acc* v);

template <>
__device__ __forceinline__ void unpack_stats<float>(uint4 q, int kind,
                                                    float* v) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int s = 0; s < kMaxS; ++s) {
    if (kind == kF32) {
      v[s] = s < 4 ? __uint_as_float(w[s & 3]) : 0.f;
    } else {
      // bf16 -> f32 is exact: the bf16 bits are the high half
      const uint32_t h = (w[s >> 1] >> (16 * (s & 1))) & 0xffffu;
      v[s] = __uint_as_float(h << 16);
    }
  }
}

template <>
__device__ __forceinline__ void unpack_stats<int>(uint4 q, int kind,
                                                  int* v) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int s = 0; s < kMaxS; ++s) {
    if (kind == kI8) {
      const uint32_t b = s < 4 ? (w[0] >> (8 * s)) & 0xffu : w[1] & 0xffu;
      v[s] = static_cast<int>(static_cast<int8_t>(b));
    } else {
      const uint32_t h = (w[s >> 1] >> (16 * (s & 1))) & 0xffffu;
      v[s] = static_cast<int>(static_cast<int16_t>(h));
    }
  }
}

// ---- phase A: slot ids, duplicate chains, per-warp counts, zero raw ----
// Each warp of a block takes a contiguous part of the block's tile, so
// that the scatter in phase B needs no block barrier: warp w's rows come
// after warp w-1's in every slot.
__device__ __forceinline__ void warp_rows(const HistArgs& a, long long* lo,
                                          long long* hi) {
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const long long t0 = static_cast<long long>(blockIdx.x) * a.tile_rows;
  // tile_rows: a multiple of 32 * kGroupUnroll * nw
  const long long sub = a.tile_rows / nw;
  *lo = min(a.n, t0 + warp * sub);
  *hi = min(a.n, *lo + sub);
}

template <typename Acc>
__device__ void phase_count(const HistArgs& a, const Persist& p,
                            int* wc /* [nwarps][K] */, int* tab_words) {
  const int K = a.K;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  for (int k = tid; k < K; k += nt) p.sl[k] = a.slots[k];
  for (int i = tid; i < nw * K; i += nt) wc[i] = 0;
  for (int i = tid; i < kTableWords; i += nt) tab_words[i] = -1;  // kNone
  __syncthreads();
  unsigned char* tab = reinterpret_cast<unsigned char*>(tab_words);
  if (tid == 0)  // the last write of an id is its first slot
    for (int k = K - 1; k >= 0; --k)
      if (p.sl[k] >= 0 && p.sl[k] < kTable)
        tab[p.sl[k]] = static_cast<unsigned char>(k);
  for (int k = tid; k < K; k += nt) {
    int nx = -1;
    if (p.sl[k] >= 0)
      for (int k2 = k + 1; k2 < K; ++k2)
        if (p.sl[k2] == p.sl[k]) {
          nx = k2;
          break;
        }
    p.nxt[k] = nx;
  }
  __syncthreads();  // the table is written
  // the output: every block zeroes a stripe
  {
    const long long words =
        static_cast<long long>(a.F) * a.K * padded_row(a.B, a.S);
    Acc* raw = static_cast<Acc*>(a.raw);
    for (long long i = static_cast<long long>(blockIdx.x) * nt + tid;
         i < words; i += static_cast<long long>(gridDim.x) * nt)
      raw[i] = Acc(0);
  }
  long long lo, hi;
  warp_rows(a, &lo, &hi);
  int* mine = wc + warp * K;
  for (long long b0 = lo; b0 < hi; b0 += 32 * kGroupUnroll) {
    int l[kGroupUnroll];
#pragma unroll
    for (int j = 0; j < kGroupUnroll; ++j) {
      const long long r = b0 + 32 * j + lane;
      l[j] = r < hi ? a.leaf[r] : -1;
    }
#pragma unroll
    for (int j = 0; j < kGroupUnroll; ++j) {
      const int s = slot_of(p.sl, tab, K, l[j]);
      const unsigned peers = __match_any_sync(0xffffffffu, s);
      // one leader per distinct slot: plain adds to distinct words
      if (s >= 0 && lane == __ffs(peers) - 1) mine[s] += __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();
  for (int k = tid; k < K; k += nt) {
    int c = 0;
    for (int w = 0; w < nw; ++w) c += wc[w * K + k];
    a.counts[static_cast<long long>(k) * gridDim.x + blockIdx.x] = c;
  }
}

// ---- phase B: offsets, then the stable scatter into the grouped list ----
__device__ inline void phase_group(const HistArgs& a, const Persist& p,
                                   const int* wc /* [nwarps][K] */,
                                   int* wb /* [nwarps][K] */, int* tot,
                                   const unsigned char* tab) {
  const int K = a.K;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int G = gridDim.x;
  // this block's start in each slot and the slot totals
  for (int k = warp; k < K; k += nw) {
    int before = 0, total = 0;
    // slot k's counts are contiguous: a warp reads them coalesced
    for (int b = lane; b < G; b += 32) {
      const int c = __ldcg(a.counts + static_cast<long long>(k) * G + b);
      total += c;
      if (b < static_cast<int>(blockIdx.x)) before += c;
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      before += __shfl_xor_sync(0xffffffffu, before, d);
      total += __shfl_xor_sync(0xffffffffu, total, d);
    }
    if (lane == 0) {
      p.base[k] = before;
      tot[k] = total;
    }
  }
  __syncthreads();
  if (tid == 0) {
    int o = 0;
    for (int k = 0; k < K; ++k) {
      p.off[k] = o;
      p.base[k] += o;
      o += tot[k];
    }
    p.off[K] = o;
  }
  __syncthreads();
  if (blockIdx.x == 0)
    for (int k = tid; k <= K; k += nt) a.offsets[k] = p.off[k];
  // each warp's start: the block's, plus the earlier warps' rows
  for (int i = tid; i < nw * K; i += nt) {
    const int w = i / K, k = i % K;
    int o = p.base[k];
    for (int w2 = 0; w2 < w; ++w2) o += wc[w2 * K + k];
    wb[i] = o;
  }
  __syncthreads();

  const unsigned lt = (1u << lane) - 1u;
  int* mine = wb + warp * K;
  long long lo, hi;
  warp_rows(a, &lo, &hi);
  for (long long b0 = lo; b0 < hi; b0 += 32 * kGroupUnroll) {
    int s[kGroupUnroll];
    uint4 q[kGroupUnroll];
#pragma unroll
    for (int j = 0; j < kGroupUnroll; ++j) {
      const long long r = b0 + 32 * j + lane;
      s[j] = r < hi ? slot_of(p.sl, tab, K, __ldg(a.leaf + r)) : -1;
    }
#pragma unroll
    for (int j = 0; j < kGroupUnroll; ++j)
      q[j] = s[j] >= 0 ? pack_stats(a.stats, a.kind, a.S, a.n,
                                    b0 + 32 * j + lane)
                       : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int j = 0; j < kGroupUnroll; ++j) {
      const unsigned peers = __match_any_sync(0xffffffffu, s[j]);
      if (s[j] >= 0) {
        const int pos = mine[s[j]] + __popc(peers & lt);
        a.rows[pos] = static_cast<int32_t>(b0 + 32 * j + lane);
        a.gstats[pos] = q[j];
      }
      __syncwarp();
      if (s[j] >= 0 && lane == __ffs(peers) - 1) mine[s[j]] += __popc(peers);
      __syncwarp();
    }
  }
}

// one lane's run of equal bins, added into the block's sums
template <typename Acc>
__device__ __forceinline__ void add_run(Acc* sh, int bin, const Acc* acc,
                                        int S, int f) {
#pragma unroll
  for (int s = 0; s < kMaxS; ++s)
    if (s < S) atomicAdd(sh + (bin * S + s) * Layout<Acc>::kStride + f,
                         acc[s]);
}

// rows [a0, e0) of the grouped list, features [f0, f0 + fc).  A warp
// takes 32 list entries at a time: lane e loads entry e (row index,
// packed stats) and gathers that row's 32 bins (one 32-byte sector, two
// 16-byte loads), so the warp has 32 gathers in flight; the bins go
// through the warp's tile in shared memory (9 words an entry: lane e's
// writes on distinct banks) and lane f reads feature f of each entry.
template <typename Acc>
__device__ void accumulate(const HistArgs& a, Acc* sh, uint32_t* tile,
                           int a0, int e0, int f0, int fc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const bool feat = lane < fc;
  const int S = a.S, B = a.B;
  const unsigned full = 0xffffffffu;
  // the 32-bit words a row's packed stats fill
  const int esize = (a.kind == kF32) ? 4 : (a.kind == kI8 ? 1 : 2);
  const int qwords = (S * esize + 3) / 4;
  int cur = -1;
  Acc acc[kMaxS];
#pragma unroll
  for (int s = 0; s < kMaxS; ++s) acc[s] = Acc(0);
  for (int base = a0 + warp * 32; base < e0; base += nw * 32) {
    const int i = base + lane;
    const int cnt = min(32, e0 - base);
    uint4 my_q = make_uint4(0u, 0u, 0u, 0u);
    uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
    if (i < e0) {
      const int r = __ldcg(a.rows + i);
      my_q = __ldcg(a.gstats + i);
      const uint4* src = reinterpret_cast<const uint4*>(
          a.bins_rm + static_cast<long long>(r) * a.FR + f0);
      lo = __ldg(src);
      hi = __ldg(src + 1);
    }
    uint32_t* t = tile + lane * kTileStride;
    t[0] = lo.x; t[1] = lo.y; t[2] = lo.z; t[3] = lo.w;
    t[4] = hi.x; t[5] = hi.y; t[6] = hi.z; t[7] = hi.w;
    __syncwarp();
    for (int e = 0; e < cnt; ++e) {
      uint4 q = make_uint4(0u, 0u, 0u, 0u);
      q.x = __shfl_sync(full, my_q.x, e);
      if (qwords > 1) q.y = __shfl_sync(full, my_q.y, e);
      if (qwords > 2) q.z = __shfl_sync(full, my_q.z, e);
      if (qwords > 3) q.w = __shfl_sync(full, my_q.w, e);
      const int bin = feat ? (tile[e * kTileStride + (lane >> 2)]
                              >> (8 * (lane & 3))) & 0xffu
                           : 256;
      if (bin >= B) continue;  // not a feature, or a bin past num_bins
      Acc v[kMaxS];
      unpack_stats<Acc>(q, a.kind, v);
      if (bin == cur) {
#pragma unroll
        for (int s = 0; s < kMaxS; ++s) acc[s] += v[s];
      } else {
        if (cur >= 0) add_run<Acc>(sh, cur, acc, S, lane);
        cur = bin;
#pragma unroll
        for (int s = 0; s < kMaxS; ++s) acc[s] = v[s];
      }
    }
    __syncwarp();
  }
  if (cur >= 0) add_run<Acc>(sh, cur, acc, S, lane);
}

// the block's sums of slot k into raw (and into every later slot with
// the same leaf id), then zero them.  raw is [K][F][BSp], so the words
// of one (slot, feature) are contiguous and a warp's global adds cover
// consecutive words: int32 sums one word a lane, f32 sums four (one
// 16-byte atomic a lane, sm_90).
template <typename Acc>
__device__ void flush(const HistArgs& a, const Persist& p, Acc* sh, int k,
                      int f0, int fc) {
  Acc* raw = static_cast<Acc*>(a.raw);
  const int BS = a.B * a.S, BSp = padded_row(a.B, a.S);
  if constexpr (Layout<Acc>::kStride != kChunk) {
    for (int i = threadIdx.x; i < fc * BS; i += blockDim.x) {
      const int f = i / BS, rem = i % BS;  // rem = bin * S + stat
      Acc* src = sh + rem * Layout<Acc>::kStride + f;
      const Acc v = *src;
      if (v == Acc(0)) continue;
      *src = Acc(0);
      for (int kk = k; kk >= 0; kk = p.nxt[kk])
        atomicAdd(raw + (static_cast<long long>(kk) * a.F + f0 + f) * BSp
                      + rem,
                  v);
    }
  } else {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (warp < kStageWarps) {
      Acc* st = sh + BS * kChunk + warp * kStageWords;
      const int sub = lane & 7, grp = lane >> 3;
      for (int r0 = warp * 32; r0 < BS; r0 += kStageWarps * 32) {
        // read lane = feature (bank = lane), write transposed
#pragma unroll 4
        for (int j = 0; j < 32; ++j) {
          Acc v = Acc(0);
          if (r0 + j < BS) {
            Acc* src = sh + (r0 + j) * kChunk + lane;
            v = *src;
            *src = Acc(0);
          }
          st[j * (kChunk + 1) + lane] = v;
        }
        __syncwarp();
        // lane (grp, sub): words r0 + 4 sub .. + 3 of features grp + 4 i
        const int rem = r0 + 4 * sub;
        if (rem < BSp) {
          for (int f = grp; f < fc; f += 4) {
            const Acc* c = st + 4 * sub * (kChunk + 1) + f;
            const float4 v = make_float4(c[0], c[kChunk + 1],
                                         c[2 * (kChunk + 1)],
                                         c[3 * (kChunk + 1)]);
            if (v.x == 0.f && v.y == 0.f && v.z == 0.f && v.w == 0.f)
              continue;
            for (int kk = k; kk >= 0; kk = p.nxt[kk])
              atomicAdd(reinterpret_cast<float4*>(
                            raw + (static_cast<long long>(kk) * a.F + f0 + f)
                                      * BSp
                            + rem),
                        v);
          }
        }
        __syncwarp();
      }
    }
  }
}

// rows of the grouped list a block takes at a time: at least seg_rows,
// and few enough that the grid's blocks share the m rows x chunks
__device__ __forceinline__ int segment_rows(const HistArgs& a, int m) {
  const long long per =
      (static_cast<long long>(m) * a.chunks + gridDim.x - 1) / gridDim.x;
  return static_cast<int>(per > a.seg_rows ? per : a.seg_rows);
}

// ---- phase C ----
template <typename Acc>
__device__ void phase_hist(const HistArgs& a, const Persist& p, Acc* sh) {
  const int K = a.K;
  const int words = a.B * a.S * Layout<Acc>::kStride;
  for (int i = threadIdx.x; i < words; i += blockDim.x) sh[i] = Acc(0);
  // the warps' bins tiles after the sums (the f32 flush's staging tiles
  // use the same words, at another time)
  uint32_t* tiles = reinterpret_cast<uint32_t*>(
      sh + a.B * a.S * Layout<Acc>::kStride);
  __syncthreads();
  const int m = p.off[K];
  if (m == 0) return;
  const int R = segment_rows(a, m);
  const int nr = (m + R - 1) / R;
  const int G = gridDim.x;
  const int items = nr * a.chunks;
  for (int t = blockIdx.x; t < items; t += G) {
    const int c = t / nr, i = t % nr;
    const int lo = i * R, hi = min(m, lo + R);
    const int f0 = c * kChunk, fc = min(kChunk, a.F - f0);
    for (int k = 0; k < K; ++k) {
      const int s0 = max(lo, p.off[k]), e0 = min(hi, p.off[k + 1]);
      if (s0 >= e0) continue;
      accumulate<Acc>(a, sh, tiles + (threadIdx.x >> 5) * kTileWords, s0,
                      e0, f0, fc);
      __syncthreads();
      flush<Acc>(a, p, sh, k, f0, fc);
      __syncthreads();
    }
  }
}

// The kernel: phases A, B, C and, for B2, the tail (the split scan).
// Tail::run(args, tail_args) runs after a last grid barrier.
template <typename Acc, class Tail>
__global__ void __launch_bounds__(kMaxThreads)
    grouped_hist_kernel(HistArgs a, typename Tail::Args t) {
  extern __shared__ __align__(16) int smem[];
  cg::grid_group grid = cg::this_grid();
  const Persist p = persist_of(smem, a.K);
  // the union region starts 16-byte aligned after the persistent words
  int* un = smem + ((persist_words(a.K) + 3) & ~3);
  const int warp_words = (blockDim.x >> 5) * a.K;
  int* tab = un + 2 * warp_words + a.K;
  phase_count<Acc>(a, p, un, tab);
  grid.sync();
  phase_group(a, p, un, un + warp_words, un + 2 * warp_words,
              reinterpret_cast<const unsigned char*>(tab));
  if (a.group_only) return;
  grid.sync();
  phase_hist<Acc>(a, p, reinterpret_cast<Acc*>(un));
  if constexpr (Tail::kRuns) {
    grid.sync();
    Tail::run(a, t);
  }
}

struct NoTail {
  static constexpr bool kRuns = false;
  struct Args {};
  __device__ static void run(const HistArgs&, const Args&) {}
};

// Launch one call: plan[] from the wrapper (ops/histogram.py:hist_plan).
template <typename Acc, class Tail>
inline int launch_grouped(HistArgs a, typename Tail::Args t, const int* plan,
                          cudaStream_t st) {
  const int threads = plan[kPlanThreads];
  const int smem = plan[kPlanSmem];
  const int grid = plan[kPlanGrid];
  auto* fn = grouped_hist_kernel<Acc, Tail>;
  // the function attributes and the resident-grid check, once per device
  // and shared-memory size (they cost host time on every call otherwise)
  struct Checked {
    int smem = -1, threads = 0, set = 0, max_grid = 0;
  };
  static Checked checked[16];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 16) return static_cast<int>(cudaErrorInvalidDevice);
  Checked& c = checked[dev];
  if (c.smem != smem || c.threads != threads) {
    if (smem > c.set) {
      err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      // all of the SM's unified L1/shared storage as shared memory, so
      // that the plan's blocks per SM fit
      err = cudaFuncSetAttribute(
          fn, cudaFuncAttributePreferredSharedMemoryCarveout,
          static_cast<int>(cudaSharedmemCarveoutMaxShared));
      if (err != cudaSuccess) return static_cast<int>(err);
      c.set = smem;
    }
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                        threads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    c.max_grid = per_sm * sms;
    c.smem = smem;
    c.threads = threads;
  }
  // a cooperative grid must be resident at once
  if (grid < 1 || grid > c.max_grid)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  a.chunks = plan[kPlanChunks];
  a.seg_rows = plan[kPlanSegRows];
  a.tile_rows = plan[kPlanTileRows];
  void* args[] = {&a, &t};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fn),
                                    dim3(grid),
                                    dim3(threads), args,
                                    static_cast<size_t>(smem), st);
  return static_cast<int>(err);
}

}  // namespace lgbt
