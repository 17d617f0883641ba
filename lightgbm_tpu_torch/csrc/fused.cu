// Kernel B2: the grow megakernel (histogram + sibling subtraction + split
// scan).
//
// Replaces lightgbm_tpu/ops/fused.py:fused_hist_scan (pallas_call at
// fused.py:221).  For K slots of smaller children it builds their int32
// histograms, and for each of the 2K children (left 0..K-1, then right
// 0..K-1) and each feature it returns the per-feature best split record
// of ops/split.py:per_feature_best_split with acc_scale:
//     [gain, threshold, default_left, left_g, left_h, left_count, 0, 0]
// Child j reads slot k = j % K: the fresh histogram when
// ctx[j, CTX_USE_SMALL] > 0, else the parent's pooled histogram minus it.
// Row 2K of ctx holds the dequantization scales (g, h, count).
//
// The TPU kernel runs the scan at its last row block, while the finished
// accumulator is still in VMEM.  The GPU form of that step: the kernel is
// B1's grouped histogram (grouped_hist.cuh: rows grouped by slot, int32
// shared atomics, flushed into the output with global atomics) in one
// cooperative launch, and after a last grid-wide barrier the same blocks
// take the 2K x F (child, feature) scans, reading the fresh histograms
// (2.4 MB at K = 25, F = 32) from L2.  One launch a round, where the
// previous version took four (slot pass, histogram, reduce, scan).
//
// The scan: the blocks are cut into parts of 256 threads, each with its
// own named barrier, and a part takes one (child, feature) at a time, in
// tiles of 256 bins, one thread a bin.  Each thread masks its bin as the
// search does (the zero bin of a zero-missing feature, the NaN bin, bins
// past num_bin), the part takes inclusive int32 prefix sums of (g, h,
// count) -- exact in any order -- carried from tile to tile, and each
// thread dequantizes its prefix, evaluates both missing-value directions
// at its threshold, and keeps its best of each direction with the int32
// prefix sums there; the part then reduces to the best threshold of each
// direction: the first maximum for +1 and the last for -1, across tiles
// too, the reference's tie-break that the twin takes with argmax.  With
// more than one tile (wide bins, B > 256) a first pass adds up the
// totals that direction -1 reads; with one they are the tile's.  (One
// warp per item, eight bins a lane, keeps a serial chain of sixteen gain
// evaluations a lane: 73 us a round against about 14 us for one thread a
// bin, NVIDIA H100 80GB HBM3, 700 W.)
//
// Wide bins (int32 bins_t; the TPU kernel reads them at fused.py:148):
// the histogram phases are B1's WideBins instance (16-bit row-major
// bins, a slot's sums spread over a thread-block cluster, one tile of
// bins a block, each live row read once per tile group;
// grouped_hist.cuh), in one launch that is cooperative and clustered at
// once, so the scan still follows a grid barrier.
//
// Rounding: the twin is a sequence of PyTorch elementwise ops, each
// rounded on its own.  Every product, sum and quotient here is written
// with the _rn intrinsics, in the twin's order, and the file is built
// with --fmad=false, so no a*b+c contracts into an FMA that would round
// once where the twin rounds twice and flip a gain tie.  The records are
// bitwise equal to the twin's.
//
// What bounds it on this card: the bytes.  The histogram phases read B1's
// inputs; the scan reads the fresh and the parent histograms (12 bytes a
// bin each) and does about 60 f32 operations a bin and child.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grouped_hist.cuh"

namespace {

constexpr int kMissingZero = 1;
constexpr int kMissingNan = 2;
constexpr int kScanThreads = 256;   // bins a part scans at a time
constexpr int kWarps = kScanThreads / 32;
// ctx columns (ops/fused.py CTX_*)
constexpr int kCtxSumG = 0, kCtxSumH = 1, kCtxCount = 2, kCtxMinC = 3,
              kCtxMaxC = 4, kCtxUseSmall = 5;
constexpr int kRecWidth = 8;

struct SplitScalars {
  float l1, l2, max_delta_step, min_data, min_hess, min_gain;
  int clamp_delta;  // max_delta_step > 0
};

// torch.sign: +0 for either zero
__device__ __forceinline__ float t_sign(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : (x != x ? x : 0.f));
}

// torch.maximum / torch.minimum: NaN propagates
__device__ __forceinline__ float t_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? b : a;
}

__device__ __forceinline__ float t_min(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return b < a ? b : a;
}

// split.py _threshold_l1: sign(s) * clamp(|s| - l1, min=0)
__device__ __forceinline__ float threshold_l1(float s, float l1) {
  float reg = __fsub_rn(fabsf(s), l1);
  if (!(reg != reg) && reg < 0.f) reg = 0.f;
  return __fmul_rn(t_sign(s), reg);
}

// split.py leaf_output
__device__ __forceinline__ float leaf_output(float g, float h,
                                             const SplitScalars& p) {
  float out = __fdiv_rn(-threshold_l1(g, p.l1), __fadd_rn(h, p.l2));
  if (p.clamp_delta) out = t_min(t_max(out, -p.max_delta_step),
                                 p.max_delta_step);
  return out;
}

// -(2 * sg_l1 * out + (h + l2) * out * out), left to right
__device__ __forceinline__ float gain_terms(float sg_l1, float out, float h,
                                            const SplitScalars& p) {
  const float a = __fmul_rn(__fmul_rn(2.f, sg_l1), out);
  const float b = __fmul_rn(__fmul_rn(__fadd_rn(h, p.l2), out), out);
  return -__fadd_rn(a, b);
}

// split.py eval_dir for one threshold
__device__ __forceinline__ float eval_dir(float lg, float lh, float lc,
                                          bool thr_ok, float sg, float sh,
                                          float nd, float min_c, float max_c,
                                          int mono, float min_gain_shift,
                                          const SplitScalars& p) {
  const float rg = __fsub_rn(sg, lg);
  const float rh = __fsub_rn(sh, lh);
  const float rc = __fsub_rn(nd, lc);
  const bool ok = thr_ok && lc >= p.min_data && rc >= p.min_data
                  && lh >= p.min_hess && rh >= p.min_hess;
  const float lo = t_min(t_max(leaf_output(lg, lh, p), min_c), max_c);
  const float ro = t_min(t_max(leaf_output(rg, rh, p), min_c), max_c);
  const bool mono_bad = (mono > 0 && lo > ro) || (mono < 0 && lo < ro);
  const float g_l = gain_terms(threshold_l1(lg, p.l1), lo, lh, p);
  const float g_r = gain_terms(threshold_l1(rg, p.l1), ro, rh, p);
  const float gain = mono_bad ? 0.f : __fadd_rn(g_l, g_r);
  return (ok && gain > min_gain_shift) ? gain
                                       : static_cast<float>(-1e30);
}

// (value, index) maximum; ties keep the lower index when low_wins, the
// higher one otherwise
__device__ __forceinline__ void arg_better(float& v, int& i, float v2,
                                           int i2, bool low_wins) {
  if (v2 > v || (v2 == v && (low_wins ? i2 < i : i2 > i))) {
    v = v2;
    i = i2;
  }
}

// one 256-thread part of a block: its own barrier (0 is __syncthreads)
__device__ __forceinline__ void part_sync(int part) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + part), "r"(kScanThreads)
               : "memory");
}

struct ScanTail {
  static constexpr bool kRuns = true;
  struct Args {
    const int32_t* parent;  // [K][F][B][3]
    const float* ctx;       // [2K + 1][8]
    const int32_t* meta_i;  // [F][8]
    const float* meta_f;    // [F][8]
    float* records;         // [2K][F][8]
    SplitScalars p;
  };
  // a part's shared words: wsum[3][8] (each warp's int32 sums), red_v[2][8],
  // red_i[2][8] (each warp's best of each direction), win[3] and a pad
  // (the int32 prefix sums at the chosen threshold;
  // ops/histogram.py:_SCAN_WORDS)
  static constexpr int kWords = 3 * kWarps + 4 * kWarps + 4;

  // child j, feature f, on one part of kScanThreads threads, in tiles of
  // one bin a thread
  __device__ static void scan_one(const lgbt::HistArgs& a, const Args& t,
                                  int j, int f, int part, int* words) {
    int(*wsum)[kWarps] = reinterpret_cast<int(*)[kWarps]>(words);
    float(*red_v)[kWarps] =
        reinterpret_cast<float(*)[kWarps]>(words + 3 * kWarps);
    int(*red_i)[kWarps] =
        reinterpret_cast<int(*)[kWarps]>(words + 5 * kWarps);
    int* win = words + 7 * kWarps;
    const int F = a.F, B = a.B, K = a.K, C = 2 * K;
    const int k = j % K;
    const SplitScalars& p = t.p;
    const int tb = threadIdx.x % kScanThreads;
    const int lane = tb & 31, warp = tb >> 5;

    const int nb = t.meta_i[f * 8 + 0];
    const int mt = t.meta_i[f * 8 + 1];
    const int db = t.meta_i[f * 8 + 2];
    const int mono = t.meta_i[f * 8 + 3];
    const float pen = t.meta_f[f * 8 + 0];
    const float fmask = t.meta_f[f * 8 + 1];
    const float* cj = t.ctx + j * 8;
    const float sg = cj[kCtxSumG], sh = cj[kCtxSumH], nd = cj[kCtxCount];
    const float min_c = cj[kCtxMinC], max_c = cj[kCtxMaxC];
    const bool use_small = cj[kCtxUseSmall] > 0.f;
    const float* qs = t.ctx + C * 8;
    const bool is_nan = mt == kMissingNan;
    // the fresh sums, written by other blocks' atomics: from L2
    const int32_t* small_row =
        static_cast<const int32_t*>(a.raw)
        + (static_cast<long long>(k) * F + f) * lgbt::padded_row(B, 3);
    const int32_t* parent_row =
        t.parent + (static_cast<long long>(k) * F + f) * B * 3;

    // bin b's sibling-subtracted int32 sums, 0 where the search masks
    // the bin (the zero bin of a zero-missing feature, the NaN bin, bins
    // past num_bin or B)
    auto sums_of = [&](int b, int* v) {
      v[0] = v[1] = v[2] = 0;
      if (b >= B || b >= nb || (mt == kMissingZero && b == db)
          || (is_nan && b == nb - 1))
        return;
      for (int c = 0; c < 3; ++c) {
        const int small = __ldcg(small_row + b * 3 + c);
        v[c] = use_small ? small : __ldg(parent_row + b * 3 + c) - small;
      }
    };
    // the part's int32 totals of x[3] (exact in any order), in wsum
    auto part_sum = [&](int* x) {
      for (int c = 0; c < 3; ++c) {
        int y = x[c];
#pragma unroll
        for (int d = 16; d > 0; d >>= 1)
          y += __shfl_xor_sync(0xffffffffu, y, d);
        if (lane == 0) wsum[c][warp] = y;
      }
      part_sync(part);
      for (int c = 0; c < 3; ++c) {
        x[c] = 0;
        for (int w = 0; w < kWarps; ++w) x[c] += wsum[c][w];
      }
      part_sync(part);
    };

    // ---- the totals over every bin, which direction -1 reads; with one
    // tile they come out of its prefix sums ----
    int tot[3] = {0, 0, 0};
    const bool tiled = B > kScanThreads;
    if (tiled) {
      for (int b = tb; b < B; b += kScanThreads) {
        int v[3];
        sums_of(b, v);
        for (int c = 0; c < 3; ++c) tot[c] += v[c];
      }
      part_sum(tot);
    }

    const float sh_eps = __fadd_rn(sh, static_cast<float>(2e-15));
    const float gain_shift = gain_terms(threshold_l1(sg, p.l1),
                                        leaf_output(sg, sh_eps, p), sh_eps,
                                        p);
    const float min_gain_shift = __fadd_rn(gain_shift, p.min_gain);
    // this thread's best threshold of each direction, and the int32
    // prefix sums there: the first maximum for +1, the last for -1
    const float neg_inf = -__int_as_float(0x7f800000);
    float vp = neg_inf, vm = neg_inf;
    int ip = -1, im = -1;
    int pp[3] = {0, 0, 0}, pm[3] = {0, 0, 0};
    int carry[3] = {0, 0, 0};
    for (int t0 = 0; t0 < B; t0 += kScanThreads) {
      const int b = t0 + tb;
      // ---- inclusive int32 prefix sums over the bins (exact) ----
      int v[3];
      sums_of(b, v);
      for (int c = 0; c < 3; ++c) {
        int x = v[c];
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, x, d);
          if (lane >= d) x += y;
        }
        v[c] = x;
        if (lane == 31) wsum[c][warp] = x;
      }
      part_sync(part);
      for (int c = 0; c < 3; ++c) {
        int off = carry[c], all = 0;
        for (int w = 0; w < kWarps; ++w) {
          if (w < warp) off += wsum[c][w];
          all += wsum[c][w];
        }
        v[c] += off;
        carry[c] += all;
        if (!tiled) tot[c] = carry[c];
      }
      // the next tile writes wsum once every thread has read it
      if (t0 + kScanThreads < B) part_sync(part);
      if (b >= B) continue;
      // ---- gains of both directions at this thread's threshold ----
      float cum[3], left[3];
      for (int c = 0; c < 3; ++c) {
        cum[c] = __fmul_rn(__int2float_rn(v[c]), qs[c]);
        const float last = __fmul_rn(__int2float_rn(tot[c]), qs[c]);
        left[c] = __fsub_rn(c == 0 ? sg : (c == 1 ? sh : nd),
                            __fsub_rn(last, cum[c]));
      }
      const bool skip = (mt == kMissingZero) && b == db;
      const float g_p1 = eval_dir(cum[0], cum[1], cum[2],
                                  b <= nb - 2 && !skip, sg, sh, nd, min_c,
                                  max_c, mono, min_gain_shift, p);
      const float g_m1 = eval_dir(
          left[0], left[1], left[2],
          b <= nb - 2 - (is_nan ? 1 : 0) && !skip, sg, sh, nd, min_c,
          max_c, mono, min_gain_shift, p);
      const int ip0 = ip, im0 = im;
      arg_better(vp, ip, g_p1, b, true);
      arg_better(vm, im, g_m1, b, false);
      for (int c = 0; c < 3; ++c) {
        if (ip != ip0) pp[c] = v[c];
        if (im != im0) pm[c] = v[c];
      }
    }
    // ---- best threshold per direction over the part ----
    float wp = vp, wm = vm;
    int jp = ip, jm = im;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      arg_better(wp, jp, __shfl_xor_sync(0xffffffffu, wp, d),
                 __shfl_xor_sync(0xffffffffu, jp, d), true);
      arg_better(wm, jm, __shfl_xor_sync(0xffffffffu, wm, d),
                 __shfl_xor_sync(0xffffffffu, jm, d), false);
    }
    if (lane == 0) {
      red_v[0][warp] = wp;
      red_i[0][warp] = jp;
      red_v[1][warp] = wm;
      red_i[1][warp] = jm;
    }
    part_sync(part);
    float best_p1 = red_v[0][0], best_m1 = red_v[1][0];
    int idx_p1 = red_i[0][0], idx_m1 = red_i[1][0];
    for (int w = 1; w < kWarps; ++w) {
      arg_better(best_p1, idx_p1, red_v[0][w], red_i[0][w], true);
      arg_better(best_m1, idx_m1, red_v[1][w], red_i[1][w], false);
    }
    const bool use_p1 = best_p1 > best_m1;
    const int thr = use_p1 ? idx_p1 : idx_m1;
    // the thread that took bin thr publishes its prefix sums there (the
    // part's best is its own best too: the order is total)
    if (use_p1 ? ip == thr : im == thr)
      for (int c = 0; c < 3; ++c) win[c] = use_p1 ? pp[c] : pm[c];
    part_sync(part);
    if (tb != 0) return;
    float feat_gain = use_p1 ? best_p1 : best_m1;
    bool dleft = !use_p1;
    // only-2-bin NaN features get default_left = false
    if (nb <= 2 && is_nan) dleft = false;
    if (!(fmask > 0.f)) feat_gain = static_cast<float>(-1e30);
    const float out_gain =
        feat_gain > static_cast<float>(-5e29)
            ? __fmul_rn(__fsub_rn(feat_gain, min_gain_shift), pen)
            : static_cast<float>(-1e30);
    float* rec = t.records + (static_cast<long long>(j) * F + f) * kRecWidth;
    rec[0] = out_gain;
    rec[1] = static_cast<float>(thr);
    rec[2] = dleft ? 1.f : 0.f;
    const float tots[3] = {sg, sh, nd};
    for (int c = 0; c < 3; ++c) {
      const float cum = __fmul_rn(__int2float_rn(win[c]), qs[c]);
      const float last = __fmul_rn(__int2float_rn(tot[c]), qs[c]);
      rec[3 + c] = dleft ? __fsub_rn(tots[c], __fsub_rn(last, cum)) : cum;
    }
    rec[6] = 0.f;
    rec[7] = 0.f;
  }

  // the 2K x F (child, feature) items over the grid's 256-thread parts;
  // the shared memory of phase C is free by now
  __device__ static void run(const lgbt::HistArgs& a, const Args& t) {
    extern __shared__ __align__(16) int smem[];
    const int part = threadIdx.x / kScanThreads;
    const int parts = blockDim.x / kScanThreads;
    int* words = smem + ((lgbt::persist_words(a.K) + 3) & ~3)
                 + part * kWords;
    const int items = 2 * a.K * a.F;
    for (int it = blockIdx.x * parts + part; it < items;
         it += gridDim.x * parts) {
      // the previous item's thread 0 has read its records' sums
      part_sync(part);
      scan_one(a, t, it / a.F, it % a.F, part, words);
    }
  }
};

}  // namespace

// Clusters of `cluster` blocks of the wide instance that the card holds
// at once at threads and smem bytes a block, into out[0] (the plan's
// grid is at most this many clusters).  Returns a cudaError_t.
extern "C" int lgbt_fused_clusters(int threads, int smem, int cluster,
                                   int* out) {
  return lgbt::query_clusters<int, ScanTail, lgbt::WideBins>(
      threads, smem, cluster, out);
}

// One cooperative launch: B1's integer histogram of the K slots into raw
// ([K][F][BSp] int32, BSp = 3B padded to 4; bins_rm, bins, scratch and
// plan as lgbt_hist_batched's, bins 0 or 2), then the
// scan into records ([2K][F][8] f32).  parent: [K][F][B][3] int32; ctx:
// [2K+1][8] f32; meta_i / meta_f: [F][8].  Returns a cudaError_t (0 =
// launched).
extern "C" int lgbt_fused_hist_scan(
    const void* bins_rm, int FR, int bins, const void* stats, int stats_kind,
    const void* leaf, const void* slots, void* scratch, void* raw,
    const void* parent, const void* ctx, const void* meta_i,
    const void* meta_f, void* records, int F, long long n, int K, int B,
    const int* plan, float l1, float l2, float max_delta_step,
    float min_data, float min_hess, float min_gain, void* stream) {
  const bool wide = bins == lgbt::WideBins::kCode;
  if (B < 1 || B > (wide ? 65536 : 256) || K < 1 || F < 1 || n < 1
      || (!wide && bins != lgbt::U8Bins::kCode)
      || (stats_kind != lgbt::kI8 && stats_kind != lgbt::kI16))
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
  a.S = 3;
  a.F = F;
  a.K = K;
  a.B = B;
  a.group_only = 0;
  ScanTail::Args t{static_cast<const int32_t*>(parent),
                   static_cast<const float*>(ctx),
                   static_cast<const int32_t*>(meta_i),
                   static_cast<const float*>(meta_f),
                   static_cast<float*>(records),
                   SplitScalars{l1, l2, max_delta_step, min_data, min_hess,
                                min_gain, max_delta_step > 0.f ? 1 : 0}};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return wide ? lgbt::launch_grouped<int, ScanTail, lgbt::WideBins>(a, t,
                                                                   plan, st)
              : lgbt::launch_grouped<int, ScanTail, lgbt::U8Bins>(a, t,
                                                                 plan, st);
}
