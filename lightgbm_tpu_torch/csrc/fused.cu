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
// own named barrier, and a part takes one (child, feature) at a time,
// one thread per bin (B <= 256).  Each thread masks its bin as the search
// does (the zero bin of a zero-missing feature, the NaN bin, bins past
// num_bin), the part takes inclusive int32 prefix sums of (g, h, count)
// -- exact in any order -- and each thread dequantizes its prefix,
// evaluates both missing-value directions at its threshold, and the part
// reduces to the best threshold of each direction: the first maximum for
// +1 and the last for -1, the reference's tie-break that the twin takes
// with argmax.  (One warp per item, eight bins a lane, keeps a serial
// chain of sixteen gain evaluations a lane: 73 us a round against about
// 14 us for one thread a bin, NVIDIA H100 80GB HBM3, 700 W.)
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
constexpr int kScanThreads = 256;   // one thread per bin (B <= 256)
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
  // a part's shared words: wsum[3][8], cum[3][256], left_m1[3][256],
  // red_v[2][8], red_i[2][8] (ops/histogram.py:_SCAN_WORDS)
  static constexpr int kWords = 3 * kWarps + 6 * kScanThreads + 4 * kWarps;

  // child j, feature f, on one part of kScanThreads threads, one per bin
  __device__ static void scan_one(const lgbt::HistArgs& a, const Args& t,
                                  int j, int f, int part, int* words) {
    int(*wsum)[kWarps] = reinterpret_cast<int(*)[kWarps]>(words);
    float(*cum)[kScanThreads] =
        reinterpret_cast<float(*)[kScanThreads]>(words + 3 * kWarps);
    float(*left_m1)[kScanThreads] = reinterpret_cast<float(*)[kScanThreads]>(
        words + 3 * kWarps + 3 * kScanThreads);
    float(*red_v)[kWarps] = reinterpret_cast<float(*)[kWarps]>(
        words + 3 * kWarps + 6 * kScanThreads);
    int(*red_i)[kWarps] = reinterpret_cast<int(*)[kWarps]>(
        words + 5 * kWarps + 6 * kScanThreads);
    const int F = a.F, B = a.B, K = a.K, C = 2 * K;
    const int k = j % K;
    const int32_t* raw = static_cast<const int32_t*>(a.raw);
    const SplitScalars& p = t.p;
    const int b = threadIdx.x % kScanThreads;
    const int lane = b & 31, warp = b >> 5;

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
    const bool skip = (mt == kMissingZero) && b == db;
    const bool na = is_nan && b == nb - 1;

    // ---- sibling subtraction and the masked bins, in int32 ----
    int v[3] = {0, 0, 0};
    if (b < B && !skip && !na && b < nb) {
      for (int c = 0; c < 3; ++c) {
        // the fresh sums, written by other blocks' atomics: from L2
        const int small = __ldcg(
            raw + (static_cast<long long>(k) * F + f) * lgbt::padded_row(B, 3)
            + b * 3 + c);
        v[c] = use_small
                   ? small
                   : __ldg(t.parent
                           + ((static_cast<long long>(k) * F + f) * B + b)
                                 * 3
                           + c) - small;
      }
    }
    // ---- inclusive int32 prefix sums over the bins (exact) ----
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
      int off = 0;
      for (int w = 0; w < warp; ++w) off += wsum[c][w];
      v[c] += off;
      cum[c][b] = __fmul_rn(__int2float_rn(v[c]), qs[c]);
    }
    part_sync(part);

    // ---- gains of both directions at this thread's threshold ----
    const float sh_eps = __fadd_rn(sh, static_cast<float>(2e-15));
    const float gain_shift = gain_terms(threshold_l1(sg, p.l1),
                                        leaf_output(sg, sh_eps, p), sh_eps,
                                        p);
    const float min_gain_shift = __fadd_rn(gain_shift, p.min_gain);
    // bins past B never win: every real gain is >= -1e30
    const float neg_inf = -__int_as_float(0x7f800000);
    float g_p1 = neg_inf, g_m1 = neg_inf;
    if (b < B) {
      const float cg = cum[0][b], ch = cum[1][b], cc = cum[2][b];
      g_p1 = eval_dir(cg, ch, cc, b <= nb - 2 && !skip, sg, sh, nd, min_c,
                      max_c, mono, min_gain_shift, p);
      const float lg = __fsub_rn(sg, __fsub_rn(cum[0][B - 1], cg));
      const float lh = __fsub_rn(sh, __fsub_rn(cum[1][B - 1], ch));
      const float lc = __fsub_rn(nd, __fsub_rn(cum[2][B - 1], cc));
      left_m1[0][b] = lg;
      left_m1[1][b] = lh;
      left_m1[2][b] = lc;
      g_m1 = eval_dir(lg, lh, lc, b <= nb - 2 - (is_nan ? 1 : 0) && !skip,
                      sg, sh, nd, min_c, max_c, mono, min_gain_shift, p);
    }
    // ---- best threshold per direction: first max (+1), last max (-1) ----
    float vp = g_p1, vm = g_m1;
    int ip = b, im = b;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      arg_better(vp, ip, __shfl_xor_sync(0xffffffffu, vp, d),
                 __shfl_xor_sync(0xffffffffu, ip, d), true);
      arg_better(vm, im, __shfl_xor_sync(0xffffffffu, vm, d),
                 __shfl_xor_sync(0xffffffffu, im, d), false);
    }
    if (lane == 0) {
      red_v[0][warp] = vp;
      red_i[0][warp] = ip;
      red_v[1][warp] = vm;
      red_i[1][warp] = im;
    }
    part_sync(part);
    if (b != 0) return;
    float best_p1 = red_v[0][0], best_m1 = red_v[1][0];
    int idx_p1 = red_i[0][0], idx_m1 = red_i[1][0];
    for (int w = 1; w < kWarps; ++w) {
      arg_better(best_p1, idx_p1, red_v[0][w], red_i[0][w], true);
      arg_better(best_m1, idx_m1, red_v[1][w], red_i[1][w], false);
    }
    const bool use_p1 = best_p1 > best_m1;
    float feat_gain = use_p1 ? best_p1 : best_m1;
    const int thr = use_p1 ? idx_p1 : idx_m1;
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
    for (int c = 0; c < 3; ++c) rec[3 + c] = dleft ? left_m1[c][thr]
                                                   : cum[c][thr];
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

// One cooperative launch: B1's integer histogram of the K slots into raw
// ([K][F][BSp] int32, BSp = 3B padded to 4; scratch and plan as
// lgbt_hist_batched's), then the
// scan into records ([2K][F][8] f32).  parent: [K][F][B][3] int32; ctx:
// [2K+1][8] f32; meta_i / meta_f: [F][8].  Returns a cudaError_t (0 =
// launched).
extern "C" int lgbt_fused_hist_scan(
    const void* bins_rm, int FR, const void* stats, int stats_kind,
    const void* leaf, const void* slots, void* scratch, void* raw,
    const void* parent, const void* ctx, const void* meta_i,
    const void* meta_f, void* records, int F, long long n, int K, int B,
    const int* plan, float l1, float l2, float max_delta_step,
    float min_data, float min_hess, float min_gain, void* stream) {
  if (B < 1 || B > kScanThreads || K < 1 || F < 1 || n < 1
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
  return lgbt::launch_grouped<int, ScanTail>(
      a, t, plan, static_cast<cudaStream_t>(stream));
}
