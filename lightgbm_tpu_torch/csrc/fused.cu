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
// The TPU kernel runs the scan at the last row block, while the finished
// accumulator is still in VMEM.  Here the grid has no last block, so the
// work is two launches: the histogram is B1's integer path (the slot
// pre-pass, shared-memory int32 atomics, scratch slices added in int32),
// then the scan kernel below reads it back from device memory (at most
// K * F * 256 * 12 bytes, 2.4 MB at K = 25, F = 32) with the parent.
// Fusing the two, so that the scan runs while the histogram is on chip,
// is left for a later version.
//
// The scan: one block per (feature, child), one thread per bin (B <= 256).
// Each thread masks its bin as the search does (the zero bin of a
// zero-missing feature, the NaN bin, bins past num_bin), the block takes
// inclusive int32 prefix sums of (g, h, count) -- exact in any order --
// and each thread dequantizes its prefix, evaluates both missing-value
// directions at its threshold, and the block reduces to the best
// threshold of each direction: the first maximum for +1 and the last for
// -1, the reference's tie-break that the twin takes with argmax.
//
// Rounding: the twin is a sequence of PyTorch elementwise ops, each
// rounded on its own.  Every product, sum and quotient here is written
// with the _rn intrinsics, in the twin's order, and the file is built
// with --fmad=false, so no a*b+c contracts into an FMA that would round
// once where the twin rounds twice and flip a gain tie.  The records are
// bitwise equal to the twin's.
//
// What bounds it on this card: the bytes.  The histogram pass reads B1's
// inputs; the scan reads the fresh and the parent histograms (12 bytes a
// bin each) and does about 60 f32 operations a bin and child.

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" int lgbt_hist_batched(const void* bins, const void* stats,
                                 int stats_kind, const void* leaf,
                                 const void* slots, void* slot_of,
                                 void* partial, void* raw, int F, long long n,
                                 int S, int K, int B, const int* plan,
                                 void* stream);

namespace {

constexpr int kScanThreads = 256;
constexpr int kWarps = kScanThreads / 32;
constexpr int kMissingZero = 1;
constexpr int kMissingNan = 2;
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

__global__ void fused_scan_kernel(const int32_t* __restrict__ raw,
                                  const int32_t* __restrict__ parent,
                                  const float* __restrict__ ctx,
                                  const int32_t* __restrict__ meta_i,
                                  const float* __restrict__ meta_f,
                                  float* __restrict__ records, int F, int B,
                                  int K, SplitScalars p) {
  __shared__ int wsum[3][kWarps];
  __shared__ float cum[3][kScanThreads];   // dequantized prefix sums
  __shared__ float left_m1[3][kScanThreads];
  __shared__ float red_v[2][kWarps];
  __shared__ int red_i[2][kWarps];

  const int f = blockIdx.x;
  const int j = blockIdx.y;
  const int C = 2 * K;
  const int k = j % K;
  const int b = threadIdx.x;
  const int lane = b & 31, warp = b >> 5;

  const int nb = meta_i[f * 8 + 0];
  const int mt = meta_i[f * 8 + 1];
  const int db = meta_i[f * 8 + 2];
  const int mono = meta_i[f * 8 + 3];
  const float pen = meta_f[f * 8 + 0];
  const float fmask = meta_f[f * 8 + 1];
  const float* cj = ctx + j * 8;
  const float sg = cj[kCtxSumG], sh = cj[kCtxSumH], nd = cj[kCtxCount];
  const float min_c = cj[kCtxMinC], max_c = cj[kCtxMaxC];
  const bool use_small = cj[kCtxUseSmall] > 0.f;
  const float* qs = ctx + C * 8;

  const bool is_nan = mt == kMissingNan;
  const bool skip = (mt == kMissingZero) && b == db;
  const bool na = is_nan && b == nb - 1;

  // ---- sibling subtraction and the masked bins, in int32 ----
  int v[3] = {0, 0, 0};
  if (b < B && !skip && !na && b < nb) {
    for (int c = 0; c < 3; ++c) {
      const int small =
          raw[((static_cast<long long>(f) * B + b) * K + k) * 3 + c];
      v[c] = use_small
                 ? small
                 : parent[((static_cast<long long>(k) * F + f) * B + b) * 3
                          + c] - small;
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
  __syncthreads();
  for (int c = 0; c < 3; ++c) {
    int off = 0;
    for (int w = 0; w < warp; ++w) off += wsum[c][w];
    v[c] += off;
    cum[c][b] = __fmul_rn(__int2float_rn(v[c]), qs[c]);
  }
  __syncthreads();

  // ---- gains of both directions at this thread's threshold ----
  const float sh_eps = __fadd_rn(sh, static_cast<float>(2e-15));
  const float gain_shift = gain_terms(threshold_l1(sg, p.l1),
                                      leaf_output(sg, sh_eps, p), sh_eps, p);
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
    g_m1 = eval_dir(lg, lh, lc, b <= nb - 2 - (is_nan ? 1 : 0) && !skip, sg,
                    sh, nd, min_c, max_c, mono, min_gain_shift, p);
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
  __syncthreads();
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
  float* rec = records + (static_cast<long long>(j) * F + f) * kRecWidth;
  rec[0] = out_gain;
  rec[1] = static_cast<float>(thr);
  rec[2] = dleft ? 1.f : 0.f;
  for (int c = 0; c < 3; ++c) rec[3 + c] = dleft ? left_m1[c][thr]
                                                 : cum[c][thr];
  rec[6] = 0.f;
  rec[7] = 0.f;
}

}  // namespace

// The histogram of B1's integer path into raw ([F][B][K][3] int32, with
// its slot_of / partial scratch and plan), then the scan into records
// ([2K][F][8] f32).  parent: [K][F][B][3] int32; ctx: [2K+1][8] f32;
// meta_i / meta_f: [F][8].  Returns a cudaError_t (0 = launched).
extern "C" int lgbt_fused_hist_scan(
    const void* bins, const void* stats, int stats_kind, const void* leaf,
    const void* slots, void* slot_of, void* partial, void* raw,
    const void* parent, const void* ctx, const void* meta_i,
    const void* meta_f, void* records, int F, long long n, int K, int B,
    const int* plan, float l1, float l2, float max_delta_step,
    float min_data, float min_hess, float min_gain, void* stream) {
  if (B < 1 || B > kScanThreads || K < 1 || F < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = lgbt_hist_batched(bins, stats, stats_kind, leaf, slots, slot_of,
                              partial, raw, F, n, 3, K, B, plan, stream);
  if (err != 0) return err;
  SplitScalars p{l1, l2, max_delta_step, min_data, min_hess, min_gain,
                 max_delta_step > 0.f ? 1 : 0};
  dim3 grid(F, 2 * K);
  fused_scan_kernel<<<grid, kScanThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(raw), static_cast<const int32_t*>(parent),
      static_cast<const float*>(ctx), static_cast<const int32_t*>(meta_i),
      static_cast<const float*>(meta_f), static_cast<float*>(records), F, B,
      K, p);
  return static_cast<int>(cudaGetLastError());
}
