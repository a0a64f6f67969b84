// The ToA fit's profile-likelihood sweep for NVIDIA Hopper (sm_90a): K5.
//
// Replaces the fixed-shape body of profile_loglik_full
// (crimp_tpu/ops/toafit.py:297), which XLA fuses under the jit of
// fit_toas_batch (:709): shape_at_shifts (:150), the Newton norm solve
// _optimal_norm (:203) or the joint (A, b) solve _optimal_norm_amp (:223),
// and _loglik_at (:276). Those are not Pallas kernels. In eager PyTorch one
// sweep costs about a dozen launches per Newton step and writes and reads
// (segments, phases, events) f64 temporaries through device memory at every
// step; here one launch does the whole sweep and the per-event values stay
// on the chip.
//
// What K5 computes, for every (segment row r, phase phi = phis[r, q]):
//   s_i      the template's shape term at event i shifted by phi:
//            Fourier   sum_j cos(j phi) C_ij + sum_j sin(j phi) S_ij
//                      (C, S the per-event coefficients amp_j ampShift
//                      cos/sin(2 pi j x_i + loc_j), from the wrapper)
//            von Mises sum_k coef_k exp(kappa_k cos((x_i - cen_k) - phi))
//            Cauchy    sum_k coef_k / (cosh(wid_k) - cos((x_i - cen_k) - phi))
//   A, b     the norm (and ampShift) that maximise the extended likelihood
//            at that phi: newton_iters projected Newton steps on A, or
//            2 newton_iters joint 2x2 Newton steps on (A, b), or the
//            template's norm held fixed;
//   ll       -A T + const + sum_i m_i log(max(A + b s_i, 1e-300)), or -inf
//            when some masked A + b s_i <= 0,
// with the same expressions, clamps and safeguards as the plain twin
// (ops/toafit.py::profile_sweep_reference). Every sum over events is taken
// in a fixed order: thread t adds events t, t + 512, ... in turn, then the
// 512 partials meet in a fixed tree (warp shuffles, then the 16 warp sums in
// a second shuffle tree). No atomics: reruns are bitwise, and a row's results depend only on
// its own events, not on the rows beside it in the launch or on how far it
// is padded (masked events are skipped, which adds exactly +0.0).
//
// bf16 (mxu_bf16 == 1, Fourier only): cos(j phi), sin(j phi), C and S are
// rounded to bf16 (through f32, as torch's conversion from f64), multiplied
// in f32 (exact: a product of two bf16 values fits an f32), and the K cosine
// terms and the K sine terms are each added in f32 in harmonic order, then
// the two sums; s is that f32 value in f64.
//
// What bounds it on this card: f64 operations. Per (row, phase, event) a
// sweep does ~4K operations of shape, newton_iters x 5 (or 2 newton_iters
// x 12) of Newton steps with one division each, and a log: ~130 f64
// operations against 9 bytes of input read once (obs/costmodel.py::
// k5_counts), far on the operations side of the 34 TFLOP/s f64 / 3.35 TB/s
// ridge. The divisions and logs are sequences of several f64 instructions
// each, so the bound (which counts each as one operation) is not reached.
//
// Design, against that bound (simple first):
//   - One block of 512 threads per (row, phase) pair on gridDim.x (not
//     gridDim.y, which caps at 65535; 512 ran the brute and golden-section
//     sweeps faster than 256 or 1024, PERF.md), so the card's 132 SMs are filled by
//     the brute sweep (rows x 128 phases) and the work per event is only
//     arithmetic: the shape term is computed once and kept in shared memory
//     while the row's N events fit (N * 8 bytes within the 227 KB a block may
//     take, dynamic shared memory beyond 48 KB); past that every pass
//     recomputes it from the coefficients. Both branches use the same
//     rounded intrinsics, so they give the same bits.
//   - A block's phase-dependent constants (cos/sin(j phi) or the component
//     constants) sit in shared memory; the Newton state is per block and
//     lives in registers, updated by every thread from the broadcast sums.
//   - Each Newton step is one pass over the events and one block reduction
//     of its 2 (or 5) sums; the masked minimum and the event count come from
//     the first pass, the log-sum and the positivity test from the last.
//
// Plain C interface, loaded with ctypes (crimp_tpu_torch/ops/toafit.py). The
// entry point launches on the caller's stream, allocates nothing and returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_COMP = 64;  // harmonics or components: a block's constants sit in fixed arrays
constexpr int MAX_SUMS = 5;
constexpr double TWO_PI = 6.283185307179586;  // 2 * math.pi, as the twin writes it

enum Kind { FOURIER = 0, VONMISES = 1, CAUCHY = 2 };
enum NormMode { NORM_NEWTON = 0, NORM_JOINT = 1, NORM_FIXED = 2 };

struct SweepArgs {
  const double* x;              // (S, N) folded phases
  const unsigned char* mask;    // (S, N) 1 = event, 0 = padding
  const double* exposure;       // (S,)
  const double* phis;           // (S, P)
  const double* cosj;           // (S, P, K) cos(j phi), Fourier
  const double* sinj;           // (S, P, K) sin(j phi), Fourier
  const double* ev_c;           // (S, K, N) per-event coefficients, Fourier
  const double* ev_s;           // (S, K, N)
  const double* comp;           // (S, 3, K) coef, kappa or cosh(wid), centre; vM / Cauchy
  const double* row;            // (S, 3) norm lower bound, norm, sum_j amp_j ampShift
  double* ll;                   // (S, P) outputs
  double* a_out;
  double* b_out;
  long long n_events;
  int n_phis, n_comp, kind, mode, iters, bf16, s_in_smem;
  double norm_hi, amp_lo, amp_hi;
};

// torch.maximum / torch.minimum / clamp: NaN propagates
__device__ __forceinline__ double tmax(double a, double b) {
  return (a != a || b != b) ? CUDART_NAN : (a > b ? a : b);
}
__device__ __forceinline__ double tmin(double a, double b) {
  return (a != a || b != b) ? CUDART_NAN : (a < b ? a : b);
}
__device__ __forceinline__ double clip(double v, double lo, double hi) { return tmin(tmax(v, lo), hi); }

__device__ __forceinline__ float to_bf16(double v) {
  return __bfloat162float(__float2bfloat16_rn(__double2float_rn(v)));
}

struct BlockConsts {
  double trig[2 * MAX_COMP];    // Fourier: cos(j phi), then sin(j phi)
  float trigf[2 * MAX_COMP];    // the same rounded to bf16 (bf16 sweeps)
  double comp[3 * MAX_COMP];    // vM / Cauchy: coef, kappa or cosh(wid), centre
  double red[MAX_SUMS][WARPS];  // block reductions: warp partials
  double out[MAX_SUMS];         // ... and their totals
};

// s_i for event i of row r at the block's phase phi, from rounded intrinsics
// only, so the shared-memory and the recompute branches agree bit for bit.
__device__ __forceinline__ double shape_term(const SweepArgs& p, const BlockConsts& c, long long r, long long i, double phi) {
  const int K = p.n_comp;
  const long long N = p.n_events;
  if (p.kind == FOURIER) {
    const double* cc = p.ev_c + r * K * N + i;
    const double* ss = p.ev_s + r * K * N + i;
    if (p.bf16) {
      float acc_c = 0.0f, acc_s = 0.0f;
      for (int j = 0; j < K; ++j) acc_c = __fmaf_rn(c.trigf[j], to_bf16(cc[j * N]), acc_c);
      for (int j = 0; j < K; ++j) acc_s = __fmaf_rn(c.trigf[K + j], to_bf16(ss[j * N]), acc_s);
      return static_cast<double>(__fadd_rn(acc_c, acc_s));
    }
    double acc_c = 0.0, acc_s = 0.0;
    for (int j = 0; j < K; ++j) acc_c = __fma_rn(c.trig[j], cc[j * N], acc_c);
    for (int j = 0; j < K; ++j) acc_s = __fma_rn(c.trig[K + j], ss[j * N], acc_s);
    return __dadd_rn(acc_c, acc_s);
  }
  const double x = p.x[r * N + i];
  double acc = 0.0;
  for (int k = 0; k < K; ++k) {
    const double cosd = cos(__dsub_rn(__dsub_rn(x, c.comp[2 * K + k]), phi));
    const double term = p.kind == CAUCHY
        ? __ddiv_rn(c.comp[k], __dsub_rn(c.comp[K + k], cosd))
        : __dmul_rn(c.comp[k], exp(__dmul_rn(c.comp[K + k], cosd)));
    acc = __dadd_rn(acc, term);
  }
  return acc;
}

// Sum each of v[0..n) over the block in a fixed tree; every thread gets the totals.
template <int NS>
__device__ __forceinline__ void block_sum(double (&v)[NS], BlockConsts& c) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = 0; k < NS; ++k)
    for (int off = 16; off > 0; off >>= 1) v[k] = __dadd_rn(v[k], __shfl_down_sync(0xffffffffu, v[k], off));
  if (lane == 0)
    for (int k = 0; k < NS; ++k) c.red[k][warp] = v[k];
  __syncthreads();
  if (warp == 0) {
    for (int k = 0; k < NS; ++k) {
      double t = lane < WARPS ? c.red[k][lane] : 0.0;
      for (int off = WARPS / 2; off > 0; off >>= 1) t = __dadd_rn(t, __shfl_down_sync(0xffffffffu, t, off));
      if (lane == 0) c.out[k] = t;
    }
  }
  __syncthreads();
  for (int k = 0; k < NS; ++k) v[k] = c.out[k];
}

// The block minimum of v (NaN propagates), given to every thread.
__device__ __forceinline__ double block_min(double v, BlockConsts& c) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) v = tmin(v, __shfl_down_sync(0xffffffffu, v, off));
  if (lane == 0) c.red[0][warp] = v;
  __syncthreads();
  if (warp == 0) {
    double t = lane < WARPS ? c.red[0][lane] : CUDART_INF;
    for (int off = WARPS / 2; off > 0; off >>= 1) t = tmin(t, __shfl_down_sync(0xffffffffu, t, off));
    if (lane == 0) c.out[0] = t;
  }
  __syncthreads();
  return c.out[0];
}

__global__ void __launch_bounds__(THREADS) profile_kernel(const SweepArgs p) {
  extern __shared__ double s_val[];
  __shared__ BlockConsts c;
  const long long P = p.n_phis, N = p.n_events;
  const long long r = blockIdx.x / P;
  const long long q = blockIdx.x % P;
  const int K = p.n_comp;
  const double phi = p.phis[r * P + q];
  const unsigned char* m = p.mask + r * N;

  if (p.kind == FOURIER) {
    for (int j = threadIdx.x; j < K; j += THREADS) {
      c.trig[j] = p.cosj[(r * P + q) * K + j];
      c.trig[K + j] = p.sinj[(r * P + q) * K + j];
      c.trigf[j] = to_bf16(c.trig[j]);
      c.trigf[K + j] = to_bf16(c.trig[K + j]);
    }
  } else {
    for (int j = threadIdx.x; j < 3 * K; j += THREADS) c.comp[j] = p.comp[r * 3 * K + j];
  }
  __syncthreads();

  // pass 1: the shape term (kept in shared memory when it fits), the masked
  // minimum and the event count
  double min_s = CUDART_INF;
  double count[1] = {0.0};
  for (long long i = threadIdx.x; i < N; i += THREADS) {
    const double s = shape_term(p, c, r, i, phi);
    if (p.s_in_smem) s_val[i] = s;
    if (m[i]) {
      min_s = tmin(min_s, s);
      count[0] = __dadd_rn(count[0], 1.0);
    }
  }
  min_s = block_min(min_s, c);
  block_sum(count, c);
  const double n_ev = count[0];
  const double T = p.exposure[r];
  const double a_lo = p.row[r * 3], norm = p.row[r * 3 + 1], q0 = p.row[r * 3 + 2];

  // s_val is written by the thread that reads it back: no barrier needed
  auto s_at = [&](long long i) { return p.s_in_smem ? s_val[i] : shape_term(p, c, r, i, phi); };

  double a, b = 1.0;
  if (p.mode == NORM_FIXED) {
    a = norm;
  } else if (p.mode == NORM_NEWTON) {
    const double feasible_lo = tmax(a_lo, __dadd_rn(__dmul_rn(-min_s, 1.0 + 1e-9), 1e-12));
    a = clip(__ddiv_rn(n_ev, T), feasible_lo, p.norm_hi);
    for (int it = 0; it < p.iters; ++it) {
      double sums[2] = {0.0, 0.0};
      for (long long i = threadIdx.x; i < N; i += THREADS) {
        if (!m[i]) continue;
        const double inv = __ddiv_rn(1.0, __dadd_rn(a, s_at(i)));
        sums[0] = __dadd_rn(sums[0], inv);
        sums[1] = __dadd_rn(sums[1], __dmul_rn(inv, inv));
      }
      block_sum(sums, c);
      const double g = __dsub_rn(sums[0], T);
      const double gp = -sums[1];
      a = clip(__dsub_rn(a, __ddiv_rn(g, gp)), feasible_lo, p.norm_hi);
    }
  } else {  // NORM_JOINT: (A, b) = (norm, ampShift)
    const double c_b = p.kind == FOURIER ? 0.0 : __ddiv_rn(q0, TWO_PI);
    auto feasible_a_lo = [&](double bb) {
      return tmax(a_lo, __dadd_rn(__dmul_rn(__dmul_rn(-bb, min_s), 1.0 + 1e-9), 1e-12));
    };
    a = clip(__ddiv_rn(n_ev, T), feasible_a_lo(1.0), p.norm_hi);
    for (int it = 0; it < 2 * p.iters; ++it) {
      double sums[5] = {0.0, 0.0, 0.0, 0.0, 0.0};
      for (long long i = threadIdx.x; i < N; i += THREADS) {
        if (!m[i]) continue;
        const double s = s_at(i);
        const double inv = __ddiv_rn(1.0, __dadd_rn(a, __dmul_rn(b, s)));
        const double inv_s = __dmul_rn(inv, s);
        sums[0] = __dadd_rn(sums[0], inv);
        sums[1] = __dadd_rn(sums[1], inv_s);
        sums[2] = __dadd_rn(sums[2], __dmul_rn(inv, inv));
        sums[3] = __dadd_rn(sums[3], __dmul_rn(inv, inv_s));
        sums[4] = __dadd_rn(sums[4], __dmul_rn(inv_s, inv_s));
      }
      block_sum(sums, c);
      const double g_a = __dsub_rn(sums[0], T);
      const double g_b = __dsub_rn(sums[1], __dmul_rn(c_b, T));
      const double h_aa = -sums[2], h_ab = -sums[3], h_bb = -sums[4];
      double det = __dsub_rn(__dmul_rn(h_aa, h_bb), __dmul_rn(h_ab, h_ab));
      const bool safe = fabs(det) > 1e-30;
      det = safe ? det : 1.0;
      const double da = safe ? __ddiv_rn(-__dsub_rn(__dmul_rn(h_bb, g_a), __dmul_rn(h_ab, g_b)), det)
                             : __ddiv_rn(g_a, __dadd_rn(-h_aa, 1e-30));
      const double db = safe ? __ddiv_rn(-__dadd_rn(__dmul_rn(-h_ab, g_a), __dmul_rn(h_aa, g_b)), det) : 0.0;
      b = clip(__dadd_rn(b, db), p.amp_lo, p.amp_hi);
      a = clip(__dadd_rn(a, da), feasible_a_lo(b), p.norm_hi);
    }
  }

  // last pass: the clamped log-sum and the positivity test
  double min_v = CUDART_INF;
  double log_sum[1] = {0.0};
  for (long long i = threadIdx.x; i < N; i += THREADS) {
    if (!m[i]) continue;
    const double v = __dadd_rn(a, __dmul_rn(b, s_at(i)));
    min_v = tmin(min_v, v);
    log_sum[0] = __dadd_rn(log_sum[0], log(tmax(v, 1e-300)));
  }
  min_v = block_min(min_v, c);
  block_sum(log_sum, c);
  if (threadIdx.x == 0) {
    double cst;
    if (p.kind == FOURIER) {
      cst = __dmul_rn(n_ev, log(T));
    } else {
      const double qb = __dmul_rn(q0, b);
      cst = __dsub_rn(__dmul_rn(n_ev, log(__ddiv_rn(T, TWO_PI))), __ddiv_rn(__dmul_rn(qb, T), TWO_PI));
    }
    const double ll = __dadd_rn(__dadd_rn(__dmul_rn(-a, T), cst), log_sum[0]);
    const long long o = r * P + q;
    p.ll[o] = min_v > 0.0 ? ll : -CUDART_INF;
    p.a_out[o] = a;
    p.b_out[o] = b;
  }
}

// Events of a row whose shape terms fit the dynamic shared memory a block
// may take on the current card, beside the kernel's static arrays.
int smem_events() {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, profile_kernel) != cudaSuccess)
    return -1;
  return (optin - static_cast<int>(attr.sharedSizeBytes)) / static_cast<int>(sizeof(double));
}

}  // namespace

// Events of a row that K5 keeps in shared memory on the current card (beyond
// it, every pass recomputes the shape term); -1 on a CUDA error.
extern "C" int toafit_smem_events() { return smem_events(); }

// One sweep over n_rows x n_phis (row, phase) pairs, one block each. kind:
// 0 Fourier, 1 von Mises, 2 Cauchy; mode: 0 Newton on A, 1 joint (A, b),
// 2 fixed norm. Fourier reads cosj, sinj, ev_c, ev_s (comp may be null);
// von Mises and Cauchy read x and comp (the Fourier operands may be null).
// Outputs may not alias the inputs.
extern "C" int toafit_profile(const double* x, const unsigned char* mask, const double* exposure,
                              const double* phis, const double* cosj, const double* sinj, const double* ev_c,
                              const double* ev_s, const double* comp, const double* row, int n_rows,
                              int n_phis, long long n_events, int n_comp, int kind, int mode, int newton_iters,
                              double norm_hi, double amp_lo, double amp_hi, int bf16, double* ll, double* a_out,
                              double* b_out, void* stream) {
  if (n_rows < 1 || n_phis < 1 || n_events < 1 || n_comp < 1 || n_comp > MAX_COMP || kind < 0 || kind > 2 ||
      mode < 0 || mode > 2 || newton_iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_blocks = static_cast<long long>(n_rows) * n_phis;
  if (n_blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const int keep = smem_events();
  if (keep < 0) return static_cast<int>(cudaGetLastError());
  const bool in_smem = n_events <= keep;
  const size_t smem = in_smem ? sizeof(double) * static_cast<size_t>(n_events) : 0;
  if (smem + sizeof(BlockConsts) > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(profile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  SweepArgs args{x, mask, exposure, phis, cosj, sinj, ev_c, ev_s, comp, row, ll, a_out, b_out,
                 n_events, n_phis, n_comp, kind, mode, newton_iters, bf16, in_smem ? 1 : 0,
                 norm_hi, amp_lo, amp_hi};
  profile_kernel<<<static_cast<unsigned>(n_blocks), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}
