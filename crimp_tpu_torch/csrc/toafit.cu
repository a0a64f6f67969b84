// The ToA fit's profile-likelihood sweep for NVIDIA Hopper (sm_90a): K5.
//
// Replaces the fixed-shape body of profile_loglik_full
// (crimp_tpu/ops/toafit.py:297), which XLA fuses under the jit of
// fit_toas_batch (:709): shape_at_shifts (:150), the Newton norm solve
// _optimal_norm (:203) or the joint (A, b) solve _optimal_norm_amp (:223),
// and _loglik_at (:276); and the golden-section refine that fit_segment
// (:583) runs over it, golden_section's fori_loop under the same jit
// (crimp_tpu/ops/optimize.py:26-49, called at crimp_tpu/ops/toafit.py:645),
// with the nuisance solve at its optimum. Those are not Pallas kernels. In
// eager PyTorch one sweep costs about a dozen launches per Newton step and
// writes and reads (segments, phases, events) f64 temporaries through device
// memory at every step; here one launch does a whole sweep, or the whole
// golden-section refine, and the per-event values stay on the chip.
//
// What K5 evaluates, for a segment row r at a phase phi:
//   s_i      the template's shape term at event i shifted by phi:
//            Fourier   sum_j cos(j phi) C_ij + sum_j sin(j phi) S_ij
//                      (C, S the per-event coefficients amp_j ampShift
//                      cos/sin(2 pi j x_i + loc_j), from the wrapper;
//                      cos(j phi) and sin(j phi) made here from the f64
//                      product j phi, as torch.cos(j * phi) rounds it)
//            von Mises sum_k coef_k exp(kappa_k cos((x_i - cen_k) - phi))
//            Cauchy    sum_k coef_k / (cosh(wid_k) - cos((x_i - cen_k) - phi))
//   A, b     the norm (and ampShift) that maximise the extended likelihood
//            at that phi: newton_iters projected Newton steps on A, or
//            2 newton_iters joint 2x2 Newton steps on (A, b), or the
//            template's norm held fixed;
//   ll       -A T + const + sum_i m_i log(max(A + b s_i, 1e-300)), or -inf
//            when some masked A + b s_i <= 0,
// with the same expressions, clamps and safeguards as the plain twin
// (ops/toafit.py::profile_sweep_reference). One __device__ body, evaluate(),
// computes it in every entry point, so an evaluation at (row, phi) gives the
// same bits in any launch. Every sum over events is taken in a fixed order:
// thread t adds events t, t + 512, ... in turn, then the 512 partials meet
// in a fixed tree (warp shuffles, then the 16 warp sums in a second shuffle
// tree). No atomics: reruns are bitwise, and a row's results depend only on
// its own events and phi, not on the rows or phases beside it in the launch
// or on how far it is padded (a masked event adds exactly +0.0 to a sum,
// which starts at +0.0 and so is never -0.0, and +inf to a minimum).
//
// bf16 (mxu_bf16 == 1, Fourier only): cos(j phi), sin(j phi), C and S are
// rounded to bf16 (through f32, as torch's conversion from f64), multiplied
// in f32 (exact: a product of two bf16 values fits an f32), and the K cosine
// terms and the K sine terms are each added in f32 in harmonic order, then
// the two sums; s is that f32 value in f64.
//
// Entry points:
//   toafit_profile  one sweep over (row, phase) pairs: one 512-thread block
//                   a pair on gridDim.x (not gridDim.y, which caps at 65535);
//   toafit_golden   the golden-section refine of every row on [lo, hi] and
//                   the nuisance solve at its optimum, in one launch:
//                   clusters of 2 blocks, one a row. Block rank 0 evaluates
//                   x1 and rank 1 x2 each round; each writes its (LL, A, b)
//                   to its own shared memory, the cluster synchronises, and
//                   each reads its partner's through distributed shared
//                   memory, then both update (a, b, x1, x2) with
//                   golden_section's operations in its order
//                   (ops/optimize.py: x1 = b - PHI (b - a), ...; f1 > f2 with
//                   IEEE comparisons; the final max propagating NaN as
//                   torch.maximum). Only finished values cross the cluster.
//                   The (A, b) reported are those of the evaluation that
//                   picked phi_best: the bits a one-phase sweep at phi_best
//                   gives. 1 + refine_iters rounds replace 2 + 2 refine_iters
//                   one-phase launches, their torch bookkeeping and the
//                   nuisance sweep.
//
// What bounds it on this card: f64 operations. Per (row, phase, event) a
// sweep does ~4K operations of shape, newton_iters x 5 (or 2 newton_iters
// x 12) of Newton steps with one reciprocal each, and a log: ~130 f64
// operations against 9 bytes of input read once (obs/costmodel.py::
// k5_counts), far on the operations side of the 34 TFLOP/s f64 / 3.35 TB/s
// ridge. The reciprocals and logs are sequences of several f64 instructions
// each, so the bound (which counts each as one operation) is not reached.
//
// Design, against that bound:
//   - 512 threads a block (faster than 256 or 1024 for the brute and
//     golden-section sweeps, PERF.md), at most 64 registers so that two
//     blocks share an SM (__launch_bounds__(512, 2)). The shape term is
//     computed once a (row, phase) and kept in shared memory while the row's
//     N events fit (N * 8 bytes within the 227 KB a block may take, dynamic
//     shared memory beyond 48 KB); past that every pass recomputes it from
//     the coefficients. Both branches use the same rounded intrinsics, so
//     they give the same bits; each is its own instantiation, so a pass has
//     no branch on it.
//   - A Newton pass is branch-free: the mask selects each event's terms
//     (+0.0 when masked) instead of skipping it, and the per-thread loop
//     is unrolled (rows in shared memory) so one thread's reciprocals
//     overlap while its sums still take the events in order. Passes stop at
//     the row's last masked event. 1 / (A + s) stays __ddiv_rn(1.0, .):
//     ptxas makes it the same MUFU.RCP64H and five DFMA an event as
//     __drcp_rn (utils/k5_ab.py's SASS count, PERF.md), so the reciprocal
//     would not be shorter.
//   - One barrier a block reduction: the warp partials are double-buffered,
//     and every warp runs the same 16-lane tree over them, so every thread
//     holds the totals without a second barrier. The masked minimum and the
//     event count share the first pass's reduction; the log-sum and the
//     positivity test the last pass's.
//
// Plain C interface, loaded with ctypes (crimp_tpu_torch/ops/toafit.py). The
// entry points launch on the caller's stream, allocate nothing and return
// the launch's CUDA error (0 on success).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int MIN_BLOCKS = 2;  // blocks an SM holds: at most 64 registers a thread
constexpr int WARPS = THREADS / 32;
constexpr int MAX_COMP = 64;  // harmonics or components: a block's constants sit in fixed arrays
constexpr int MAX_SUMS = 5;
constexpr int NEWTON_UNROLL = 4;  // events a thread has in flight in a Newton pass on A
constexpr int JOINT_UNROLL = 2;   // ... in a joint (A, b) pass, and in the log-sum pass
// (shared-memory rows; a row whose shape term is recomputed every pass takes
// its events one at a time: its passes are the shape term's, and unrolling
// them spills)
constexpr double TWO_PI = 6.283185307179586;  // 2 * math.pi, as the twin writes it
constexpr double PHI = 0x1.3c6ef372fe950p-1;  // (5 ** 0.5 - 1) / 2, ops/optimize.py's PHI
constexpr unsigned FULL = 0xffffffffu;

enum Kind { FOURIER = 0, VONMISES = 1, CAUCHY = 2 };
enum NormMode { NORM_NEWTON = 0, NORM_JOINT = 1, NORM_FIXED = 2 };

// A row's operands, common to every entry point.
struct RowArgs {
  const double* x;              // (S, N) folded phases
  const unsigned char* mask;    // (S, N) 1 = event, 0 = padding
  const double* exposure;       // (S,)
  const double* ev_c;           // (S, K, N) per-event coefficients, Fourier
  const double* ev_s;           // (S, K, N)
  const double* comp;           // (S, 3, K) coef, kappa or cosh(wid), centre; vM / Cauchy
  const double* row;            // (S, 3) norm lower bound, norm, sum_j amp_j ampShift
  long long n_events;
  int n_comp, kind, mode, iters, bf16;
  double norm_hi, amp_lo, amp_hi;
};

struct SweepOut {
  const double* phis;  // (S, P)
  double* ll;          // (S, P) outputs
  double* a;
  double* b;
  int n_phis;
};

struct GoldenOut {
  const double* lo;  // (S,) the bracket
  const double* hi;
  double* phi;       // (S,) outputs
  double* ll;
  double* a;
  double* b;
  int iters;         // refine_iters
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

struct BlockState {
  double trig[2 * MAX_COMP];          // Fourier: cos(j phi), then sin(j phi)
  float trigf[2 * MAX_COMP];          // the same rounded to bf16 (bf16 sweeps)
  double comp[3 * MAX_COMP];          // vM / Cauchy: coef, kappa or cosh(wid), centre
  double red[2][MAX_SUMS][WARPS];     // block reductions: warp partials, double-buffered
};

// s_i for event i of row r at phase phi, from rounded intrinsics only, so
// the shared-memory and the recompute branches agree bit for bit.
__device__ __forceinline__ double shape_term(const RowArgs& p, const BlockState& c, long long r, long long i,
                                             double phi) {
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

// NS sums then NM minimums (NaN propagates) over the block in a fixed tree,
// with one barrier: every warp reduces the 16 warp partials itself, so every
// thread ends with the totals. ``buf`` alternates the partials' buffer, so a
// warp that runs ahead into the next reduction cannot overwrite partials
// another warp still reads.
template <int NS, int NM>
__device__ __forceinline__ void block_reduce(double* sum, double* mn, BlockState& c, int& buf) {
  static_assert(NS + NM <= MAX_SUMS, "too many block sums");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NS; ++k)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum[k] = __dadd_rn(sum[k], __shfl_down_sync(FULL, sum[k], off));
#pragma unroll
  for (int k = 0; k < NM; ++k)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mn[k] = tmin(mn[k], __shfl_down_sync(FULL, mn[k], off));
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < NS; ++k) c.red[buf][k][warp] = sum[k];
#pragma unroll
    for (int k = 0; k < NM; ++k) c.red[buf][NS + k][warp] = mn[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    double t = lane < WARPS ? c.red[buf][k][lane] : 0.0;
#pragma unroll
    for (int off = WARPS / 2; off > 0; off >>= 1) t = __dadd_rn(t, __shfl_down_sync(FULL, t, off));
    sum[k] = __shfl_sync(FULL, t, 0);
  }
#pragma unroll
  for (int k = 0; k < NM; ++k) {
    double t = lane < WARPS ? c.red[buf][NS + k][lane] : CUDART_INF;
#pragma unroll
    for (int off = WARPS / 2; off > 0; off >>= 1) t = tmin(t, __shfl_down_sync(FULL, t, off));
    mn[k] = __shfl_sync(FULL, t, 0);
  }
  buf ^= 1;
}

// This thread's events i < n_hi (i = t, t + THREADS, ...), U at a time:
// start(u, i) for each of the U (independent work, whose latencies overlap),
// then fold(u, i) for each in event order; the tail one at a time.
template <int U, class Start, class Fold>
__device__ __forceinline__ void each_event(long long n_hi, Start start, Fold fold) {
  long long i = threadIdx.x;
  for (; i + (U - 1) * THREADS < n_hi; i += U * THREADS) {
#pragma unroll
    for (int u = 0; u < U; ++u) start(u, i + u * THREADS);
#pragma unroll
    for (int u = 0; u < U; ++u) fold(u, i + u * THREADS);
  }
  for (; i < n_hi; i += THREADS) {
    start(0, i);
    fold(0, i);
  }
}

// A row's constants that do not depend on phi (von Mises, Cauchy); the
// first barrier of evaluate() publishes them.
__device__ __forceinline__ void load_components(const RowArgs& p, BlockState& c, long long r) {
  if (p.kind != FOURIER)
    for (int j = threadIdx.x; j < 3 * p.n_comp; j += THREADS) c.comp[j] = p.comp[r * 3 * p.n_comp + j];
}

struct Eval {
  double ll, a, b;
};

// The sweep's body at (row r, phase phi), run by every thread of the block;
// every thread returns the results. SMEM: the shape term kept in s_val.
template <bool SMEM>
__device__ __forceinline__ Eval evaluate(const RowArgs& p, BlockState& c, double* s_val, long long r, double phi, int& buf) {
  const int K = p.n_comp;
  const long long N = p.n_events;
  const unsigned char* m = p.mask + r * N;
  if (p.kind == FOURIER) {
    for (int j = threadIdx.x; j < K; j += THREADS) {
      const double jp = __dmul_rn(static_cast<double>(j + 1), phi);
      c.trig[j] = cos(jp);
      c.trig[K + j] = sin(jp);
      c.trigf[j] = to_bf16(c.trig[j]);
      c.trigf[K + j] = to_bf16(c.trig[K + j]);
    }
  }
  __syncthreads();

  // pass 1: the shape term (kept in shared memory when it fits), the masked
  // minimum, the event count and the row's last masked event
  double count[1] = {0.0};
  double lows[2] = {CUDART_INF, CUDART_INF};  // min s, -(1 + the last masked index)
  for (long long i = threadIdx.x; i < N; i += THREADS) {
    const double s = shape_term(p, c, r, i, phi);
    if (SMEM) s_val[i] = s;
    const bool on = m[i] != 0;
    lows[0] = tmin(lows[0], on ? s : CUDART_INF);
    count[0] = __dadd_rn(count[0], on ? 1.0 : 0.0);
    lows[1] = on ? -static_cast<double>(i + 1) : lows[1];
  }
  block_reduce<1, 2>(count, lows, c, buf);
  const double n_ev = count[0], min_s = lows[0];
  const long long n_hi = lows[1] == CUDART_INF ? 0 : static_cast<long long>(-lows[1]);
  const double T = p.exposure[r];
  const double a_lo = p.row[r * 3], norm = p.row[r * 3 + 1], q0 = p.row[r * 3 + 2];

  // s_val is written by the thread that reads it back: no barrier needed
  auto s_at = [&](long long i) {
    if constexpr (SMEM) {
      return s_val[i];
    } else {
      return shape_term(p, c, r, i, phi);
    }
  };

  constexpr int NU = SMEM ? NEWTON_UNROLL : 1, JU = SMEM ? JOINT_UNROLL : 1;
  double a, b = 1.0;
  if (p.mode == NORM_FIXED) {
    a = norm;
  } else if (p.mode == NORM_NEWTON) {
    const double feasible_lo = tmax(a_lo, __dadd_rn(__dmul_rn(-min_s, 1.0 + 1e-9), 1e-12));
    a = clip(__ddiv_rn(n_ev, T), feasible_lo, p.norm_hi);
    for (int it = 0; it < p.iters; ++it) {
      double sums[2] = {0.0, 0.0};
      double inv[NU];
      each_event<NU>(
          n_hi, [&](int u, long long i) { inv[u] = __ddiv_rn(1.0, __dadd_rn(a, s_at(i))); },
          [&](int u, long long i) {
            const bool on = m[i] != 0;
            sums[0] = __dadd_rn(sums[0], on ? inv[u] : 0.0);
            sums[1] = __dadd_rn(sums[1], on ? __dmul_rn(inv[u], inv[u]) : 0.0);
          });
      block_reduce<2, 0>(sums, nullptr, c, buf);
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
      double sv[JU], inv[JU];
      each_event<JU>(
          n_hi,
          [&](int u, long long i) {
            sv[u] = s_at(i);
            inv[u] = __ddiv_rn(1.0, __dadd_rn(a, __dmul_rn(b, sv[u])));
          },
          [&](int u, long long i) {
            const bool on = m[i] != 0;
            const double inv_s = __dmul_rn(inv[u], sv[u]);
            sums[0] = __dadd_rn(sums[0], on ? inv[u] : 0.0);
            sums[1] = __dadd_rn(sums[1], on ? inv_s : 0.0);
            sums[2] = __dadd_rn(sums[2], on ? __dmul_rn(inv[u], inv[u]) : 0.0);
            sums[3] = __dadd_rn(sums[3], on ? __dmul_rn(inv[u], inv_s) : 0.0);
            sums[4] = __dadd_rn(sums[4], on ? __dmul_rn(inv_s, inv_s) : 0.0);
          });
      block_reduce<5, 0>(sums, nullptr, c, buf);
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
  double log_sum[1] = {0.0};
  double min_v[1] = {CUDART_INF};
  double v[JU], lg[JU];
  each_event<JU>(
      n_hi,
      [&](int u, long long i) {
        v[u] = __dadd_rn(a, __dmul_rn(b, s_at(i)));
        lg[u] = log(tmax(v[u], 1e-300));
      },
      [&](int u, long long i) {
        const bool on = m[i] != 0;
        min_v[0] = tmin(min_v[0], on ? v[u] : CUDART_INF);
        log_sum[0] = __dadd_rn(log_sum[0], on ? lg[u] : 0.0);
      });
  block_reduce<1, 1>(log_sum, min_v, c, buf);
  double cst;
  if (p.kind == FOURIER) {
    cst = __dmul_rn(n_ev, log(T));
  } else {
    const double qb = __dmul_rn(q0, b);
    cst = __dsub_rn(__dmul_rn(n_ev, log(__ddiv_rn(T, TWO_PI))), __ddiv_rn(__dmul_rn(qb, T), TWO_PI));
  }
  const double ll = __dadd_rn(__dadd_rn(__dmul_rn(-a, T), cst), log_sum[0]);
  return {min_v[0] > 0.0 ? ll : -CUDART_INF, a, b};
}

template <bool SMEM>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) profile_kernel(const RowArgs p, const SweepOut o) {
  extern __shared__ double s_val[];
  __shared__ BlockState c;
  const long long P = o.n_phis;
  const long long r = blockIdx.x / P;
  const long long q = blockIdx.x % P;
  load_components(p, c, r);
  int buf = 0;
  const Eval e = evaluate<SMEM>(p, c, s_val, r, o.phis[r * P + q], buf);
  if (threadIdx.x == 0) {
    o.ll[r * P + q] = e.ll;
    o.a[r * P + q] = e.a;
    o.b[r * P + q] = e.b;
  }
}

// Hand this block's evaluation to its partner in the cluster and take the
// partner's: written to this block's shared memory, read from the partner's
// after the cluster barrier (its release / acquire orders the two).
// Double-buffered by round, so one barrier a round suffices.
__device__ __forceinline__ Eval exchange(const Eval& own, double (&xch)[2][3], int& xb,
                                         cg::cluster_group& cluster) {
  if (threadIdx.x == 0) {
    xch[xb][0] = own.ll;
    xch[xb][1] = own.a;
    xch[xb][2] = own.b;
  }
  cluster.sync();
  Eval o{0.0, 0.0, 0.0};
  if ((threadIdx.x & 31) == 0) {
    const double* peer = cluster.map_shared_rank(&xch[xb][0], static_cast<int>(cluster.block_rank() ^ 1u));
    o = {peer[0], peer[1], peer[2]};
  }
  o.ll = __shfl_sync(FULL, o.ll, 0);
  o.a = __shfl_sync(FULL, o.a, 0);
  o.b = __shfl_sync(FULL, o.b, 0);
  xb ^= 1;
  return o;
}

// The golden-section refine of row blockIdx.x / 2 on [lo, hi], as
// golden_section (ops/optimize.py) runs it over one-phase sweeps, and the
// (A, b) at its optimum. Launched in clusters of 2 blocks.
template <bool SMEM>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) golden_kernel(const RowArgs p, const GoldenOut g) {
  extern __shared__ double s_val[];
  __shared__ BlockState c;
  __shared__ double xch[2][3];
  cg::cluster_group cluster = cg::this_cluster();
  const bool first = cluster.block_rank() == 0;  // evaluates x1; its partner x2
  const long long r = blockIdx.x / 2;
  load_components(p, c, r);
  int buf = 0, xb = 0;
  const double lo = g.lo[r], hi = g.hi[r];
  double ga = lo, gb = hi;
  double x1 = __dsub_rn(hi, __dmul_rn(PHI, __dsub_rn(hi, lo)));
  double x2 = __dadd_rn(lo, __dmul_rn(PHI, __dsub_rn(hi, lo)));
  Eval own{0.0, 0.0, 0.0}, other{0.0, 0.0, 0.0};
  for (int rnd = 0; rnd <= g.iters; ++rnd) {  // one evaluation site: evaluate() inlines once
    if (rnd > 0) {
      const double f1 = first ? own.ll : other.ll, f2 = first ? other.ll : own.ll;
      const bool shrink_right = f1 > f2;  // keep [a, x2]
      const double na = shrink_right ? ga : x1, nb = shrink_right ? x2 : gb;
      ga = na;
      gb = nb;
      x1 = __dsub_rn(gb, __dmul_rn(PHI, __dsub_rn(gb, ga)));
      x2 = __dadd_rn(ga, __dmul_rn(PHI, __dsub_rn(gb, ga)));
    }
    own = evaluate<SMEM>(p, c, s_val, r, first ? x1 : x2, buf);
    other = exchange(own, xch, xb, cluster);
  }
  if (first && threadIdx.x == 0) {
    const Eval& e2 = other;
    const bool pick1 = own.ll > e2.ll;
    g.phi[r] = pick1 ? x1 : x2;
    g.ll[r] = tmax(own.ll, e2.ll);
    g.a[r] = pick1 ? own.a : e2.a;
    g.b[r] = pick1 ? own.b : e2.b;
  }
  cluster.sync();  // a block's shared memory outlives its partner's last read
}

// Events of a row whose shape terms fit the dynamic shared memory a block
// may take on the current card, beside the kernels' static arrays.
int smem_events() {
  int dev = 0, optin = 0;
  cudaFuncAttributes sweep, golden;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess ||
      cudaFuncGetAttributes(&sweep, profile_kernel<true>) != cudaSuccess ||
      cudaFuncGetAttributes(&golden, golden_kernel<true>) != cudaSuccess)
    return -1;
  const size_t fixed = sweep.sharedSizeBytes > golden.sharedSizeBytes ? sweep.sharedSizeBytes : golden.sharedSizeBytes;
  return (optin - static_cast<int>(fixed)) / static_cast<int>(sizeof(double));
}

bool bad_row_args(long long n_events, int n_comp, int kind, int mode, int newton_iters) {
  return n_events < 1 || n_comp < 1 || n_comp > MAX_COMP || kind < 0 || kind > 2 || mode < 0 || mode > 2 ||
         newton_iters < 0;
}

// The dynamic shared memory a launch over rows of n_events takes (0 when
// the shape term is recomputed), with the kernel's limit raised past 48 KB;
// -1 with err set on a CUDA error.
template <class Kernel>
long long prepare_smem(Kernel kernel_smem, long long n_events, cudaError_t& err) {
  err = cudaSuccess;
  const int keep = smem_events();
  if (keep < 0) {
    err = cudaGetLastError();
    if (err == cudaSuccess) err = cudaErrorUnknown;
    return -1;
  }
  if (n_events > keep) return 0;
  const size_t smem = sizeof(double) * static_cast<size_t>(n_events);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel_smem);
  if (err == cudaSuccess && smem + attr.sharedSizeBytes > 48 * 1024)
    err = cudaFuncSetAttribute(kernel_smem, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  return err == cudaSuccess ? static_cast<long long>(smem) : -1;
}

}  // namespace

// Events of a row that K5 keeps in shared memory on the current card (beyond
// it, every pass recomputes the shape term); -1 on a CUDA error.
extern "C" int toafit_smem_events() { return smem_events(); }

// One sweep over n_rows x n_phis (row, phase) pairs, one block each. kind:
// 0 Fourier, 1 von Mises, 2 Cauchy; mode: 0 Newton on A, 1 joint (A, b),
// 2 fixed norm. Fourier reads ev_c, ev_s (comp may be null); von Mises and
// Cauchy read x and comp (the Fourier operands may be null). Outputs may not
// alias the inputs.
extern "C" int toafit_profile(const double* x, const unsigned char* mask, const double* exposure,
                              const double* phis, const double* ev_c, const double* ev_s, const double* comp,
                              const double* row, int n_rows, int n_phis, long long n_events, int n_comp, int kind,
                              int mode, int newton_iters, double norm_hi, double amp_lo, double amp_hi, int bf16,
                              double* ll, double* a_out, double* b_out, void* stream) {
  if (n_rows < 1 || n_phis < 1 || bad_row_args(n_events, n_comp, kind, mode, newton_iters))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_blocks = static_cast<long long>(n_rows) * n_phis;
  if (n_blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  const long long smem = prepare_smem(profile_kernel<true>, n_events, err);
  if (smem < 0) return static_cast<int>(err);
  const RowArgs args{x, mask, exposure, ev_c, ev_s, comp, row, n_events, n_comp, kind, mode, newton_iters, bf16,
                     norm_hi, amp_lo, amp_hi};
  const SweepOut out{phis, ll, a_out, b_out, n_phis};
  auto kernel = smem > 0 ? profile_kernel<true> : profile_kernel<false>;
  kernel<<<static_cast<unsigned>(n_blocks), THREADS, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      args, out);
  return static_cast<int>(cudaGetLastError());
}

// The golden-section refine of every row on [lo[r], hi[r]] over refine_iters
// rounds, as golden_section over one-phase sweeps, with the (A, b) at the
// optimum: phi_best, ll_max, a_best, b_best, each (n_rows,). One cluster of
// 2 blocks a row. Operands as toafit_profile's.
extern "C" int toafit_golden(const double* x, const unsigned char* mask, const double* exposure, const double* lo,
                             const double* hi, const double* ev_c, const double* ev_s, const double* comp,
                             const double* row, int n_rows, long long n_events, int n_comp, int kind, int mode,
                             int newton_iters, int refine_iters, double norm_hi, double amp_lo, double amp_hi,
                             int bf16, double* phi_best, double* ll_max, double* a_best, double* b_best,
                             void* stream) {
  if (n_rows < 1 || n_rows > 1073741823 || refine_iters < 0 ||
      bad_row_args(n_events, n_comp, kind, mode, newton_iters))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  const long long smem = prepare_smem(golden_kernel<true>, n_events, err);
  if (smem < 0) return static_cast<int>(err);
  const RowArgs args{x, mask, exposure, ev_c, ev_s, comp, row, n_events, n_comp, kind, mode, newton_iters, bf16,
                     norm_hi, amp_lo, amp_hi};
  const GoldenOut out{lo, hi, phi_best, ll_max, a_best, b_best, refine_iters};
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(2 * n_rows));
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = static_cast<size_t>(smem);
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, smem > 0 ? golden_kernel<true> : golden_kernel<false>, args, out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
