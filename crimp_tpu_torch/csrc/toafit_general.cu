// The readvaryparam ToA fit's profile for NVIDIA Hopper (sm_90a): K6, the
// batched bounded Nelder-Mead.
//
// Replaces _general_profile_vecs (crimp_tpu/ops/toafit.py:428-459), which
// XLA fuses under the jit of fit_toas_batch (:709): a vmap over phases of
// nelder_mead (crimp_tpu/ops/optimize.py:54-119, a lax.scan of nm_iters
// steps) with bounded_transform (:122) over -extended_loglik
// (crimp_tpu/models/profiles.py:173-204, the curves at :109-146 and
// extended_norm_factor at :150). Those are not Pallas kernels. In eager
// PyTorch one Nelder-Mead step is about 145 launches and writes (segments,
// phases, vertices, events) f64 temporaries through device memory; here one
// launch runs every (segment row, phase) problem's whole Nelder-Mead, and
// the per-event values stay on the chip.
//
// What K6 computes, for a problem (row r, phase phi) with F free template
// parameters (flattened-vector indices free_idx, box [lo, lo + span]):
//   u0       the start, to_unbounded(start[free_idx]), from the wrapper;
//   simplex  u0 and u0 + 0.25 e_d, d < F;
//   nm_iters steps of ops/optimize.py::nelder_mead, with its comparisons in
//            its order: the vertices in stable order of their values (NaN
//            last, as torch.argsort(stable=True)), the centroid of the F best
//            ((v_0 + v_1) + ... + v_{F-1}) * (1 / F), the reflect, expand,
//            outside and inside candidates, the decision tree, the shrink
//            towards the best vertex;
//   f(u)     -extended_loglik of the template with free_idx set to
//            lo + span / (1 + exp(-u)) and ph_shift = phi: the model
//            norm + sum_k term_k at every masked event, normalised by the
//            extended norm factor, log-summed (clamped at 1e-300), with +inf
//            when the normalised model is <= 0 at some masked event;
//   result   the first vertex of least value: -f (the LL) and its full
//            flattened vector [norm, amp_1..K, loc_1..K, wid_1..K, ampShift].
// Per event and component, with the twin's own angle and rounding
// (ops/general_sweep.py::general_nll, each operation one IEEE f64 operation,
// libdevice cos, exp and log as torch calls them on the card):
//   Fourier   term = (amp ampShift) cos(((j 2 pi) x + loc) - j phi)
//   von Mises term = ((amp ampShift) / (2 pi i0(kappa))) exp(kappa cos((x - cen) - phi)),
//             kappa = 1 / (wid wid)
//   Cauchy    term = (((amp ampShift) (1 / 2 pi)) sinh(wid)) / (cosh(wid) - cos((x - cen) - phi))
// Every sum over events is taken in a fixed order: thread t adds events t,
// t + 512, ... in turn, then the 512 partials meet in a fixed tree (warp
// shuffles, then the 16 warp sums), no atomics, as K5 (csrc/toafit.cu)
// does; the twin's general_nll takes its sums in the same order
// (general_sweep.block_sum), so a problem's values do not depend on the
// problems beside it, and reruns are bitwise.
//
// Entry points:
//   toafit_general_nm    every (row, phase) problem's Nelder-Mead, one
//                        512-thread block a problem on gridDim.x;
//   toafit_general_eval  f at given unbounded points (row, phase, M vertices),
//                        through the same evaluation body, so its values are
//                        the bits the Nelder-Mead compares.
//
// Design, a simple kernel that is right first:
//   - The simplex (at most 51 x 50 f64) stays in shared memory, addressed
//     through an order array; thread 0 keeps the order by a stable insertion
//     sort and takes the decisions, threads d < F do the centroid and the
//     candidates a coordinate each.
//   - One pass over the events evaluates up to four vertices: the four
//     candidates of a step in one pass, with four sums and four minimums a
//     thread. The F shrink vertices (the best one is unchanged) are evaluated
//     only in the steps where the problem shrinks, four a pass; the
//     branch-free twin evaluates all F + 1 every step and discards them, the
//     same bits at 4 evaluations a step instead of F + 5.
//   - Passes stop at the row's last masked event.
//   - Per problem it reports the shrink steps and the candidate values the
//     decision tree read (f_reflect; f_expand where f_reflect beats the best;
//     past the reflect, f_out where f_reflect beats the worst and f_in where
//     the outside contraction is not taken): the evaluations the data needs,
//     which obs/costmodel.py::k6_counts charges, not the 4 a step K6 makes.
//   - Optional trace: the decision of every step (0 expand, 1 reflect,
//     2 outside, 3 inside contraction, 4 shrink), for locating the step where
//     two runs part.
//
// What bounds it on this card: f64 operations. Per (problem, evaluation,
// masked event) an evaluation does 5K + 6 (Fourier) to 7K + 6 (von Mises)
// operations counting a cos, exp, log or division as one
// (obs/costmodel.py::k6_counts), against 9 bytes of input read once per
// launch, far on the operations side of the ridge. The
// libdevice cos is a few dozen f64 instructions, so the bound is not reached.
//
// Plain C interface, loaded with ctypes (crimp_tpu_torch/ops/general_sweep.py).
// The entry points launch on the caller's stream, allocate nothing and
// return the launch's CUDA error (0 on success).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_COMP = 16;                 // template components (harmonics)
constexpr int MAX_DIM = 3 * MAX_COMP + 2;    // flattened vector length D
constexpr int MAX_FREE = MAX_DIM;            // free parameters F
constexpr int GROUP = 4;                     // vertices a pass over the events evaluates
constexpr double TWO_PI = 0x1.921fb54442d18p+2;      // 2 * math.pi
constexpr double INV_TWO_PI = 0x1.45f306dc9c883p-3;  // 1.0 / (2 * math.pi)
constexpr double INIT_SCALE = 0.25;          // the initial simplex's step (_general_profile_vecs)
constexpr unsigned FULL = 0xffffffffu;

enum Kind { FOURIER = 0, VONMISES = 1, CAUCHY = 2 };
enum Step { EXPAND = 0, REFLECT = 1, OUTSIDE = 2, INSIDE = 3, SHRINK = 4 };

struct Args {
  const double* x;            // (S, N) folded phases
  const unsigned char* mask;  // (S, N) 1 = event, 0 = padding
  const double* exposure;     // (S,)
  const double* phis;         // (S, P)
  const double* base;         // (D,) the template's flattened vector
  const int* free_idx;        // (F,) indices into it
  const double* lo;           // (F,) box lower bounds
  const double* span;         // (F,) hi - lo
  long long n_events;
  int n_phis, n_comp, kind, n_free;
};

struct Shared {
  double simplex[MAX_FREE + 1][MAX_FREE];  // rows addressed through ord
  double fvals[MAX_FREE + 1];
  int ord[MAX_FREE + 1];                   // position -> simplex row, best first
  double cand[GROUP][MAX_FREE];            // unbounded points of the pass
  double vec[GROUP][MAX_DIM];              // their flattened vectors
  double coef[GROUP][MAX_COMP];            // per component: amp ampShift (Fourier), the vM / Cauchy coefficient
  double shp[GROUP][MAX_COMP];             // kappa (vM) or cosh(wid) (Cauchy)
  double loc[GROUP][MAX_COMP];             // ph_k or cen_k
  double norm[GROUP], nf[GROUP], expct[GROUP];
  double cj[MAX_COMP], jphi[MAX_COMP];     // Fourier: j 2 pi and j phi
  double lo[MAX_FREE], span[MAX_FREE];
  int fidx[MAX_FREE];
  double red[2 * GROUP][WARPS];            // block reductions: warp partials
  double fg[GROUP];                        // the pass's values
  long long n_hi;
  double n_ev;
  int shrink;
};

// torch.maximum / torch.minimum: NaN propagates
__device__ __forceinline__ double tmax(double a, double b) {
  return (a != a || b != b) ? CUDART_NAN : (a > b ? a : b);
}
__device__ __forceinline__ double tmin(double a, double b) {
  return (a != a || b != b) ? CUDART_NAN : (a < b ? a : b);
}

// torch.special.i0 as torch computes it on the card (ATen/native/cuda/Math.cuh,
// i0_string: Cephes' Chebyshev expansions), written as plain C++ so nvcc
// contracts it as torch's build does.
__device__ double chbevl(double x, const double* array, int len) {
  double b0 = array[0], b1 = 0.0, b2 = 0.0;
  for (int i = 1; i < len; ++i) {
    b2 = b1;
    b1 = b0;
    b0 = x * b1 - b2 + array[i];
  }
  return 0.5 * (b0 - b2);
}

__device__ double bessel_i0(double x_in) {
  const double x = fabs(x_in);
  if (x <= 8.0) {
    const double A[] = {
        -4.41534164647933937950E-18, 3.33079451882223809783E-17, -2.43127984654795469359E-16,
        1.71539128555513303061E-15,  -1.16853328779934516808E-14, 7.67618549860493561688E-14,
        -4.85644678311192946090E-13, 2.95505266312963983461E-12, -1.72682629144155570723E-11,
        9.67580903537323691224E-11,  -5.18979560163526290666E-10, 2.65982372468238665035E-9,
        -1.30002500998624804212E-8,  6.04699502254191894932E-8,  -2.67079385394061173391E-7,
        1.11738753912010371815E-6,   -4.41673835845875056359E-6,  1.64484480707288970893E-5,
        -5.75419501008210370398E-5,  1.88502885095841655729E-4,  -5.76375574538582365885E-4,
        1.63947561694133579842E-3,   -4.32430999505057594430E-3,  1.05464603945949983183E-2,
        -2.37374148058994688156E-2,  4.93052842396707084878E-2,  -9.49010970480476444210E-2,
        1.71620901522208775349E-1,   -3.04682672343198398683E-1,  6.76795274409476084995E-1};
    const double y = (x / 2.0) - 2.0;
    return exp(x) * chbevl(y, A, 30);
  }
  const double B[] = {
      -7.23318048787475395456E-18, -4.83050448594418207126E-18, 4.46562142029675999901E-17,
      3.46122286769746109310E-17,  -2.82762398051658348494E-16, -3.42548561967721913462E-16,
      1.77256013305652638360E-15,  3.81168066935262242075E-15,  -9.55484669882830764870E-15,
      -4.15056934728722208663E-14, 1.54008621752140982691E-14,  3.85277838274214270114E-13,
      7.18012445138366623367E-13,  -1.79417853150680611778E-12, -1.32158118404477131188E-11,
      -3.14991652796324136454E-11, 1.18891471078464383424E-11,  4.94060238822496958910E-10,
      3.39623202570838634515E-9,   2.26666899049817806459E-8,   2.04891858946906374183E-7,
      2.89137052083475648297E-6,   6.88975834691682398426E-5,   3.36911647825569408990E-3,
      8.04490411014108831608E-1};
  return (exp(x) * chbevl(32.0 / x - 2.0, B, 25)) / sqrt(x);
}

// A before B in the stable order of values: NaN after every number
__device__ __forceinline__ bool before(double a, double b) { return (a == a && b != b) || a < b; }

// The row's event count and its last masked event + 1, into sh (every
// thread reads them after the barrier).
__device__ void row_extent(const Args& p, Shared& sh, long long r) {
  const long long N = p.n_events;
  const unsigned char* m = p.mask + r * N;
  long long cnt = 0, hi = 0;
  for (long long i = threadIdx.x; i < N; i += THREADS) {
    if (m[i]) {
      ++cnt;
      hi = i + 1;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_down_sync(FULL, cnt, off);
    const long long o = __shfl_down_sync(FULL, hi, off);
    hi = o > hi ? o : hi;
  }
  __shared__ long long part[2][WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    part[0][warp] = cnt;
    part[1][warp] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long c = 0, h = 0;
    for (int w = 0; w < WARPS; ++w) {
      c += part[0][w];
      h = part[1][w] > h ? part[1][w] : h;
    }
    sh.n_ev = static_cast<double>(c);
    sh.n_hi = h;
  }
  __syncthreads();
}

// The block's constants of a problem: the free set, the template vector in
// every slot of vec (its free entries are overwritten per pass) and, for
// Fourier, j 2 pi and j phi.
__device__ void load_problem(const Args& p, Shared& sh, double phi) {
  const int F = p.n_free, K = p.n_comp, D = 3 * K + 2;
  for (int d = threadIdx.x; d < F; d += THREADS) {
    sh.fidx[d] = p.free_idx[d];
    sh.lo[d] = p.lo[d];
    sh.span[d] = p.span[d];
  }
  for (int w = threadIdx.x; w < GROUP * D; w += THREADS) sh.vec[w / D][w % D] = p.base[w % D];
  for (int k = threadIdx.x; k < K; k += THREADS) {
    const double j = static_cast<double>(k + 1);
    sh.cj[k] = __dmul_rn(j, TWO_PI);
    sh.jphi[k] = __dmul_rn(j, phi);
  }
  __syncthreads();
}

// f at the nv (<= GROUP) unbounded points in sh.cand, into sh.fg; run by
// every thread of the block, barrier-separated from what comes before and
// after.
__device__ void eval_group(const Args& p, Shared& sh, long long r, double phi, int nv) {
  const int F = p.n_free, K = p.n_comp, D = 3 * K + 2;
  const int tid = threadIdx.x;
  // 1. the flattened vectors: lo + span * sigmoid(u), sigmoid as torch's
  //    1 / (1 + exp(-u))
  for (int w = tid; w < nv * F; w += THREADS) {
    const int g = w / F, d = w % F;
    const double sig = __ddiv_rn(1.0, __dadd_rn(1.0, exp(-sh.cand[g][d])));
    sh.vec[g][sh.fidx[d]] = __dadd_rn(sh.lo[d], __dmul_rn(sh.span[d], sig));
  }
  __syncthreads();
  // 2. per vertex and component
  for (int w = tid; w < nv * K; w += THREADS) {
    const int g = w / K, k = w % K;
    const double* v = sh.vec[g];
    const double amp_sh = __dmul_rn(v[1 + k], v[D - 1]);
    const double wid = v[1 + 2 * K + k];
    double coef = amp_sh, shape = 0.0;
    if (p.kind == VONMISES) {
      shape = __ddiv_rn(1.0, __dmul_rn(wid, wid));
      coef = __ddiv_rn(amp_sh, __dmul_rn(TWO_PI, bessel_i0(shape)));
    } else if (p.kind == CAUCHY) {
      coef = __dmul_rn(__dmul_rn(amp_sh, INV_TWO_PI), sinh(wid));
      shape = cosh(wid);
    }
    sh.coef[g][k] = coef;
    sh.shp[g][k] = shape;
    sh.loc[g][k] = v[1 + K + k];
  }
  // 3. per vertex: the norm, the extended norm factor, the expected count
  for (int g = tid; g < nv; g += THREADS) {
    const double* v = sh.vec[g];
    const double norm = v[0];
    const double T = p.exposure[r];
    double nf = norm, expct = __dmul_rn(norm, T);
    if (p.kind != FOURIER) {
      double q = __dmul_rn(v[1], v[D - 1]);
      for (int k = 1; k < K; ++k) q = __dadd_rn(q, __dmul_rn(v[1 + k], v[D - 1]));
      nf = __dadd_rn(__dmul_rn(TWO_PI, norm), q);
      expct = __dmul_rn(__dmul_rn(nf, T), INV_TWO_PI);
    }
    sh.norm[g] = norm;
    sh.nf[g] = nf;
    sh.expct[g] = expct;
  }
  __syncthreads();

  // 4. one pass over the events
  const long long N = p.n_events, n_hi = sh.n_hi;
  const double* xr = p.x + r * N;
  const unsigned char* m = p.mask + r * N;
  double lsum[GROUP], lmin[GROUP];
#pragma unroll
  for (int g = 0; g < GROUP; ++g) {
    lsum[g] = 0.0;
    lmin[g] = CUDART_INF;
  }
  for (long long i = tid; i < n_hi; i += THREADS) {
    const double x = xr[i];
    const bool on = m[i] != 0;
    double tot[GROUP];
    for (int k = 0; k < K; ++k) {
      if (p.kind == FOURIER) {
        const double cjx = __dmul_rn(sh.cj[k], x);
        const double jp = sh.jphi[k];
#pragma unroll
        for (int g = 0; g < GROUP; ++g) {
          if (g < nv) {
            const double term = __dmul_rn(sh.coef[g][k], cos(__dsub_rn(__dadd_rn(cjx, sh.loc[g][k]), jp)));
            tot[g] = k == 0 ? term : __dadd_rn(tot[g], term);
          }
        }
      } else {
#pragma unroll
        for (int g = 0; g < GROUP; ++g) {
          if (g < nv) {
            const double cd = cos(__dsub_rn(__dsub_rn(x, sh.loc[g][k]), phi));
            const double term = p.kind == VONMISES
                ? __dmul_rn(sh.coef[g][k], exp(__dmul_rn(sh.shp[g][k], cd)))
                : __ddiv_rn(sh.coef[g][k], __dsub_rn(sh.shp[g][k], cd));
            tot[g] = k == 0 ? term : __dadd_rn(tot[g], term);
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      if (g < nv) {
        const double nz = __ddiv_rn(__dadd_rn(sh.norm[g], tot[g]), sh.nf[g]);
        const double lg = log(tmax(nz, 1e-300));
        lsum[g] = __dadd_rn(lsum[g], on ? lg : 0.0);
        lmin[g] = tmin(lmin[g], on ? nz : CUDART_INF);
      }
    }
  }

  // 5. the block's sums and minimums in a fixed tree; thread 0 takes f
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int g = 0; g < GROUP; ++g) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lsum[g] = __dadd_rn(lsum[g], __shfl_down_sync(FULL, lsum[g], off));
      lmin[g] = tmin(lmin[g], __shfl_down_sync(FULL, lmin[g], off));
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      sh.red[g][warp] = lsum[g];
      sh.red[GROUP + g][warp] = lmin[g];
    }
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      double s = lane < WARPS ? sh.red[g][lane] : 0.0;
      double mn = lane < WARPS ? sh.red[GROUP + g][lane] : CUDART_INF;
#pragma unroll
      for (int off = WARPS / 2; off > 0; off >>= 1) {
        s = __dadd_rn(s, __shfl_down_sync(FULL, s, off));
        mn = tmin(mn, __shfl_down_sync(FULL, mn, off));
      }
      if (lane == 0 && g < nv) {
        const double e = sh.expct[g];
        const double value = __dadd_rn(__dadd_rn(-e, __dmul_rn(sh.n_ev, log(e))), s);
        sh.fg[g] = mn <= 0.0 ? CUDART_INF : -value;
      }
    }
  }
  __syncthreads();
}

// Copy positions [k0, k0 + nv) of the simplex (through ord) into sh.cand.
__device__ __forceinline__ void stage_vertices(const Args& p, Shared& sh, int k0, int nv) {
  const int F = p.n_free;
  for (int w = threadIdx.x; w < nv * F; w += THREADS) sh.cand[w / F][w % F] = sh.simplex[sh.ord[k0 + w / F]][w % F];
  __syncthreads();
}

__device__ __forceinline__ void store_values(Shared& sh, int k0, int nv) {
  if (threadIdx.x == 0)
    for (int g = 0; g < nv; ++g) sh.fvals[sh.ord[k0 + g]] = sh.fg[g];
  __syncthreads();
}

// Evaluate positions [k_begin, F] of the simplex, GROUP a pass.
__device__ void eval_positions(const Args& p, Shared& sh, long long r, double phi, int k_begin) {
  for (int k0 = k_begin; k0 <= p.n_free; k0 += GROUP) {
    const int nv = p.n_free + 1 - k0 < GROUP ? p.n_free + 1 - k0 : GROUP;
    stage_vertices(p, sh, k0, nv);
    eval_group(p, sh, r, phi, nv);
    store_values(sh, k0, nv);
  }
}

// One block a (row, phase) problem: the whole Nelder-Mead.
__global__ void __launch_bounds__(THREADS, 1)
nm_kernel(const Args p, const double* u0, int iters, double* ll, double* vec_out, int* shrinks, int* reads,
          signed char* trace) {
  __shared__ Shared sh;
  const long long P = p.n_phis;
  const long long b = blockIdx.x;
  const long long r = b / P;
  const double phi = p.phis[b];
  const int F = p.n_free, tid = threadIdx.x;
  const double inv_f = 1.0 / static_cast<double>(F);
  load_problem(p, sh, phi);
  row_extent(p, sh, r);
  for (int w = tid; w < (F + 1) * F; w += THREADS) {
    const int k = w / F, d = w % F;
    sh.simplex[k][d] = __dadd_rn(u0[r * F + d], k == d + 1 ? INIT_SCALE : 0.0);
  }
  if (tid <= F) sh.ord[tid] = tid;
  __syncthreads();
  eval_positions(p, sh, r, phi, 0);
  int n_shrink = 0, n_read = 0;  // n_read: thread 0's count
  for (int it = 0; it < iters; ++it) {
    if (tid == 0) {  // stable insertion sort of the positions by value
      for (int k = 1; k <= F; ++k) {
        const int row = sh.ord[k];
        const double v = sh.fvals[row];
        int j = k - 1;
        while (j >= 0 && before(v, sh.fvals[sh.ord[j]])) {
          sh.ord[j + 1] = sh.ord[j];
          --j;
        }
        sh.ord[j + 1] = row;
      }
    }
    __syncthreads();
    for (int d = tid; d < F; d += THREADS) {
      double c = sh.simplex[sh.ord[0]][d];
      for (int k = 1; k < F; ++k) c = __dadd_rn(c, sh.simplex[sh.ord[k]][d]);
      c = __dmul_rn(c, inv_f);
      const double dir = __dsub_rn(c, sh.simplex[sh.ord[F]][d]);
      sh.cand[0][d] = __dadd_rn(c, dir);
      sh.cand[1][d] = __dadd_rn(c, __dmul_rn(2.0, dir));
      sh.cand[2][d] = __dadd_rn(c, __dmul_rn(0.5, dir));
      sh.cand[3][d] = __dsub_rn(c, __dmul_rn(0.5, dir));
    }
    __syncthreads();
    eval_group(p, sh, r, phi, GROUP);
    if (tid == 0) {
      const double best = sh.fvals[sh.ord[0]], worst = sh.fvals[sh.ord[F]];
      const double second = sh.fvals[sh.ord[F > 0 ? F - 1 : 0]];
      const double fr = sh.fg[0], fe = sh.fg[1], fo = sh.fg[2], fi = sh.fg[3];
      const bool use_expand = (fr < best) && (fe < fr);
      const bool use_reflect = !use_expand && (fr < second);
      const bool use_out = !use_expand && !use_reflect && (fr < worst) && (fo <= fr);
      const bool use_in = !use_expand && !use_reflect && !use_out && (fi < worst);
      const int step = use_expand ? EXPAND : use_reflect ? REFLECT : use_out ? OUTSIDE : use_in ? INSIDE : SHRINK;
      n_read += 1 + (fr < best);  // f_reflect, and f_expand where the reflect beats the best
      if (!use_expand && !use_reflect) n_read += (fr < worst) + !use_out;  // f_out, then f_in
      sh.shrink = step == SHRINK;
      if (step != SHRINK) {
        const int row = sh.ord[F];
        for (int d = 0; d < F; ++d) sh.simplex[row][d] = sh.cand[step == EXPAND ? 1 : step == REFLECT ? 0 : step][d];
        sh.fvals[row] = sh.fg[step == EXPAND ? 1 : step == REFLECT ? 0 : step];
      }
      if (trace != nullptr) trace[b * iters + it] = static_cast<signed char>(step);
    }
    __syncthreads();
    if (sh.shrink) {
      ++n_shrink;
      for (int d = tid; d < F; d += THREADS) {
        const double s0 = sh.simplex[sh.ord[0]][d];
        for (int k = 1; k <= F; ++k) {
          double& v = sh.simplex[sh.ord[k]][d];
          v = __dadd_rn(s0, __dmul_rn(0.5, __dsub_rn(v, s0)));
        }
        sh.simplex[sh.ord[0]][d] = __dadd_rn(s0, __dmul_rn(0.5, __dsub_rn(s0, s0)));
      }
      __syncthreads();
      eval_positions(p, sh, r, phi, 1);  // the best vertex keeps its value
    }
  }
  if (tid == 0) {  // torch.argmin: the first NaN, else the first least value
    int best = 0;
    for (int k = 1; k <= F; ++k) {
      const double v = sh.fvals[sh.ord[k]], cur = sh.fvals[sh.ord[best]];
      if (cur == cur && (v != v || v < cur)) best = k;
    }
    sh.ord[0] = sh.ord[best];
    ll[b] = -sh.fvals[sh.ord[best]];
    shrinks[b] = n_shrink;
    reads[b] = n_read;
  }
  __syncthreads();
  const int D = 3 * p.n_comp + 2;
  for (int d = tid; d < D; d += THREADS) vec_out[b * D + d] = p.base[d];
  __syncthreads();
  for (int d = tid; d < F; d += THREADS) {
    const double sig = __ddiv_rn(1.0, __dadd_rn(1.0, exp(-sh.simplex[sh.ord[0]][d])));
    vec_out[b * D + sh.fidx[d]] = __dadd_rn(sh.lo[d], __dmul_rn(sh.span[d], sig));
  }
}

// One block a (row, phase): f at its M given unbounded points, GROUP a pass.
__global__ void __launch_bounds__(THREADS, 1) eval_kernel(const Args p, const double* u, int n_pts, double* f) {
  __shared__ Shared sh;
  const long long b = blockIdx.x;
  const long long r = b / p.n_phis;
  const double phi = p.phis[b];
  const int F = p.n_free;
  load_problem(p, sh, phi);
  row_extent(p, sh, r);
  for (int m0 = 0; m0 < n_pts; m0 += GROUP) {
    const int nv = n_pts - m0 < GROUP ? n_pts - m0 : GROUP;
    for (int w = threadIdx.x; w < nv * F; w += THREADS)
      sh.cand[w / F][w % F] = u[(b * n_pts + m0 + w / F) * F + w % F];
    __syncthreads();
    eval_group(p, sh, r, phi, nv);
    if (threadIdx.x == 0)
      for (int g = 0; g < nv; ++g) f[b * n_pts + m0 + g] = sh.fg[g];
    __syncthreads();
  }
}

bool bad_args(int n_rows, int n_phis, long long n_events, int n_comp, int kind, int n_free) {
  return n_rows < 1 || n_phis < 1 || n_events < 1 || n_comp < 1 || n_comp > MAX_COMP || kind < 0 || kind > 2 ||
         n_free < 1 || n_free > MAX_FREE || n_free > 3 * n_comp + 2 ||
         static_cast<long long>(n_rows) * n_phis > 2147483647LL;
}

}  // namespace

// Every (row, phase) problem's bounded Nelder-Mead: ll (S, P), vec (S, P, D)
// with D = 3 n_comp + 2, shrinks (S, P) the steps that shrank, reads (S, P)
// the candidate values its decisions read over all steps; trace (S, P,
// iters) the decision of every step, or null. kind: 0 Fourier, 1 von Mises,
// 2 Cauchy. free_idx must hold distinct indices below D. Outputs may not
// alias the inputs.
extern "C" int toafit_general_nm(const double* x, const unsigned char* mask, const double* exposure,
                                 const double* phis, const double* base, const int* free_idx, const double* lo,
                                 const double* span, const double* u0, int n_rows, int n_phis, long long n_events,
                                 int n_comp, int kind, int n_free, int iters, double* ll, double* vec, int* shrinks,
                                 int* reads, signed char* trace, void* stream) {
  if (bad_args(n_rows, n_phis, n_events, n_comp, kind, n_free) || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args args{x, mask, exposure, phis, base, free_idx, lo, span, n_events, n_phis, n_comp, kind, n_free};
  nm_kernel<<<static_cast<unsigned>(n_rows * n_phis), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      args, u0, iters, ll, vec, shrinks, reads, trace);
  return static_cast<int>(cudaGetLastError());
}

// f = -extended_loglik at n_pts unbounded points per (row, phase): u (S, P,
// n_pts, n_free) -> f (S, P, n_pts), through the Nelder-Mead's evaluation.
extern "C" int toafit_general_eval(const double* x, const unsigned char* mask, const double* exposure,
                                   const double* phis, const double* base, const int* free_idx, const double* lo,
                                   const double* span, const double* u, int n_rows, int n_phis, long long n_events,
                                   int n_comp, int kind, int n_free, int n_pts, double* f, void* stream) {
  if (bad_args(n_rows, n_phis, n_events, n_comp, kind, n_free) || n_pts < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args args{x, mask, exposure, phis, base, free_idx, lo, span, n_events, n_phis, n_comp, kind, n_free};
  eval_kernel<<<static_cast<unsigned>(n_rows * n_phis), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      args, u, n_pts, f);
  return static_cast<int>(cudaGetLastError());
}
