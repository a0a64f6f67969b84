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
// libdevice cos, sin, exp and log as torch calls them on the card):
//   Fourier   term = a_j C_j + b_j S_j, j = k + 1, with the event's harmonic
//             pair (C_1, S_1) = (cos, sin)(2 pi x) and (C_j+1, S_j+1) =
//             (C_j C_1 - S_j S_1, S_j C_1 + C_j S_1), and the vertex's
//             a_j = (amp ampShift) cos(loc - j phi), b_j = -((amp ampShift)
//             sin(loc - j phi)): (amp ampShift) cos((j 2 pi x + loc) - j phi)
//             by angle addition, the angle never formed;
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
//   toafit_general_nm    every (row, phase) problem's Nelder-Mead; a
//                        512-thread block takes G (1, 2 or 4) consecutive
//                        phases of one row side by side; at G 2 and 4 a
//                        Fourier row's first harmonic pairs are staged once
//                        a block (below);
//   toafit_general_nm_room  the dynamic shared memory that launch may take
//                        on the current card;
//   toafit_general_nm_blocks  its resident blocks an SM at given dynamic
//                        shared memory;
//   toafit_general_golden  the -rv fit's golden-section refine and the refit
//                        vector at its optimum, one 512-thread block a row
//                        whose rounds run their two golden points side by
//                        side (G = 2) through nm_kernel's body (run_problems);
//                        it replaces the 2 + 2 refine_iters one-phase
//                        launches and the one at the optimum that
//                        optimize.golden_section drove from the host
//                        (crimp_tpu/ops/optimize.py:26-49 at
//                        crimp_tpu/ops/toafit.py:640-660); a Fourier row's
//                        first harmonic pairs are staged once a launch
//                        (below);
//   toafit_general_golden_room  the dynamic shared memory that launch may
//                        take on the current card;
//   toafit_general_eval  f at given unbounded points (row, phase, M vertices),
//                        through the same evaluation body, so its values are
//                        the bits the Nelder-Mead compares;
//   toafit_general_max_group  the largest G whose simplices fit the
//                        current card's shared memory at F free parameters.
//
// What bounds it on this card: f64 operations. Per (problem, evaluation,
// masked event) an evaluation does 5K + 6 (Fourier) to 7K + 6 (von Mises)
// operations counting a cos, exp, log or division as one
// (obs/costmodel.py::k6_counts), against 9 bytes of input read once per
// launch, far on the operations side of the ridge. A libdevice f64 cos or
// log is a few dozen instructions, so the design spends them sparingly:
//   - Evaluate only what the decisions read. A step evaluates the reflect;
//     then exactly the value optimize._decide's tree reads next: the expand
//     where f_r < best, nothing where f_r < second worst, else the outside
//     contraction where f_r < worst, then the inside contraction where the
//     outside one is not taken (the values optimize.candidate_reads
//     counts). The F shrink vertices (the best keeps its value) are
//     evaluated only in the steps that shrink, up to 4 a pass, as the F + 1
//     starting vertices are. A value at a point does not depend on the pass
//     that evaluates it, so this is the branch-free twin's Nelder-Mead bit
//     for bit, at its reads (1.3-1.5 a step) where the twin evaluates F + 5.
//   - A row's phases side by side. A block takes G problems of one row;
//     warp g's lane 0 sorts and decides problem g, its lanes form its
//     centroid and candidates, so the G problems' bookkeeping runs in
//     parallel. Each pass walks the row's events (in walks of up to 4
//     vertices) for every problem's next value(s): its reflect, its next
//     candidate or up to 4 starting or shrink vertices. A problem whose step
//     ended begins its next step in the next pass, without waiting for the
//     others; the block ends when all G have made nm_iters steps. The
//     simplices live in dynamic shared memory, (F + 5) (F + 1) doubles a
//     problem. The event sums keep the one-problem order above, so G moves
//     no bit.
//   - The Fourier term without a cos in the event loop: one cos and one sin
//     of 2 pi x an event and walk, shared by the walk's vertices, the
//     harmonics by the recurrence (each operation an explicit __d*_rn, so
//     nvcc contracts nothing the twin does not), and 2 products and 2 adds
//     a (vertex, component) against the K cos (a, b) a vertex formed
//     outside the loop. Von Mises and Cauchy keep their direct cos.
//   - A thread takes U events a step (4 at one vertex a walk, 2 at two, 1
//     at four), their chains side by side, so a walk of few vertices is not
//     one long dependent chain an event; the terms are still added in event
//     order. Each family has its own event loop (eval_walk's KIND), so the
//     Fourier loop carries none of the others' registers. Passes stop at
//     the row's last masked event.
//   - The staged pair. The pair (C_1, S_1) and the mask byte depend on the
//     event alone, and a block walks its row's events ~210 times
//     (nm_kernel<4>, a brute or dense group of four phases) to ~5 700
//     (golden_kernel's 26 rounds), so golden_kernel and nm_kernel<2, 4>
//     form them once a block, after row_extent, with the walk's own
//     operations (__dmul_rn(TWO_PI, x), libdevice cos and sin; nm_kernel's
//     stage_row), into dynamic shared memory after their G simplices
//     (16-byte aligned, 17 B an event: the stage), and their walks read
//     them there in a loop of their own before the computed loop
//     (eval_walk's Pairs: golden_kernel's StagedPairs holds the stage's
//     pointers, nm_kernel's DynStage its count alone and forms them per
//     walk, and only nm_kernel<G>'s walks of G or more vertices read it;
//     nm_kernel<1> and eval_kernel take ComputedPairs, whose
//     code is the walk's as before; one loop choosing its pair a step took
//     golden_kernel from 200 to 2 794 B of spill). The values are the same
//     doubles wherever formed and each thread keeps its chain of events in
//     order across the two loops, so the stage moves no bit. The host plans
//     n_stage (ops/general_sweep.py::stage_events): the most events whose
//     17 B fit the room beside the G simplices, a multiple of STAGE_STEP =
//     4 x 512, or the whole row. The room is the opt-in shared memory less
//     the block's static Shared and row_extent's partials, and for
//     golden_kernel GoldenShared (toafit_general_golden_room(),
//     toafit_general_nm_room()); both kernels hold one block an SM whatever
//     the stage (the f64 chains' 128 registers a thread under
//     __launch_bounds__(512, 1)). A whole step of every thread at every U
//     (which divides 4) then lies on one side of n_stage, so no warp parts
//     there; events at or above it compute their pair in the walk. Von
//     Mises and Cauchy keep their direct cos((x - cen) - phi): their one
//     phase-free input is x, so they stage nothing. Why not the 48 SMs the
//     84 row blocks of golden_kernel leave idle: a row's event sums are
//     pinned to 512 thread chains and a fixed tree, so a cluster of two 256-thread blocks a row could split the
//     chains with the same bits, but its 168 blocks would put both halves of
//     some rows on shared SMs, those rows would run at today's pace, and the
//     launch ends with its slowest row.
// Per problem it reports the shrink steps and the candidate values the
// decision tree read, which obs/costmodel.py::k6_counts charges, and
// optionally the decision of every step (0 expand, 1 reflect, 2 outside,
// 3 inside contraction, 4 shrink).
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
constexpr int POS_GROUP = 4;                 // starting or shrink vertices of a problem a pass
constexpr int WALK = 4;                      // vertices one walk over the events evaluates
constexpr int MAX_GROUP = 4;                 // problems a block (one a warp; 8 and 16 ran slower)
constexpr int MAX_SLOTS = MAX_GROUP * POS_GROUP;  // vertices a pass at most
constexpr double TWO_PI = 0x1.921fb54442d18p+2;      // 2 * math.pi
constexpr double INV_TWO_PI = 0x1.45f306dc9c883p-3;  // 1.0 / (2 * math.pi)
constexpr double INIT_SCALE = 0.25;          // the initial simplex's step (_general_profile_vecs)
constexpr double PHI = 0x1.3c6ef372fe950p-1;  // (5 ** 0.5 - 1) / 2, ops/optimize.py's PHI
constexpr unsigned FULL = 0xffffffffu;

enum Kind { FOURIER = 0, VONMISES = 1, CAUCHY = 2 };
enum Step { EXPAND = 0, REFLECT = 1, OUTSIDE = 2, INSIDE = 3, SHRINK = 4 };
// a problem's stage: the value(s) its pass evaluates
enum Stage { ST_START, ST_REFLECT, ST_EXPAND, ST_OUTSIDE, ST_INSIDE, ST_SHRINK, ST_DONE };

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

// One problem's Nelder-Mead state; its simplex, values, order and
// candidates are in dynamic shared memory (Simplex).
struct Problem {
  double phi;
  double fr;                 // the step's reflect value
  double fv[POS_GROUP];      // the pass's values: candidates 0-3 (reflect, expand, outside, inside) or positions
  int stage, it, k0;         // k0: first position of a start or shrink pass
  int n_pts, first;          // the pass evaluates cand[first .. first + n_pts)
  int n_shrink, n_read, active;
};

struct Shared {
  Problem prob[MAX_GROUP];
  short slot_g[MAX_SLOTS];               // the pass's vertices: problem
  short slot_j[MAX_SLOTS];               //   and candidate row
  double vec[WALK][MAX_DIM];             // a walk's flattened vectors
  double2 ab[WALK][MAX_COMP];            // Fourier (a, b); von Mises / Cauchy (coefficient, kappa or cosh(wid))
  double loc[WALK][MAX_COMP];            // von Mises / Cauchy: cen_k
  double norm[WALK], nf[WALK], expct[WALK], vphi[WALK];
  double lo[MAX_FREE], span[MAX_FREE];
  int fidx[MAX_FREE];
  double red[2 * WALK][WARPS];           // block reductions: warp partials
  long long n_hi;
  double n_ev;
};

// golden_kernel's own shared state, apart from Shared so that nm_kernel's
// layout is not touched (fields added to Shared, first or last, slowed
// nm_kernel by 0.1-0.3% at 84 x 128 on an H100, utils/k6_ab.py).
struct GoldenShared {
  double u0[MAX_FREE];  // the row's start
  double x[2];          // the round's two golden points
  double ll[2];         // their LLs
  int best[2];          // and their problems' result positions
};

// A problem's arrays in dynamic shared memory.
struct Simplex {
  double* rows;   // (F + 1) x F, addressed through ord
  double* fvals;  // F + 1
  double* cand;   // 4 x F: the candidates, or the positions a pass evaluates
  int* ord;       // F + 1: position -> row, best first
};

__host__ __device__ constexpr long long problem_doubles(int F) { return (F + 1LL) * F + (F + 1) + 4LL * F; }

__host__ __device__ constexpr long long dyn_bytes(int G, int F) {
  return G * problem_doubles(F) * 8 + G * (F + 1LL) * 4;
}

// golden_kernel's dynamic shared memory: its two simplices, then (16-byte
// aligned) the stage's n_stage pairs and n_stage mask bytes, 17 B an event.
__host__ __device__ constexpr long long stage_offset(int F) { return (dyn_bytes(2, F) + 15) / 16 * 16; }
__host__ __device__ constexpr long long golden_bytes(int F, long long n_stage) {
  return stage_offset(F) + n_stage * static_cast<long long>(sizeof(double2) + 1);
}

// Where nm_kernel<G>'s stage begins after its G simplices: dyn_bytes(G, F)
// rounded up to 16 bytes, written out (a device caller of dyn_bytes beside
// golden_kernel's stage_offset changed how golden_kernel's address
// arithmetic compiled).
template <int G>
__host__ __device__ constexpr long long nm_stage_offset(int F) {
  return (G * (problem_doubles(F) * 8 + (F + 1LL) * 4) + 15) / 16 * 16;
}

// Where a Fourier walk takes an event's first harmonic pair (C_1, S_1) from.
// nm_kernel<1> and eval_kernel compute it in the walk (cos and sin of 2 pi
// x); golden_kernel and nm_kernel<2, 4> read it, and the event's mask byte,
// from the block's stage in dynamic shared memory for the events below n,
// formed once a block with the same operations, in a loop of its own, and
// compute it above n in the walk's loop as the others do.
struct ComputedPairs {
  static constexpr bool STAGED = false;
  static constexpr int MIN_V = 1;  // walks of at least MIN_V vertices read a stage
};

struct StagedPairs {
  static constexpr bool STAGED = true;
  // the staged loop's events a thread a step at 1, 2 and 4 vertices a walk
  // (utils/k6_ab.py --stage-u): each a divisor of 4, so that STAGE_STEP
  // events are whole steps of every thread
  static constexpr int U1 = 1, U2 = 2, U4 = 1;
  static constexpr int MIN_V = 1;
  const double2* cs;        // (C_1, S_1) of events [0, n)
  const unsigned char* on;  // their mask bytes, below the row's last masked event
  long long n;
  __device__ __forceinline__ const double2* stage_cs(const Args&) const { return cs; }
  __device__ __forceinline__ const unsigned char* stage_on(const Args&) const { return on; }
};

// nm_kernel<2, 4>'s stage: the same pairs after its G simplices, with only
// the count held across the passes and the pointers formed where a walk
// reads them (holding StagedPairs' two pointers and 64-bit count ran
// nm_kernel<4> 1.7% slower at 84 x 128 on an H100). Only walks of at least
// G vertices read it, nearly all of a block's (one candidate a problem):
// staged loops for fewer as well took nm_kernel<4>'s ptxas spill from 252
// to 472 B and ran it 0.5-1% slower; nm_kernel<2> reading it in walks of
// four alone ran 24% slower at 84 x 128 than in walks of two and four.
template <int G>
struct DynStage {
  static constexpr bool STAGED = true;
  static constexpr int MIN_V = G;
  int n;
  __device__ __forceinline__ double2* stage_cs(const Args& p) const {
    extern __shared__ __align__(16) double dyn[];
    return reinterpret_cast<double2*>(dyn + nm_stage_offset<G>(p.n_free) / 8);
  }
  __device__ __forceinline__ unsigned char* stage_on(const Args& p) const {
    return reinterpret_cast<unsigned char*>(stage_cs(p) + n);
  }
};

// An n_stage below the row's events is a multiple of this: a whole step of
// every thread at every U, so that no warp parts at the stage's end.
constexpr long long STAGE_STEP = 4 * THREADS;

__device__ __forceinline__ Simplex simplex_of(double* dyn, int G, int F, int g) {
  Simplex s;
  s.rows = dyn + g * problem_doubles(F);
  s.fvals = s.rows + (F + 1) * F;
  s.cand = s.fvals + (F + 1);
  s.ord = reinterpret_cast<int*>(dyn + G * problem_doubles(F)) + g * (F + 1);
  return s;
}

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

// The block's constants: the free set and the template vector in every
// walk slot of vec (its free entries are overwritten per walk).
__device__ void load_block(const Args& p, Shared& sh) {
  const int F = p.n_free, D = 3 * p.n_comp + 2;
  for (int d = threadIdx.x; d < F; d += THREADS) {
    sh.fidx[d] = p.free_idx[d];
    sh.lo[d] = p.lo[d];
    sh.span[d] = p.span[d];
  }
  for (int w = threadIdx.x; w < WALK * D; w += THREADS) sh.vec[w / D][w % D] = p.base[w % D];
  __syncthreads();
}

// f at nv (<= V <= WALK) unbounded points of row r: vertex w's coordinate d
// is point(w, d), its phase phase(w); its value goes to sink(w, f). Run by
// every thread of the block, barrier-separated from what comes before and
// after.
template <int V, int KIND, class Point, class Phase, class Sink, class Pairs = ComputedPairs>
__device__ void eval_walk(const Args& p, Shared& sh, long long r, int nv, Point point, Phase phase, Sink sink,
                          Pairs pairs = Pairs()) {
  const int F = p.n_free, K = p.n_comp, D = 3 * K + 2;
  const int tid = threadIdx.x;
  // 1. the flattened vectors: lo + span * sigmoid(u), sigmoid as torch's
  //    1 / (1 + exp(-u)); each vertex's phase
  for (int w = tid; w < nv * F; w += THREADS) {
    const int g = w / F, d = w % F;
    const double sig = __ddiv_rn(1.0, __dadd_rn(1.0, exp(-point(g, d))));
    sh.vec[g][sh.fidx[d]] = __dadd_rn(sh.lo[d], __dmul_rn(sh.span[d], sig));
  }
  for (int g = tid; g < nv; g += THREADS) sh.vphi[g] = phase(g);
  __syncthreads();
  // 2. per vertex and component
  for (int w = tid; w < nv * K; w += THREADS) {
    const int g = w / K, k = w % K;
    const double* v = sh.vec[g];
    const double amp_sh = __dmul_rn(v[1 + k], v[D - 1]);
    const double wid = v[1 + 2 * K + k];
    if (KIND == FOURIER) {
      const double theta = __dsub_rn(v[1 + K + k], __dmul_rn(static_cast<double>(k + 1), sh.vphi[g]));
      sh.ab[g][k] = make_double2(__dmul_rn(amp_sh, cos(theta)), -__dmul_rn(amp_sh, sin(theta)));
    } else if (KIND == VONMISES) {
      const double kappa = __ddiv_rn(1.0, __dmul_rn(wid, wid));
      sh.ab[g][k] = make_double2(__ddiv_rn(amp_sh, __dmul_rn(TWO_PI, bessel_i0(kappa))), kappa);
    } else {
      sh.ab[g][k] = make_double2(__dmul_rn(__dmul_rn(amp_sh, INV_TWO_PI), sinh(wid)), cosh(wid));
    }
    sh.loc[g][k] = v[1 + K + k];
  }
  // 3. per vertex: the norm, the extended norm factor, the expected count
  for (int g = tid; g < nv; g += THREADS) {
    const double* v = sh.vec[g];
    const double norm = v[0];
    const double T = p.exposure[r];
    double nf = norm, expct = __dmul_rn(norm, T);
    if (KIND != FOURIER) {
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

  // 4. one walk over the events, U events a step (1 at four vertices, 2 at
  //    two, 4 at one): each thread's chains of U events side by side, their
  //    terms added in event order
  constexpr int U = V >= 4 ? 1 : 8 / (2 * V);
  const long long N = p.n_events, n_hi = sh.n_hi;
  const double* xr = p.x + r * N;
  const unsigned char* m = p.mask + r * N;
  double lsum[V], lmin[V];
#pragma unroll
  for (int g = 0; g < V; ++g) {
    lsum[g] = 0.0;
    lmin[g] = CUDART_INF;
  }
  long long i_first = tid;
  if constexpr (Pairs::STAGED && KIND == FOURIER && V >= Pairs::MIN_V) {
    // the staged loop: the steps below min(stage, n_hi) read each
    // event's (C_1, S_1) and mask byte from the stage; the loop below goes on
    // from the first step past it with the same chains (STAGE_STEP: a whole
    // step of every thread, UV events a thread a step), so the bits are the
    // computed loop's
    constexpr int UV = V >= 4 ? StagedPairs::U4 : V == 2 ? StagedPairs::U2 : StagedPairs::U1;
    const long long n_s = pairs.n < n_hi ? pairs.n : n_hi;
    const double2* const stage_cs = pairs.stage_cs(p);
    const unsigned char* const stage_on = pairs.stage_on(p);
    long long i0 = tid;
    for (; i0 - tid < n_s; i0 += static_cast<long long>(UV) * THREADS) {
      double c1[UV], s1[UV], c[UV], s[UV], tot[UV][V];
      bool on[UV];
#pragma unroll
      for (int u = 0; u < UV; ++u) {  // past the row's last masked event: cos and sin of 0, as computed
        const long long i = i0 + static_cast<long long>(u) * THREADS;
        const double2 cs = i < n_hi ? stage_cs[i] : make_double2(1.0, 0.0);
        on[u] = i < n_hi && stage_on[i] != 0;
        c1[u] = c[u] = cs.x;
        s1[u] = s[u] = cs.y;
      }
      for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int u = 0; u < UV; ++u) {
          if (k > 0) {
            const double cn = __dsub_rn(__dmul_rn(c[u], c1[u]), __dmul_rn(s[u], s1[u]));
            s[u] = __dadd_rn(__dmul_rn(s[u], c1[u]), __dmul_rn(c[u], s1[u]));
            c[u] = cn;
          }
#pragma unroll
          for (int g = 0; g < V; ++g) {
            if (g < nv) {
              const double2 ab = sh.ab[g][k];
              const double term = __dadd_rn(__dmul_rn(ab.x, c[u]), __dmul_rn(ab.y, s[u]));
              tot[u][g] = k == 0 ? term : __dadd_rn(tot[u][g], term);
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < UV; ++u) {
#pragma unroll
        for (int g = 0; g < V; ++g) {
          if (g < nv) {
            const double nz = __ddiv_rn(__dadd_rn(sh.norm[g], tot[u][g]), sh.nf[g]);
            const double lg = log(tmax(nz, 1e-300));
            lsum[g] = __dadd_rn(lsum[g], on[u] ? lg : 0.0);
            lmin[g] = tmin(lmin[g], on[u] ? nz : CUDART_INF);
          }
        }
      }
    }
    i_first = i0;
  }
  for (long long i0 = i_first; i0 < n_hi; i0 += static_cast<long long>(U) * THREADS) {
    double x[U], tot[U][V];
    bool on[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {  // past the row's last masked event: a slot that adds nothing
      const long long i = i0 + static_cast<long long>(u) * THREADS;
      x[u] = i < n_hi ? xr[i] : 0.0;
      on[u] = i < n_hi && m[i] != 0;
    }
    if (KIND == FOURIER) {
      double c1[U], s1[U], c[U], s[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const double ang = __dmul_rn(TWO_PI, x[u]);
        c1[u] = cos(ang);
        s1[u] = sin(ang);
        c[u] = c1[u];
        s[u] = s1[u];
      }
      for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (k > 0) {
            const double cn = __dsub_rn(__dmul_rn(c[u], c1[u]), __dmul_rn(s[u], s1[u]));
            s[u] = __dadd_rn(__dmul_rn(s[u], c1[u]), __dmul_rn(c[u], s1[u]));
            c[u] = cn;
          }
#pragma unroll
          for (int g = 0; g < V; ++g) {
            if (g < nv) {
              const double2 ab = sh.ab[g][k];
              const double term = __dadd_rn(__dmul_rn(ab.x, c[u]), __dmul_rn(ab.y, s[u]));
              tot[u][g] = k == 0 ? term : __dadd_rn(tot[u][g], term);
            }
          }
        }
      }
    } else {
      for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int g = 0; g < V; ++g) {
            if (g < nv) {
              const double2 cs = sh.ab[g][k];
              const double cd = cos(__dsub_rn(__dsub_rn(x[u], sh.loc[g][k]), sh.vphi[g]));
              const double term = KIND == VONMISES ? __dmul_rn(cs.x, exp(__dmul_rn(cs.y, cd)))
                                                     : __ddiv_rn(cs.x, __dsub_rn(cs.y, cd));
              tot[u][g] = k == 0 ? term : __dadd_rn(tot[u][g], term);
            }
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int g = 0; g < V; ++g) {
        if (g < nv) {
          const double nz = __ddiv_rn(__dadd_rn(sh.norm[g], tot[u][g]), sh.nf[g]);
          const double lg = log(tmax(nz, 1e-300));
          lsum[g] = __dadd_rn(lsum[g], on[u] ? lg : 0.0);
          lmin[g] = tmin(lmin[g], on[u] ? nz : CUDART_INF);
        }
      }
    }
  }

  // 5. the block's sums and minimums in a fixed tree; warp 0 takes f
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int g = 0; g < V; ++g) {
    if (g < nv) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        lsum[g] = __dadd_rn(lsum[g], __shfl_down_sync(FULL, lsum[g], off));
        lmin[g] = tmin(lmin[g], __shfl_down_sync(FULL, lmin[g], off));
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < V; ++g) {
      sh.red[g][warp] = lsum[g];
      sh.red[WALK + g][warp] = lmin[g];
    }
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int g = 0; g < V; ++g) {
      if (g < nv) {
        double s = lane < WARPS ? sh.red[g][lane] : 0.0;
        double mn = lane < WARPS ? sh.red[WALK + g][lane] : CUDART_INF;
#pragma unroll
        for (int off = WARPS / 2; off > 0; off >>= 1) {
          s = __dadd_rn(s, __shfl_down_sync(FULL, s, off));
          mn = tmin(mn, __shfl_down_sync(FULL, mn, off));
        }
        if (lane == 0) {
          const double e = sh.expct[g];
          const double value = __dadd_rn(__dadd_rn(-e, __dmul_rn(sh.n_ev, log(e))), s);
          sink(g, mn <= 0.0 ? CUDART_INF : -value);
        }
      }
    }
  }
  __syncthreads();
}

// Evaluate n vertices in walks of up to WALK, each walk at the least
// register block that holds it and with the family's own event loop:
// vertex w's coordinate d is point(w, d).
template <int KIND, class Point, class Phase, class Sink, class Pairs = ComputedPairs>
__device__ void eval_family(const Args& p, Shared& sh, long long r, int n, Point point, Phase phase, Sink sink,
                            Pairs pairs = Pairs()) {
  for (int w0 = 0; w0 < n; w0 += WALK) {
    const int nv = n - w0 < WALK ? n - w0 : WALK;
    auto pt = [&](int w, int d) { return point(w0 + w, d); };
    auto ph = [&](int w) { return phase(w0 + w); };
    auto sk = [&](int w, double f) { sink(w0 + w, f); };
    if (nv > 2)
      eval_walk<4, KIND>(p, sh, r, nv, pt, ph, sk, pairs);
    else if (nv == 2)
      eval_walk<2, KIND>(p, sh, r, nv, pt, ph, sk, pairs);
    else
      eval_walk<1, KIND>(p, sh, r, nv, pt, ph, sk, pairs);
  }
}

template <class Point, class Phase, class Sink, class Pairs = ComputedPairs>
__device__ void eval_vertices(const Args& p, Shared& sh, long long r, int n, Point point, Phase phase, Sink sink,
                              Pairs pairs = Pairs()) {
  switch (p.kind) {
    case FOURIER: eval_family<FOURIER>(p, sh, r, n, point, phase, sink, pairs); break;
    case VONMISES: eval_family<VONMISES>(p, sh, r, n, point, phase, sink, pairs); break;
    default: eval_family<CAUCHY>(p, sh, r, n, point, phase, sink, pairs); break;
  }
}

// Problem g's next pass after its values came in, run by the 32 lanes of
// warp g: lane 0 takes the decisions, the lanes the vectors.
__device__ void advance(const Args& p, Problem& pr, const Simplex& sx, long long b, int iters, signed char* trace) {
  enum { NONE, BEGIN, POSITIONS, REPLACE, SHRINK_SIMPLEX };
  const int F = p.n_free, lane = threadIdx.x & 31;
  int action = NONE, pick = 0;
  if (lane == 0) {
    const double best = sx.fvals[sx.ord[0]], worst = sx.fvals[sx.ord[F]];
    const double second = sx.fvals[sx.ord[F > 0 ? F - 1 : 0]];
    int step = -1, next = -1;
    switch (pr.stage) {
      case ST_START:
      case ST_SHRINK:
        for (int j = 0; j < pr.n_pts; ++j) sx.fvals[sx.ord[pr.k0 + j]] = pr.fv[j];
        pr.k0 += pr.n_pts;
        if (pr.k0 <= F) {
          action = POSITIONS;
        } else {
          pr.it += pr.stage == ST_SHRINK;
          action = BEGIN;
        }
        break;
      case ST_REFLECT: {
        const double fr = pr.fv[0];
        pr.fr = fr;
        ++pr.n_read;
        if (fr < best) next = ST_EXPAND;
        else if (fr < second) step = REFLECT;
        else if (fr < worst) next = ST_OUTSIDE;
        else next = ST_INSIDE;
        break;
      }
      case ST_EXPAND: {
        const double fr = pr.fr;
        ++pr.n_read;
        if (pr.fv[1] < fr) step = EXPAND;
        else if (fr < second) step = REFLECT;
        else if (fr < worst) next = ST_OUTSIDE;
        else next = ST_INSIDE;
        break;
      }
      case ST_OUTSIDE:
        ++pr.n_read;
        if (pr.fv[2] <= pr.fr) step = OUTSIDE;
        else next = ST_INSIDE;
        break;
      case ST_INSIDE:
        ++pr.n_read;
        step = pr.fv[3] < worst ? INSIDE : SHRINK;
        break;
      default:
        break;
    }
    if (next >= 0) {  // one more candidate value this step
      pr.stage = next;
      pr.first = next - ST_REFLECT;
      pr.n_pts = 1;
    } else if (step >= 0) {
      if (trace != nullptr) trace[b * iters + pr.it] = static_cast<signed char>(step);
      if (step == SHRINK) {
        ++pr.n_shrink;
        pr.stage = ST_SHRINK;
        pr.k0 = 1;  // the best vertex keeps its value
        action = SHRINK_SIMPLEX;
      } else {
        pick = step == EXPAND ? 1 : step == REFLECT ? 0 : step;
        sx.fvals[sx.ord[F]] = pr.fv[pick];
        ++pr.it;
        action = REPLACE;
      }
    }
  }
  __syncwarp();
  action = __shfl_sync(FULL, action, 0);
  pick = __shfl_sync(FULL, pick, 0);
  if (action == REPLACE) {
    double* row = sx.rows + sx.ord[F] * F;
    for (int d = lane; d < F; d += 32) row[d] = sx.cand[pick * F + d];
    __syncwarp();
    action = BEGIN;
  } else if (action == SHRINK_SIMPLEX) {
    for (int d = lane; d < F; d += 32) {
      const double s0 = sx.rows[sx.ord[0] * F + d];
      for (int k = 1; k <= F; ++k) {
        double& v = sx.rows[sx.ord[k] * F + d];
        v = __dadd_rn(s0, __dmul_rn(0.5, __dsub_rn(v, s0)));
      }
      sx.rows[sx.ord[0] * F + d] = __dadd_rn(s0, __dmul_rn(0.5, __dsub_rn(s0, s0)));
    }
    __syncwarp();
    action = POSITIONS;
  }
  if (action == BEGIN) {
    if (pr.it >= iters) {
      __syncwarp();
      if (lane == 0) {
        pr.stage = ST_DONE;
        pr.n_pts = 0;
      }
    } else {
      if (lane == 0) {  // stable insertion sort of the positions by value
        for (int k = 1; k <= F; ++k) {
          const int row = sx.ord[k];
          const double v = sx.fvals[row];
          int j = k - 1;
          while (j >= 0 && before(v, sx.fvals[sx.ord[j]])) {
            sx.ord[j + 1] = sx.ord[j];
            --j;
          }
          sx.ord[j + 1] = row;
        }
      }
      __syncwarp();
      const double inv_f = 1.0 / static_cast<double>(F);
      for (int d = lane; d < F; d += 32) {
        double c = sx.rows[sx.ord[0] * F + d];
        for (int k = 1; k < F; ++k) c = __dadd_rn(c, sx.rows[sx.ord[k] * F + d]);
        c = __dmul_rn(c, inv_f);
        const double dir = __dsub_rn(c, sx.rows[sx.ord[F] * F + d]);
        sx.cand[d] = __dadd_rn(c, dir);
        sx.cand[F + d] = __dadd_rn(c, __dmul_rn(2.0, dir));
        sx.cand[2 * F + d] = __dadd_rn(c, __dmul_rn(0.5, dir));
        sx.cand[3 * F + d] = __dsub_rn(c, __dmul_rn(0.5, dir));
      }
      __syncwarp();
      if (lane == 0) {
        pr.stage = ST_REFLECT;
        pr.first = 0;
        pr.n_pts = 1;
      }
    }
  } else if (action == POSITIONS) {
    const int k0 = pr.k0;
    const int n = F + 1 - k0 < POS_GROUP ? F + 1 - k0 : POS_GROUP;
    for (int w = lane; w < n * F; w += 32) sx.cand[w] = sx.rows[sx.ord[k0 + w / F] * F + w % F];
    __syncwarp();
    if (lane == 0) {
      pr.first = 0;
      pr.n_pts = n;
    }
  }
  __syncwarp();
}

// Problems g < n_act of row r side by side, problem g warp g's, at phase
// phase(g) from the start start(d), d < F (see the design note): each one's
// whole Nelder-Mead. Leaves each problem's simplex, values and order in dyn
// and its counts in sh.prob; problem g's decisions go to trace row
// trace_row(g). The three are functions evaluated where they are used, so
// nm_kernel reads its phases and start from global memory as it always did.
// Run by every thread of the block.
template <int G, class PhaseOf, class Start, class TraceRow, class Pairs = ComputedPairs>
__device__ __forceinline__ void run_problems(const Args& p, Shared& sh, double* dyn, long long r, int n_act, int iters,
                                             signed char* trace, PhaseOf phase, Start start, TraceRow trace_row,
                                             Pairs pairs = Pairs()) {
  const int F = p.n_free, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (warp < G) {  // warp g starts problem g: its simplex and its first positions
    Problem& pr = sh.prob[warp];
    const Simplex sx = simplex_of(dyn, G, F, warp);
    const bool act = warp < n_act;
    if (act) {
      for (int w = lane; w < (F + 1) * F; w += 32) {
        const int k = w / F, d = w % F;
        sx.rows[k * F + d] = __dadd_rn(start(d), k == d + 1 ? INIT_SCALE : 0.0);
      }
      for (int k = lane; k <= F; k += 32) sx.ord[k] = k;
    }
    __syncwarp();
    const int n = F + 1 < POS_GROUP ? F + 1 : POS_GROUP;
    if (act)
      for (int w = lane; w < n * F; w += 32) sx.cand[w] = sx.rows[w];
    if (lane == 0) {
      pr.active = act;
      pr.phi = act ? phase(warp) : 0.0;
      pr.stage = act ? ST_START : ST_DONE;
      pr.it = pr.k0 = pr.first = pr.n_shrink = pr.n_read = 0;
      pr.n_pts = act ? n : 0;
    }
  }
  __syncthreads();
  for (;;) {
    // the pass's vertices: problem g's at [sum of the n_pts before it, + its n_pts)
    int total = 0, off = 0;
    for (int g = 0; g < G; ++g) {
      off += g < warp ? sh.prob[g].n_pts : 0;
      total += sh.prob[g].n_pts;
    }
    if (warp < G && lane < sh.prob[warp].n_pts) {
      sh.slot_g[off + lane] = static_cast<short>(warp);
      sh.slot_j[off + lane] = static_cast<short>(sh.prob[warp].first + lane);
    }
    __syncthreads();
    if (total == 0) break;
    eval_vertices(
        p, sh, r, total,
        [&](int s, int d) { return simplex_of(dyn, G, F, sh.slot_g[s]).cand[sh.slot_j[s] * F + d]; },
        [&](int s) { return sh.prob[sh.slot_g[s]].phi; },
        [&](int s, double f) {
          sh.prob[sh.slot_g[s]].fv[sh.slot_j[s]] = f;
        },
        pairs);
    if (warp < G && sh.prob[warp].stage != ST_DONE)
      advance(p, sh.prob[warp], simplex_of(dyn, G, F, warp), trace_row(warp), iters, trace);
    __syncthreads();
  }
}

// nm_kernel<G>'s stage (the design note), after its G simplices: (C_1, S_1)
// as eval_walk computes them, and the mask, of row r's events below n_stage
// and its last masked event; nothing for von Mises and Cauchy. The barrier
// before the first pass orders it.
template <int G>
__device__ __forceinline__ DynStage<G> stage_row(const Args& p, const Shared& sh, long long r, long long n_stage) {
  const DynStage<G> pairs{p.kind == FOURIER ? static_cast<int>(n_stage) : 0};
  double2* stage_cs = pairs.stage_cs(p);
  unsigned char* stage_on = pairs.stage_on(p);
  const int tid = threadIdx.x;
  const long long N = p.n_events, n_fill = pairs.n < sh.n_hi ? pairs.n : sh.n_hi;
  const double* xr = p.x + r * N;
  const unsigned char* m = p.mask + r * N;
  for (long long i = tid; i < n_fill; i += THREADS) {
    const double ang = __dmul_rn(TWO_PI, xr[i]);
    stage_cs[i] = make_double2(cos(ang), sin(ang));
    stage_on[i] = m[i];
  }
  return pairs;
}

// nm_kernel's pairs: computed at G 1, staged (stage_row) at G 2 and 4.
template <int G>
__device__ __forceinline__ auto nm_pairs(const Args& p, const Shared& sh, long long r, long long n_stage) {
  if constexpr (G == 1)
    return ComputedPairs();
  else
    return stage_row<G>(p, sh, r, n_stage);
}

// The position of a finished simplex's result, as torch.argmin over its
// values by position: the first NaN, else the first least value
// (golden_kernel's; nm_kernel writes the same out in place).
__device__ __forceinline__ int best_position(const Simplex& sx, int F) {
  int best = 0;
  for (int k = 1; k <= F; ++k) {
    const double v = sx.fvals[sx.ord[k]], cur = sx.fvals[sx.ord[best]];
    if (cur == cur && (v != v || v < cur)) best = k;
  }
  return best;
}

// The flattened vector (D) of position ``best``, by the 32 lanes of a warp:
// the template's, its free entries lo + span * sigmoid(u) (golden_kernel's;
// nm_kernel writes the same out in place).
__device__ __forceinline__ void write_vector(const Args& p, const Shared& sh, const Simplex& sx, int best,
                                             double* out) {
  const int F = p.n_free, D = 3 * p.n_comp + 2, lane = threadIdx.x & 31;
  for (int d = lane; d < D; d += 32) out[d] = p.base[d];
  __syncwarp();
  const double* u = sx.rows + sx.ord[best] * F;
  for (int d = lane; d < F; d += 32) {
    const double sig = __ddiv_rn(1.0, __dadd_rn(1.0, exp(-u[d])));
    out[sh.fidx[d]] = __dadd_rn(sh.lo[d], __dmul_rn(sh.span[d], sig));
  }
}

// A block takes G consecutive phases of one row: every problem's whole
// Nelder-Mead, side by side (see the design note); at G 2 and 4 a Fourier
// row's first harmonic pairs and mask bytes of events below n_stage are
// staged once, and every walk reads them there.
template <int G>
__global__ void __launch_bounds__(THREADS, 1)
nm_kernel(const Args p, const double* u0, int iters, double* ll, double* vec_out, int* shrinks, int* reads,
          signed char* trace, long long n_stage) {
  extern __shared__ __align__(16) double dyn[];
  __shared__ Shared sh;
  const long long P = p.n_phis, n_grp = (P + G - 1) / G;
  const long long r = blockIdx.x / n_grp, q0 = (blockIdx.x % n_grp) * G;
  const int F = p.n_free, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_act = P - q0 < G ? static_cast<int>(P - q0) : G;
  load_block(p, sh);
  row_extent(p, sh, r);
  const auto pairs = nm_pairs<G>(p, sh, r, n_stage);
  run_problems<G>(
      p, sh, dyn, r, n_act, iters, trace, [&](int g) { return p.phis[r * P + q0 + g]; },
      [&](int d) { return u0[r * F + d]; }, [&](int g) { return r * P + q0 + g; }, pairs);
  // best_position and write_vector, written out: through the helpers
  // nm_kernel compiled to another spill (140 B at G 4) and ran 0.2% slower
  // at 84 x 128 on an H100 (utils/k6_ab.py against the source before them)
  if (warp < G && sh.prob[warp].active) {
    Problem& pr = sh.prob[warp];
    const Simplex sx = simplex_of(dyn, G, F, warp);
    const long long b = r * P + q0 + warp;
    int best = 0;
    if (lane == 0) {  // torch.argmin: the first NaN, else the first least value
      for (int k = 1; k <= F; ++k) {
        const double v = sx.fvals[sx.ord[k]], cur = sx.fvals[sx.ord[best]];
        if (cur == cur && (v != v || v < cur)) best = k;
      }
      ll[b] = -sx.fvals[sx.ord[best]];
      shrinks[b] = pr.n_shrink;
      reads[b] = pr.n_read;
    }
    best = __shfl_sync(FULL, best, 0);
    const int D = 3 * p.n_comp + 2;
    for (int d = lane; d < D; d += 32) vec_out[b * D + d] = p.base[d];
    __syncwarp();
    const double* u = sx.rows + sx.ord[best] * F;
    for (int d = lane; d < F; d += 32) {
      const double sig = __ddiv_rn(1.0, __dadd_rn(1.0, exp(-u[d])));
      vec_out[b * D + sh.fidx[d]] = __dadd_rn(sh.lo[d], __dmul_rn(sh.span[d], sig));
    }
  }
}

// One block a row: optimize.golden_section's 1 + refine rounds on [lo, hi]
// (maximizing the LL, f = 1.0 LL, which is the LL), each round's two points
// (x1, x2) two problems side by side (G = 2), each started cold from the
// row's u0 as a one-phase nm_kernel launch starts it, so each value is that
// launch's LL bit for bit. Thread 0 keeps (a, b) and forms the next points
// with golden_section's operations in its order; the block ends with
// phi_best = f1 > f2 ? x1 : x2, ll_max = torch.maximum(f1, f2) and the
// flattened vector of the problem that gave phi_best: the bits a one-phase
// launch at phi_best gives. shrinks and reads sum the row's 2 + 2 refine
// problems' counts. A Fourier row's first harmonic pairs and mask bytes of
// events below n_stage are staged once (the design note); every walk of its
// rounds reads them there.
__global__ void __launch_bounds__(THREADS, 1)
golden_kernel(const Args p, const double* lo, const double* hi, const double* u0, int iters, int refine,
              long long n_stage, double* phi_best, double* ll_max, double* vec_out, int* shrinks, int* reads) {
  extern __shared__ __align__(16) double dyn[];
  __shared__ Shared sh;
  __shared__ GoldenShared gs;
  const long long r = blockIdx.x;
  const int F = p.n_free, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  load_block(p, sh);
  row_extent(p, sh, r);
  // the stage: (C_1, S_1) as eval_walk computes them, and the mask, up to
  // the row's last masked event (the barrier before the first round orders it)
  double2* stage_cs = reinterpret_cast<double2*>(dyn + stage_offset(F) / 8);
  unsigned char* stage_on = reinterpret_cast<unsigned char*>(stage_cs + n_stage);
  const StagedPairs pairs{stage_cs, stage_on, p.kind == FOURIER ? n_stage : 0};
  {
    const long long N = p.n_events, n_fill = pairs.n < sh.n_hi ? pairs.n : sh.n_hi;
    const double* xr = p.x + r * N;
    const unsigned char* m = p.mask + r * N;
    for (long long i = tid; i < n_fill; i += THREADS) {
      const double ang = __dmul_rn(TWO_PI, xr[i]);
      stage_cs[i] = make_double2(cos(ang), sin(ang));
      stage_on[i] = m[i];
    }
  }
  for (int d = tid; d < F; d += THREADS) gs.u0[d] = u0[r * F + d];
  double a = 0.0, b = 0.0;  // thread 0: the bracket
  int n_shrink = 0, n_read = 0;
  if (tid == 0) {
    a = lo[r];
    b = hi[r];
    gs.x[0] = __dsub_rn(b, __dmul_rn(PHI, __dsub_rn(b, a)));
    gs.x[1] = __dadd_rn(a, __dmul_rn(PHI, __dsub_rn(b, a)));
  }
  __syncthreads();
  for (int round = 0;; ++round) {
    run_problems<2>(
        p, sh, dyn, r, 2, iters, nullptr, [&](int g) { return gs.x[g]; }, [&](int d) { return gs.u0[d]; },
        [](int) { return 0LL; }, pairs);
    if (warp < 2 && lane == 0) {
      const Simplex sx = simplex_of(dyn, 2, F, warp);
      const int best = best_position(sx, F);
      gs.best[warp] = best;
      gs.ll[warp] = -sx.fvals[sx.ord[best]];
    }
    __syncthreads();
    if (tid == 0) {
      n_shrink += sh.prob[0].n_shrink + sh.prob[1].n_shrink;
      n_read += sh.prob[0].n_read + sh.prob[1].n_read;
    }
    if (round == refine) break;
    if (tid == 0) {
      const bool shrink_right = gs.ll[0] > gs.ll[1];  // keep [a, x2]
      const double x1 = gs.x[0], x2 = gs.x[1];
      a = shrink_right ? a : x1;
      b = shrink_right ? x2 : b;
      gs.x[0] = __dsub_rn(b, __dmul_rn(PHI, __dsub_rn(b, a)));
      gs.x[1] = __dadd_rn(a, __dmul_rn(PHI, __dsub_rn(b, a)));
    }
    __syncthreads();
  }
  const int w = gs.ll[0] > gs.ll[1] ? 0 : 1;  // x_best = where(f1 > f2, x1, x2)
  if (tid == 0) {
    phi_best[r] = gs.x[w];
    ll_max[r] = tmax(gs.ll[0], gs.ll[1]);
    shrinks[r] = n_shrink;
    reads[r] = n_read;
  }
  if (warp == w) write_vector(p, sh, simplex_of(dyn, 2, F, w), gs.best[w], vec_out + r * (3 * p.n_comp + 2));
}

// One block a (row, phase): f at its M given unbounded points, WALK a walk.
__global__ void __launch_bounds__(THREADS, 1) eval_kernel(const Args p, const double* u, int n_pts, double* f) {
  __shared__ Shared sh;
  const long long b = blockIdx.x;
  const long long r = b / p.n_phis;
  const double phi = p.phis[b];
  const int F = p.n_free;
  load_block(p, sh);
  row_extent(p, sh, r);
  eval_vertices(
      p, sh, r, n_pts, [&](int w, int d) { return u[(b * n_pts + w) * F + d]; }, [&](int) { return phi; },
      [&](int w, double v) { f[b * n_pts + w] = v; });
}

bool bad_args(int n_rows, int n_phis, long long n_events, int n_comp, int kind, int n_free) {
  return n_rows < 1 || n_phis < 1 || n_events < 1 || n_comp < 1 || n_comp > MAX_COMP || kind < 0 || kind > 2 ||
         n_free < 1 || n_free > MAX_FREE || n_free > 3 * n_comp + 2 ||
         static_cast<long long>(n_rows) * n_phis > 2147483647LL;
}

// The dynamic shared memory a block may take on the current card beside its
// static shared memory: Shared, row_extent's partials and extra bytes of its
// own (golden_kernel's GoldenShared).
long long smem_room(size_t extra = 0) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return static_cast<long long>(optin) -
         static_cast<long long>(sizeof(Shared) + 2 * WARPS * sizeof(long long) + extra);
}

// nm_kernel<G>'s dynamic shared memory: G simplices, and at G 2 and 4 the
// stage after them.
template <int G>
constexpr long long nm_bytes(int F, long long n_stage) {
  return G == 1 ? dyn_bytes(1, F) : nm_stage_offset<G>(F) + n_stage * static_cast<long long>(sizeof(double2) + 1);
}

// nm_kernel<G>'s resident blocks an SM at bytes of dynamic shared memory
// (0 where they do not fit or the card does not answer).
template <int G>
int nm_blocks(long long bytes) {
  int n = 0;
  if (bytes < 0 || bytes > smem_room() ||
      cudaFuncSetAttribute(nm_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, nm_kernel<G>, THREADS, static_cast<size_t>(bytes)) !=
          cudaSuccess)
    return 0;
  return n;
}

template <int G>
int launch_nm(const Args& args, const double* u0, int n_rows, int iters, long long n_stage, double* ll, double* vec,
              int* shrinks, int* reads, signed char* trace, cudaStream_t stream) {
  const long long bytes = nm_bytes<G>(args.n_free, n_stage);
  const long long blocks = static_cast<long long>(n_rows) * ((args.n_phis + G - 1) / G);
  if ((G == 1 && n_stage != 0) || bytes > smem_room() || blocks > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaFuncSetAttribute(nm_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes));
  if (set != cudaSuccess) return static_cast<int>(set);
  nm_kernel<G><<<static_cast<unsigned>(blocks), THREADS, static_cast<size_t>(bytes), stream>>>(
      args, u0, iters, ll, vec, shrinks, reads, trace, n_stage);
  return static_cast<int>(cudaGetLastError());
}

// n_stage as a staging launch takes it: 0 to n_events, below n_events a
// multiple of STAGE_STEP.
bool bad_stage(long long n_stage, long long n_events) {
  return n_stage < 0 || n_stage > n_events || (n_stage != n_events && n_stage % STAGE_STEP != 0);
}

}  // namespace

// The largest G of 4, 2, 1 whose G simplices of n_free free
// parameters fit the current card's shared memory beside the block's own
// (0 when not even one does).
extern "C" int toafit_general_max_group(int n_free) {
  if (n_free < 1 || n_free > MAX_FREE) return 0;
  const long long room = smem_room();
  for (int g = MAX_GROUP; g >= 1; g /= 2)
    if (dyn_bytes(g, n_free) <= room) return g;
  return 0;
}

// Every (row, phase) problem's bounded Nelder-Mead, G = group phases of a
// row a block: ll (S, P), vec (S, P, D) with D = 3 n_comp + 2, shrinks
// (S, P) the steps that shrank, reads (S, P) the candidate values its
// decisions read (each evaluated once) over all steps; trace (S, P, iters)
// the decision of every step, or null. kind: 0 Fourier, 1 von Mises, 2
// Cauchy. free_idx must hold distinct indices below D. group is 1, 2 or 4
// and at most toafit_general_max_group(n_free); it moves no bit. n_stage:
// at group 2 and 4 the events of a Fourier row whose first harmonic pair is
// staged in shared memory (0 to n_events; below n_events a multiple of 4 x
// 512), 0 at group 1; it moves no bit, and a launch whose stage does not
// fit the card's shared memory is refused. Outputs may not alias the
// inputs.
extern "C" int toafit_general_nm(const double* x, const unsigned char* mask, const double* exposure,
                                 const double* phis, const double* base, const int* free_idx, const double* lo,
                                 const double* span, const double* u0, int n_rows, int n_phis, long long n_events,
                                 int n_comp, int kind, int n_free, int iters, int group, long long n_stage,
                                 double* ll, double* vec, int* shrinks, int* reads, signed char* trace, void* stream) {
  if (bad_args(n_rows, n_phis, n_events, n_comp, kind, n_free) || iters < 0 || bad_stage(n_stage, n_events))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args args{x, mask, exposure, phis, base, free_idx, lo, span, n_events, n_phis, n_comp, kind, n_free};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 1: return launch_nm<1>(args, u0, n_rows, iters, n_stage, ll, vec, shrinks, reads, trace, st);
    case 2: return launch_nm<2>(args, u0, n_rows, iters, n_stage, ll, vec, shrinks, reads, trace, st);
    case 4: return launch_nm<4>(args, u0, n_rows, iters, n_stage, ll, vec, shrinks, reads, trace, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dynamic shared memory nm_kernel may take on the current card: its
// simplices and its stage (ops/general_sweep.py::stage_events). Under
// __launch_bounds__(512, 1) its f64 chains hold 128 registers a thread, one
// block an SM, so the stage costs no resident block
// (toafit_general_nm_blocks reads them).
extern "C" long long toafit_general_nm_room() { return smem_room(); }

// nm_kernel's resident blocks an SM at group phases a block (1, 2 or 4) and
// bytes of dynamic shared memory (0 where they do not fit).
extern "C" int toafit_general_nm_blocks(int group, long long bytes) {
  switch (group) {
    case 1: return nm_blocks<1>(bytes);
    case 2: return nm_blocks<2>(bytes);
    case 4: return nm_blocks<4>(bytes);
    default: return 0;
  }
}

// The dynamic shared memory golden_kernel may take on the current card: its
// two simplices and its stage (ops/general_sweep.py::stage_events).
extern "C" long long toafit_general_golden_room() { return smem_room(sizeof(GoldenShared)); }

// The readvaryparam fit's golden-section refine of every row's profile on
// [lo, hi] (each (S,)) and the refit vector at its optimum, one block a row
// (golden_kernel): phi_best (S,), ll_max (S,), vec (S, D) with D = 3 n_comp
// + 2, and shrinks (S,) and reads (S,), the shrink steps and the candidate
// values read summed over a row's 2 + 2 refine_iters problems. Bitwise the
// chain it replaces: optimize.golden_section over one-phase
// toafit_general_nm launches (iters Nelder-Mead steps from u0 (S, F)), then
// the launch at phi_best for its vector. n_stage: the events of a Fourier
// row whose first harmonic pair is staged in shared memory (0 to n_events;
// below n_events a multiple of 4 x 512); it moves no bit, and a launch whose
// stage does not fit toafit_general_golden_room() is refused. Outputs may
// not alias the inputs.
extern "C" int toafit_general_golden(const double* x, const unsigned char* mask, const double* exposure,
                                     const double* lo_phi, const double* hi_phi, const double* base,
                                     const int* free_idx, const double* lo, const double* span, const double* u0,
                                     int n_rows, long long n_events, int n_comp, int kind, int n_free, int iters,
                                     int refine_iters, long long n_stage, double* phi_best, double* ll_max,
                                     double* vec, int* shrinks, int* reads, void* stream) {
  if (bad_args(n_rows, 2, n_events, n_comp, kind, n_free) || iters < 0 || refine_iters < 0 ||
      bad_stage(n_stage, n_events))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args args{x, mask, exposure, nullptr, base, free_idx, lo, span, n_events, 2, n_comp, kind, n_free};
  const long long bytes = golden_bytes(n_free, n_stage);
  if (bytes > toafit_general_golden_room()) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaFuncSetAttribute(golden_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes));
  if (set != cudaSuccess) return static_cast<int>(set);
  golden_kernel<<<static_cast<unsigned>(n_rows), THREADS, static_cast<size_t>(bytes),
                  static_cast<cudaStream_t>(stream)>>>(args, lo_phi, hi_phi, u0, iters, refine_iters, n_stage,
                                                       phi_best, ll_max, vec, shrinks, reads);
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
