// Uniform-grid Z^2 tile kernel and build probe for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of crimp_tpu/ops/pallas_z2.py:
//   - probe_kernel      <- pallas_minimal_probe (pallas_z2.py:50-68): sum(x+1)
//                          over one (8, 128) f32 block; tells a toolchain
//                          failure from a kernel failure.
//   - z2_tile_kernel    <- _make_kernel / _tile_chunk_sums (pallas_z2.py:71-133)
//     + z2_reduce_splits   and the f64 row precompute of its host wrapper
//                          (pallas_z2.py:164-226), extended to the search cube
//                          of crimp_tpu/ops/search.py:618-705.
//
// What K2 computes, per (fddot row l, fdot row i, trial tile, trial j_lo):
//   phase(t) = [(cfrac(f_tile*t) + cfrac(0.5*fdot_i*t^2)) + cfrac(fdd_l/6*t^3)]
//              + j_lo*cfrac(df*t)
// with each f64 product reduced by the floor-based centered fraction and
// cast to f32, the rows added in f32 in that association (search.py:687),
// the f32 phase reduced again, a sin/cos pair (the fixed polynomial of
// ops/fasttrig.py, or sincosf(2*pi*frac) on the same f32 argument) and the
// Chebyshev recurrence to nharm harmonics; C_k, S_k are the sums over events
// of w_e*cos_k, w_e*sin_k (w_e = 1 when no weights are given).
// f_tile = f0 + (tile0 + tile)*(T*df), T = 256: tile0 > 0 computes the
// tiles [tile0, tile0 + n_tiles) of the grid that starts at f0, bit for bit
// the same tiles of one launch over the whole grid (a chunked scan).
//
// On a uniform grid trial j of a tile has phase base + j*b, b = cfrac(df*t)
// fixed by the event, so the sin/cos pair of trial j + 1 is that of trial j
// rotated by (cos 2*pi*b, sin 2*pi*b). K2 forms the phase directly, as above,
// only for the first trial of each thread's block of R consecutive trials and
// rotates for the other R - 1.
//
// What bounds it on this card: f32 instruction issue. The direct form
// spends about 27 instructions a (trial, event) pair at nharm 2 (phase,
// reduction, the polynomial, Chebyshev, sums; 26 + 6*nharm FLOPs). The
// rotation costs 4 (two FMUL, two FFMA), so a pair costs the Chebyshev
// recurrence and the sums (7 at nharm 2) plus the rotation, plus the start
// angle (~20) and the shared loads once an event for R pairs: ~14 at R = 8.
// z2_grid.flops_per_pair counts that in FLOPs (FMA = 2). The bytes are the
// 8-byte event times (and 4-byte weights), read once per block: at the
// north-star shape (1e5 trials x 8.4e5 events, nharm 2) ~1.5e12 FLOPs
// against ~7 MB, far on the compute side of the 67 TFLOP/s f32 / 3.35 TB/s
// ridge.
//
// Design, against that bound:
//   - The TPU kernel carried C and S across a sequential grid axis in VMEM.
//     Here a thread owns R consecutive trials j0 .. j0 + R - 1 of one tile
//     (R = trials_per_thread<NH>: 8 at nharm <= 2, 4 up to 5, 2 above) and
//     keeps their 2*NH*R running sums and 2*NH*R per-chunk sums in registers
//     (NH and R are template parameters, so the arrays stay in registers).
//   - Trial j0's phase is cfrac_f(base + j0*b) with __fmul_rn/__fadd_rn, its
//     sin/cos the polynomial or sincosf as before; trials j0 + 1 .. j0 + R - 1
//     rotate (c, s) by the staged (cos 2*pi*b, sin 2*pi*b), each rotation two
//     products and two FMAs with rounded intrinsics, then the Chebyshev
//     recurrence to NH. The rotation adds ~1e-7 cycles of rounding a step, R
//     - 1 <= 7 steps, against the ~4e-6 cycles the direct form's f32 j*b
//     already carries at j = 255. The pair is the mode's trig scaled to unit
//     length in f64: the polynomial's |pair| - 1 reaches 5.6e-7, and R - 1
//     rotations would compound it into a bias of the sums that grows with the
//     signal (at the north-star surrogate's peak, Z^2 1.6e4, it doubled the
//     polynomial grid's error against the f64-trig statistic).
//   - A block of 256 threads holds R (tile, row) pairs, 256 / R threads each
//     (one warp a pair at R = 8), taken in order from the flattened (row,
//     tile) index, so a block keeps 8 warps however few trials a thread
//     covers. A pair's sums depend only on its own tile, row and the events:
//     not on which pairs share its block, nor on tile0.
//   - The block stages one chunk of 1024 events in shared memory: once an
//     event, (b, cos 2*pi*b, sin 2*pi*b, w) as one float4 (the rotation
//     pair with the mode's trig, at unit length), and once an event and
//     pair, the f64 rows reduced and added in f32 to base (Hopper has real
//     f64, so the TILE_CHUNK HBM rows the TPU needed are gone). A thread
//     then sweeps the chunk with one broadcast 16-byte load and one 4-byte
//     load an event for its R pairs.
//   - The weights, the fddot row and the trig mode are template flags: the
//     plain variant (no weights, no fddot row, polynomial trig) does no extra
//     work. The extended variant accumulates fmaf(w_e, cos_k, C_k): with w_e
//     = 1.0 the product is exact, so it equals the plain sum bit for bit; a
//     zero fddot row adds an exact 0.0f, so the cube at fddots=[0.0] equals
//     the 2-D grid bit for bit, as the JAX kernels pin.
//   - Per-chunk sums are added to the running sums, as the Pallas kernel
//     accumulated per event chunk; every trial sums its events in order.
//   - Events are split across blocks in ranges of per_split events (the
//     caller's plan: z2_grid.default_per_split fits the grid to whole waves of
//     the resident blocks that z2_grid_occupancy reports); a second kernel
//     adds the split partials in split order. No float atomics: two runs are
//     bitwise equal, and a streamed run that launches one split per chunk and
//     adds the chunks in order equals the monolithic run at the same split.
//   - Events past the end are never read: the tail chunk's loop bound stops
//     at n, which is the weight-0 padding of the Pallas wrapper (pallas_z2.py:
//     190) without the +0.0 additions.
//   - The phase and the rotation are formed with __fmul_rn/__fadd_rn/
//     __fmaf_rn and the f64 rows with __dmul_rn, so nvcc cannot contract them:
//     the phase's rounding is that of the JAX decomposition. The file is built
//     without -use_fast_math, so sincosf is the accurate libdevice function,
//     not __sincosf.
//
// Plain C interface, loaded with ctypes (crimp_tpu_torch/ops/z2_grid.py).
// Every entry point launches on the caller's stream and returns
// cudaGetLastError() (0 on success); it allocates nothing.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int TRIAL_TILE = 256;
constexpr int EVENT_CHUNK = 1024;
constexpr int PROBE_THREADS = 1024;

__device__ __forceinline__ double cfrac_d(double x) {
  const double f = __dsub_rn(x, floor(x));
  return f >= 0.5 ? __dsub_rn(f, 1.0) : f;
}

__device__ __forceinline__ float cfrac_f(float x) {
  const float f = __fsub_rn(x, floorf(x));
  return f >= 0.5f ? __fsub_rn(f, 1.0f) : f;
}

// sin(2*pi*x), cos(2*pi*x) for x in [-0.5, 0.5]: ops/fasttrig.py's
// degree-11 odd / degree-12 even least-squares polynomials in z = x^2. The
// last product is rounded on its own (__fmul_rn), so no sum it feeds can
// absorb it into an FMA.
__device__ __forceinline__ void sincos_poly(float x, float& s, float& c) {
  const float z = x * x;
  float sp = -1.2372507211e01f;
  sp = fmaf(sp, z, 4.1269936976e01f);
  sp = fmaf(sp, z, -7.6594929804e01f);
  sp = fmaf(sp, z, 8.1597658022e01f);
  sp = fmaf(sp, z, -4.1341480362e01f);
  sp = fmaf(sp, z, 6.2831834664e00f);
  s = __fmul_rn(sp, x);
  float cp = fmaf(6.5756180224e00f, z, -2.6000532120e01f);
  cp = fmaf(cp, z, 6.0176231390e01f);
  cp = fmaf(cp, z, -8.5451165912e01f);
  cp = fmaf(cp, z, 6.4939172239e01f);
  cp = fmaf(cp, z, -1.9739205554e01f);
  cp = fmaf(cp, z, 9.9999999229e-01f);
  c = cp;
}

__global__ void probe_kernel(const float* __restrict__ x, float* __restrict__ out, int n) {
  __shared__ float buf[PROBE_THREADS];
  const int i = threadIdx.x;
  buf[i] = i < n ? x[i] + 1.0f : 0.0f;
  __syncthreads();
  for (int stride = PROBE_THREADS / 2; stride > 0; stride >>= 1) {
    if (i < stride) buf[i] += buf[i + stride];
    __syncthreads();
  }
  if (i == 0) *out = buf[0];
}

// Does nothing: its launch time is the floor under K1's (chip_smoke.py).
__global__ void empty_kernel() {}

// 2*pi rounded to f32, as (2*np.pi) * f32 is in the JAX kernels
constexpr float TWO_PI_F = static_cast<float>(6.283185307179586);

// Trials a thread owns (and (tile, row) pairs a block holds), and the
// resident blocks a SM the register budget is cut for (65536 / (256 *
// MIN_BLOCKS) registers a thread): the 4*NH*R running and chunk sums stay in
// registers with no spill up to nharm 5 at two blocks a SM; above nharm 10
// the budget is one block's 255 registers. ops/z2_grid.py::trials_per_thread
// mirrors this.
template <int NH>
__host__ __device__ constexpr int trials_per_thread() {
  return NH <= 2 ? 8 : (NH <= 5 ? 4 : 2);
}

template <int NH>
__host__ __device__ constexpr int min_blocks() {
  return NH <= 10 ? 2 : 1;
}

// Events an event-loop iteration: 4 at nharm <= 2 (2.7% faster than 2 at
// the north-star shape on the H100, 120 registers, no spill; 1 is 4% slower
// than 2, and three blocks a SM spill), 2 above.
template <int NH>
__host__ __device__ constexpr int event_unroll() {
  return NH <= 2 ? 4 : 2;
}

__device__ __forceinline__ void trig_cycles(float x, bool poly, float& s, float& c) {
  if (poly) {
    sincos_poly(x, s, c);
  } else {
    sincosf(__fmul_rn(TWO_PI_F, x), &s, &c);
  }
}

// acc += w*v (EXT) or acc += v, each one rounding
template <bool EXT>
__device__ __forceinline__ void accumulate(float& acc, float v, float w) {
  acc = EXT ? __fmaf_rn(w, v, acc) : __fadd_rn(acc, v);
}

// One trial's harmonics 1..NH from (cos, sin) of its phase: the Chebyshev
// recurrence, each harmonic's pair into the chunk sums.
template <int NH, bool EXT>
__device__ __forceinline__ void add_harmonics(float c1, float s1, float w, float (&c_ch)[NH],
                                              float (&s_ch)[NH]) {
  accumulate<EXT>(c_ch[0], c1, w);
  accumulate<EXT>(s_ch[0], s1, w);
  const float two_c1 = 2.0f * c1;
  float ckm2 = 1.0f, skm2 = 0.0f, ckm1 = c1, skm1 = s1;
#pragma unroll
  for (int k = 1; k < NH; ++k) {
    const float ck = __fmaf_rn(two_c1, ckm1, -ckm2);
    const float sk = __fmaf_rn(two_c1, skm1, -skm2);
    accumulate<EXT>(c_ch[k], ck, w);
    accumulate<EXT>(s_ch[k], sk, w);
    ckm2 = ckm1;
    skm2 = skm1;
    ckm1 = ck;
    skm1 = sk;
  }
}

// Grid (ceil(n_pairs / R), 1, n_split), TRIAL_TILE threads; pair p = row *
// n_tiles + tile, row (fddot row / n_fdot, fdot row % n_fdot); thread
// lane of the block's pair g owns trials lane*R .. lane*R + R - 1 of its
// tile. Writes the sums to dst[split][2][n_rows][n_tiles][NH][TRIAL_TILE]
// (C then S). EXT adds the optional fddot row (sixth_fdd = fdd/6 per fddot,
// may be null) and the optional per-event weights (w, may be null: 1.0).
template <int NH, bool EXT, bool POLY>
__global__ void __launch_bounds__(TRIAL_TILE, (min_blocks<NH>()))
z2_tile_kernel(const double* __restrict__ t, int n, double f0, double tdf, double df,
               const double* __restrict__ half_fd, int n_fdot,
               const double* __restrict__ sixth_fdd, const float* __restrict__ w,
               int n_tiles, long long n_pairs, int tile0, int per_split, float* __restrict__ dst) {
  constexpr int R = trials_per_thread<NH>();
  constexpr int PAIRS = R;                   // (tile, row) pairs a block
  constexpr int LANES = TRIAL_TILE / R;      // threads a pair
  __shared__ float4 s_bcw[EVENT_CHUNK];           // (b, cos 2*pi*b, sin 2*pi*b, w) an event
  __shared__ float s_base[PAIRS][EVENT_CHUNK];    // base an event and pair
  const int tid = threadIdx.x;
  const int g = tid / LANES;
  const int lane = tid % LANES;
  const long long pair = static_cast<long long>(blockIdx.x) * PAIRS + g;
  const bool active = pair < n_pairs;  // uniform over the pair's warps
  const int tile = active ? static_cast<int>(pair % n_tiles) : 0;
  const int row = active ? static_cast<int>(pair / n_tiles) : 0;
  const int split = blockIdx.z;

  const double f_tile = __dadd_rn(f0, __dmul_rn(static_cast<double>(tile0 + tile), tdf));
  const double hf = half_fd[row % n_fdot];
  const bool has_r = EXT && sixth_fdd != nullptr;
  const double sf = has_r ? sixth_fdd[row / n_fdot] : 0.0;
  const float j0 = static_cast<float>(lane * R);

  float c_tot[R][NH], s_tot[R][NH];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int k = 0; k < NH; ++k) {
      c_tot[r][k] = 0.0f;
      s_tot[r][k] = 0.0f;
    }
  }

  // 64-bit: split * per_split + per_split can pass INT_MAX for n < INT_MAX
  const long long e_begin = static_cast<long long>(split) * per_split;
  const long long e_end = min(static_cast<long long>(n), e_begin + per_split);
  for (long long e0 = e_begin; e0 < e_end; e0 += EVENT_CHUNK) {
    const int cnt = static_cast<int>(min(static_cast<long long>(EVENT_CHUNK), e_end - e0));
    __syncthreads();  // the previous chunk has been consumed
    for (int e = tid; e < cnt; e += TRIAL_TILE) {
      const float b = static_cast<float>(cfrac_d(__dmul_rn(df, t[e0 + e])));
      float sb, cb;
      trig_cycles(b, POLY, sb, cb);
      // to unit length in f64: the rotation carries the pair's angle, not its
      // amplitude error, which R - 1 rotations would compound
      const double inv = __ddiv_rn(1.0, __dsqrt_rn(__dadd_rn(__dmul_rn(cb, cb), __dmul_rn(sb, sb))));
      s_bcw[e] = make_float4(b, static_cast<float>(__dmul_rn(cb, inv)), static_cast<float>(__dmul_rn(sb, inv)),
                             EXT && w != nullptr ? w[e0 + e] : 1.0f);
    }
    if (active) {
      for (int e = lane; e < cnt; e += LANES) {
        const double tv = t[e0 + e];
        const double tt = __dmul_rn(tv, tv);
        const float r = static_cast<float>(cfrac_d(__dmul_rn(f_tile, tv)));
        const float q = static_cast<float>(cfrac_d(__dmul_rn(hf, tt)));
        float base = __fadd_rn(r, q);
        if (has_r) {
          base = __fadd_rn(base, static_cast<float>(cfrac_d(__dmul_rn(sf, __dmul_rn(tt, tv)))));
        }
        s_base[g][e] = base;
      }
    }
    __syncthreads();

    float c_ch[R][NH], s_ch[R][NH];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int k = 0; k < NH; ++k) {
        c_ch[r][k] = 0.0f;
        s_ch[r][k] = 0.0f;
      }
    }
    if (active) {
      const float* base_g = s_base[g];
#pragma unroll (event_unroll<NH>())
      for (int e = 0; e < cnt; ++e) {
        const float4 bcw = s_bcw[e];
        // trial j0 directly, as the direct form: cfrac_f(base + j0*b), trig
        float s, c;
        trig_cycles(cfrac_f(__fadd_rn(base_g[e], __fmul_rn(j0, bcw.x))), POLY, s, c);
        add_harmonics<NH, EXT>(c, s, bcw.w, c_ch[0], s_ch[0]);
        // trials j0 + 1 .. j0 + R - 1: rotate by 2*pi*b
#pragma unroll
        for (int r = 1; r < R; ++r) {
          const float cn = __fmaf_rn(c, bcw.y, -__fmul_rn(s, bcw.z));
          const float sn = __fmaf_rn(s, bcw.y, __fmul_rn(c, bcw.z));
          c = cn;
          s = sn;
          add_harmonics<NH, EXT>(c, s, bcw.w, c_ch[r], s_ch[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int k = 0; k < NH; ++k) {
        c_tot[r][k] = __fadd_rn(c_tot[r][k], c_ch[r][k]);
        s_tot[r][k] = __fadd_rn(s_tot[r][k], s_ch[r][k]);
      }
    }
  }

  if (!active) return;
  const size_t plane = static_cast<size_t>(n_pairs) * NH * TRIAL_TILE;
  const size_t off = static_cast<size_t>(pair) * NH * TRIAL_TILE + static_cast<size_t>(lane) * R;
  float* c_dst = dst + static_cast<size_t>(split) * 2 * plane + off;
  float* s_dst = c_dst + plane;
#pragma unroll
  for (int k = 0; k < NH; ++k) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      c_dst[static_cast<size_t>(k) * TRIAL_TILE + r] = c_tot[r][k];
      s_dst[static_cast<size_t>(k) * TRIAL_TILE + r] = s_tot[r][k];
    }
  }
}

// out[i] = sum over splits of partial[s][i], in split order.
__global__ void z2_reduce_splits(const float* __restrict__ partial, int n_split, size_t m,
                                 float* __restrict__ out) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= m) return;
  float acc = partial[i];
  for (int s = 1; s < n_split; ++s) acc += partial[static_cast<size_t>(s) * m + i];
  out[i] = acc;
}

template <int NH>
int launch_tiles(bool ext, bool poly, long long n_pairs, int n_split, cudaStream_t stream,
                 const double* t, int n, double f0, double tdf, double df, const double* half_fd,
                 int n_fdot, const double* sixth_fdd, const float* w, int n_tiles, int tile0,
                 int per_split, float* dst) {
  constexpr int R = trials_per_thread<NH>();
  const long long blocks = (n_pairs + R - 1) / R;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), 1, n_split);
  if (!ext) {
    z2_tile_kernel<NH, false, true><<<grid, TRIAL_TILE, 0, stream>>>(
        t, n, f0, tdf, df, half_fd, n_fdot, nullptr, nullptr, n_tiles, n_pairs, tile0, per_split, dst);
  } else if (poly) {
    z2_tile_kernel<NH, true, true><<<grid, TRIAL_TILE, 0, stream>>>(
        t, n, f0, tdf, df, half_fd, n_fdot, sixth_fdd, w, n_tiles, n_pairs, tile0, per_split, dst);
  } else {
    z2_tile_kernel<NH, true, false><<<grid, TRIAL_TILE, 0, stream>>>(
        t, n, f0, tdf, df, half_fd, n_fdot, sixth_fdd, w, n_tiles, n_pairs, tile0, per_split, dst);
  }
  return static_cast<int>(cudaGetLastError());
}

// Pairs a block and the resident blocks a SM of the kernels an nharm call can
// launch: with poly the fewer of the plain and the extended polynomial
// variants (so a call's plan does not depend on its weights or fddot row),
// else the extended sincosf one.
template <int NH>
int occupancy(int poly, int* pairs_per_block, int* blocks_per_sm) {
  int a = 0, b = 0;
  cudaError_t err;
  if (poly) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&a, z2_tile_kernel<NH, false, true>, TRIAL_TILE, 0);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, z2_tile_kernel<NH, true, true>, TRIAL_TILE, 0);
    }
    a = a < b ? a : b;
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&a, z2_tile_kernel<NH, true, false>, TRIAL_TILE, 0);
  }
  *pairs_per_block = trials_per_thread<NH>();
  *blocks_per_sm = a;
  return static_cast<int>(err);
}

}  // namespace

extern "C" int z2_probe(const float* x, float* out, int n, void* stream) {
  if (n < 1 || n > PROBE_THREADS) return static_cast<int>(cudaErrorInvalidValue);
  probe_kernel<<<1, PROBE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(x, out, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int z2_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

#define Z2_CASES(X)                                                              \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) X(15) \
  X(16) X(17) X(18) X(19) X(20)

// For an nharm call: (tile, row) pairs a block and resident blocks a SM (0
// when none fits), for the wrapper's split plan.
extern "C" int z2_grid_occupancy(int nharm, int poly, int* pairs_per_block, int* blocks_per_sm) {
  switch (nharm) {
#define Z2_OCC(NH) \
  case NH:         \
    return occupancy<NH>(poly, pairs_per_block, blocks_per_sm);
    Z2_CASES(Z2_OCC)
#undef Z2_OCC
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Sums for the grid f0 + ((tile0 + tile)*TRIAL_TILE + j)*df, one row per (fddot, fdot)
// pair: half_fd holds 0.5*fdot (n_fdot), sixth_fdd fdd/6 (n_fddot; null for
// the 2-D grid, then n_fddot must be 1), w the per-event f32 weights (null:
// all 1). poly selects the polynomial sin/cos (1) or sincosf (0).
// out: [2][n_fddot][n_fdot][n_tiles][nharm][TRIAL_TILE] f32. With n_split > 1
// the event range is cut into n_split ranges of per_split events (a multiple
// of EVENT_CHUNK), their sums land in partial ([n_split] x out's shape) and
// a second kernel reduces them into out in split order.
extern "C" int z2_grid_sums(const double* t, int n, double f0, double tdf, double df,
                            const double* half_fd, int n_fdot, const double* sixth_fdd,
                            int n_fddot, const float* w, int n_tiles, int tile0, int nharm,
                            int poly, int n_split, int per_split, float* partial, float* out,
                            void* stream) {
  const long long n_rows = static_cast<long long>(n_fdot) * n_fddot;
  if (n < 1 || n_fdot < 1 || n_fddot < 1 || n_tiles < 1 || tile0 < 0 || n_split < 1 || per_split < 1 ||
      static_cast<long long>(tile0) + n_tiles > 2147483647LL ||
      per_split % EVENT_CHUNK != 0 || n_rows > 65535 || n_split > 65535 ||
      (sixth_fdd == nullptr && n_fddot != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  // every split starts inside the event list, and together they cover it
  const long long covered = static_cast<long long>(n_split) * per_split;
  if (covered - per_split >= n || covered < n) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_pairs = n_rows * n_tiles;
  float* dst = n_split > 1 ? partial : out;
  const bool ext = sixth_fdd != nullptr || w != nullptr || !poly;
  int err;
  switch (nharm) {
#define Z2_CASE(NH)                                                                      \
  case NH:                                                                               \
    err = launch_tiles<NH>(ext, poly != 0, n_pairs, n_split, s, t, n, f0, tdf, df, half_fd, \
                           n_fdot, sixth_fdd, w, n_tiles, tile0, per_split, dst);        \
    break;
    Z2_CASES(Z2_CASE)
#undef Z2_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0 || n_split == 1) return err;
  const size_t m = static_cast<size_t>(2) * n_pairs * nharm * TRIAL_TILE;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((m + threads - 1) / threads);
  z2_reduce_splits<<<blocks, threads, 0, s>>>(partial, n_split, m, out);
  return static_cast<int>(cudaGetLastError());
}
