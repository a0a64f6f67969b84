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
// What bounds it on this card: f32 arithmetic. Each (trial, event) pair
// costs about 26 + 6*nharm FLOPs (FMA = 2; see z2_grid.flops_per_pair),
// while the bytes are the 8-byte event times (and 4-byte weights), read once
// per block: at the north-star shape (1e5 trials x 8.4e5 events, nharm 2)
// that is ~3.2e12 FLOPs against ~7 MB, far on the compute side of the
// 67 TFLOP/s f32 / 3.35 TB/s ridge.
//
// Design, against that bound:
//   - The TPU kernel carried C and S across a sequential grid axis in VMEM.
//     Here each thread owns one trial and keeps its 2*nharm running sums and
//     2*nharm per-chunk sums in registers (nharm <= 20: at most 80 floats);
//     nharm is a template parameter so the arrays stay in registers.
//   - One block per (tile, fddot*n_fdot + fdot, event split). The block
//     stages one chunk of 1024 events in shared memory: each thread computes
//     the f64 rows for a stride of events (Hopper has real f64, so the
//     TILE_CHUNK HBM rows the TPU needed are gone), then every thread sweeps
//     the chunk, reading the (base, b) pair as one broadcast float2 load.
//     The f64 row work is ~15-20 operations per event per block against 256
//     trials of f32 work.
//   - The weights, the fddot row and the trig mode are template flags: the
//     plain variant (no weights, no fddot row, polynomial trig) is the 2-D
//     north-star kernel as it was, with no extra work. The extended variant
//     stages w_e beside (base, b) and accumulates fmaf(w_e, cos_k, C_k):
//     with w_e = 1.0 the product is exact, so it equals the plain sum bit for
//     bit; a zero fddot row adds an exact 0.0f, so the cube at fddots=[0.0]
//     equals the 2-D grid bit for bit, as the JAX kernels pin.
//   - Per-chunk sums are added to the running sums, as the Pallas kernel
//     accumulated per event chunk.
//   - When the (tile, row) grid is too small to fill the 132 SMs, events are
//     split across blocks in ranges of per_split events (chosen by the
//     caller); a second kernel adds the split partials in split order. No
//     float atomics: two runs are bitwise equal, and a streamed run that
//     launches one split per chunk and adds the chunks in order equals the
//     monolithic run at the same split length.
//   - Events past the end are never read: the tail chunk's loop bound stops
//     at n, which is the weight-0 padding of the Pallas wrapper (pallas_z2.py:
//     190) without the +0.0 additions.
//   - The phase is formed with __fmul_rn/__fadd_rn and the f64 rows with
//     __dmul_rn so nvcc cannot contract them into FMAs: the rounding is that
//     of the JAX decomposition. The polynomial and the recurrence use FMA.
//     The file is built without -use_fast_math, so sincosf is the accurate
//     libdevice function, not __sincosf.
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
// degree-11 odd / degree-12 even least-squares polynomials in z = x^2.
__device__ __forceinline__ void sincos_poly(float x, float& s, float& c) {
  const float z = x * x;
  float sp = -1.2372507211e01f;
  sp = fmaf(sp, z, 4.1269936976e01f);
  sp = fmaf(sp, z, -7.6594929804e01f);
  sp = fmaf(sp, z, 8.1597658022e01f);
  sp = fmaf(sp, z, -4.1341480362e01f);
  sp = fmaf(sp, z, 6.2831834664e00f);
  s = sp * x;
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

// Grid (n_tiles, n_rows, n_split), n_rows = n_fddot*n_fdot, TRIAL_TILE
// threads. Row y is (fddot y / n_fdot, fdot y % n_fdot). Writes the block's
// sums to dst[split][2][n_rows][n_tiles][NH][TRIAL_TILE] (C then S).
// EXT adds the optional fddot row (sixth_fdd = fdd/6 per fddot, may be
// null) and the optional per-event weights (w, may be null: 1.0).
template <int NH, bool EXT, bool POLY>
__global__ void __launch_bounds__(TRIAL_TILE)
z2_tile_kernel(const double* __restrict__ t, int n, double f0, double tdf, double df,
               const double* __restrict__ half_fd, int n_fdot,
               const double* __restrict__ sixth_fdd, const float* __restrict__ w,
               int n_tiles, int tile0, int per_split, float* __restrict__ dst) {
  __shared__ float2 s_pb[EVENT_CHUNK];              // (base, b) per staged event
  __shared__ float s_w[EXT ? EVENT_CHUNK : 1];      // w per staged event
  const int tile = blockIdx.x;
  const int row = blockIdx.y;
  const int split = blockIdx.z;
  const int j = threadIdx.x;

  const double f_tile = __dadd_rn(f0, __dmul_rn(static_cast<double>(tile0 + tile), tdf));
  const double hf = half_fd[row % n_fdot];
  const bool has_r = EXT && sixth_fdd != nullptr;
  const double sf = has_r ? sixth_fdd[row / n_fdot] : 0.0;
  const float jlo = static_cast<float>(j);

  float c_tot[NH], s_tot[NH];
#pragma unroll
  for (int k = 0; k < NH; ++k) {
    c_tot[k] = 0.0f;
    s_tot[k] = 0.0f;
  }

  // 64-bit: split * per_split + per_split can pass INT_MAX for n < INT_MAX
  const long long e_begin = static_cast<long long>(split) * per_split;
  const long long e_end = min(static_cast<long long>(n), e_begin + per_split);
  for (long long e0 = e_begin; e0 < e_end; e0 += EVENT_CHUNK) {
    const int cnt = static_cast<int>(min(static_cast<long long>(EVENT_CHUNK), e_end - e0));
    __syncthreads();  // the previous chunk has been consumed
    for (int e = j; e < cnt; e += TRIAL_TILE) {
      const double tv = t[e0 + e];
      const double tt = __dmul_rn(tv, tv);
      const float r = static_cast<float>(cfrac_d(__dmul_rn(f_tile, tv)));
      const float q = static_cast<float>(cfrac_d(__dmul_rn(hf, tt)));
      const float b = static_cast<float>(cfrac_d(__dmul_rn(df, tv)));
      float base = __fadd_rn(r, q);
      if (has_r) {
        base = __fadd_rn(base, static_cast<float>(cfrac_d(__dmul_rn(sf, __dmul_rn(tt, tv)))));
      }
      s_pb[e] = make_float2(base, b);
      if (EXT) s_w[e] = w != nullptr ? w[e0 + e] : 1.0f;
    }
    __syncthreads();

    float c_ch[NH], s_ch[NH];
#pragma unroll
    for (int k = 0; k < NH; ++k) {
      c_ch[k] = 0.0f;
      s_ch[k] = 0.0f;
    }
#pragma unroll 4
    for (int e = 0; e < cnt; ++e) {
      const float2 pb = s_pb[e];
      const float fr = cfrac_f(__fadd_rn(pb.x, __fmul_rn(jlo, pb.y)));
      float s1, c1;
      if (POLY) {
        sincos_poly(fr, s1, c1);
      } else {
        sincosf(__fmul_rn(TWO_PI_F, fr), &s1, &c1);
      }
      const float we = EXT ? s_w[e] : 1.0f;
      if (EXT) {
        c_ch[0] = fmaf(we, c1, c_ch[0]);
        s_ch[0] = fmaf(we, s1, s_ch[0]);
      } else {
        c_ch[0] += c1;
        s_ch[0] += s1;
      }
      const float two_c1 = 2.0f * c1;
      float ckm2 = 1.0f, skm2 = 0.0f, ckm1 = c1, skm1 = s1;
#pragma unroll
      for (int k = 1; k < NH; ++k) {
        const float ck = fmaf(two_c1, ckm1, -ckm2);
        const float sk = fmaf(two_c1, skm1, -skm2);
        if (EXT) {
          c_ch[k] = fmaf(we, ck, c_ch[k]);
          s_ch[k] = fmaf(we, sk, s_ch[k]);
        } else {
          c_ch[k] += ck;
          s_ch[k] += sk;
        }
        ckm2 = ckm1;
        skm2 = skm1;
        ckm1 = ck;
        skm1 = sk;
      }
    }
#pragma unroll
    for (int k = 0; k < NH; ++k) {
      c_tot[k] += c_ch[k];
      s_tot[k] += s_ch[k];
    }
  }

  const size_t plane = static_cast<size_t>(gridDim.y) * n_tiles * NH * TRIAL_TILE;
  const size_t off = ((static_cast<size_t>(row) * n_tiles + tile) * NH) * TRIAL_TILE + j;
  float* c_dst = dst + static_cast<size_t>(split) * 2 * plane + off;
  float* s_dst = c_dst + plane;
#pragma unroll
  for (int k = 0; k < NH; ++k) {
    c_dst[static_cast<size_t>(k) * TRIAL_TILE] = c_tot[k];
    s_dst[static_cast<size_t>(k) * TRIAL_TILE] = s_tot[k];
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
void launch_tiles(bool ext, bool poly, dim3 grid, cudaStream_t stream, const double* t, int n,
                  double f0, double tdf, double df, const double* half_fd, int n_fdot,
                  const double* sixth_fdd, const float* w, int n_tiles, int tile0, int per_split,
                  float* dst) {
  if (!ext) {
    z2_tile_kernel<NH, false, true><<<grid, TRIAL_TILE, 0, stream>>>(
        t, n, f0, tdf, df, half_fd, n_fdot, nullptr, nullptr, n_tiles, tile0, per_split, dst);
  } else if (poly) {
    z2_tile_kernel<NH, true, true><<<grid, TRIAL_TILE, 0, stream>>>(
        t, n, f0, tdf, df, half_fd, n_fdot, sixth_fdd, w, n_tiles, tile0, per_split, dst);
  } else {
    z2_tile_kernel<NH, true, false><<<grid, TRIAL_TILE, 0, stream>>>(
        t, n, f0, tdf, df, half_fd, n_fdot, sixth_fdd, w, n_tiles, tile0, per_split, dst);
  }
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
  const dim3 grid(n_tiles, static_cast<unsigned>(n_rows), n_split);
  float* dst = n_split > 1 ? partial : out;
  const bool ext = sixth_fdd != nullptr || w != nullptr || !poly;
  switch (nharm) {
#define Z2_CASE(NH)                                                                    \
  case NH:                                                                             \
    launch_tiles<NH>(ext, poly != 0, grid, s, t, n, f0, tdf, df, half_fd, n_fdot,      \
                     sixth_fdd, w, n_tiles, tile0, per_split, dst);                    \
    break;
    Z2_CASE(1) Z2_CASE(2) Z2_CASE(3) Z2_CASE(4) Z2_CASE(5)
    Z2_CASE(6) Z2_CASE(7) Z2_CASE(8) Z2_CASE(9) Z2_CASE(10)
    Z2_CASE(11) Z2_CASE(12) Z2_CASE(13) Z2_CASE(14) Z2_CASE(15)
    Z2_CASE(16) Z2_CASE(17) Z2_CASE(18) Z2_CASE(19) Z2_CASE(20)
#undef Z2_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  const size_t m = static_cast<size_t>(2) * n_rows * n_tiles * nharm * TRIAL_TILE;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((m + threads - 1) / threads);
  z2_reduce_splits<<<blocks, threads, 0, s>>>(partial, n_split, m, out);
  return static_cast<int>(cudaGetLastError());
}
