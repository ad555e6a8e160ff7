// n leapfrog steps of the spectral barotropic core in one cooperative
// launch, for Hopper (sm_90a).
//
// Replaces: dlwp_tpu/barotropic/pallas_step.py:123, _make_kernel (forms
// psi and vrt), called through _fused_call. Per step, with M = T+1 modes,
// J latitudes and L longitudes, on the real-pair state (vr, vi, pr, pi),
// each (M, M):
//   tendency, psi form: synthesise the modes of d(psi)/dx, d(zeta)/dx,
//     d(psi)/dy, d(zeta)/dy through Gm and Ha (per-m contractions over n),
//     inverse DFT to the transposed (L, J) grid, Jacobian
//     dpdx*dvdy - dpdy*dvdx, forward DFT, analysis through A (the minus and
//     the hemisphere sign correction are composed into A);
//   tendency, vrt form: the same with P, Hv, Gv, the Coriolis row f_row and
//     the curl analysis Au . fu - Av . fv_i, Au . fu_i + Av . fv_r;
//   damping: dz = (tend - damp * prev) * dden;
//   time step: leapfrog + Robert filter in the reference's interleave, or
//     forward Euler where step0 + i == 0.
// Everything is fp32 on CUDA cores: no tensor cores and no TF32 (the TPU
// kernel needed Precision.HIGHEST; bf16 passes grew to 0.23 relative error
// in 40 steps).
//
// Bound on an H100 SXM (67 TFLOP/s fp32, 3.35 TB/s): per step about
// 10*M*J*N multiply-adds of Legendre contractions (about half of them on
// structural zeros, n < m) plus 6-7 DFT products of L*2M*J multiply-adds:
// 19.4 MFLOP at T72 on 73x144 for either form counting only the n >= m
// pairs (about 23 MFLOP dense), 0.29 us a step. A launch reads 5-8 MB of
// tables (L2-resident after the first step) and 85 KB of state, about
// 2 us. A run of hundreds of steps is bound by operations; this first
// version is paced by its two grid-wide barriers a step and by the latency
// of its small per-block reductions, not by arithmetic.
//
// Design: one persistent cooperative launch with max(M, J) blocks (fewer
// if the card cannot hold that many at once; blocks then loop over rows).
// Per step:
//   phase A (block m): synthesise every mode row of wavenumber m into the
//     global scratch `syn` (fields, 2M, J);
//   grid sync;
//   phase B (block j): for latitude column j, the inverse DFT to all L
//     longitudes, the grid products, and the forward DFT back to the modes
//     of column j, into the global scratch `fwd` (fields, M, J); all in
//     shared memory, no sync between the three;
//   grid sync;
//   phase C (block m): analyse row m, damp and step it; the same block then
//     runs the next step's phase A on row m, so a step needs two grid syncs.
// The state lives in the output buffers; each row is read and written only
// by the block that owns it. Every contraction puts one warp on one output
// with the lanes along the contracted axis (coalesced reads of the tables,
// which stay in global memory, i.e. L2) and a shuffle reduction: no
// atomics, so a launch is deterministic and run(run(s, 7), 13) equals
// run(s, 20) bit for bit. The DFT matrices are read as composed on the host
// (dinv, dfwd_re, dfwd_im), not rebuilt from a cos/sin table.
// Cross-block scratch is read with __ldcg (L2, not the SM's L1) after each
// grid sync.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPsi = 0;
constexpr int kVrt = 1;

struct Params {
  const float* in[4];   // vr, vi, pr, pi (M, M)
  float* out[4];        // the state across steps, then the result
  float* syn;           // (SYN, 2M, J) synthesised mode rows
  float* fwd;           // (FWD, M, J) forward-DFT outputs
  const float* dinv;    // (L, 2M)
  const float* dfwd_re; // (M, L)
  const float* dfwd_im; // (M, L)
  const float* damp;    // (M, M)
  const float* dden;    // (M, M)
  // psi: Gm (M,J,M), Ha (M,J,M), A (M,M,J), invF (M,M)
  // vrt: P, Hv, Gv (M,J,M), Au, Av (M,M,J), f_row (J)
  const float* tab[6];
  int M, J, L, step0, n_steps;
  float dt, r;
};

template <int K>
__device__ __forceinline__ void warp_sum(float (&v)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }
__device__ __forceinline__ int warp_id() { return threadIdx.x >> 5; }

// Phase A: mode rows of wavenumber m into syn[(f*2M + k)*J + j], k < M the
// real parts and k >= M the imaginary parts.
template <int FORM>
__device__ void synthesise(const Params& p, int m, float* sh) {
  const int M = p.M, N = p.M, J = p.J;
  const float* vr = p.out[0] + m * N;
  const float* vi = p.out[1] + m * N;
  // psi: x = [psr, psi, vr, vi]; vrt: x = [vr, vi].
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    if (FORM == kPsi) {
      const float f = p.tab[3][m * N + n];
      sh[n] = vr[n] * f;
      sh[N + n] = vi[n] * f;
      sh[2 * N + n] = vr[n];
      sh[3 * N + n] = vi[n];
    } else {
      sh[n] = vr[n];
      sh[N + n] = vi[n];
    }
  }
  __syncthreads();
  const int lane = lane_id();
  auto put = [&](int f, float re, float im, int j) {
    p.syn[(f * 2 * M + m) * J + j] = re;
    p.syn[(f * 2 * M + M + m) * J + j] = im;
  };
  for (int j = warp_id(); j < J; j += kWarps) {
    const size_t row = ((size_t)m * J + j) * N;
    if (FORM == kPsi) {
      const float* gm = p.tab[0] + row;
      const float* ha = p.tab[1] + row;
      float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int n = lane; n < N; n += 32) {
        const float g = gm[n], h = ha[n];
        const float psr = sh[n], psi = sh[N + n];
        const float xr = sh[2 * N + n], xi = sh[3 * N + n];
        a[0] += g * psi;
        a[1] += g * psr;
        a[2] += g * xi;
        a[3] += g * xr;
        a[4] += h * psr;
        a[5] += h * psi;
        a[6] += h * xr;
        a[7] += h * xi;
      }
      warp_sum(a);
      if (lane == 0) {
        put(0, -a[0], a[1], j);  // dpsi/dx = i * Gm-syn(psi)
        put(1, -a[2], a[3], j);  // dzeta/dx
        put(2, a[4], a[5], j);   // dpsi/dy = Ha-syn(psi)
        put(3, a[6], a[7], j);   // dzeta/dy
      }
    } else {
      const float* pp = p.tab[0] + row;
      const float* hv = p.tab[1] + row;
      const float* gv = p.tab[2] + row;
      float a[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int n = lane; n < N; n += 32) {
        const float xr = sh[n], xi = sh[N + n];
        const float q = pp[n], h = hv[n], g = gv[n];
        a[0] += q * xr;
        a[1] += q * xi;
        a[2] += h * xr;
        a[3] += h * xi;
        a[4] += g * xi;
        a[5] += g * xr;
      }
      warp_sum(a);
      if (lane == 0) {
        put(0, a[0], a[1], j);    // vorticity
        put(1, -a[2], -a[3], j);  // u
        put(2, -a[4], a[5], j);   // v = i * Gv-syn
      }
    }
  }
  __syncthreads();
}

// Phase B: column j through the inverse DFT, the grid products and the
// forward DFT, into fwd[(q*M + m)*J + j].
template <int FORM>
__device__ void column(const Params& p, int j, float* sh) {
  constexpr int NF = FORM == kPsi ? 4 : 3;  // synthesised fields
  constexpr int NP = FORM == kPsi ? 1 : 2;  // grid products
  const int M = p.M, J = p.J, L = p.L, K = 2 * p.M;
  float* modes = sh;          // (NF, 2M)
  float* prod = sh + NF * K;  // (NP, L)
  for (int i = threadIdx.x; i < NF * K; i += blockDim.x)
    modes[i] = __ldcg(p.syn + (size_t)i * J + j);
  __syncthreads();
  const int lane = lane_id();
  for (int l = warp_id(); l < L; l += kWarps) {
    const float* d = p.dinv + (size_t)l * K;
    float g[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) g[f] = 0.f;
    for (int k = lane; k < K; k += 32) {
      const float dk = d[k];
#pragma unroll
      for (int f = 0; f < NF; ++f) g[f] += dk * modes[f * K + k];
    }
    warp_sum(g);
    if (lane == 0) {
      if (FORM == kPsi) {
        prod[l] = g[0] * g[3] - g[2] * g[1];  // Jacobian
      } else {
        const float av = p.tab[5][j] + g[0];  // absolute vorticity
        prod[l] = -av * g[2];                 // d(u)/dt = -(f + zeta) v
        prod[L + l] = av * g[1];              // d(v)/dt = (f + zeta) u
      }
    }
  }
  __syncthreads();
  for (int m = warp_id(); m < M; m += kWarps) {
    const float* fr = p.dfwd_re + (size_t)m * L;
    const float* fi = p.dfwd_im + (size_t)m * L;
    float s[2 * NP];
#pragma unroll
    for (int q = 0; q < 2 * NP; ++q) s[q] = 0.f;
    for (int l = lane; l < L; l += 32) {
      const float cr = fr[l], ci = fi[l];
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        s[2 * q] += cr * prod[q * L + l];
        s[2 * q + 1] += ci * prod[q * L + l];
      }
    }
    warp_sum(s);
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < 2 * NP; ++q) p.fwd[((size_t)q * M + m) * J + j] = s[q];
    }
  }
  __syncthreads();
}

// Phase C: analyse row m, damp it and take the time step.
template <int FORM>
__device__ void analyse_and_step(const Params& p, int m, bool first,
                                 float* sh) {
  constexpr int NQ = FORM == kPsi ? 2 : 4;
  const int M = p.M, N = p.M, J = p.J;
  for (int i = threadIdx.x; i < NQ * J; i += blockDim.x) {
    const int q = i / J, j = i - q * J;
    sh[i] = __ldcg(p.fwd + ((size_t)q * M + m) * J + j);
  }
  __syncthreads();
  const int lane = lane_id();
  for (int n = warp_id(); n < N; n += kWarps) {
    const size_t row = ((size_t)m * N + n) * J;
    float tr, ti;
    if (FORM == kPsi) {
      const float* a = p.tab[2] + row;
      float s[2] = {0.f, 0.f};
      for (int j = lane; j < J; j += 32) {
        s[0] += a[j] * sh[j];
        s[1] += a[j] * sh[J + j];
      }
      warp_sum(s);
      tr = s[0];
      ti = s[1];
    } else {
      // sh rows: fu_r, fu_i, fv_r, fv_i.
      const float* au = p.tab[3] + row;
      const float* av = p.tab[4] + row;
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      for (int j = lane; j < J; j += 32) {
        s[0] += au[j] * sh[j];
        s[1] += av[j] * sh[3 * J + j];
        s[2] += au[j] * sh[J + j];
        s[3] += av[j] * sh[2 * J + j];
      }
      warp_sum(s);
      tr = s[0] - s[1];
      ti = s[2] + s[3];
    }
    if (lane == 0) {
      const int i = m * N + n;
      const float vr = p.out[0][i], vi = p.out[1][i];
      const float pr = p.out[2][i], pi = p.out[3][i];
      const float damp = p.damp[i], dden = p.dden[i];
      // Implicit hyperdiffusion against the lagged state.
      const float dzr = (tr - damp * pr) * dden;
      const float dzi = (ti - damp * pi) * dden;
      const float r = p.r;
      if (first) {
        const float nr = vr + p.dt * dzr, ni = vi + p.dt * dzi;
        p.out[0][i] = nr;
        p.out[1][i] = ni;
        p.out[2][i] = vr + r * (nr - vr);
        p.out[3][i] = vi + r * (ni - vi);
      } else {
        const float two_dt = 2.f * p.dt;
        const float nr = pr + two_dt * dzr, ni = pi + two_dt * dzi;
        p.out[0][i] = nr;
        p.out[1][i] = ni;
        p.out[2][i] = vr + r * (pr - 2.f * vr) + r * nr;
        p.out[3][i] = vi + r * (pi - 2.f * vi) + r * ni;
      }
    }
  }
  __syncthreads();
}

template <int FORM>
__global__ void __launch_bounds__(kThreads)
barotropic_kernel(Params p) {
  extern __shared__ float sh[];
  cg::grid_group grid = cg::this_grid();
  const int M = p.M;
  for (int m = blockIdx.x; m < M; m += gridDim.x)
    for (int n = threadIdx.x; n < M; n += blockDim.x)
#pragma unroll
      for (int c = 0; c < 4; ++c) p.out[c][m * M + n] = p.in[c][m * M + n];
  __syncthreads();
  if (p.n_steps == 0) return;
  for (int m = blockIdx.x; m < M; m += gridDim.x) synthesise<FORM>(p, m, sh);
  for (int i = 0; i < p.n_steps; ++i) {
    grid.sync();
    for (int j = blockIdx.x; j < p.J; j += gridDim.x) column<FORM>(p, j, sh);
    grid.sync();
    const bool first = p.step0 + i == 0;
    for (int m = blockIdx.x; m < M; m += gridDim.x) {
      analyse_and_step<FORM>(p, m, first, sh);
      if (i + 1 < p.n_steps) synthesise<FORM>(p, m, sh);
    }
  }
}

size_t shared_bytes(int form, int M, int J, int L) {
  const size_t a = (size_t)4 * M;
  const size_t b = form == kPsi ? (size_t)4 * 2 * M + L
                                : (size_t)3 * 2 * M + 2 * (size_t)L;
  const size_t c = (size_t)(form == kPsi ? 2 : 4) * J;
  size_t most = a > b ? a : b;
  most = most > c ? most : c;
  return most * sizeof(float);
}

}  // namespace

// ptrs: vr, vi, pr, pi (in); vr, vi, pr, pi (out); syn; fwd; dinv,
// dfwd_re, dfwd_im, damp, dden; then the form's tables (psi: Gm, Ha, A,
// invF; vrt: P, Hv, Gv, Au, Av, f_row). Launches on `stream`, writes the
// grid size to *blocks_out and returns the CUDA error (0 = ok).
extern "C" int dlwp_barotropic_step(int form, void* const* ptrs, int M,
                                    int J, int L, int step0, int n_steps,
                                    float dt, float r, int* blocks_out,
                                    void* stream) {
  Params p;
  for (int c = 0; c < 4; ++c) {
    p.in[c] = static_cast<const float*>(ptrs[c]);
    p.out[c] = static_cast<float*>(ptrs[4 + c]);
  }
  p.syn = static_cast<float*>(ptrs[8]);
  p.fwd = static_cast<float*>(ptrs[9]);
  p.dinv = static_cast<const float*>(ptrs[10]);
  p.dfwd_re = static_cast<const float*>(ptrs[11]);
  p.dfwd_im = static_cast<const float*>(ptrs[12]);
  p.damp = static_cast<const float*>(ptrs[13]);
  p.dden = static_cast<const float*>(ptrs[14]);
  const int n_tab = form == kPsi ? 4 : 6;
  for (int t = 0; t < 6; ++t)
    p.tab[t] = t < n_tab ? static_cast<const float*>(ptrs[15 + t]) : nullptr;
  p.M = M;
  p.J = J;
  p.L = L;
  p.step0 = step0;
  p.n_steps = n_steps;
  p.dt = dt;
  p.r = r;

  const void* fn = form == kPsi ? (const void*)barotropic_kernel<kPsi>
                                : (const void*)barotropic_kernel<kVrt>;
  const size_t smem = shared_bytes(form, M, J, L);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  // Every block of a cooperative launch must be resident at once.
  const int want = M > J ? M : J;
  const int fit = per_sm * sms;
  if (fit < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int blocks = want < fit ? want : fit;
  *blocks_out = blocks;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kThreads), args,
                                    smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
