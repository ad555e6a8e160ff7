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
// Bound on an H100 SXM (67 TFLOP/s fp32, 3.35 TB/s): 19.4 MFLOP a step at
// T72 on 73x144 for either form, counting the Legendre contractions over
// n >= m only and the DFTs as dense products, 0.29 us a step; a launch
// reads 5-8 MB of tables, about 2 us. A run of hundreds of steps is bound
// by operations. On an NVIDIA H100 80GB HBM3 at 700 W, a first version
// that re-read every table from L2 each step (~17-20 MB) and reduced each
// output across a warp took 20.4 us a step, of which its two grid syncs
// (the sync probe below) took 2.2 us; this one takes 7.0 (psi) and 7.5
// (vrt) us, the same 2.2 us of syncs included, and is bound by shared
// memory's bandwidth in every phase (chip_smoke.py, time_barotropic).
//
// Design: one persistent cooperative launch of max(P, J) blocks, P =
// ceil(M/2) row pairs (one block an SM, every block resident).
//   Block b < P owns the wavenumbers m1 = b and m2 = M-1-b (the middle row
//   of odd M alone). Their n >= m entries number M+1 whatever b, so every
//   pair does the same work, and its slices of the Legendre tables
//   (kernels/barotropic_step.py pack_tables: NT slabs of (M+1) x J) are
//   copied into shared memory once per launch by 16-byte cp.async and never
//   read from L2 again. Its rows of the state stay in shared memory across
//   steps. Block P + b, where the grid has one, helps pair b: it holds the
//   same tables and state and runs phase C alike, and takes half of phase
//   A's latitudes.
// Per step:
//   phase A (pair blocks): synthesise the pair's mode rows into the global
//     exchange buffer `syn` (J, M, 2 NF), each output summed over n >= m
//     in kSplit chunks, with irfft's weights of its mode applied;
//   grid sync;
//   phase B (block j, every block): column j through the inverse DFT, the
//     grid products and the forward DFT into `fwd` (M, J, 2 NP), all in
//     shared memory. The DFTs read a matrix of (cos, sin)(2 pi m l / L)
//     that each block builds at launch from one twiddle table, indexed at
//     (m l) mod L, and pair l with L - l, whose twiddles are equal (cos) or
//     opposite (sin), which halves both DFTs;
//   grid sync;
//   phase C (pair blocks): analyse the pair's rows (n >= m; the tendency of
//     n < m is 0, as the tables are), damp and step them; the same block
//     then runs the next step's phase A.
// Every output is owned by one thread and summed in a fixed order: each
// contraction is kSplit partial sums over consecutive chunks, added in
// chunk order. No atomics and no shuffles, so a launch is deterministic and
// run(run(s, 7), 13) equals run(s, 20) bit for bit. The exchange buffers
// are read with __ldcg (L2, not the SM's L1) after each grid sync. The
// partial sums are stored column-major (store_cols): a warp's accesses
// fall in distinct banks, as shared memory's bandwidth, not the FMAs,
// bounds every phase.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstring>

#include "tf32_mma.cuh"  // cp_async16, cp_async_commit, cp_async_wait

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kSplit = 6;    // chunks of a contraction summed in order
constexpr int kStamps = 12;  // stage clocks a step (stamp())
constexpr int kPsi = 0;
constexpr int kVrt = 1;

// NS synthesis and NA analysis tables; NF synthesised fields and NP grid
// products (complex); NQ analysis sums an output; NX floats of a packed
// state entry (psi: psr, psi, vr, vi; vrt: vr, vi).
template <int FORM>
struct Form;
template <>
struct Form<kPsi> {
  static constexpr int NS = 2, NA = 1, NF = 4, NP = 1, NQ = 2, NX = 4;
};
template <>
struct Form<kVrt> {
  static constexpr int NS = 3, NA = 2, NF = 3, NP = 2, NQ = 4, NX = 2;
};

// Offsets (floats) of the shared-memory regions and their total bytes, in
// the order of the `lay` array of the C entry points. The wrapper
// (kernels/barotropic_step.py, layout()) is their only owner; the entry
// points check only what the indexing below needs of them (check_layout).
//   tab   (NS + NA) slabs of `slab` floats: the pair's packed tables;
//   twm   (M, nlp) float2: (cos, sin)(2 pi m l / L), l < L/2 + 1;
//   wts   (2, M): irfft's weights;  st (2 M, 4): the pair's state rows;
//   rowc  damp, dden (and psi's invF) of the pair's rows;
//   frow  vrt's f_row (J);  xs (M + 1, 4): x of the pair's entries;
//   work  each phase's operands and partial sums, up to `bytes`.
struct Layout {
  int slab, nlp, tab, twm, wts, st, rowc, frow, xs, work, bytes;
};
constexpr int kLayoutFields = 11;

struct Params {
  const float* in[4];  // vr, vi, pr, pi (M, M)
  float* out[4];       // the result
  float* syn;          // (J, M, 2 NF) synthesised modes, weighted
  float* fwd;          // (M, J, 2 NP) forward-DFT outputs
  const float* tab;    // (P, NS + NA, slab) packed Legendre tables
  const float* tw;     // (L, 4): cos, sin, cos/L, -sin/L of 2 pi k/L
  const float* wts;    // (2, M): irfft's weights of re and im parts
  const float* damp;   // (M, M)
  const float* dden;   // (M, M)
  const float* extra;  // psi: invF (M, M); vrt: f_row (J)
  int M, J, L, step0, n_steps;
  float dt, r;
  long long* clocks;  // null, or (n_steps, kStamps) stage clocks of block 0
  Layout y;           // shared memory
};

__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

// Stage clocks: thread 0 of block 0 stamps clock64() at the end of each
// stage of a step into clk[k] (clk is null but in the timing build).
template <bool ON>
__device__ __forceinline__ void stamp(long long* clk, int k) {
  if constexpr (ON)
    if (clk != nullptr && threadIdx.x == 0) clk[k] = clock64();
}

// The 2 NF floats of a mode row (re, im of each field), from shared memory
// in vector loads: psi 2 x 16 bytes, vrt 3 x 8 bytes.
template <int FORM>
__device__ __forceinline__ void load_row(const float* src, float* v) {
  if constexpr (FORM == kPsi) {
    const float4 a = reinterpret_cast<const float4*>(src)[0];
    const float4 b = reinterpret_cast<const float4*>(src)[1];
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float2 a = reinterpret_cast<const float2*>(src)[i];
      v[2 * i] = a.x, v[2 * i + 1] = a.y;
    }
  }
}

template <int FORM>
__device__ __forceinline__ void store_row(float* dst, const float* v) {
  if constexpr (FORM == kPsi) {
    reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int i = 0; i < 3; ++i)
      reinterpret_cast<float2*>(dst)[i] = make_float2(v[2 * i], v[2 * i + 1]);
  }
}

// Partial sums are stored column-major, element x of a thread's partial at
// base[x stride] with consecutive threads at consecutive base: a warp's
// accesses then fall in distinct banks.
template <int N>
__device__ __forceinline__ void store_cols(float* base, int stride,
                                           const float* v) {
#pragma unroll
  for (int x = 0; x < N; ++x) base[x * stride] = v[x];
}

template <int N>
__device__ __forceinline__ void add_cols(const float* base, int stride,
                                         float* v) {
#pragma unroll
  for (int x = 0; x < N; ++x) v[x] += base[x * stride];
}

// x of state entry i, the pair's entry k: psi (vr invF, vi invF, vr, vi),
// vrt (vr, vi); what phase A reads.
template <int FORM>
__device__ __forceinline__ void put_x(float* sh, const Layout& y, int M,
                                      int i, int k, float vr, float vi) {
  if constexpr (FORM == kPsi) {
    const float f = sh[y.rowc + 4 * M + i];
    reinterpret_cast<float4*>(sh + y.xs)[k] =
        make_float4(vr * f, vi * f, vr, vi);
  } else {
    reinterpret_cast<float2*>(sh + y.xs)[k] = make_float2(vr, vi);
  }
}

// Phase A: the pair's mode rows at latitudes ja <= j < jb into
// syn[(j M + m) 2NF + 2f + (re, im)]. A thread takes one latitude, every
// synthesis table (so each entry's x is read once for NS outputs) and
// chunk s of kSplit of the pair's entries; output (j, row) sums its chunks
// in order.
template <int FORM, bool CLK>
__device__ void synthesise(const Params& p, const Layout& y, float* sh,
                           int m1, int m2, int ja, int jb, long long* clk) {
  using F = Form<FORM>;
  constexpr int TX = F::NS * F::NX;  // floats of a (j, row) partial
  const int M = p.M, J = p.J, K1 = M + 1, c1 = M - m1, nj = jb - ja;
  const int nrow = m2 != m1 ? 2 : 1, kend = nrow == 2 ? K1 : c1;
  const int ch = (kend + kSplit - 1) / kSplit;
  const float* xs = sh + y.xs;  // written by put_x()
  float* pa = sh + y.work;  // (kSplit, NS NX, 2 rows, J) partial sums
  for (int task = threadIdx.x; task < kSplit * nj; task += kThreads) {
    const int s = task / nj, j = ja + task - s * nj;
    const int ka = s * ch, kb = min(kend, ka + ch);
    for (int r = 0; r < 2; ++r) {
      float a[TX];
#pragma unroll
      for (int x = 0; x < TX; ++x) a[x] = 0.f;
      const int k0 = r ? max(ka, c1) : ka, k1 = r ? kb : min(kb, c1);
      const float* T = sh + y.tab + k0 * J + j;  // table t at T[t slab]
      for (int k = k0; k < k1; ++k, T += J) {
        float x[F::NX];
        if constexpr (FORM == kPsi) {
          const float4 v = reinterpret_cast<const float4*>(xs)[k];
          x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
        } else {
          const float2 v = reinterpret_cast<const float2*>(xs)[k];
          x[0] = v.x, x[1] = v.y;
        }
#pragma unroll
        for (int t = 0; t < F::NS; ++t) {
          const float g = T[t * y.slab];
#pragma unroll
          for (int c = 0; c < F::NX; ++c) a[t * F::NX + c] += g * x[c];
        }
      }
      store_cols<TX>(pa + (s * TX * 2 + r) * J + j, 2 * J, a);
    }
  }
  __syncthreads();
  stamp<CLK>(clk, 10);
  const float* wre = sh + y.wts;
  const float* wim = wre + M;
  for (int task = threadIdx.x; task < nrow * nj; task += kThreads) {
    const int r = task / nj, j = ja + task - r * nj, m = r ? m2 : m1;
    float a[TX] = {};
    for (int s = 0; s < kSplit; ++s)
      add_cols<TX>(pa + (s * TX * 2 + r) * J + j, 2 * J, a);
    const float wr = wre[m], wi = wim[m];
    float v[2 * F::NF];
    if constexpr (FORM == kPsi) {
      // a: Gm . (psr, psi, vr, vi), then Ha . the same. dpsi/dx = i
      // Gm-syn(psi), dzeta/dx = i Gm-syn(zeta), dpsi/dy and dzeta/dy =
      // Ha-syn.
      const float o[8] = {-a[1], a[0], -a[3], a[2], a[4], a[5], a[6], a[7]};
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = o[i] * (i % 2 ? wi : wr);
    } else {
      // a: P, Hv, Gv . (vr, vi). vorticity = P-syn, u = -Hv-syn, v = i
      // Gv-syn.
      const float o[6] = {a[0], a[1], -a[2], -a[3], -a[5], a[4]};
#pragma unroll
      for (int i = 0; i < 6; ++i) v[i] = o[i] * (i % 2 ? wi : wr);
    }
    store_row<FORM>(p.syn + ((size_t)j * M + m) * (2 * F::NF), v);
  }
  if constexpr (CLK) {
    __syncthreads();
    stamp<CLK>(clk, 11);
  }
}

// Phase B: column j through the inverse DFT, the grid products and the
// forward DFT, into fwd[(m J + j) 2NP + 2q + (re, im)]. The twiddles come
// from the block's matrix twm[m nlp + l] = (cos, sin)(2 pi m l / L), which
// a warp reads in consecutive entries (inverse: l) or with an odd stride
// (forward: m): both without bank conflicts.
template <int FORM, bool CLK>
__device__ void column(const Params& p, const Layout& y, float* sh, int j,
                       float inv_l, long long* clk) {
  using F = Form<FORM>;
  constexpr int W = 2 * F::NF;  // floats of a mode row
  const int M = p.M, J = p.J, L = p.L, nl = L / 2 + 1, nlp = y.nlp;
  float* md = sh + y.work;                   // (M, W)
  float* pb = md + round4(W * M);            // (kSplit, W, nl)
  float* pf = pb + round4(kSplit * nl * W);  // (NP, nl, sum|diff)
  float* pc = pf + round4(F::NP * nl * 2);   // (kSplit, 2NP, M)
  const float2* twm = reinterpret_cast<const float2*>(sh + y.twm);
  const float2* src =
      reinterpret_cast<const float2*>(p.syn + (size_t)j * M * W);
  for (int i = threadIdx.x; i < M * W / 2; i += kThreads)
    reinterpret_cast<float2*>(md)[i] = __ldcg(src + i);
  __syncthreads();
  stamp<CLK>(clk, 1);
  // Inverse DFT, chunk s of the modes, at longitudes l0 = g and l1 = g +
  // ceil(nl/2): C = sum re' cos, S = sum im' sin; the grid is C + S at l
  // and C - S at L - l.
  const int G2 = (nl + 1) / 2, chm = (M + kSplit - 1) / kSplit;
  for (int task = threadIdx.x; task < kSplit * G2; task += kThreads) {
    const int s = task / G2, l0 = task - s * G2, l1 = l0 + G2;
    const int l1c = l1 < nl ? l1 : nl - 1;  // a valid address, unused
    const int ma = s * chm, mb = min(M, ma + chm);
    float c0[W], c1[W];  // (C, S) of each field at l0 and l1
#pragma unroll
    for (int i = 0; i < W; ++i) c0[i] = c1[i] = 0.f;
    for (int m = ma; m < mb; ++m) {
      const float2 t0 = twm[m * nlp + l0], t1 = twm[m * nlp + l1c];
      float v[W];
      load_row<FORM>(md + m * W, v);
#pragma unroll
      for (int f = 0; f < F::NF; ++f) {
        c0[2 * f] += v[2 * f] * t0.x;
        c0[2 * f + 1] += v[2 * f + 1] * t0.y;
        c1[2 * f] += v[2 * f] * t1.x;
        c1[2 * f + 1] += v[2 * f + 1] * t1.y;
      }
    }
    store_cols<W>(pb + s * W * nl + l0, nl, c0);
    if (l1 < nl) store_cols<W>(pb + s * W * nl + l1, nl, c1);
  }
  __syncthreads();
  stamp<CLK>(clk, 2);
  // Sum the chunks, form the grid values at l and L - l, their products,
  // and the sums and differences the forward DFT pairs.
  for (int l = threadIdx.x; l < nl; l += kThreads) {
    float cs[W] = {};
    for (int s = 0; s < kSplit; ++s)
      add_cols<W>(pb + s * W * nl + l, nl, cs);
    float a[F::NF], c[F::NF];  // the grid at l and at L - l
#pragma unroll
    for (int f = 0; f < F::NF; ++f) {
      a[f] = cs[2 * f] + cs[2 * f + 1];
      c[f] = cs[2 * f] - cs[2 * f + 1];
    }
    const bool paired = l > 0 && 2 * l != L;
    float pa[F::NP], pl[F::NP];
    if constexpr (FORM == kPsi) {  // Jacobian dpdx dvdy - dpdy dvdx
      pa[0] = a[0] * a[3] - a[2] * a[1];
      pl[0] = c[0] * c[3] - c[2] * c[1];
    } else {  // d(u)/dt = -(f + zeta) v, d(v)/dt = (f + zeta) u
      const float f0 = sh[y.frow + j];
      const float va = f0 + a[0], vc = f0 + c[0];
      pa[0] = -va * a[2];
      pa[1] = va * a[1];
      pl[0] = -vc * c[2];
      pl[1] = vc * c[1];
    }
#pragma unroll
    for (int q = 0; q < F::NP; ++q)
      reinterpret_cast<float2*>(pf)[q * nl + l] =
          paired ? make_float2(pa[q] + pl[q], pa[q] - pl[q])
                 : make_float2(pa[q], pa[q]);
  }
  __syncthreads();
  stamp<CLK>(clk, 3);
  // Forward DFT, chunk s of the longitude pairs: R = sum cos (p(l) +
  // p(L-l)), I = sum sin (p(l) - p(L-l)); then / L and -/ L.
  const int chl = (nl + kSplit - 1) / kSplit;
  for (int task = threadIdx.x; task < kSplit * M; task += kThreads) {
    const int s = task / M, m = task - s * M;
    const int la = s * chl, lb = min(nl, la + chl);
    float R[F::NP], I[F::NP];
#pragma unroll
    for (int q = 0; q < F::NP; ++q) R[q] = I[q] = 0.f;
    for (int l = la; l < lb; ++l) {
      const float2 t = twm[m * nlp + l];
#pragma unroll
      for (int q = 0; q < F::NP; ++q) {
        const float2 v = reinterpret_cast<const float2*>(pf)[q * nl + l];
        R[q] += t.x * v.x;
        I[q] += t.y * v.y;
      }
    }
#pragma unroll
    for (int q = 0; q < F::NP; ++q) {
      pc[(s * 2 * F::NP + 2 * q) * M + m] = R[q];
      pc[(s * 2 * F::NP + 2 * q + 1) * M + m] = I[q];
    }
  }
  __syncthreads();
  stamp<CLK>(clk, 4);
  for (int m = threadIdx.x; m < M; m += kThreads) {
    float v[2 * F::NP] = {};
    for (int s = 0; s < kSplit; ++s)
      add_cols<2 * F::NP>(pc + s * 2 * F::NP * M + m, M, v);
    float2* o = reinterpret_cast<float2*>(p.fwd + ((size_t)m * J + j) * 2 *
                                                      F::NP);
#pragma unroll
    for (int q = 0; q < F::NP; ++q)
      o[q] = make_float2(v[2 * q] * inv_l, -v[2 * q + 1] * inv_l);
  }
  __syncthreads();  // md and pb are the next column's
  stamp<CLK>(clk, 5);
}

// Phase C: analyse the pair's rows, damp them and take the time step.
template <int FORM, bool CLK>
__device__ void analyse_and_step(const Params& p, const Layout& y, float* sh,
                                 int m1, int m2, bool first, long long* clk) {
  using F = Form<FORM>;
  constexpr int Q = 2 * F::NP;  // floats of fwd a (m, j)
  const int M = p.M, J = p.J, K1 = M + 1, c1 = M - m1;
  const int nrow = m2 != m1 ? 2 : 1, kend = m2 != m1 ? K1 : c1;
  float* fc = sh + y.work;            // (rows, J, Q)
  float* pc = fc + round4(2 * J * Q);  // (kSplit, NQ, kend)
  // One vector load a (row, j), all issued at once: one L2 round trip.
  for (int i = threadIdx.x; i < nrow * J; i += kThreads) {
    const float* src = p.fwd + ((size_t)(i < J ? m1 : m2) * J + i % J) * Q;
    if constexpr (FORM == kPsi)
      reinterpret_cast<float2*>(fc)[i] =
          __ldcg(reinterpret_cast<const float2*>(src));
    else
      reinterpret_cast<float4*>(fc)[i] =
          __ldcg(reinterpret_cast<const float4*>(src));
  }
  __syncthreads();
  stamp<CLK>(clk, 7);
  const float* ana = sh + y.tab + F::NS * y.slab;  // [j K1 + k]
  const int chj = (J + kSplit - 1) / kSplit;
  for (int task = threadIdx.x; task < kSplit * kend; task += kThreads) {
    const int s = task / kend, k = task - s * kend;
    const float* f = fc + (k < c1 ? 0 : J * Q);
    const int ja = s * chj, jb = min(J, ja + chj);
    float acc[F::NQ];
#pragma unroll
    for (int i = 0; i < F::NQ; ++i) acc[i] = 0.f;
    for (int j = ja; j < jb; ++j) {
      if constexpr (FORM == kPsi) {
        const float a = ana[j * K1 + k];
        const float2 v = reinterpret_cast<const float2*>(f)[j];
        acc[0] += a * v.x;
        acc[1] += a * v.y;
      } else {  // f rows: fu_r, fu_i, fv_r, fv_i
        const float au = ana[j * K1 + k], av = ana[y.slab + j * K1 + k];
        const float4 v = reinterpret_cast<const float4*>(f)[j];
        acc[0] += au * v.x;
        acc[1] += av * v.w;
        acc[2] += au * v.y;
        acc[3] += av * v.z;
      }
    }
    store_cols<F::NQ>(pc + s * F::NQ * kend + k, kend, acc);
  }
  __syncthreads();
  stamp<CLK>(clk, 8);
  float* st = sh + y.st;
  const float* damp = sh + y.rowc;
  const float* dden = damp + 2 * M;
  for (int i = threadIdx.x; i < nrow * M; i += kThreads) {
    const int r = i / M, n = i - r * M, m = r ? m2 : m1;
    float tr = 0.f, ti = 0.f;  // the tables are zero for n < m
    if (n >= m) {
      const int k = r ? c1 + n - m2 : n - m1;
      float v[F::NQ] = {};
      for (int s = 0; s < kSplit; ++s)
        add_cols<F::NQ>(pc + s * F::NQ * kend + k, kend, v);
      if constexpr (FORM == kPsi) {
        tr = v[0];
        ti = v[1];
      } else {
        tr = v[0] - v[1];
        ti = v[2] + v[3];
      }
    }
    float4 x = reinterpret_cast<float4*>(st)[i];  // vr, vi, pr, pi
    // Implicit hyperdiffusion against the lagged state.
    const float dzr = (tr - damp[i] * x.z) * dden[i];
    const float dzi = (ti - damp[i] * x.w) * dden[i];
    const float rr = p.r;
    if (first) {
      const float nr = x.x + p.dt * dzr, ni = x.y + p.dt * dzi;
      x = make_float4(nr, ni, x.x + rr * (nr - x.x), x.y + rr * (ni - x.y));
    } else {
      const float two_dt = 2.f * p.dt;
      const float nr = x.z + two_dt * dzr, ni = x.w + two_dt * dzi;
      x = make_float4(nr, ni, x.x + rr * (x.z - 2.f * x.x) + rr * nr,
                      x.y + rr * (x.w - 2.f * x.y) + rr * ni);
    }
    reinterpret_cast<float4*>(st)[i] = x;
    if (n >= m)
      put_x<FORM>(sh, y, M, i, r ? c1 + n - m2 : n - m1, x.x, x.y);
  }
  __syncthreads();
  stamp<CLK>(clk, 9);
}

template <int FORM, bool CLK>
__global__ void __launch_bounds__(kThreads, 1)
barotropic_kernel(Params p) {
  using F = Form<FORM>;
  extern __shared__ __align__(16) float sh[];
  cg::grid_group grid = cg::this_grid();
  const int M = p.M, L = p.L;
  const Layout& y = p.y;
  // Block b < P owns pair b; block P + b, where the grid has it, helps a
  // pair of two rows: both hold the pair's tables and state and run phase
  // C alike (the same sums, so the same state), and phase A splits the
  // latitudes between them. Only the owner writes the result.
  const int b = blockIdx.x, P = (M + 1) / 2;
  const bool owner = b < P;
  const int m1 = owner ? b : b - P, m2 = M - 1 - m1;
  const int nrow = m2 != m1 ? 2 : 1;
  const bool pair = owner || (b < 2 * P && nrow == 2);
  const bool helped = nrow == 2 && m1 + P < (int)gridDim.x;
  const int jh = (p.J + 1) / 2;
  const int ja = owner ? 0 : jh, jb = owner && helped ? jh : p.J;
  if (pair) {
    const int n = (F::NS + F::NA) * y.slab;
    const float* src = p.tab + (size_t)m1 * n;
    for (int i = 4 * threadIdx.x; i < n; i += 4 * kThreads)
      cp_async16(sh + y.tab + i, src + i);
    cp_async_commit();
    for (int i = threadIdx.x; i < nrow * M; i += kThreads) {
      const int r = i / M, n = i % M, m = r ? m2 : m1, g = m * M + n;
#pragma unroll
      for (int c = 0; c < 4; ++c) sh[y.st + 4 * i + c] = p.in[c][g];
      sh[y.rowc + i] = p.damp[g];
      sh[y.rowc + 2 * M + i] = p.dden[g];
      if constexpr (FORM == kPsi) sh[y.rowc + 4 * M + i] = p.extra[g];
      if (n >= m)
        put_x<FORM>(sh, y, M, i, r ? M - m1 + n - m2 : n - m1, p.in[0][g],
                    p.in[1][g]);
    }
    for (int i = threadIdx.x; i < 2 * M; i += kThreads)
      sh[y.wts + i] = p.wts[i];
  }
  // The twiddle matrix from the table: (cos, sin) at (m l) mod L.
  const int nl = L / 2 + 1;
  for (int i = threadIdx.x; i < M * nl; i += kThreads) {
    const int m = i / nl, l = i - m * nl;
    const float4 t = reinterpret_cast<const float4*>(p.tw)[(m * l) % L];
    reinterpret_cast<float2*>(sh + y.twm)[m * y.nlp + l] =
        make_float2(t.x, t.y);
  }
  const float inv_l = p.tw[2];  // 1/L, the table's cos(0)/L
  if constexpr (FORM == kVrt)
    for (int j = threadIdx.x; j < p.J; j += kThreads)
      sh[y.frow + j] = p.extra[j];
  cp_async_wait<0>();
  __syncthreads();
  long long* clk = nullptr;
  if (pair && p.n_steps > 0)
    synthesise<FORM, CLK>(p, y, sh, m1, m2, ja, jb, clk);
  for (int i = 0; i < p.n_steps; ++i) {
    if (CLK && b == 0) clk = p.clocks + (size_t)i * kStamps;
    grid.sync();
    stamp<CLK>(clk, 0);
    for (int j = b; j < p.J; j += gridDim.x)
      column<FORM, CLK>(p, y, sh, j, inv_l, clk);
    grid.sync();
    stamp<CLK>(clk, 6);
    if (pair) {
      analyse_and_step<FORM, CLK>(p, y, sh, m1, m2, p.step0 + i == 0, clk);
      if (i + 1 < p.n_steps)
        synthesise<FORM, CLK>(p, y, sh, m1, m2, ja, jb, clk);
    }
  }
  if (owner)
    for (int i = threadIdx.x; i < nrow * M; i += kThreads) {
      const int g = (i < M ? m1 : m2) * M + i % M;
#pragma unroll
      for (int c = 0; c < 4; ++c) p.out[c][g] = sh[y.st + 4 * i + c];
    }
}

// The sync probe: the kernel's loop of two grid-wide barriers a step and
// nothing else, launched with the same grid and shared-memory request, so
// that (kernel - probe) per step is the time of the phases.
__global__ void __launch_bounds__(kThreads) sync_probe(int n_steps) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n_steps; ++i) {
    grid.sync();
    grid.sync();
  }
}

// What the kernel's indexing needs of the wrapper's layout: the regions in
// order from 0, each 16-byte aligned (cp.async and vector accesses), a slab
// for the M+1 entries of J values, an odd twiddle row of at least L/2 + 1
// entries (no bank conflicts), and the work region inside the bytes.
bool check_layout(const int* lay, int M, int J, int L, Layout* y) {
  static_assert(sizeof(Layout) == kLayoutFields * sizeof(int), "ints only");
  memcpy(y, lay, sizeof(Layout));
  bool ok = y->tab == 0 && y->slab % 4 == 0 && y->slab >= (M + 1) * J &&
            y->nlp % 2 == 1 && y->nlp >= L / 2 + 1 && y->bytes > 4 * y->work;
  for (int i = 3; i < kLayoutFields - 1; ++i)  // twm .. work
    ok = ok && lay[i] % 4 == 0 && lay[i] >= lay[i - 1];
  return ok;
}

// One cooperative launch of `fn` with `smem` bytes of shared memory a
// block and the kernel's grid: max(P, J) blocks, or `blocks` if > 0, cut
// to what the card holds at once (every block of a cooperative launch must
// be resident), and refused below the P row-pair blocks.
int launch(const void* fn, void** args, size_t smem, int M, int J,
           int blocks, int* blocks_out, void* stream) {
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
  const int pairs = (M + 1) / 2;
  const int want = blocks > 0 ? blocks : (pairs > J ? pairs : J);
  const int fit = per_sm * sms;
  if (fit < pairs) return (int)cudaErrorCooperativeLaunchTooLarge;
  if (want < pairs) return (int)cudaErrorInvalidValue;
  *blocks_out = want < fit ? want : fit;
  err = cudaLaunchCooperativeKernel(fn, dim3(*blocks_out), dim3(kThreads),
                                    args, smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: vr, vi, pr, pi (in); vr, vi, pr, pi (out); syn; fwd; tab, tw,
// wts, damp, dden; then invF (psi) or f_row (vrt). lay: the kLayoutFields
// values of Layout. Launches on `stream`, with `clocks` (null, or n_steps
// x kStamps) the build that stamps block 0's stages; writes the grid size
// to *blocks_out and returns the CUDA error (0 = ok).
extern "C" int dlwp_barotropic_step(int form, void* const* ptrs, int M,
                                    int J, int L, int step0, int n_steps,
                                    float dt, float r, const int* lay,
                                    long long* clocks, int* blocks_out,
                                    void* stream) {
  Params p;
  if ((form != kPsi && form != kVrt) || !check_layout(lay, M, J, L, &p.y))
    return (int)cudaErrorInvalidValue;
  for (int c = 0; c < 4; ++c) {
    p.in[c] = static_cast<const float*>(ptrs[c]);
    p.out[c] = static_cast<float*>(ptrs[4 + c]);
  }
  p.syn = static_cast<float*>(ptrs[8]);
  p.fwd = static_cast<float*>(ptrs[9]);
  p.tab = static_cast<const float*>(ptrs[10]);
  p.tw = static_cast<const float*>(ptrs[11]);
  p.wts = static_cast<const float*>(ptrs[12]);
  p.damp = static_cast<const float*>(ptrs[13]);
  p.dden = static_cast<const float*>(ptrs[14]);
  p.extra = static_cast<const float*>(ptrs[15]);
  p.M = M;
  p.J = J;
  p.L = L;
  p.step0 = step0;
  p.n_steps = n_steps;
  p.dt = dt;
  p.r = r;
  p.clocks = clocks;
  const void* fn =
      form == kPsi ? (clocks ? (const void*)barotropic_kernel<kPsi, true>
                             : (const void*)barotropic_kernel<kPsi, false>)
                   : (clocks ? (const void*)barotropic_kernel<kVrt, true>
                             : (const void*)barotropic_kernel<kVrt, false>);
  void* args[] = {&p};
  return launch(fn, args, p.y.bytes, M, J, 0, blocks_out, stream);
}

// The sync probe of the kernel at these sizes: n_steps x two grid syncs on
// the kernel's grid (blocks = 0) or on `blocks` blocks, with the kernel's
// shared-memory request, `smem` bytes. Writes the grid size to *blocks_out.
extern "C" int dlwp_barotropic_sync_probe(int M, int J, int smem,
                                          int n_steps, int blocks,
                                          int* blocks_out, void* stream) {
  void* args[] = {&n_steps};
  return launch((const void*)sync_probe, args, smem, M, J, blocks,
                blocks_out, stream);
}
