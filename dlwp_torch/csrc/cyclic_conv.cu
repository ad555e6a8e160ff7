// Cyclic conv3x3 + bias + activation in one pass, fp32 results through
// 3xTF32 tensor-core products, with an optional parity-interleaved store,
// for Hopper (sm_90a).
//
// Replaces: no Pallas kernel. On the TPU, XLA fused the flagship tower's
// small-grid convs (dlwp_tpu/models/layers.py CyclicConv2D and UpConv2D
// after the peephole fusions) with their wrap pad, bias, activation and the
// upsampling conv's parity interleave; on the card those ran as cuDNN
// convs with a pass each for the pad, bias, activation and permute.
// Computes
//     y = act(cyclic_conv2d(x, k) + b)
// for a 3x3 kernel at stride 1 and dilation 1, periodic in longitude and
// zero outside latitude [0, H), on x (B, C, H, W) NCHW, k (N, C, 3, 3)
// OIHW (read as it is). act: linear or tanh. Plain store: y (B, N, H, W).
// Parity store (conv_after_upsample2's folded form, N = 4 O, channel n =
// (pr O + o) 2 + pc): the value of channel n at small-grid pixel (r, u) is
// y[b, o, 2 r + pr, 2 u + pc] of y (B, O, 2 H, 2 W), and b[o] its bias.
//
// Bound on an H100 SXM: 2 B H W N C 9 flops on few bytes (the flagship's
// 128 -> 4 x 64 parity conv on 9 x 36 at B = 64: 12.2 GFLOP against 32 MB).
// This kernel does three TF32 tensor-core products per multiply-add (fp32
// accuracy; the configurations run with TF32 off), so its own bound is 3
// flops / 495 TFLOP/s.
//
// Design:
// 1. An implicit GEMM on mma.sync m16n8k8 TF32 with the 3xTF32 split of
//    tf32_mma.cuh: M = output pixels, flattened over (b, r, u), m16
//    fragments of 16 consecutive pixels, which may run across rows and
//    samples; N = output channels, n8 fragments; K = (8-channel slab) x
//    (9 taps), one k8 step a tap. A warp owns MF m16 x NF n8 fragments
//    (two builds: 2 x 4 and 2 x 2); a block of wm x wn warps owns a tile
//    of bm = 16 MF wm pixels x bn = 8 NF wn channels. The plan
//    (dlwp_torch/kernels/cyclic_conv.py, _plan) picks the build and the
//    block from (B H W, N, C) so that B = 1 and B = 256 both fill the SMs.
// 2. The wrap and the zero latitude rows are in the load addressing: no
//    padded copy exists. A slab stages the input rows that its tile's
//    pixels read: flat rows (b H + r) fr0 - 1 .. fr0 + nrows - 2, fr0 the
//    tile's first, as nrows rows of rsp positions; position i of a row
//    holds column i - 1 modulo W (positions 0 .. W + 1), each position the
//    slab's 8 channels in 12 floats (48 bytes: the 16-byte rows of 8
//    consecutive positions fall in distinct bank groups, and rsp = W mod 8
//    keeps that across a row's end). One more row stays zero. A lane's
//    pixel reads the staged rows above, at and below its own, or the zero
//    row where r - 1 or r + 1 leaves [0, H); tap (dy, dx) is then the
//    position u + dx of that row. A-fragments (pixels x channels) load
//    with ldmatrix.x4, each lane naming its pixel's 16-byte row;
//    B-fragments (weights) with scalar loads from rows of 76 floats, the
//    slab's 8 channels x 9 taps of an output channel as OIHW holds them
//    (stage_w of tf32_mma.cuh), conflict-free.
// 3. A persistent grid (SMs x resident blocks) walks the tiles, channel
//    tile fastest, so the blocks that stage one row range run together; a
//    ring of 2-4 buffers runs over (tile, slab) units across tile
//    boundaries with cp.async, staged by every warp of the block: 16
//    bytes for weights where C % 4 == 0, 4 bytes for the input, whose
//    channels are transposed into positions. Issuing those copies takes
//    about as long as a unit's products; the other layouts tried were
//    slower still (PERF.md): channel planes staged 16 bytes at a
//    time and read with scalar loads; rows staged as x holds them, then
//    transposed in shared memory; a producer warp beside the computing
//    ones.
// 4. fp32 accuracy: each slab's 9 k8 steps x 3 products are chained on the
//    tensor cores, then added to fp32 sums in registers (one chain over
//    all of K drifts, as in fused_conv_pool.cu). Every output sums in the
//    same order (slabs ascending, taps in order, the three products, the
//    tensor core's k8 sum) whatever the tile or the batch, so a sample's
//    result depends on neither the plan nor B.
// 5. The epilogue adds the bias, applies the activation and stores: the
//    plain layout a channel pair per lane to two planes; the parity layout
//    a channel pair (pc = 0, 1) per lane as one 8-byte store of two
//    neighbouring large-grid columns.

#include <cuda_runtime.h>

#include <cstdint>

#include "tf32_mma.cuh"

namespace {

constexpr int PP = 12;  // floats a staged position holds (8 channels)
constexpr int MAX_THREADS = 256;
constexpr int MAX_SMEM = 227 * 1024;

// Plan values, in the order of the `plan` array of the C entry point.
enum PlanField {
  P_MF, P_NF, P_WM, P_WN, P_STAGES, P_RSP, P_NROWS, P_TILES, P_NNT, P_SMEM,
  P_GRID, P_VEC_W, P_FIELDS
};

struct Params {
  const float* x;
  const float* k;
  const float* bias;
  float* y;
  int B, C, H, W, N, O, HW, P, act, parity;
  int wm, wn, bm, bn, n_nt, tiles, nslab, rsp, nrows, stages;
  int xs_floats, ws_floats, vec_w;
};

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A tile: pixels p0 .. p0 + bm - 1, channels n0 .. n0 + bn - 1; fr0 the
// flat row of pixel p0.
struct Tile {
  int p0, n0, fr0;
};

__device__ __forceinline__ Tile decode(const Params& p, int t) {
  Tile tl;
  const int pt = t / p.n_nt;
  tl.n0 = (t - pt * p.n_nt) * p.bn;
  tl.p0 = pt * p.bm;
  tl.fr0 = tl.p0 / p.W;
  return tl;
}

// Stage slab c0's input rows of a tile whose first flat row is fr0 (header,
// 2.). A warp takes (row, channel half) items; its lanes are 8 positions x
// 4 channels, so a copy reads 32 bytes of each of 4 channel rows and
// writes 32 distinct banks. Rows outside [0, B H) and channels past C
// stage as zeros.
__device__ void stage_x(float* xs, const Params& p, int fr0, int c0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int pin = lane & 7, cq = lane >> 3;
  const int npos = p.W + 2, BH = p.B * p.H;
  for (int item = warp; item < 2 * p.nrows; item += nwarps) {
    const int j = item >> 1, c = ((item & 1) << 2) + cq;
    const int fr = fr0 - 1 + j;
    float* dst = xs + j * p.rsp * PP + c;
    if (fr >= 0 && fr < BH && c0 + c < p.C) {
      const int b = fr / p.H, r = fr - b * p.H;
      const float* src =
          p.x + (((size_t)b * p.C + c0 + c) * p.H + r) * p.W;
      for (int pos = pin; pos < npos; pos += 8) {
        const int col = pos == 0 ? p.W - 1 : (pos > p.W ? 0 : pos - 1);
        cp_async4(dst + pos * PP, src + col);
      }
    } else {
      for (int pos = pin; pos < npos; pos += 8) dst[pos * PP] = 0.f;
    }
  }
}

// One slab of one warp: 9 k8 steps of 3xTF32 products chained into tmp
// (zero on entry). xa: this stage's input buffer (shared address) plus the
// lane's 16-byte half; q[i][dy]: the staged position of tap (dy, 0) of
// the lane's pixel in m-fragment i; wb: the lane's B element (channel t,
// output channel g) of the warp's first n-fragment at tap 0.
template <int MF, int NF>
__device__ __forceinline__ void compute(float (&tmp)[MF][NF][4],
                                        uint32_t xa, const int (&q)[MF][3],
                                        const float* wb) {
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int tap = dy * 3 + dx;
      uint32_t bhi[NF][2], blo[NF][2];
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        split(wb[j * 8 * WR + tap], bhi[j][0], blo[j][0]);
        split(wb[j * 8 * WR + 36 + tap], bhi[j][1], blo[j][1]);
      }
#pragma unroll
      for (int i = 0; i < MF; ++i) {
        uint32_t r[4], ahi[4], alo[4];
        ldsm4(r, xa + (q[i][dy] + dx) * (PP * 4));
#pragma unroll
        for (int e = 0; e < 4; ++e) split(__uint_as_float(r[e]), ahi[e], alo[e]);
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          mma(tmp[i][j], ahi, blo[j][0], blo[j][1]);
          mma(tmp[i][j], alo, bhi[j][0], bhi[j][1]);
          mma(tmp[i][j], ahi, bhi[j][0], bhi[j][1]);
        }
      }
    }
  }
}

__device__ __forceinline__ float activate(float v, int act) {
  return act ? tanhf(v) : v;
}

// Bias (from shared memory), activation and store of one tile's sums, then
// the sums zeroed: lane (g, t) holds pixels g and g + 8 of each m-fragment
// at channels 2 t and 2 t + 1 of each n-fragment. The channels' offsets
// within a sample's output and their biases are found once a tile.
template <int MF, int NF>
__device__ __forceinline__ void store(float (&acc)[MF][NF][4],
                                      const Params& p, const Tile& tl,
                                      int pw, int nw, const float* bias) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  int coff[NF], nok[NF];  // offset of the pair's first; channels stored
  float b0[NF], b1[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    const int n = tl.n0 + nw + 8 * j + 2 * t;
    if (p.parity) {  // o's plane, row parity pr (a pair: columns pc 0, 1)
      const int pr = n / (2 * p.O), o = (n - pr * 2 * p.O) >> 1;
      nok[j] = n < p.N ? 2 : 0;
      coff[j] = o * 4 * p.HW + pr * 2 * p.W;
      b0[j] = b1[j] = n < p.N ? bias[o] : 0.f;
    } else {
      nok[j] = (n < p.N) + (n + 1 < p.N);
      coff[j] = n * p.HW;
      b0[j] = n < p.N ? bias[n] : 0.f;
      b1[j] = n + 1 < p.N ? bias[n + 1] : 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < MF; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int px = tl.p0 + pw + 16 * i + g + 8 * h;
      if (px < p.P) {
        const int b = px / p.HW, rem = px - b * p.HW;
        if (p.parity) {
          const int r = rem / p.W, u = rem - r * p.W;
          float* y = p.y + (size_t)b * p.O * 4 * p.HW + 4 * r * p.W + 2 * u;
#pragma unroll
          for (int j = 0; j < NF; ++j)
            if (nok[j])
              *reinterpret_cast<float2*>(y + coff[j]) =
                  make_float2(activate(acc[i][j][2 * h] + b0[j], p.act),
                              activate(acc[i][j][2 * h + 1] + b1[j], p.act));
        } else {
          float* y = p.y + (size_t)b * p.N * p.HW + rem;
#pragma unroll
          for (int j = 0; j < NF; ++j) {
            if (nok[j] > 0)
              y[coff[j]] = activate(acc[i][j][2 * h] + b0[j], p.act);
            if (nok[j] > 1)
              y[coff[j] + p.HW] =
                  activate(acc[i][j][2 * h + 1] + b1[j], p.act);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NF; ++j) acc[i][j][2 * h] = acc[i][j][2 * h + 1] = 0.f;
    }
  }
}

// The block walks tiles blockIdx.x, + gridDim.x, ...; unit u is slab
// u % nslab of its (u / nslab)-th tile, in buffer u % stages of the ring,
// which keeps stages - 1 units in flight ahead of the one computed.
template <int MF, int NF>
__device__ void run(const Params& p) {
  extern __shared__ __align__(16) float smem[];
  float* wring = smem + p.stages * p.xs_floats;
  float* sbias = wring + p.stages * p.ws_floats;
  // Each buffer's zero row starts at zero (no copy writes it; nothing
  // reads what no copy writes elsewhere).
  for (int b = 0; b < p.stages; ++b)
    for (int i = threadIdx.x; i < p.rsp * PP; i += blockDim.x)
      smem[b * p.xs_floats + p.nrows * p.rsp * PP + i] = 0.f;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wmi = warp / p.wn, wni = warp - wmi * p.wn;
  const int pw = wmi * MF * 16, nw = wni * NF * 8;
  // The lane's 16-byte ldmatrix row of an A fragment: pixel lane % 16 at
  // channel half lane / 16; its B element: output channel g, channel t.
  const uint32_t xhalf = (lane >> 4) * 16;
  const int wlane = (nw + (lane >> 2)) * WR + (lane & 3) * 9;
  const int zrow = p.nrows * p.rsp;  // position 0 of the zero row

  const int units =
      ((p.tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) * p.nslab;
  auto tile_of = [&](int u) {
    return decode(p, blockIdx.x + u / p.nslab * gridDim.x);
  };
  auto prefetch = [&](int u) {
    if (u < units) {
      const Tile tl = tile_of(u);
      const int s = u % p.nslab, buf = u % p.stages;
      stage_x(smem + buf * p.xs_floats, p, tl.fr0, s * CS);
      stage_w(wring + buf * p.ws_floats, p.k, p.N, p.C, tl.n0, p.bn, s * CS,
              p.vec_w);
    }
    cp_async_commit();
  };

  float acc[MF][NF][4] = {}, tmp[MF][NF][4] = {};
  int q[MF][3];
  for (int u = 0; u < p.stages - 1; ++u) prefetch(u);
  // The bias, needed at the first store, comes in behind the copies.
  for (int i = threadIdx.x; i < p.O; i += blockDim.x) sbias[i] = p.bias[i];
  for (int u = 0; u < units; ++u) {
    switch (p.stages) {  // stages - 2 units may stay in flight
      case 4: cp_async_wait<2>(); break;
      case 3: cp_async_wait<1>(); break;
      default: cp_async_wait<0>(); break;
    }
    __syncthreads();  // unit u landed; unit u - 1's buffer is free
    prefetch(u + p.stages - 1);
    const int s = u % p.nslab, buf = u % p.stages;
    const Tile tl = tile_of(u);
    if (s == 0) {  // the lane's pixels of this tile
#pragma unroll
      for (int i = 0; i < MF; ++i) {
        const int px = tl.p0 + pw + 16 * i + (lane & 15);
        if (px < p.P) {
          const int fr = px / p.W, col = px - fr * p.W;
          const int r = fr % p.H, j = fr - tl.fr0 + 1;
          q[i][0] = (r == 0 ? p.nrows : j - 1) * p.rsp + col;
          q[i][1] = j * p.rsp + col;
          q[i][2] = (r == p.H - 1 ? p.nrows : j + 1) * p.rsp + col;
        } else {
          q[i][0] = q[i][1] = q[i][2] = zrow;
        }
      }
    }
    compute<MF, NF>(tmp, smem_u32(smem + buf * p.xs_floats) + xhalf, q,
                    wring + buf * p.ws_floats + wlane);
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[i][j][e] += tmp[i][j][e];
          tmp[i][j][e] = 0.f;
        }
    if (s == p.nslab - 1) store<MF, NF>(acc, p, tl, pw, nw, sbias);
  }
  cp_async_wait<0>();
}

template <int MF, int NF>
__global__ void __launch_bounds__(MAX_THREADS, 2)
    cyclic_conv_kernel(const Params p) {
  run<MF, NF>(p);
}

// The four parity kernels of conv_after_upsample2 from an odd k x k kernel
// (k <= 5), in the channel order of the parity store: kw[(pr O + o) 2 +
// pc][c][j][l] sums k[o][c][a][b] over the taps a whose row lands on the
// small grid's row tap j at row parity pr (floor((pr + a - (k - 1) / 2) /
// 2) + 1 == j), and b likewise on l at pc; a thread an output. Replaces
// the wrapper's einsum (a few kernels a call) on the card.
__global__ void parity_fold_kernel(const float* k, float* kw, int O, int C,
                                   int ks) {
  const int total = 4 * O * C * 9, half = (ks - 1) / 2;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += gridDim.x * blockDim.x) {
    const int l = e % 3, j = e / 3 % 3, c = e / 9 % C, n = e / (9 * C);
    const int pc = n & 1, o = (n >> 1) % O, pr = (n >> 1) / O;
    float sum = 0.f;
    for (int a = 0; a < ks; ++a) {
      if (((pr + a - half + 4) >> 1) - 1 != j) continue;
      for (int b = 0; b < ks; ++b) {
        if (((pc + b - half + 4) >> 1) - 1 != l) continue;
        sum += k[((o * C + c) * ks + a) * ks + b];
      }
    }
    kw[e] = sum;
  }
}

using Kernel = void (*)(const Params);

Kernel kernel_of(int mf, int nf) {
  if (mf == 2 && nf == 4) return &cyclic_conv_kernel<2, 4>;
  if (mf == 2 && nf == 2) return &cyclic_conv_kernel<2, 2>;
  return nullptr;
}

}  // namespace

// Once, when the library loads: every build may take a block's whole
// shared memory (outside any CUDA graph capture). Returns the first CUDA
// error, 0 = ok.
extern "C" int dlwp_cyclic_conv_init() {
  const int builds[][2] = {{2, 4}, {2, 2}};
  for (const auto& b : builds) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel_of(b[0], b[1]), cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_SMEM);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Launches parity_fold_kernel on `stream`: k (O, C, ks, ks), kw (4 O, C, 3,
// 3). Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int dlwp_cyclic_conv_fold(const float* k, float* kw, int O, int C,
                                     int ks, void* stream) {
  if (O < 1 || C < 1 || ks < 1 || ks > 5 || ks % 2 == 0 ||
      36LL * O * C > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int total = 36 * O * C, threads = 256;
  const int grid = (total + threads - 1) / threads;
  parity_fold_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(k, kw, O, C,
                                                                 ks);
  return (int)cudaGetLastError();
}

// Resident blocks an SM of build (mf, nf) at `threads` threads and `smem`
// bytes: the persistent grid is SMs x this.
extern "C" int dlwp_cyclic_conv_occupancy(int mf, int nf, int threads,
                                          int smem, int* per_sm) {
  const Kernel kernel = kernel_of(mf, nf);
  if (!kernel || !per_sm) return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                            threads, smem);
}

// Launches on `stream` and returns cudaGetLastError() after the launch (0 =
// ok). k: the weights (N, C, 3, 3); bias (N,), or (N / 4,) with `parity`;
// plan: the P_FIELDS values of the wrapper's _plan and launch.
extern "C" int dlwp_cyclic_conv(const float* x, const float* k,
                                const float* bias, float* y, int B, int C,
                                int H, int W, int N, int act, int parity,
                                const int* plan, void* stream) {
  if (B < 1 || C < 1 || H < 1 || W < 1 || N < 1 || (act != 0 && act != 1) ||
      (parity && N % 4) || (long long)B * H * W > 0x7fffffffLL ||
      (long long)N * H * W > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x, p.k = k, p.bias = bias, p.y = y;
  p.B = B, p.C = C, p.H = H, p.W = W, p.N = N, p.O = parity ? N / 4 : N;
  p.HW = H * W, p.P = B * H * W, p.act = act, p.parity = parity;
  const int mf = plan[P_MF], nf = plan[P_NF];
  p.wm = plan[P_WM], p.wn = plan[P_WN], p.stages = plan[P_STAGES];
  p.rsp = plan[P_RSP], p.nrows = plan[P_NROWS], p.tiles = plan[P_TILES];
  p.n_nt = plan[P_NNT], p.vec_w = plan[P_VEC_W];
  const int smem = plan[P_SMEM], grid = plan[P_GRID];
  const Kernel kernel = kernel_of(mf, nf);
  const int threads = p.wm * p.wn * 32;
  if (!kernel || p.wm < 1 || p.wn < 1 || threads > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  p.bm = 16 * mf * p.wm, p.bn = 8 * nf * p.wn;
  p.nslab = (C + CS - 1) / CS;
  p.xs_floats = (p.nrows + 1) * p.rsp * PP;
  p.ws_floats = p.bn * WR;
  const long long tiles =
      (long long)((p.P + p.bm - 1) / p.bm) * ((N + p.bn - 1) / p.bn);
  // The staged rows hold every row a tile's pixels read (header, 2.): a
  // tile spans at most (bm + W - 2) / W + 1 flat rows, and one more on
  // each side; positions 0 .. W + 1 fit a row, whose length is W mod 8.
  if (p.n_nt != (N + p.bn - 1) / p.bn || p.tiles != tiles ||
      (p.stages < 2 || p.stages > 4) ||
      p.nrows < (p.bm + W - 2) / W + 3 || p.rsp < W + 2 ||
      (p.rsp - W) % 8 || grid < 1 || grid > p.tiles ||
      (long long)((p.tiles - 1) / grid + 1) * p.nslab > 0x7fffffffLL ||
      smem > MAX_SMEM ||
      smem != (p.stages * (p.xs_floats + p.ws_floats) + (N + 3) / 4 * 4) *
                  (int)sizeof(float))
    return (int)cudaErrorInvalidValue;
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
