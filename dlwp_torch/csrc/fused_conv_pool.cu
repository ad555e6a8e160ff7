// Fused cyclic conv3x3 + bias + tanh + 2x2 max-pool, fp32 results through
// 3xTF32 tensor-core products, for Hopper (sm_90a).
//
// Replaces: dlwp_tpu/ops/fused_stages.py, fused_conv_pool (Pallas kernel
// _conv_pool_kernel). Computes
//     y = maxpool2x2(tanh(cyclic_conv2d(x, k, dilation d) + b))
// with zero latitude boundary and periodic longitude, on x (B, C, H, W),
// k (O, C, 3, 3) OIHW (read as it is), b (O,), y (B, O, H/2, W/2); H and
// W even. tanh is monotone, so the four conv sums of a pool window are
// maxed first and bias + tanh run once on the pooled value (as the Pallas
// kernel does).
//
// Bound on an H100 SXM: 2 * B * O * H * W * C * 9 flops on few bytes
// (stage 1 of the flagship, (64, 24, 36, 144) -> 32 at d = 2: 4.59 GFLOP
// against 42.5 MB). In fp32 FMA that is 0.0685 ms at 67 TFLOP/s; this
// kernel does three TF32 tensor-core products per multiply-add, so its
// own bound is 3 * flops / 495 TFLOP/s = 0.0278 ms.
//
// Design:
// 1. An implicit GEMM on mma.sync TF32 with the 3xTF32 split of
//    tf32_mma.cuh, as in overlap_conv.cu, but transposed: M = output
//    channels (m16 fragments), N = output pixels (n8 tiles of 8 columns of
//    one output row), K = (8-channel slab) x (9 taps). In the accumulator
//    layout a lane holds columns 2t and 2t + 1 of rows g and g + 8, so
//    every horizontal pool pair lies in one lane. Each warp holds the two
//    output rows of its pooled row at the same columns, so the 2x2 max is
//    four fmaxf in registers: no shuffle, no second pass, and the
//    full-resolution conv never leaves the SM. The B operand (pixels) is
//    read from rows staged in their natural order, 8 consecutive columns
//    x 4 channels a warp, conflict-free with a row stride of 8 or 24 mod
//    32; the A operand (weights) from rows of 76 floats, also
//    conflict-free.
// 2. A warp owns MO o-fragments (2 or 1: two builds) x one n8 column tile
//    x the 2 rows of its pooled row (at most 4 m16n8 tiles, 16 fp32 sums
//    and 16 chain sums). A tile of a block is `bb` samples x `rb` pooled
//    rows x a column block of 8 ncg columns (n_cb blocks cover a row, the
//    last masked where 8 ncg n_cb > W) x an o-group of nm m16 fragments
//    (64 or 32 output channels); its warps cover every (sample, pooled
//    row, column tile, o-subgroup) once. The plan
//    (dlwp_torch/kernels/fused_conv_pool.py, _plan) picks the shapes on
//    the host: at the flagship, both stages take MO 2 in blocks of 18
//    warps, one column block a row (stage 1: 18 column tiles of 144
//    columns; stage 2: 9 column tiles of 72 x 2 o-subgroups); a wider grid
//    takes more column blocks (5 at 720 and 360 columns).
// 3. Dilation and the wrap are offsets into shared memory, at any d < W.
//    A tile's rows 2 hp0 .. 2 (hp0 + rb) - 1 read the rows dy d away, dy
//    in -1, 0, 1. Where d <= 2 rb the tile stages the rows 2 hp0 - d ..
//    2 (hp0 + rb) - 1 + d of each sample in order (2 rb + 2 d rows);
//    beyond, it stages three groups of 2 rb rows, group dy + 1 holding
//    rows 2 hp0 + dy d + r' (6 rb rows, however large d). Either way tap
//    dy is the offset dy rstep rows, rstep = min(d, 2 rb). Columns alike:
//    where d <= cw, the tile's n columns w0 .. w0 + n - 1 and the d
//    columns on each side, taken modulo W (the longitude wrap), stand in
//    order; beyond, three groups of cw columns, group dx + 1 holding
//    columns w0 + dx d + i modulo W; tap dx is the offset dx cstep,
//    cstep = min(d, cw). Latitude outside [0, H) stages as zeros. Row
//    interiors go as 16-byte cp.async.cg where W % 4 == 0 and x is
//    16-byte aligned, else 4 bytes at a time (the same values either
//    way). A masked column reads what an earlier tile left past n; no
//    stored output does.
// 4. A persistent grid (SMs x resident blocks) walks the tiles; a ring of
//    2 or 3 buffers runs over (tile, slab) units across tile boundaries.
//    Where the launch has one o-group (both flagship stages), every slab's
//    weights are staged once per block and stay (27.6 KB at stage 1, 73.7
//    KB at stage 2), else each slab's weights travel with its rows. Blocks
//    have at most 18 warps. 18 warps on the SM's four register partitions
//    leave 96 registers a thread: 4 m16n8 tiles a warp fit them without
//    spills; warps of 8 tiles (2x2, 4x1 in blocks of 9, two an SM) ran
//    6-10% faster but spilled (PERF.md). A block of more than 10 warps is
//    alone on its SM, so its ring may take 227 KB (3 stages at stage 1).
// 5. fp32 accuracy: each 8-channel slab's 27 products are chained on the
//    tensor core, then added to fp32 sums in registers (one chain over all
//    of K drifts past 1e-5; tests/test_torch_port_overlap.py and
//    tests/test_torch_port_conv_pool.py emulate it). A last slab of at
//    most 4 channels uses m16n8k4.
//
// Every output sums in the same order (slabs ascending, then dy, then dx,
// then the tensor core's k8 or k4 sum) whatever the tile or the batch
// size, so a sample's result does not depend on B or on the plan.

#include <cuda_runtime.h>

#include <cstdint>

#include "tf32_mma.cuh"

namespace {

constexpr int MAX_WARPS = 18;  // a block: 96 registers a thread
constexpr int MIN_BLOCKS = 1;

// Plan values, in the order of the `plan` array of the C entry point.
enum PlanField {
  P_BB, P_RB, P_WARPS, P_STAGES, P_RS, P_LM, P_NM, P_MO, P_NOG, P_NCG,
  P_NCB, P_VEC_X, P_VEC_W, P_SMEM, P_TILES, P_RESIDENT, P_FIELDS
};

struct Params {
  const float* x;
  const float* k;
  const float* bias;
  float* y;
  int B, C, H, W, O, d;
  int bb, rb, rs, lm, nm, nos, n_og, ncg, n_cb, cw, n_rg, nslab, tiles;
  int vec_x, vec_w;
  // Rows and columns between taps in shared memory (header, 3.):
  // min(d, 2 rb) and min(d, cw); staged rows of a sample: 2 rb + 2 rstep.
  int rstep, cstep, nrows;
  int xs_floats, ws_floats, stages;
  int resident;  // the weights of every slab stay in shared memory
};

// A tile: samples b0 .. b0 + nb - 1, pooled rows hp0 .. hp0 + nr - 1,
// columns w0 .. w0 + cw - 1, o-group og. Tiles run o-group fastest, then
// column block, so the blocks that stage one input row group run together.
struct Tile {
  int b0, nb, hp0, nr, w0, og;
};

__device__ __forceinline__ Tile decode(const Params& p, int t) {
  Tile tl;
  tl.og = 0, tl.w0 = 0;
  int q = t;
  if (p.n_og > 1) {  // uniform branches: no division by a count of 1
    tl.og = q % p.n_og;
    q /= p.n_og;
  }
  if (p.n_cb > 1) {
    tl.w0 = (q % p.n_cb) * p.cw;
    q /= p.n_cb;
  }
  tl.hp0 = (q % p.n_rg) * p.rb;
  tl.b0 = (q / p.n_rg) * p.bb;
  tl.nb = min(p.bb, p.B - tl.b0);
  tl.nr = min(p.rb, p.H / 2 - tl.hp0);
  return tl;
}

// Stage the input rows of slab c0 of tile tl: xs [bl][r][cc][rs], row r
// as the header (3.) orders them; its n = min(cw, W - w0) columns w0 ..
// w0 + n - 1 at lm .. lm + n - 1, then the columns of the taps dx = -1
// and 1, taken modulo W: the d on each side where d <= cw, else the
// groups at lm - cw and lm + cw. Rows outside [0, H), samples past the
// batch and channels past C stage as zeros.
__device__ void stage_x(float* xs, const Params& p, const Tile& tl, int c0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int W = p.W, H = p.H, d = p.d, w0 = tl.w0;
  const int n = min(p.cw, W - w0);
  const int nrows = p.bb * p.nrows * CS;
  const int nq = p.vec_x ? n / 4 : n;
  // Columns of each side, where the right side starts in shared memory and
  // in the row (header, 3.).
  const bool col_groups = p.cstep < d;
  const int side = col_groups ? n : d;
  const int rpos = col_groups ? p.cw : n, rcol = col_groups ? d : n;
  // Row index (bl * nrows + r) * CS + cc, stepped by nwarps without
  // division.
  int cc = warp % CS, r = warp / CS, bl = 0;
  while (r >= p.nrows) r -= p.nrows, ++bl;
  for (int row = warp; row < nrows; row += nwarps) {
    const int c = c0 + cc;
    int gr = 2 * tl.hp0 - d + r;
    if (p.rstep < d) {  // three groups of 2 rb rows
      const int grp = r / (2 * p.rb);
      gr = 2 * tl.hp0 + (grp - 1) * d + r - grp * 2 * p.rb;
    }
    float* dst = xs + row * p.rs + p.lm;
    if (bl < tl.nb && c < p.C && gr >= 0 && gr < H) {
      const float* src =
          p.x + (((size_t)(tl.b0 + bl) * p.C + c) * H + gr) * W;
      for (int i = lane; i < nq + 2 * side; i += 32) {
        if (i < nq) {
          if (p.vec_x) {
            cp_async16(dst + 4 * i, src + w0 + 4 * i);
          } else {
            cp_async4(dst + i, src + w0 + i);
          }
        } else if (i < nq + side) {  // left: from column w0 - d
          const int j = i - nq, col = w0 - d + j;  // > -W, as d < W
          cp_async4(dst - p.cstep + j, src + (col < 0 ? col + W : col));
        } else {  // right: from column w0 + n, or w0 + d
          const int j = i - nq - side, col = w0 + rcol + j;  // < 2 W
          cp_async4(dst + rpos + j, src + (col < W ? col : col - W));
        }
      }
    } else {
      for (int i = lane - p.cstep; i < p.cw + p.cstep; i += 32)
        dst[i] = 0.f;
    }
    for (cc += nwarps; cc >= CS; cc -= CS) {
      if (++r == p.nrows) r = 0, ++bl;
    }
  }
}

// The A (weight) fragment of o-fragment i at one tap, split: row g and
// g + 8, channels t and t + 4 (t only where K4).
template <bool K4>
__device__ __forceinline__ void load_a(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                       const float* a) {
  split(a[0], hi[0], lo[0]);
  split(a[8 * WR], hi[1], lo[1]);
  if (K4) {
    hi[2] = hi[3] = lo[2] = lo[3] = 0u;
  } else {
    split(a[36], hi[2], lo[2]);
    split(a[8 * WR + 36], hi[3], lo[3]);
  }
}

// The B (pixel) fragment of one column tile at one tap, split: channels t
// and t + 4 (t only where K4) of column g.
template <bool K4>
__device__ __forceinline__ void load_b(uint32_t (&hi)[2], uint32_t (&lo)[2],
                                       const float* b, int rs) {
  split(b[0], hi[0], lo[0]);
  if (K4) {
    hi[1] = lo[1] = 0u;
  } else {
    split(b[4 * rs], hi[1], lo[1]);
  }
}

// One m16n8 tile's three products of a tap: lo_a hi_b, hi_a lo_b, hi_a
// hi_b, the order every output sums in.
template <bool K4>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4],
                                     const uint32_t (&bhi)[2],
                                     const uint32_t (&blo)[2]) {
  if (K4) {
    mma4(c, ahi, blo[0]);
    mma4(c, alo, bhi[0]);
    mma4(c, ahi, bhi[0]);
  } else {
    mma(c, ahi, blo[0], blo[1]);
    mma(c, alo, bhi[0], bhi[1]);
    mma(c, ahi, bhi[0], bhi[1]);
  }
}

// One slab of one warp: 9 k8 steps (k4 steps where K4: the slab's
// channels 4..7 are all padding) of 3xTF32 products, chained on the tensor
// cores into tmp (zero on entry): tmp[i][rr] is the m16n8 tile of the
// warp's o-fragment i and row rr of the pool window. xb points at this
// lane's B element (channel t, column g) of the warp's first row at tap
// (0, 0); wa at its A element (row g, channel t) of the warp's first
// o-fragment. Within a tap the warp holds both rows' B fragments while
// the A fragments stream, so each fragment is loaded and split once.
template <int MO, bool K4>
__device__ __forceinline__ void compute(float (&tmp)[MO][2][4],
                                        const float* xb, const float* wa,
                                        int rs, int rstep, int cstep) {
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int tap = dy * 3 + dx;
      const float* xt = xb + dy * rstep * CS * rs + dx * cstep;
      uint32_t bhi[2][2], blo[2][2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        load_b<K4>(bhi[rr], blo[rr], xt + rr * CS * rs, rs);
#pragma unroll
      for (int i = 0; i < MO; ++i) {
        uint32_t ahi[4], alo[4];
        load_a<K4>(ahi, alo, wa + i * 16 * WR + tap);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          mma3<K4>(tmp[i][rr], ahi, alo, bhi[rr], blo[rr]);
      }
    }
  }
}

// This warp's part of every tile: sample bl, pooled row rl, column tile
// cg and o-subgroup os, warp = ((bl rb + rl) ncg + cg) nos + os.
struct Unit {
  int bl, rl, cg, os;
};

__device__ __forceinline__ Unit warp_unit(const Params& p) {
  const int warp = threadIdx.x >> 5;
  return {warp / (p.nos * p.ncg * p.rb), (warp / (p.nos * p.ncg)) % p.rb,
          (warp / p.nos) % p.ncg, warp % p.nos};
}

// The pool, bias and tanh of one tile's sums, then the sums zeroed: lane
// (g, t) stores pooled column w0 / 2 + 4 cg + t of channels g and g + 8
// of each o-fragment i.
template <int MO>
__device__ __forceinline__ void store(float (&acc)[MO][2][4],
                                      const Params& p, const Tile& tl) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const Unit w = warp_unit(p);
  const int H2 = p.H / 2, W2 = p.W / 2;
  const bool ok = w.bl < tl.nb && w.rl < tl.nr;
  const size_t b = tl.b0 + w.bl;
  const int hp = tl.hp0 + w.rl;
  const int wp = tl.w0 / 2 + 4 * w.cg + t;
  const int o0 = (tl.og * p.nm + w.os * MO) * 16 + g;
#pragma unroll
  for (int i = 0; i < MO; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = o0 + 16 * i + 8 * h;
      const float m = fmaxf(fmaxf(acc[i][0][2 * h], acc[i][0][2 * h + 1]),
                            fmaxf(acc[i][1][2 * h], acc[i][1][2 * h + 1]));
      if (ok && o < p.O && wp < W2) {
        p.y[((b * p.O + o) * H2 + hp) * W2 + wp] = tanhf(m + p.bias[o]);
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][rr][e] = 0.f;
  }
}

// The block walks tiles blockIdx.x, + gridDim.x, ...; unit u is slab
// u % nslab of its (u / nslab)-th tile, in buffer u % stages of the ring,
// which keeps stages - 1 units in flight ahead of the one computed. Loop
// state is u alone (the rest is derived from it), to leave the registers
// to the sums.
template <int MO>
__device__ void run(const Params& p) {
  extern __shared__ __align__(16) float smem[];
  float* wring = smem + p.stages * p.xs_floats;
  const int nw = p.resident ? p.nslab : p.stages;  // weight buffers
  // Margins and pads start at zero (all sizes are multiples of 4 floats).
  for (int i = threadIdx.x;
       i < (p.stages * p.xs_floats + nw * p.ws_floats) / 4; i += blockDim.x)
    reinterpret_cast<float4*>(smem)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  if (p.resident) {  // in the first unit's copy group
    for (int k = 0; k < p.nslab; ++k)
      stage_w(wring + k * p.ws_floats, p.k, p.O, p.C, 0, p.nm * 16,
              k * CS, p.vec_w);
  }

  // gridDim.x <= tiles, and tiles x nslab fits an int (the plan's check).
  const int units =
      ((p.tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) * p.nslab;
  auto tile_of = [&](int u) {
    return decode(p, blockIdx.x + u / p.nslab * gridDim.x);
  };
  auto prefetch = [&](int u) {
    if (u < units) {
      const Tile tl = tile_of(u);
      const int k = u % p.nslab, buf = u % p.stages;
      stage_x(smem + buf * p.xs_floats, p, tl, k * CS);
      if (!p.resident) {
        stage_w(wring + buf * p.ws_floats, p.k, p.O, p.C,
                tl.og * p.nm * 16, p.nm * 16, k * CS, p.vec_w);
      }
    }
    cp_async_commit();
  };

  int xbase, wbase;
  {
    const int lane = threadIdx.x & 31;
    const Unit w = warp_unit(p);
    xbase = ((w.bl * p.nrows + 2 * w.rl) * CS + (lane & 3)) * p.rs + p.lm -
            p.cstep + w.cg * 8 + (lane >> 2);
    wbase = (w.os * MO * 16 + (lane >> 2)) * WR + (lane & 3) * 9;
  }
  float acc[MO][2][4] = {}, tmp[MO][2][4] = {};

  for (int u = 0; u < p.stages - 1; ++u) prefetch(u);
  for (int u = 0; u < units; ++u) {
    if (p.stages == 3) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // unit u landed; unit u - 1's buffer is free
    prefetch(u + p.stages - 1);
    const int k = u % p.nslab, buf = u % p.stages;
    const float* xs = smem + buf * p.xs_floats + xbase;
    const float* ws = wring + (p.resident ? k : buf) * p.ws_floats + wbase;
    if (p.C - k * CS <= 4) {
      compute<MO, true>(tmp, xs, ws, p.rs, p.rstep, p.cstep);
    } else {
      compute<MO, false>(tmp, xs, ws, p.rs, p.rstep, p.cstep);
    }
#pragma unroll
    for (int i = 0; i < MO; ++i)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[i][rr][e] += tmp[i][rr][e];
          tmp[i][rr][e] = 0.f;
        }
    if (k == p.nslab - 1) store<MO>(acc, p, tile_of(u));
  }
  cp_async_wait<0>();
}

template <int MO>
__global__ void __launch_bounds__(MAX_WARPS * 32, MIN_BLOCKS)
    conv_pool_kernel(const Params p) {
  run<MO>(p);
}

template <int MO>
int launch(const Params& p, int threads, int smem, cudaStream_t stream,
           int* grid_out) {
  void (*kernel)(const Params) = &conv_pool_kernel<MO>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = sms * per_sm < p.tiles ? sms * per_sm : p.tiles;
  if (grid_out) *grid_out = grid;
  kernel<<<grid, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns the first CUDA error of the set-up
// (shared-memory attribute, occupancy query) or cudaGetLastError() after
// the launch (0 = ok). plan: the P_FIELDS values of the wrapper's _plan;
// grid_out receives the blocks launched.
extern "C" int dlwp_fused_conv_pool(const float* x, const float* k,
                                    const float* bias, float* y, int B, int C,
                                    int H, int W, int O, int d,
                                    const int* plan, void* stream,
                                    int* grid_out) {
  if (B < 1 || C < 1 || O < 1 || H < 2 || W < 2 || H % 2 || W % 2 ||
      d < 1 || d >= W)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x, p.k = k, p.bias = bias, p.y = y;
  p.B = B, p.C = C, p.H = H, p.W = W, p.O = O, p.d = d;
  p.bb = plan[P_BB], p.rb = plan[P_RB], p.rs = plan[P_RS], p.lm = plan[P_LM];
  p.nm = plan[P_NM], p.n_og = plan[P_NOG], p.ncg = plan[P_NCG];
  p.n_cb = plan[P_NCB];
  p.vec_x = plan[P_VEC_X], p.vec_w = plan[P_VEC_W];
  p.stages = plan[P_STAGES], p.tiles = plan[P_TILES];
  p.resident = plan[P_RESIDENT];
  const int mo = plan[P_MO];
  if (mo < 1 || p.nm < 1 || p.nm > 4 || p.nm % mo || p.bb < 1 || p.rb < 1 ||
      p.ncg < 1 || p.n_cb < 1 || p.n_og < 1 || p.tiles < 1)
    return (int)cudaErrorInvalidValue;
  p.nos = p.nm / mo;
  p.cw = 8 * p.ncg;
  p.n_rg = (H / 2 + p.rb - 1) / p.rb;
  p.nslab = (C + CS - 1) / CS;
  p.rstep = d < 2 * p.rb ? d : 2 * p.rb;
  p.cstep = d < p.cw ? d : p.cw;
  p.nrows = 2 * p.rb + 2 * p.rstep;
  p.xs_floats = p.bb * p.nrows * CS * p.rs;
  p.ws_floats = p.nm * 16 * WR;
  const int threads = plan[P_WARPS] * 32;
  const int smem = plan[P_SMEM];
  // Every column block holds a column: (n_cb - 1) cw < W <= n_cb cw.
  if (plan[P_WARPS] != p.bb * p.rb * p.ncg * p.nos ||
      plan[P_WARPS] > MAX_WARPS || (p.stages != 2 && p.stages != 3) ||
      p.n_cb * p.cw < W || (p.n_cb - 1) * p.cw >= W || p.lm < p.cstep ||
      p.lm % 4 || p.rs < p.lm + p.cw + p.cstep || p.rs % 4 ||
      p.n_og * p.nm * 16 < O ||
      p.tiles != (B + p.bb - 1) / p.bb * p.n_rg * p.n_cb * p.n_og ||
      (long long)p.tiles * p.nslab > 0x7fffffffLL ||
      (p.resident && p.n_og != 1) ||
      smem != (p.stages * p.xs_floats +
               (p.resident ? p.nslab : p.stages) * p.ws_floats) *
                  (int)sizeof(float))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mo) {
    case 1: return launch<1>(p, threads, smem, s, grid_out);
    case 2: return launch<2>(p, threads, smem, s, grid_out);
    default: return (int)cudaErrorInvalidValue;
  }
}
