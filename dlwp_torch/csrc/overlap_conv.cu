// 3x3 cyclic convolution of lat-band shards reading the neighbours' edge
// rows, fp32 results through 3xTF32 tensor-core products, for Hopper
// (sm_90a). Two entry points:
//
//   dlwp_overlap_conv     replaces dlwp_tpu/parallel/pallas_overlap.py,
//                         _overlap_kernel (via _overlap_local): one tile
//                         per block;
//   dlwp_overlap_conv_db  replaces _overlap_kernel_db (via
//                         _overlap_local_db): the same tiles walked by a
//                         persistent grid in `chunk`-major order, the
//                         counterpart of the TPU's chunk pipeline.
//
// For every shard s of one card, x_s (B, C, H, W) and kernel k (O, C, 3, 3)
// (read as it is), computes
//     y_s[b, o, h, w] = sum_{c, dy, dx} k[o, c, dy, dx]
//                       * x_s[b, c, h + dy - 1, (w + dx - 1) mod W]
// where row -1 is the northern neighbour's last row and row H the southern
// neighbour's first, zero where there is no neighbour: cyclic_conv2d(x, k,
// lat_mode='zero') of the global field, band by band. Output is fp32.
//
// Bound on an H100 SXM: 2 * B * O * H * W * C * 9 flops against a few bytes
// per flop's worth of data. In fp32 FMA that is 67 TFLOP/s; this kernel
// does three TF32 tensor-core products per multiply-add, so its own bound
// is 3 * flops / 495 TFLOP/s, 2.4x below the fp32 one. At the flagship on
// a lat=2 mesh, B=64: the ConvLSTM recurrent conv (12 -> 48 at 36x144) is
// 3.44 GFLOP, 0.051 ms in fp32 FMA, 0.021 ms in 3xTF32; its 80 MB of input
// and output take 0.024 ms at 3.35 TB/s.
//
// Design, against what held the first version (one output row per block,
// CUDA-core FMA) back:
// 1. The batch is a grid dimension. A tile is `bb` samples x `rb` output
//    rows of one shard, full row width, an o-group of 64 or 32 output
//    channels;
//    the tiles of a launch cover (chunk, sample group, o-group, shard, row
//    group). dlwp_overlap_conv gives each tile its own block;
//    dlwp_overlap_conv_db launches SMs x resident blocks
//    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), each walking tiles
//    t = blockIdx.x, + gridDim.x, ... so that every block finishes chunk j
//    before chunk j + 1 and no tile straddles a chunk. Tiles of a chunk
//    past the batch end (the pad of B up to a multiple of chunk) do not
//    exist: nothing there is read or written.
// 2. `chunk` no longer sizes anything in the block: the tile comes from
//    the plan (dlwp_torch/kernels/overlap_conv.py, _plan), chosen per shape
//    for two blocks and 16 warps an SM where the work has them. Blocks
//    have at most 10 warps at <= 102 registers, so two fit an SM.
// 3. Each input row of a tile is staged once per 8-channel slab: rows
//    h0 - 1 .. h0 + rb of bb samples, full width, with the two wrap
//    columns written beside the row, so the longitude wrap and the 3x3
//    shift are offsets into shared memory. Row interiors go as 16-byte
//    cp.async.cg where W % 4 == 0 and every row is 16-byte aligned, else 4
//    bytes at a time (the same values either way). Weights are read
//    straight from (O, C, 3, 3), 16 bytes at a time where C % 4 == 0: in
//    the persistent form, where they fit (C = 12 and 32 on the flagship),
//    every slab's weights are staged once per block and stay; else each
//    slab's with its rows. A ring of `stages` buffers runs over (tile,
//    slab) units across tile boundaries, so the next tile's first slabs
//    load while this tile's epilogue stores. Row strides are padded so the
//    fragment loads of a warp hit 32 banks.
// 4. Tensor cores: an implicit GEMM with M = output pixels (fragments of 16
//    longitudes of one output row), N = output channels in n8 tiles, K =
//    (8-channel slab) x (9 taps), one mma.sync.m16n8k8 TF32 step per tap
//    and slab (m16n8k4 where a last slab holds 4 channels or fewer, so
//    C = 12 costs 12 channels' products, not 16). Each warp owns two M
//    fragments and `NTW` n8 tiles. fp32
//    accuracy from the 3xTF32 split: v = hi + lo, hi = v rounded to TF32,
//    lo = v - hi (read by the tensor core as TF32), and lo_a hi_b +
//    hi_a lo_b + hi_a hi_b per step, lo_a lo_b dropped. The tensor core
//    truncates its sums, so each slab's 27 products are chained on it and
//    then added to fp32 sums in registers; one chain over all of K drifts
//    past 1e-5 at C = 128 (tests/test_torch_port_overlap.py emulates both).
// 5. No ragged 32-column tiles: W = 144 is 9 fragments exactly, W = 72 is 5
//    with the last 8 columns masked at the store.
//
// 6. Lat neighbours on other cards: the table's sources are the card's own
//    shards, then the neighbours it reads on other cards (source-only
//    entries, no tile of their own). Their edge rows are staged from the
//    peer's memory over NVLink through unified addressing (the TPU
//    kernel's remote DMA, as a pull); the wrapper enables peer access and
//    orders the streams (dlwp_torch/kernels/halo_exchange.py).
//
// Every output sums in the same order (slabs ascending, then dy, then dx,
// then the tensor core's k8 or k4 sum), whatever the tile, so the two
// entry points agree bit for bit.
//
// What bounds it in practice (PERF.md): issuing a stage's copies
// costs about as much as its products, and neither the tensor pipe nor
// issue is saturated. One producer warp, cp.async.bulk per row, and
// operands split once per stage in shared memory were each tried and
// were no faster.

#include <cuda_runtime.h>

#include <cstdint>

#include "tf32_mma.cuh"

namespace {

constexpr int MAX_SHARDS = 64;
constexpr int LM = 4;      // left margin of a staged row, in floats
constexpr int MW = 2;      // M fragments per warp
constexpr int MAX_NTW = 4;  // n8 tiles per warp: 2 x 32 sums in registers
constexpr int MAX_WARPS = 10;  // a block; two fit an SM at <= 102 registers
constexpr int MIN_BLOCKS = 2;

// x: the n outputs' own shards, then source-only entries; y, north,
// south (indices into x): one per output.
struct Table {
  const float* x[MAX_SHARDS];
  float* y[MAX_SHARDS];
  int north[MAX_SHARDS];
  int south[MAX_SHARDS];
};

// Plan values, in the order of the `plan` array of the C entry points.
enum PlanField {
  P_BB, P_RB, P_WARPS, P_STAGES, P_RS, P_NT, P_NTW, P_NOG, P_VEC_X, P_VEC_W,
  P_SMEM, P_TILES, P_RESIDENT, P_FIELDS
};

struct Params {
  Table t;
  const float* k;
  int B, C, H, W, O, n, chunk;
  int bb, rb, rs, nfrag, mf, n_rg, n_og, nslab, tiles, vec_x, vec_w;
  int nsplit;  // warps sharing one fragment pair, NTW n8 tiles each
  int og_width;  // output channels of an o-group, nt n8 tiles
  int xs_floats, ws_floats, stages;
  int resident;  // the weights of every slab stay in shared memory
};

// A tile, with the start of its first sample in its shard and in the
// neighbours' edge rows (the north's last row, the south's first; nullptr
// where there is no neighbour).
struct Tile {
  int s, b0, nb, h0, nr, og;
  const float *north, *self, *south;
};

__device__ __forceinline__ Tile decode(const Params& p, int t) {
  const int ts = p.n_og * p.n * p.n_rg;  // tiles of one sample group
  const int per_chunk = ((p.chunk + p.bb - 1) / p.bb) * ts;
  const int j = t / per_chunk;
  const int r = t % per_chunk;
  const int q = r % ts;
  Tile tl;
  tl.b0 = j * p.chunk + (r / ts) * p.bb;
  tl.nb = min(p.bb, min((j + 1) * p.chunk, p.B) - tl.b0);
  tl.og = q / (p.n * p.n_rg);
  tl.s = (q / p.n_rg) % p.n;
  tl.h0 = (q % p.n_rg) * p.rb;
  tl.nr = min(p.rb, p.H - tl.h0);
  const size_t off = (size_t)tl.b0 * p.C * p.H * p.W;
  const int n = p.t.north[tl.s], so = p.t.south[tl.s];
  tl.self = p.t.x[tl.s] + off;
  tl.north = n >= 0 ? p.t.x[n] + off + (size_t)(p.H - 1) * p.W : nullptr;
  tl.south = so >= 0 ? p.t.x[so] + off : nullptr;
  return tl;
}

// Stage the input rows of slab c0 of tile tl: xs [bl][r][cc][rs] (row r =
// input row h0 - 1 + r, interior at column LM, wrap columns at LM - 1 and
// LM + W).
__device__ void stage_x(float* xs, const Params& p, const Tile& tl, int c0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int W = p.W, H = p.H;
  const int nrows = p.bb * (p.rb + 2) * CS;
  const int nq = p.vec_x ? W / 4 : W;
  // Row index (bl * (rb + 2) + r) * CS + cc, stepped by nwarps without
  // division.
  int cc = warp % CS, r = warp / CS, bl = 0;
  while (r >= p.rb + 2) r -= p.rb + 2, ++bl;
  for (int row = warp; row < nrows; row += nwarps) {
    const int c = c0 + cc;
    const int gr = tl.h0 - 1 + r;
    const float* src = nullptr;
    if (bl < tl.nb && c < p.C && r <= tl.nr + 1) {
      const float* base =
          gr < 0 ? tl.north : (gr >= H ? tl.south : tl.self + (size_t)gr * W);
      if (base) src = base + (size_t)(bl * p.C + c) * H * W;
    }
    float* dst = xs + row * p.rs + LM;
    if (!src) {
      for (int i = lane - 1; i <= W; i += 32) dst[i] = 0.f;
    } else {
      // The interior (quads or floats), then the two wrap columns.
      for (int i = lane; i < nq + 2; i += 32) {
        if (i < nq) {
          if (p.vec_x) {
            cp_async16(dst + 4 * i, src + 4 * i);
          } else {
            cp_async4(dst + i, src + i);
          }
        } else {
          cp_async4(i == nq ? dst - 1 : dst + W, i == nq ? src + W - 1 : src);
        }
      }
    }
    for (cc += nwarps; cc >= CS; cc -= CS) {
      if (++r == p.rb + 2) r = 0, ++bl;
    }
  }
}

// Fragment f of the tile is output row rl of sample bl, columns
// 16 fr .. 16 fr + 15, f = (bl * rb + rl) * nfrag + fr. Warp w takes
// fragments 2 (w / nsplit) and 2 (w / nsplit) + 1, and n8 tiles
// NTW (w % nsplit) .. NTW (w % nsplit) + NTW - 1 of the o-group.
struct Frag {
  int bl, rl, w0, ok;
};

__device__ __forceinline__ Frag frag(const Params& p, int i) {
  int f = ((threadIdx.x >> 5) / p.nsplit) * MW + i;
  Frag fr;
  fr.ok = f < p.mf;
  if (!fr.ok) f = 0;  // computed on valid memory, never stored
  fr.bl = f / (p.rb * p.nfrag);
  fr.rl = (f / p.nfrag) % p.rb;
  fr.w0 = (f % p.nfrag) * 16;
  return fr;
}

// One slab: 9 k8 steps (k4 steps where K4: the slab's channels 4..7 are
// all padding) of 3xTF32 products, chained on the tensor cores into tmp
// (zero on entry). Every (fragment, n8 tile) pair is its own chain, so the
// products of one tap are independent. ws points at this warp's first n8
// tile.
template <int NTW, bool K4>
__device__ __forceinline__ void compute(float (&tmp)[MW][NTW][4],
                                        const float* xs, const float* ws,
                                        const int (&abase)[MW], int rs) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int tap = dy * 3 + dx;
      uint32_t ahi[MW][4], alo[MW][4];
#pragma unroll
      for (int i = 0; i < MW; ++i) {
        const float* a = xs + abase[i] + dy * CS * rs + dx;
        split(a[0], ahi[i][0], alo[i][0]);
        split(a[8], ahi[i][1], alo[i][1]);
        if (!K4) {
          split(a[4 * rs], ahi[i][2], alo[i][2]);
          split(a[4 * rs + 8], ahi[i][3], alo[i][3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        const float* b = ws + (nt * 8 + g) * WR + t * 9 + tap;
        uint32_t b0h, b0l, b1h = 0, b1l = 0;
        split(b[0], b0h, b0l);
        if (!K4) split(b[36], b1h, b1l);
#pragma unroll
        for (int i = 0; i < MW; ++i) {
          if (K4) {
            mma4(tmp[i][nt], alo[i], b0h);
            mma4(tmp[i][nt], ahi[i], b0l);
            mma4(tmp[i][nt], ahi[i], b0h);
          } else {
            mma(tmp[i][nt], alo[i], b0h, b1h);
            mma(tmp[i][nt], ahi[i], b0l, b1l);
            mma(tmp[i][nt], ahi[i], b0h, b1h);
          }
        }
      }
    }
  }
}

template <int NTW>
__device__ __forceinline__ void store(float (&acc)[MW][NTW][4],
                                      const Params& p, const Tile& tl) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int o0 =
      tl.og * p.og_width + ((threadIdx.x >> 5) % p.nsplit) * NTW * 8;
  float* y = p.t.y[tl.s];
#pragma unroll
  for (int i = 0; i < MW; ++i) {
    const Frag fr = frag(p, i);
    const bool row_ok = fr.ok && fr.bl < tl.nb && fr.rl < tl.nr;
    const size_t b = tl.b0 + fr.bl;
    const int h = tl.h0 + fr.rl;
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int w = fr.w0 + g + (j >> 1) * 8;
        const int o = o0 + nt * 8 + 2 * t + (j & 1);
        if (row_ok && w < p.W && o < p.O) {
          y[((b * p.O + o) * p.H + h) * p.W + w] = acc[i][nt][j];
        }
        acc[i][nt][j] = 0.f;
      }
    }
  }
}

// The block walks tiles blockIdx.x, + gridDim.x, ...; unit u is slab
// u % nslab of its (u / nslab)-th tile. A ring of p.stages buffers keeps
// stages - 1 units in flight ahead of the one computed.
// The block walks tiles blockIdx.x, + gridDim.x, ...; unit u is slab k of
// its t-th tile, in buffer u % stages of the ring, which keeps stages - 1
// units in flight ahead of the one computed. Each slab's tensor-core chain
// is added to the fp32 sums: chains over more of K drift past 1e-5 on the
// card.
template <int NTW>
__device__ void run(const Params& p) {
  extern __shared__ __align__(16) float smem[];
  float* wring = smem + p.stages * p.xs_floats;
  const int nw = p.resident ? p.nslab : p.stages;  // weight buffers
  // Margins and pads stay zero (all sizes are multiples of 4 floats).
  for (int i = threadIdx.x; i < (p.stages * p.xs_floats + nw * p.ws_floats) / 4;
       i += blockDim.x)
    reinterpret_cast<float4*>(smem)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  if (p.resident) {  // in the first unit's copy group
    for (int k = 0; k < p.nslab; ++k)
      stage_w(wring + k * p.ws_floats, p.k, p.O, p.C, 0,
              p.ws_floats / WR, k * CS, p.vec_w);
  }

  const int units =
      (p.tiles - blockIdx.x + gridDim.x - 1) / gridDim.x * p.nslab;
  int pf_u = 0, pf_k = 0, pf_t = blockIdx.x, pf_buf = 0;
  Tile pf_tile = decode(p, pf_t);
  auto prefetch = [&]() {
    if (pf_u++ < units) {
      stage_x(smem + pf_buf * p.xs_floats, p, pf_tile, pf_k * CS);
      if (!p.resident) {
        stage_w(wring + pf_buf * p.ws_floats, p.k, p.O, p.C,
                pf_tile.og * p.og_width, p.ws_floats / WR, pf_k * CS,
                p.vec_w);
      }
      if (++pf_k == p.nslab) {
        pf_k = 0;
        pf_t += gridDim.x;
        if (pf_t < p.tiles) pf_tile = decode(p, pf_t);
      }
      if (++pf_buf == p.stages) pf_buf = 0;
    }
    cp_async_commit();
  };

  const int lane = threadIdx.x & 31;
  int abase[MW];
#pragma unroll
  for (int i = 0; i < MW; ++i) {
    const Frag fr = frag(p, i);
    abase[i] = ((fr.bl * (p.rb + 2) + fr.rl) * CS + (lane & 3)) * p.rs +
               LM - 1 + fr.w0 + (lane >> 2);
  }
  const int wbase = ((threadIdx.x >> 5) % p.nsplit) * NTW * 8 * WR;
  float acc[MW][NTW][4] = {}, tmp[MW][NTW][4] = {};

  for (int u = 0; u < p.stages - 1; ++u) prefetch();
  for (int u = 0, k = 0, t = blockIdx.x, buf = 0; u < units; ++u) {
    if (p.stages == 3) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // unit u landed; unit u - 1's buffer is free
    prefetch();
    const float* ws = wring + (p.resident ? k : buf) * p.ws_floats;
    if (p.C - k * CS <= 4) {
      compute<NTW, true>(tmp, smem + buf * p.xs_floats, ws + wbase, abase,
                         p.rs);
    } else {
      compute<NTW, false>(tmp, smem + buf * p.xs_floats, ws + wbase, abase,
                          p.rs);
    }
#pragma unroll
    for (int i = 0; i < MW; ++i)
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][nt][j] += tmp[i][nt][j];
          tmp[i][nt][j] = 0.f;
        }
    if (++k == p.nslab) {
      store<NTW>(acc, p, decode(p, t));
      k = 0;
      t += gridDim.x;
    }
    if (++buf == p.stages) buf = 0;
  }
  cp_async_wait<0>();
}

template <int NTW>
__global__ void __launch_bounds__(MAX_WARPS * 32, MIN_BLOCKS) overlap_kernel(
    const Params p) {
  run<NTW>(p);
}

template <int NTW>
__global__ void __launch_bounds__(MAX_WARPS * 32, MIN_BLOCKS)
    overlap_db_kernel(const Params p) {
  run<NTW>(p);
}

template <int NTW>
int launch(const Params& p, int threads, int smem, bool persistent,
           cudaStream_t stream, int* grid_out) {
  void (*kernel)(const Params) =
      persistent ? &overlap_db_kernel<NTW> : &overlap_kernel<NTW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int grid = p.tiles;
  if (persistent) {
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    grid = sms * per_sm < grid ? sms * per_sm : grid;
  }
  if (grid_out) *grid_out = grid;
  kernel<<<grid, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

int dispatch(const float* const* x, float* const* y, const int* north,
             const int* south, int n, int n_src, const float* k, int B,
             int C, int H, int W, int O, int chunk, const int* plan,
             bool persistent, void* stream, int* grid_out) {
  if (n < 1 || n_src < n || n_src > MAX_SHARDS || chunk < 1 || B < 1 ||
      H < 2)
    return (int)cudaErrorInvalidValue;
  Params p;
  for (int i = 0; i < n_src; ++i) p.t.x[i] = x[i];
  for (int i = 0; i < n; ++i) {
    if (north[i] < -1 || north[i] >= n_src || south[i] < -1 ||
        south[i] >= n_src)
      return (int)cudaErrorInvalidValue;
    p.t.y[i] = y[i];
    p.t.north[i] = north[i];
    p.t.south[i] = south[i];
  }
  p.k = k;
  p.B = B, p.C = C, p.H = H, p.W = W, p.O = O, p.n = n, p.chunk = chunk;
  p.bb = plan[P_BB], p.rb = plan[P_RB], p.rs = plan[P_RS];
  p.n_og = plan[P_NOG], p.vec_x = plan[P_VEC_X], p.vec_w = plan[P_VEC_W];
  p.stages = plan[P_STAGES], p.tiles = plan[P_TILES];
  p.nfrag = (W + 15) / 16;
  p.mf = p.bb * p.rb * p.nfrag;
  p.n_rg = (H + p.rb - 1) / p.rb;
  p.nslab = (C + CS - 1) / CS;
  const int nt = plan[P_NT], ntw = plan[P_NTW];
  p.nsplit = ntw > 0 ? nt / ntw : 0;
  p.xs_floats = p.bb * (p.rb + 2) * CS * p.rs;
  p.og_width = nt * 8;
  p.ws_floats = nt * 8 * WR;
  p.resident = plan[P_RESIDENT];
  const int threads = plan[P_WARPS] * 32;
  const int smem = plan[P_SMEM];
  if (nt < 1 || nt > 8 || ntw < 1 || ntw > MAX_NTW || nt % ntw ||
      p.bb < 1 || p.rb < 1 ||
      plan[P_WARPS] != (p.mf + MW - 1) / MW * p.nsplit ||
      plan[P_WARPS] > MAX_WARPS || (p.stages != 2 && p.stages != 3) ||
      p.rs < LM + 16 * p.nfrag + 1 || p.rs % 4 || p.tiles < 1 ||
      (p.resident && p.n_og != 1) ||
      smem != (p.stages * p.xs_floats +
               (p.resident ? p.nslab : p.stages) * p.ws_floats) *
                  (int)sizeof(float))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (ntw) {
    case 1: return launch<1>(p, threads, smem, persistent, s, grid_out);
    case 2: return launch<2>(p, threads, smem, persistent, s, grid_out);
    case 3: return launch<3>(p, threads, smem, persistent, s, grid_out);
    case 4: return launch<4>(p, threads, smem, persistent, s, grid_out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int dlwp_overlap_conv_max_shards() { return MAX_SHARDS; }

// Both launch on `stream` and return the first CUDA error of the set-up
// (shared-memory attribute, occupancy query) or cudaGetLastError() after
// the launch (0 = ok). x: n_src >= n shard pointers (host array), the n
// outputs' own shards first; y, north, south: one per output, north and
// south indexing x; plan: the P_FIELDS values of the wrapper's _plan;
// grid_out receives the blocks launched.
extern "C" int dlwp_overlap_conv(const float* const* x, float* const* y,
                                 const int* north, const int* south, int n,
                                 int n_src, const float* k, int B, int C,
                                 int H, int W, int O, const int* plan,
                                 void* stream, int* grid_out) {
  return dispatch(x, y, north, south, n, n_src, k, B, C, H, W, O, B, plan,
                  false, stream, grid_out);
}

extern "C" int dlwp_overlap_conv_db(const float* const* x, float* const* y,
                                    const int* north, const int* south, int n,
                                    int n_src, const float* k, int B, int C,
                                    int H, int W, int O, int chunk,
                                    const int* plan, void* stream,
                                    int* grid_out) {
  return dispatch(x, y, north, south, n, n_src, k, B, C, H, W, O, chunk,
                  plan, true, stream, grid_out);
}
