// Latitude halo exchange between the lat-band shards of a mesh, for Hopper
// (sm_90a).
//
// Replaces: dlwp_tpu/parallel/pallas_halo.py, _halo_kernel (via
// _pallas_halo_local and pallas_halo_exchange_lat). For every shard s of
// one card, with its (rows, H, W) block x_s (rows = the product of the
// leading dims) and halo (top, bot), writes the padded block
//     out_s = [bottom `top` rows of the northern neighbour | x_s |
//              top `bot` rows of the southern neighbour]
// of shape (rows, top + H + bot, W), with zeros where a shard has no
// neighbour (north of the first band, south of the last). The values are
// copied bit for bit, whatever the dtype.
//
// Bound on an H100 SXM: a copy, so bytes (each input read once, each output
// written once) over 3.35 TB/s. At the flagship's ConvLSTM input conv on a
// lat=2 mesh, two shards of (128, 3, 18, 144) fp32 with halo (2, 2), that
// is 8.0 MB in and 9.7 MB out, about 5.3 us. With the two shards on two
// cards, each reads its neighbour's 2 edge rows of 384 blocks (0.44 MB)
// over NVLink at 450 GB/s each way: about 1 us beside the local copy.
//
// Design: the TPU kernel ships each shard's edge rows to both neighbours as
// remote DMAs, then zeroes the wrap halos outside the kernel; the edge
// slabs are pre-sliced and the output split in three refs because Mosaic
// wants 128-lane-aligned slices. None of that carries over. Here one launch
// covers every shard on the card: the kernel parameters hold a table of
// sources (the card's own shards, then the lat neighbours on other cards
// that they read), the card's outputs, and each output's neighbour indices
// into the sources (-1 for none). A shard reads its neighbours' edge rows
// directly from their allocations: a pull. A neighbour on another card is
// read over NVLink through unified addressing, the counterpart of the
// TPU's remote DMA; the wrapper enables peer access for the pair
// (dlwp_enable_peer_access) and orders the streams (this card's stream
// waits on the other card's before the launch). The sources exist before
// the launch, so no block waits on another and no flag is spun on. A warp
// copies one output row at a time in units of 16, 8, 4, 2 or 1 bytes: the
// widest that divides the row and every pointer, chosen by the caller.
// Blocks are (32 lanes, 8 rows), the grid's y is the card's own shard.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MAX_SHARDS = 64;
constexpr int LANES = 32;
constexpr int ROWS_PER_BLOCK = 8;

// src: the card's n outputs' own shards, then source-only entries (lat
// neighbours on other cards); dst, north, south: one per output.
struct Table {
  const void* src[MAX_SHARDS];
  void* dst[MAX_SHARDS];
  int north[MAX_SHARDS];
  int south[MAX_SHARDS];
};

template <typename U>
__global__ void __launch_bounds__(LANES * ROWS_PER_BLOCK)
halo_kernel(const Table t, int rows, int H, int Wu, int top, int bot) {
  const int s = blockIdx.y;
  const int Hp = top + H + bot;
  const int n_out = rows * Hp;
  const U* src = static_cast<const U*>(t.src[s]);
  const U* north = t.north[s] >= 0 ? static_cast<const U*>(t.src[t.north[s]])
                                   : nullptr;
  const U* south = t.south[s] >= 0 ? static_cast<const U*>(t.src[t.south[s]])
                                   : nullptr;
  U* dst = static_cast<U*>(t.dst[s]);
  for (int orow = blockIdx.x * ROWS_PER_BLOCK + threadIdx.y; orow < n_out;
       orow += gridDim.x * ROWS_PER_BLOCK) {
    const int bc = orow / Hp;
    const int r = orow - bc * Hp;
    const U* from = nullptr;
    if (r < top) {
      if (north) from = north + ((size_t)bc * H + H - top + r) * Wu;
    } else if (r < top + H) {
      from = src + ((size_t)bc * H + r - top) * Wu;
    } else if (south) {
      from = south + ((size_t)bc * H + r - top - H) * Wu;
    }
    U* to = dst + (size_t)orow * Wu;
    for (int w = threadIdx.x; w < Wu; w += LANES) to[w] = from ? from[w] : U{};
  }
}

template <typename U>
int launch(const Table& t, int n, int rows, int H, int row_bytes, int top,
           int bot, cudaStream_t stream) {
  const int Wu = row_bytes / (int)sizeof(U);
  const int n_out = rows * (top + H + bot);
  const int bx = (n_out + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  const dim3 grid(bx < 8192 ? bx : 8192, n);
  const dim3 block(LANES, ROWS_PER_BLOCK);
  halo_kernel<U><<<grid, block, 0, stream>>>(t, rows, H, Wu, top, bot);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dlwp_halo_exchange_max_shards() { return MAX_SHARDS; }

// Lets `device` read `peer`'s memory (cudaDeviceEnablePeerAccess from
// `device`); access already enabled counts as success. The calling
// thread's current device is restored. Returns 0 or the CUDA error.
extern "C" int dlwp_enable_peer_access(int device, int peer) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear it, so the next launch check sees none
    err = cudaSuccess;
  }
  const cudaError_t back = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : back);
}

// Launches on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// src: n_src >= n entries, the n outputs' own shards first; north and
// south index src. `unit` (16, 8, 4, 2 or 1) must divide row_bytes and
// every pointer.
extern "C" int dlwp_halo_exchange(const void* const* src, void* const* dst,
                                  const int* north, const int* south, int n,
                                  int n_src, int rows, int H, int row_bytes,
                                  int unit, int top, int bot, void* stream) {
  if (n < 1 || n_src < n || n_src > MAX_SHARDS)
    return (int)cudaErrorInvalidValue;
  Table t;
  for (int i = 0; i < n_src; ++i) t.src[i] = src[i];
  for (int i = 0; i < n; ++i) {
    if (north[i] < -1 || north[i] >= n_src || south[i] < -1 ||
        south[i] >= n_src)
      return (int)cudaErrorInvalidValue;
    t.dst[i] = dst[i];
    t.north[i] = north[i];
    t.south[i] = south[i];
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (unit) {
    case 16: return launch<uint4>(t, n, rows, H, row_bytes, top, bot, st);
    case 8: return launch<uint2>(t, n, rows, H, row_bytes, top, bot, st);
    case 4: return launch<uint32_t>(t, n, rows, H, row_bytes, top, bot, st);
    case 2: return launch<uint16_t>(t, n, rows, H, row_bytes, top, bot, st);
    case 1: return launch<uint8_t>(t, n, rows, H, row_bytes, top, bot, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
