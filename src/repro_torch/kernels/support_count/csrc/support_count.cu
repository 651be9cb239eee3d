// Popcount-semiring GEMM for itemset support counting, CUDA C++ for sm_90a.
//
//   S[b, j] = sum_w popcount(occ[b, w] & db[j, w])
//
//   occ  [B, W]  32-bit words  occurrence bitmaps of the popped nodes
//   db   [M, W]  32-bit words  transaction database, item-major (W contiguous)
//   S    [B, M]  int32         support of every extension of every node
//
// Replaces the TPU kernel src/repro/kernels/support_count/kernel.py::
// support_count_pallas (body _support_count_kernel; pl.pallas_call at :67).
// That kernel wanted the database word-major so items lay across the TPU's
// 128 lanes and took a transpose per item tile; here the item-major [M, W]
// database is read as it is, and the engine makes one launch per superstep
// over the flat [T * m_tile, W] view instead of one per 4096-item tile.
//
// Bound on an H100 SXM: bytes.  The bytes that must move are
// (M*W + B*W + B*M) * 4 at 3.35 TB/s; S alone is B*M*4.  The AND+popcount
// runs on the tensor cores: mma.sync m16n8k256 .b1 .and.popc covers 8 words
// of K for a 16 x 8 output fragment.  Counting each bit as one int8
// multiply-add at the published 1,979 TOP/s int8 rate (the b1 rate is not
// published), the operations take 2*B*M*32W / 1.979e15 s, about half the
// bytes term at W = 22 and a third at W = 12.  At the engine's alz_rec_30
// shape (B = 128, M = 253,952, W = 12) that is 142 MB, 42.5 us, of which S
// is 130 MB; at hapmap_dom_20 (128, 12,288, 22) 7.4 MB, 2.2 us, near the
// launch floor.
//
// What the design does about it.
//  * Every word is counted by the binary tensor cores, none by __popc.  A
//    warp owns 16 occ rows (the row-major A operand) and sweeps 8 fragments
//    of 8 items (the item-major database is already the column-major B
//    operand).  W is padded to a multiple of 8 words in shared memory only:
//    occ's pad words are zero, so whatever the database holds there counts
//    nothing.
//  * The database is read once per row block, streamed through a ring of
//    kStages tiles of kTileItems items by 16-byte cp.async: a tile is one
//    contiguous run of kTileItems * W words, copied flat (a 2-D TMA map
//    would need a 16-byte row stride, and W = 22 gives 88 bytes), so the
//    next tiles' copies overlap this tile's MMAs.  The wrapper checks that
//    occ, db and S are 16-byte aligned.
//  * occ stays resident: a block copies its <= 128 rows once, by 4-byte
//    cp.async in the first commit group, and walks many item tiles, one of
//    a persistent grid no larger than the resident slots the occupancy API
//    reports.  When the tiles would not give every SM two blocks, the rows
//    are split across more, narrower blocks.  Above kFlatMaxW words both
//    operands are staged per (tile, K chunk of kChunkW words) instead, by
//    4-byte cp.async.
//  * S is written once: each warp passes its accumulators through shared
//    memory and stores whole rows of its tile along j, 16 bytes a lane
//    when M % 4 == 0 (every row then starts 16-byte aligned), else 4 bytes
//    a lane, coalesced.  Ragged B and M edges are masked here.  Rows that
//    start off a 16-byte boundary leave S's edge sectors to two tiles;
//    16-byte stores from each row's first boundary on did not help.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileItems = 64;                // items per tile
constexpr int kFrags = kTileItems / 8;        // n8 fragments per tile
constexpr int kMaxWarps = 8;                  // 16 occ rows per warp
constexpr int kStages = 3;                    // depth of the database ring
constexpr int kFlatMaxW = 64;                 // widest W with occ resident
constexpr int kChunkW = 32;                   // K chunk above kFlatMaxW
constexpr int kOutLd = kTileItems + 8;        // s_out row stride, words

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Shared-memory plan, the same on host and device.  Row strides are
// 4 mod 8 words, so the A-fragment loads (8 rows x 4 words) hit 32 banks.
struct Plan {
  bool flat;       // W <= kFlatMaxW: occ resident, database tiles flat
  int kw;          // words of K per unit: W rounded to 8, or kChunkW
  int ld_occ;      // word stride of an occ row in shared memory
  int ld_db;       // word stride of a database item in shared memory
  int occ_words;   // flat: the resident occ; chunked: occ part of a stage
  int stage_words; // one ring slot
  int out_words;   // accumulator staging, all warps

  __host__ __device__ Plan(int W, int warps) {
    const int rows = warps * 16;
    flat = W <= kFlatMaxW;
    kw = flat ? round_up(W, 8) : kChunkW;
    ld_occ = kw + 4;
    occ_words = rows * ld_occ;
    if (flat) {
      // the last item's padded k-step reads up to 7 words past the tile
      ld_db = W;
      stage_words = round_up(kTileItems * W + 8, 4);
    } else {
      ld_db = kChunkW + 4;
      stage_words = occ_words + kTileItems * ld_db;
    }
    out_words = warps * 16 * kOutLd;
  }
  __host__ __device__ int words() const {
    return (flat ? occ_words : 0) + kStages * stage_words + out_words;
  }
};

__device__ __forceinline__ void cp_async16(uint32_t* dst, const uint32_t* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src,
                                          int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// c[16 x 8] += popcount(a[16 x 256 bits] & b[256 bits x 8]).  Fragments:
// a0/a2 row g, a1/a3 row g + 8, words t and t + 4 of the 8-word K step;
// b0/b1 item g, words t and t + 4; c0,c1 row g and c2,c3 row g + 8, items
// 2t and 2t + 1 (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void mma_and_popc(int (&c)[4], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// grid (row blocks, item-tile groups); block = warps x 32 threads, each
// warp 16 rows.  Block (x, y) owns rows [x * rows, +rows) and item tiles
// y, y + gridDim.y, ...; a unit is one (tile, K chunk) pair.
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
support_count_kernel(const uint32_t* __restrict__ occ,
                     const uint32_t* __restrict__ db,
                     int32_t* __restrict__ out, int B, int M, int W) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int warps = blockDim.x >> 5;
  const Plan p(W, warps);
  const int rows = warps * 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * rows;
  const int ntiles = (M + kTileItems - 1) / kTileItems;
  const int nchunks = p.flat ? 1 : (W + kChunkW - 1) / kChunkW;
  const int gy = blockIdx.y, ny = gridDim.y;
  const int units = ((ntiles - 1 - gy) / ny + 1) * nchunks;  // gy < ntiles

  uint32_t* s_occ = smem;
  uint32_t* s_ring = smem + (p.flat ? p.occ_words : 0);
  int32_t* s_out = reinterpret_cast<int32_t*>(s_ring + kStages * p.stage_words)
                   + warp * 16 * kOutLd;

  auto tile_of = [&](int u) { return gy + (u / nchunks) * ny; };

  auto issue = [&](int u) {
    uint32_t* st = s_ring + (u % kStages) * p.stage_words;
    const int j0 = tile_of(u) * kTileItems;
    const int items = min(kTileItems, M - j0);
    if (p.flat) {
      const uint32_t* src = db + static_cast<size_t>(j0) * W;
      const int words = items * W;
      for (int i = tid * 4; i < words; i += blockDim.x * 4)
        cp_async16(st + i, src + i, min(16, (words - i) * 4));
    } else {
      const int k0 = (u % nchunks) * kChunkW;
      const int kc = min(kChunkW, W - k0);
      for (int i = tid; i < (rows + kTileItems) * kChunkW; i += blockDim.x) {
        const int r = i / kChunkW, k = i - r * kChunkW;
        const uint32_t* src;
        uint32_t* dst;
        bool ok;
        if (r < rows) {
          const int b = row0 + r;
          ok = b < B && k < kc;
          src = occ + static_cast<size_t>(ok ? b : 0) * W + k0 + (ok ? k : 0);
          dst = st + r * p.ld_occ + k;
        } else {
          const int j = r - rows;
          ok = j < items && k < kc;
          src = db + static_cast<size_t>(ok ? j0 + j : 0) * W + k0 + (ok ? k : 0);
          dst = st + p.occ_words + j * p.ld_db + k;
        }
        cp_async4(dst, src, ok ? 4 : 0);  // 0 bytes: zero-fill
      }
    }
  };

  if (p.flat) {  // the resident occ rows, zero past B and past W; these
                 // copies join unit 0's commit group
    for (int i = tid; i < rows * p.kw; i += blockDim.x) {
      const int r = i / p.kw, k = i - r * p.kw, b = row0 + r;
      const bool ok = b < B && k < W;
      cp_async4(s_occ + r * p.ld_occ + k,
                occ + (ok ? static_cast<size_t>(b) * W + k : 0), ok ? 4 : 0);
    }
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < units) issue(s);
    cp_async_commit();
  }

  int acc[kFrags][4];
#pragma unroll
  for (int n = 0; n < kFrags; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0;

  for (int u = 0; u < units; ++u) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // unit u landed; slot (u - 1) % kStages is free
    if (u + kStages - 1 < units) issue(u + kStages - 1);
    cp_async_commit();

    const int chunk = u % nchunks;
    const uint32_t* st = s_ring + (u % kStages) * p.stage_words;
    const uint32_t* a = (p.flat ? s_occ : st) + (warp * 16 + g) * p.ld_occ + t;
    const uint32_t* bq = (p.flat ? st : st + p.occ_words) + g * p.ld_db + t;
    const int kw = p.flat ? p.kw : min(kChunkW, W - chunk * kChunkW);
    const int a8 = 8 * p.ld_occ;
    for (int k = 0; k < kw; k += 8) {
      const uint32_t a0 = a[k], a1 = a[a8 + k], a2 = a[k + 4], a3 = a[a8 + k + 4];
#pragma unroll
      for (int n = 0; n < kFrags; ++n) {
        const uint32_t* b = bq + n * 8 * p.ld_db + k;
        mma_and_popc(acc[n], a0, a1, a2, a3, b[0], b[4]);
      }
    }
    if (chunk != nchunks - 1) continue;

    // epilogue: the warp's [16, kTileItems] tile through shared memory
#pragma unroll
    for (int n = 0; n < kFrags; ++n) {
      *reinterpret_cast<int2*>(s_out + g * kOutLd + n * 8 + 2 * t) =
          make_int2(acc[n][0], acc[n][1]);
      *reinterpret_cast<int2*>(s_out + (g + 8) * kOutLd + n * 8 + 2 * t) =
          make_int2(acc[n][2], acc[n][3]);
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0;
    }
    __syncwarp();
    const int j0 = tile_of(u) * kTileItems;
    const int b0 = row0 + warp * 16;
    if ((M & 3) == 0) {  // 16 lanes x 16 bytes per row, two rows a pass
      const int c = (lane & 15) * 4;
      for (int r = lane >> 4; r < 16 && b0 + r < B; r += 2) {
        if (j0 + c < M)
          *reinterpret_cast<int4*>(out + static_cast<size_t>(b0 + r) * M + j0 + c) =
              *reinterpret_cast<const int4*>(s_out + r * kOutLd + c);
      }
    } else {
      for (int r = 0; r < 16 && b0 + r < B; ++r) {
        for (int c = lane; c < kTileItems && j0 + c < M; c += 32)
          out[static_cast<size_t>(b0 + r) * M + j0 + c] = s_out[r * kOutLd + c];
      }
    }
    __syncwarp();
  }
  cp_async_wait<0>();
}

}  // namespace

extern "C" {

// Launches on `stream`; returns 0, or the CUDA error of the launch or of
// the calls that size it.  occ, db and out must be 16-byte aligned.
int sc_support_count(const void* occ, const void* db, void* out, int B, int M,
                     int W, void* stream) {
  if (B <= 0 || M <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);

  // Rows per block: up to 128, fewer when the item tiles alone would not
  // give every SM two blocks.
  const int ntiles = (M + kTileItems - 1) / kTileItems;
  int warps = min(kMaxWarps, (B + 15) / 16);
  int row_blocks = (B + 16 * warps - 1) / (16 * warps);
  while (warps > 1 && static_cast<long long>(row_blocks) * ntiles < 2 * sms) {
    warps = (warps + 1) / 2;
    row_blocks = (B + 16 * warps - 1) / (16 * warps);
  }
  const int threads = warps * 32;
  const size_t bytes = static_cast<size_t>(Plan(W, warps).words()) * 4;

  err = cudaFuncSetAttribute(support_count_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, support_count_kernel, threads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);

  // A persistent grid: no more blocks than fit at once, each walking tiles.
  const long long resident = static_cast<long long>(per_sm) * sms;
  const long long groups = resident / row_blocks > 1 ? resident / row_blocks : 1;
  const int grid_y = static_cast<int>(groups < ntiles ? groups : ntiles);
  support_count_kernel<<<dim3(row_blocks, grid_y), threads, bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(occ), static_cast<const uint32_t*>(db),
      static_cast<int32_t*>(out), B, M, W);
  return static_cast<int>(cudaGetLastError());
}

const char* sc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
