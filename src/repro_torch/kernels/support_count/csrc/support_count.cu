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
// database is read as it is, and the engine calls one launch per superstep
// over the flat [T * m_tile, W] view instead of one per 4096-item tile.
//
// Bound on an H100 SXM.  Each output costs W x (AND + POPC + ADD).  POPC
// issues at 16 per clock per SM on sm_90 (the CUDA programming guide's
// arithmetic-instruction throughput table), against 64 per clock for
// 32-bit AND and ADD, so the operation bound is B*M*W / (16 * 132 SMs *
// clock).  The bytes that must move are (M*W + B*W + B*M) * 4 at
// 3.35 TB/s.  At the engine's full-width hapmap_dom_20 shape (B = P*B_exp =
// 128, M = 12,288, W = 22) that is 34.6 M popcounts, about 8.3 us at a
// 1.98 GHz clock, against 7.4 MB, about 2.2 us: the kernel is
// popcount-bound, and at that size a launch costs as much as the work.
//
// What the design does about it.  Every word the POPC unit sees comes from
// shared memory, so the loads never compete with it: a block of 128 threads
// owns 128 items x 8 rows, stages its [8, Wc] occ rows and its [128, Wc]
// database slab in shared memory in W chunks of at most 32 words (W = 400,
// as in mcf7, works the same), and each thread keeps its 8 row sums in
// registers.  The occ chunk is stored [Wc][8] so one word's 8 row values
// come in two 16-byte broadcast loads; the database slab rows are padded to
// 33 words so thread t reading row t, word c hits bank (t + c) % 32 with no
// conflict.  The grid is (ceil(M / 128), ceil(B / 8)); ragged edges are
// masked in the kernel, and the stores are coalesced along j.  Faster
// variants (binary MMA: mma.sync ... .b1 ... .and.popc; CUDA graphs over
// supersteps) are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockM = 128;  // items per block: one per thread
constexpr int kBlockB = 8;    // occ rows per block: 8 register sums per thread
constexpr int kChunkW = 32;   // words staged in shared memory per pass

__global__ void __launch_bounds__(kBlockM)
support_count_kernel(const uint32_t* __restrict__ occ,
                     const uint32_t* __restrict__ db,
                     int32_t* __restrict__ out, int B, int M, int W) {
  __shared__ __align__(16) uint32_t s_occ[kChunkW][kBlockB];
  __shared__ uint32_t s_db[kBlockM][kChunkW + 1];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBlockM;
  const int b0 = blockIdx.y * kBlockB;

  int acc[kBlockB];
#pragma unroll
  for (int r = 0; r < kBlockB; ++r) acc[r] = 0;

  for (int w0 = 0; w0 < W; w0 += kChunkW) {
    const int wc = min(kChunkW, W - w0);
    // occ rows b0..b0+7, words w0..w0+wc: read along w, store [c][r]
    for (int i = tid; i < kBlockB * wc; i += kBlockM) {
      const int r = i / wc;
      const int c = i - r * wc;
      const int b = b0 + r;
      s_occ[c][r] = b < B ? occ[(size_t)b * W + w0 + c] : 0u;
    }
    // database rows m0..m0+127, words w0..w0+wc: one contiguous run of
    // global memory when wc == W
    for (int i = tid; i < kBlockM * wc; i += kBlockM) {
      const int r = i / wc;
      const int c = i - r * wc;
      const int m = m0 + r;
      s_db[r][c] = m < M ? db[(size_t)m * W + w0 + c] : 0u;
    }
    __syncthreads();
    for (int c = 0; c < wc; ++c) {
      const uint32_t d = s_db[tid][c];
      const uint4 lo = *reinterpret_cast<const uint4*>(&s_occ[c][0]);
      const uint4 hi = *reinterpret_cast<const uint4*>(&s_occ[c][4]);
      acc[0] += __popc(lo.x & d);
      acc[1] += __popc(lo.y & d);
      acc[2] += __popc(lo.z & d);
      acc[3] += __popc(lo.w & d);
      acc[4] += __popc(hi.x & d);
      acc[5] += __popc(hi.y & d);
      acc[6] += __popc(hi.z & d);
      acc[7] += __popc(hi.w & d);
    }
    __syncthreads();
  }

  const int j = m0 + tid;
  if (j < M) {
#pragma unroll
    for (int r = 0; r < kBlockB; ++r) {
      const int b = b0 + r;
      if (b < B) out[(size_t)b * M + j] = acc[r];
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
int sc_support_count(const void* occ, const void* db, void* out, int B, int M,
                     int W, void* stream) {
  const dim3 grid((M + kBlockM - 1) / kBlockM, (B + kBlockB - 1) / kBlockB);
  support_count_kernel<<<grid, kBlockM, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(occ), static_cast<const uint32_t*>(db),
      static_cast<int32_t*>(out), B, M, W);
  return static_cast<int>(cudaGetLastError());
}

const char* sc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
