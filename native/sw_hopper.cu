// Banded Smith-Waterman x-drop extension endpoints for Hopper (sm_90a),
// called from JAX through the XLA foreign function interface.
//
// Same recurrence, band schedule, pruning and tie-breaks as the NumPy
// mirror `_sw_numpy_core` in npge_tpu/ops/sw.py, which is the
// specification (the results are bit-identical):
//
//   anti-diagonal d = i + j; band cell r in [0, W) holds i = ib(d) + r with
//   ib(d) = (d+1)/2 - W/2. diag source (i-1, j-1) is cell r of d-2; up
//   (i-1, j) is cell r-1 (d even) / r (d odd) of d-1; left (i, j-1) is
//   cell r (d even) / r+1 (d odd) of d-1.
//
// Layout: one warp per pair, W = 128 band cells, 4 consecutive cells per
// lane held in registers. The parity shift needs one cell from the
// neighbouring lane per diagonal (one shuffle). The per-diagonal max and
// its smallest band index come from one warp reduction of the packed key
// score*128 + (127 - r). The pair's two padded rows (L + 2W bytes each)
// sit in shared memory; a diagonal's 4 characters per lane are one
// unaligned 32-bit read per row, compared bytewise with __vcmpeq4.
// Device memory is touched only to load the rows and store 3 int32.
//
// Inputs: qp, trp uint8[P, L+2W] (layout built by ops/sw.py), qlen, tlen
// int32[P] (<= L). Output: int32[P, 3] = (best score, best i, best j).
//
// Build: make -C native cuda

#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kW = 128;              // band width (SW_BAND)
constexpr int kCells = kW / 32;      // band cells per lane
constexpr int kNeg = -(1 << 29);     // pruned / unreachable cell
constexpr int kKeyFloor = -(1 << 23);  // keeps score*128 inside int32
constexpr int kPairsPerBlock = 8;    // one warp per pair
constexpr unsigned kFull = 0xffffffffu;

static_assert(kCells == 4, "one 32-bit character read per lane");

struct Params {
  int L;
  int row_bytes;   // L + 2W
  int row_words;   // shared-memory words per row, incl. one spare word
  int match, mismatch, gap, xdrop;
};

// row[a .. a+3] as a little-endian word from word-aligned shared memory
__device__ __forceinline__ uint32_t load4(const uint32_t* row, int a) {
  const uint32_t lo = row[a >> 2];
  const uint32_t hi = row[(a >> 2) + 1];
  return __funnelshift_r(lo, hi, (a & 3) * 8);
}

template <bool kEven>
__device__ __forceinline__ void diagonal(
    int d, int lane, const uint32_t* qs, const uint32_t* ts, int qlen,
    int tlen, const Params& p, int (&prev2)[kCells], int (&prev)[kCells],
    int& best, int& bi, int& bj) {
  const int r0 = lane * kCells;
  const int ib = (d + 1) / 2 - kW / 2;
  const uint32_t eq = __vcmpeq4(load4(qs, kW + ib - 1 + r0),
                                load4(ts, kW + 1 + p.L - d + ib + r0));
  // even d: up[r] = prev[r-1]; odd d: left[r] = prev[r+1]
  int nb = kEven ? __shfl_up_sync(kFull, prev[kCells - 1], 1)
                 : __shfl_down_sync(kFull, prev[0], 1);
  if (kEven && lane == 0) nb = kNeg;
  if (!kEven && lane == 31) nb = kNeg;
  const int thr = best - p.xdrop;
  int s[kCells];
  int key = INT32_MIN;
#pragma unroll
  for (int k = 0; k < kCells; ++k) {
    const int r = r0 + k;
    const int i = ib + r;
    const int j = d - i;
    const int up = kEven ? (k == 0 ? nb : prev[k - 1]) : prev[k];
    const int left = kEven ? prev[k] : (k == kCells - 1 ? nb : prev[k + 1]);
    const bool inside = (i <= qlen) & (j <= tlen);
    const int sub = ((eq >> (8 * k)) & 1u) ? p.match : p.mismatch;
    int v = kNeg;
    if (inside & (i >= 1) & (j >= 1)) v = prev2[k] + sub;
    if (inside & (i >= 1) & (j >= 0)) v = max(v, up + p.gap);
    if (inside & (i >= 0) & (j >= 1)) v = max(v, left + p.gap);
    if (v < thr) v = kNeg;
    s[k] = v;
    key = max(key, max(v, kKeyFloor) * kW + (kW - 1 - r));
  }
  key = __reduce_max_sync(kFull, key);
  const int col_best = key >> 7;  // floor(key / 128): the diagonal's max
  if (col_best > best) {
    bi = ib + (kW - 1 - (key & (kW - 1)));  // smallest r reaching the max
    bj = d - bi;
    best = col_best;
  }
#pragma unroll
  for (int k = 0; k < kCells; ++k) {
    prev2[k] = prev[k];
    prev[k] = s[k];
  }
}

__global__ void __launch_bounds__(32 * kPairsPerBlock)
sw_xdrop_kernel(const uint8_t* __restrict__ qp, const uint8_t* __restrict__ trp,
                const int32_t* __restrict__ qlen_g,
                const int32_t* __restrict__ tlen_g, int32_t* __restrict__ out,
                int64_t n_pairs, Params p) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t pair = int64_t(blockIdx.x) * kPairsPerBlock + warp;
  if (pair >= n_pairs) return;  // whole warp leaves; no block barrier used
  uint32_t* qs = smem + (2 * warp) * p.row_words;
  uint32_t* ts = qs + p.row_words;
  uint8_t* qs8 = reinterpret_cast<uint8_t*>(qs);
  uint8_t* ts8 = reinterpret_cast<uint8_t*>(ts);
  const uint8_t* qrow = qp + pair * p.row_bytes;
  const uint8_t* trow = trp + pair * p.row_bytes;
  for (int x = lane; x < 4 * p.row_words; x += 32) {
    const bool in = x < p.row_bytes;
    qs8[x] = in ? qrow[x] : uint8_t(254);
    ts8[x] = in ? trow[x] : uint8_t(255);
  }
  __syncwarp();
  const int qlen = qlen_g[pair];
  const int tlen = tlen_g[pair];

  int prev2[kCells], prev[kCells];
  int m = kNeg;
#pragma unroll
  for (int k = 0; k < kCells; ++k) {
    const int r = lane * kCells + k;
    prev2[k] = (r == kW / 2) ? 0 : kNeg;  // d = 0: only (0, 0)
    const int i1 = 1 - kW / 2 + r;         // d = 1
    const int j1 = 1 - i1;
    const bool ok1 = (i1 == 1 && j1 == 0 && qlen >= 1) ||
                     (i1 == 0 && j1 == 1 && tlen >= 1);
    prev[k] = ok1 ? p.gap : kNeg;
    m = max(m, prev[k]);
  }
  int best = max(0, __reduce_max_sync(kFull, m));
  int bi = 0, bj = 0;
  const int last = 2 * p.L;
  int d = 2;
  for (; d + 1 <= last; d += 2) {
    diagonal<true>(d, lane, qs, ts, qlen, tlen, p, prev2, prev, best, bi, bj);
    diagonal<false>(d + 1, lane, qs, ts, qlen, tlen, p, prev2, prev, best,
                    bi, bj);
  }
  if (d <= last) {
    diagonal<true>(d, lane, qs, ts, qlen, tlen, p, prev2, prev, best, bi, bj);
  }
  if (lane == 0) {
    out[3 * pair + 0] = best;
    out[3 * pair + 1] = bi;
    out[3 * pair + 2] = bj;
  }
}

ffi::Error SwXdropImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> qp,
                       ffi::Buffer<ffi::U8> trp, ffi::Buffer<ffi::S32> qlen,
                       ffi::Buffer<ffi::S32> tlen,
                       ffi::ResultBuffer<ffi::S32> out, int32_t L,
                       int32_t match, int32_t mismatch, int32_t gap,
                       int32_t xdrop) {
  const auto dims = qp.dimensions();
  if (dims.size() != 2) return ffi::Error::InvalidArgument("qp must be 2-D");
  const int64_t n_pairs = dims[0];
  const int64_t row_bytes = dims[1];
  if (L < 1 || row_bytes != int64_t(L) + 2 * kW) {
    return ffi::Error::InvalidArgument(
        "rows must hold L + 2*128 bytes, got " + std::to_string(row_bytes));
  }
  if (trp.element_count() != qp.element_count() ||
      qlen.element_count() != size_t(n_pairs) ||
      tlen.element_count() != size_t(n_pairs) ||
      out->element_count() != size_t(3 * n_pairs)) {
    return ffi::Error::InvalidArgument("inconsistent pair counts");
  }
  if (n_pairs == 0) return ffi::Error::Success();
  Params p;
  p.L = L;
  p.row_bytes = int(row_bytes);
  p.row_words = int((row_bytes + 3) / 4) + 1;
  p.match = match;
  p.mismatch = mismatch;
  p.gap = gap;
  p.xdrop = xdrop;
  const size_t smem = size_t(kPairsPerBlock) * 2 * p.row_words * 4;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sw_xdrop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (e != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(e));
  }
  const int64_t blocks = (n_pairs + kPairsPerBlock - 1) / kPairsPerBlock;
  sw_xdrop_kernel<<<dim3(unsigned(blocks)), dim3(32 * kPairsPerBlock), smem,
                    stream>>>(qp.typed_data(), trp.typed_data(),
                              qlen.typed_data(), tlen.typed_data(),
                              out->typed_data(), n_pairs, p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(e));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    NpgeSwXdrop, SwXdropImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::U8>>()
        .Arg<ffi::Buffer<ffi::U8>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Ret<ffi::Buffer<ffi::S32>>()
        .Attr<int32_t>("L")
        .Attr<int32_t>("match")
        .Attr<int32_t>("mismatch")
        .Attr<int32_t>("gap")
        .Attr<int32_t>("xdrop"));
