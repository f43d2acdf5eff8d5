// Quasi-Newton ring-buffer roll + select + Gram dots, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `qn_roll_update` (paropt_tpu/ops/
// pallas_kernels.py:68-149, body :110-127).  For the stacked [2m, n] S/Y
// buffer (rows [:m] = S, rows [m:] = Y) it computes
//
//   rolled = [buf[1:m]; s; buf[m+1:]; y]
//   out    = upd ? rolled : buf          (upd is a bool read on the device)
//   dots   = rolled @ [s, y]^T           ([2m, 2], in the accumulation type)
//
// The roll is out of place: `out` is a new buffer, `buf` is left as it was,
// so a caller can still fall back to the old state.
//
// Bound: device memory.  Each element of the buffer is read once and
// written once (2 * 2m * n elements moved); the dots cost 4 flops per
// element and ride along.  Design: a block owns kTile consecutive columns
// (256 threads x 4 columns each, so every row access is coalesced) and
// walks the 2m rows, keeping s and y for its columns in registers.  The
// per-row dots are summed over the block, written to a [nblocks, 2m, 2]
// partial array, and summed in index order by a one-block second pass:
// no atomics, so a run repeats bit for bit.
//
// Instance axis: a batched call (k solves run as one, `solve_batched`)
// launches one grid with blockIdx.y the instance.  Each input has its own
// instance stride in elements (0 for an operand the instances share); the
// outputs and partials are laid out [kb, ...].  An instance's blocks do
// exactly what a single launch's do, so a launch over kb instances equals
// kb single launches bit for bit.
//
// Narrow storage: s and y arrive already quantized to the buffer type (the
// wrapper casts them, as the JAX wrapper does) and the dots accumulate in
// f32 from the quantized values.

#include "common.cuh"

namespace paropt {

constexpr int kRollThreads = 256;
constexpr int kRollCols = 4;  // columns per thread
constexpr int kRollTile = kRollThreads * kRollCols;

template <typename TS, typename TA>
__global__ void __launch_bounds__(kRollThreads)
qn_roll_kernel(const TS* __restrict__ buf, const TS* __restrict__ s,
               const TS* __restrict__ y, const bool* __restrict__ upd,
               TS* __restrict__ out, TA* __restrict__ partials, int m,
               long long n, long long sbuf, long long ss, long long sy,
               long long supd) {
  __shared__ TA red[2 * (kRollThreads / 32)];
  const int rows = 2 * m;
  const size_t inst = blockIdx.y;
  buf += inst * sbuf;
  s += inst * ss;
  y += inst * sy;
  out += inst * rows * n;
  partials += inst * gridDim.x * rows * 2;
  const bool do_upd = upd[inst * supd];
  const long long base = static_cast<long long>(blockIdx.x) * kRollTile;

  long long col[kRollCols];
  bool valid[kRollCols];
  TS sv[kRollCols], yv[kRollCols];
#pragma unroll
  for (int c = 0; c < kRollCols; ++c) {
    col[c] = base + c * kRollThreads + threadIdx.x;
    valid[c] = col[c] < n;
    sv[c] = valid[c] ? s[col[c]] : TS(0.0f);
    yv[c] = valid[c] ? y[col[c]] : TS(0.0f);
  }

  for (int r = 0; r < rows; ++r) {
    TA ds = TA(0), dy = TA(0);
#pragma unroll
    for (int c = 0; c < kRollCols; ++c) {
      if (!valid[c]) continue;
      TS rv;
      if (r == m - 1) {
        rv = sv[c];
      } else if (r == rows - 1) {
        rv = yv[c];
      } else {
        rv = buf[static_cast<size_t>(r + 1) * n + col[c]];
      }
      const size_t at = static_cast<size_t>(r) * n + col[c];
      out[at] = do_upd ? rv : buf[at];
      const TA a = to_acc<TA>(rv);
      ds += a * to_acc<TA>(sv[c]);
      dy += a * to_acc<TA>(yv[c]);
    }
    block_sum2(ds, dy, red);
    if (threadIdx.x == 0) {
      const size_t at = (static_cast<size_t>(blockIdx.x) * rows + r) * 2;
      partials[at] = ds;
      partials[at + 1] = dy;
    }
  }
}

// kb instances: the grid is (nblocks, kb); out [kb, 2m, n], partials
// [kb, nblocks, 2m, 2], dots [kb, 2m, 2]
template <typename TS, typename TA>
int launch_qn_roll(const void* buf, const void* s, const void* y,
                   const void* upd, void* out, void* partials, void* dots,
                   int m, long long n, int nblocks, int kb, long long sbuf,
                   long long ss, long long sy, long long supd,
                   void* stream) {
  if (kb < 1 || kb > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  qn_roll_kernel<TS, TA><<<dim3(nblocks, kb), kRollThreads, 0, st>>>(
      static_cast<const TS*>(buf), static_cast<const TS*>(s),
      static_cast<const TS*>(y), static_cast<const bool*>(upd),
      static_cast<TS*>(out), static_cast<TA*>(partials), m, n, sbuf, ss, sy,
      supd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials_kernel<TA><<<1, 256, 0, st>>>(
      static_cast<const TA*>(partials), static_cast<TA*>(dots), nblocks,
      4 * m, kb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace paropt

#define PAROPT_QN_ROLL_ENTRY(suffix, TS, TA)                                \
  extern "C" int paropt_qn_roll_update_##suffix(                            \
      const void* buf, const void* s, const void* y, const void* upd,      \
      void* out, void* partials, void* dots, int m, long long n,           \
      int nblocks, void* stream) {                                         \
    return paropt::launch_qn_roll<TS, TA>(buf, s, y, upd, out, partials,   \
                                          dots, m, n, nblocks, 1, 0, 0, 0, \
                                          0, stream);                      \
  }                                                                         \
  extern "C" int paropt_qn_roll_update_batched_##suffix(                    \
      const void* buf, const void* s, const void* y, const void* upd,      \
      void* out, void* partials, void* dots, int m, long long n,           \
      int nblocks, int kb, long long sbuf, long long ss, long long sy,     \
      long long supd, void* stream) {                                      \
    return paropt::launch_qn_roll<TS, TA>(buf, s, y, upd, out, partials,   \
                                          dots, m, n, nblocks, kb, sbuf,   \
                                          ss, sy, supd, stream);           \
  }

PAROPT_QN_ROLL_ENTRY(f32, float, float)
PAROPT_QN_ROLL_ENTRY(f64, double, double)
PAROPT_QN_ROLL_ENTRY(bf16, __nv_bfloat16, float)

extern "C" int paropt_qn_roll_tile() { return paropt::kRollTile; }
