// Shared device helpers for the paropt_torch kernels.
//
// Cross-block sums use a fixed-order two-stage reduce: each block writes its
// partial to a [nblocks, nout] scratch array, then `reduce_partials_kernel`
// (one block) sums the partials in index order.  No atomics, so a run
// repeats bit for bit.
#pragma once

#include <cstddef>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace paropt {

constexpr unsigned kFullMask = 0xffffffffu;

template <typename TA, typename TS>
__device__ __forceinline__ TA to_acc(TS v) {
  return static_cast<TA>(v);
}

template <>
__device__ __forceinline__ float to_acc<float, __nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Sum of (a, b) over the whole block; the result is valid in thread 0.
// `red` holds 2 * (blockDim.x / 32) values.  The order of the sums depends
// only on the thread index, so the result is deterministic.
template <typename TA>
__device__ __forceinline__ void block_sum2(TA& a, TA& b, TA* red) {
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(kFullMask, a, off);
    b += __shfl_down_sync(kFullMask, b, off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  if (lane == 0) {
    red[warp] = a;
    red[nwarps + warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    TA sa = TA(0), sb = TA(0);
    for (int w = 0; w < nwarps; ++w) {
      sa += red[w];
      sb += red[nwarps + w];
    }
    a = sa;
    b = sb;
  }
  __syncthreads();  // `red` may be reused right after
}

// out[i] = sum_p partials[p, i], one warp per output, lanes striding over p
// and a fixed shuffle tree: the same inputs always give the same bits.
template <typename TA>
__global__ void reduce_partials_kernel(const TA* __restrict__ partials,
                                       TA* __restrict__ out, int nparts,
                                       int nout) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int i = warp; i < nout; i += nwarps) {
    TA acc = TA(0);
    for (int p = lane; p < nparts; p += 32) {
      acc += partials[static_cast<size_t>(p) * nout + i];
    }
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_down_sync(kFullMask, acc, off);
    }
    if (lane == 0) out[i] = acc;
  }
}

}  // namespace paropt
