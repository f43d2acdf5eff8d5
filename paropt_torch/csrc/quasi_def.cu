// Quasi-definite block apply and the fused factor sweep, for Hopper (sm_90a).
//
// Both kernels work in the (nwblock == 1, blocked_t) view of the sparse
// Jacobian: design vectors are [k, nwcon] with the large axis minor, and
// per column w the system [[D, -Aw'], [Aw, C0]] decouples into
//
//   t  = Dinv ⊙ bx
//   aw = Σ_j vals[j] ⊙ t[j]
//   yw = cwinv ⊙ (bw − aw)
//   yx = Dinv ⊙ (bx + vals ⊙ yw)
//
// for every right-hand side b of the stack bx [K, k, nwcon], bw [K, nwcon].
//
// quasi_def_kernel replaces the Pallas kernel `quasi_def_apply_blocked_t`
// (paropt_tpu/ops/pallas_kernels.py:258-304, body `_qd_kernel` :152-172).
// Bound: device memory (about 2 flops per byte).  One thread per column;
// it reads the column's dinv/vals/cwinv once per right-hand side and each
// bx element twice (the second read hits L1), and writes yx and yw once.
//
// phi_gram_kernel replaces `phi_gram_blocked_t` (:210-255, body
// `_phi_gram_kernel` :175-207): the same apply for the stack [Z_qn; A]
// (B = 2m + ncon right-hand sides) plus gram[a, b] = Σ bx_a · yx_b in the
// same sweep, so factor setup reads the [B, n] stack once.  Bound: device
// memory for the apply; the Gram matrix costs 2·B²·k flops per column,
// about B/4 flops per byte moved.  Design: a block walks column tiles of
// `tw` columns; phase A solves the tile (threads over (b, column) pairs)
// and stages bx and yx in shared memory; phase B lets threads own (a, b)
// pairs of the Gram matrix and accumulate the tile's contribution into a
// per-block [B, B] sum in shared memory (B = 21 accumulators per thread
// would spill registers).  The per-block sums go to a [nblocks, B, B]
// partial array that a one-block second pass sums in index order: no
// atomics, so a run repeats bit for bit.
//
// Offsets into [B, k, nwcon] use size_t: at 2^24 variables in f64 the byte
// offsets pass 2^31.  Ragged tiles (nwcon not a multiple of the tile) are
// masked.

#include "common.cuh"

namespace paropt {

constexpr int kQdThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kQdThreads)
quasi_def_kernel(const T* __restrict__ dinv, const T* __restrict__ cwinv,
                 const T* __restrict__ vals, const T* __restrict__ bx,
                 const T* __restrict__ bw, T* __restrict__ yx,
                 T* __restrict__ yw, int K, int k, long long W) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long w = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       w < W; w += stride) {
    const T cwi = cwinv[w];
    for (int b = 0; b < K; ++b) {
      const size_t xb = static_cast<size_t>(b) * k * W;
      T aw = T(0);
      for (int j = 0; j < k; ++j) {
        const size_t jw = static_cast<size_t>(j) * W + w;
        aw += vals[jw] * (dinv[jw] * bx[xb + jw]);
      }
      const T ywv = cwi * (bw[static_cast<size_t>(b) * W + w] - aw);
      yw[static_cast<size_t>(b) * W + w] = ywv;
      for (int j = 0; j < k; ++j) {
        const size_t jw = static_cast<size_t>(j) * W + w;
        yx[xb + jw] = dinv[jw] * (bx[xb + jw] + vals[jw] * ywv);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kQdThreads)
phi_gram_kernel(const T* __restrict__ dinv, const T* __restrict__ cwinv,
                const T* __restrict__ vals, const T* __restrict__ bx,
                const T* __restrict__ bw, T* __restrict__ yx,
                T* __restrict__ yw, T* __restrict__ partials, int B, int k,
                long long W, int tw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int ld = tw + 1;  // padded row: fewer bank conflicts in phase B
  T* bx_s = sm;                                  // [B * k][ld]
  T* yx_s = bx_s + static_cast<size_t>(B) * k * ld;  // [B * k][ld]
  T* g_s = yx_s + static_cast<size_t>(B) * k * ld;   // [B * B]
  const int BB = B * B;
  for (int p = threadIdx.x; p < BB; p += blockDim.x) g_s[p] = T(0);

  const long long ntiles = (W + tw - 1) / tw;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long w0 = tile * tw;
    __syncthreads();  // the previous tile's phase B is done with the stage
    // phase A: solve the tile, threads over (right-hand side, column)
    for (int it = threadIdx.x; it < B * tw; it += blockDim.x) {
      const int b = it / tw;
      const int wl = it - b * tw;
      const long long w = w0 + wl;
      T* bxs = bx_s + static_cast<size_t>(b) * k * ld + wl;
      T* yxs = yx_s + static_cast<size_t>(b) * k * ld + wl;
      if (w >= W) {
        for (int j = 0; j < k; ++j) {
          bxs[j * ld] = T(0);
          yxs[j * ld] = T(0);
        }
        continue;
      }
      const size_t xb = static_cast<size_t>(b) * k * W;
      T aw = T(0);
      for (int j = 0; j < k; ++j) {
        const size_t jw = static_cast<size_t>(j) * W + w;
        const T bv = bx[xb + jw];
        bxs[j * ld] = bv;
        aw += vals[jw] * (dinv[jw] * bv);
      }
      const T ywv = cwinv[w] * (bw[static_cast<size_t>(b) * W + w] - aw);
      yw[static_cast<size_t>(b) * W + w] = ywv;
      for (int j = 0; j < k; ++j) {
        const size_t jw = static_cast<size_t>(j) * W + w;
        const T yv = dinv[jw] * (bxs[j * ld] + vals[jw] * ywv);
        yx[xb + jw] = yv;
        yxs[j * ld] = yv;
      }
    }
    __syncthreads();
    // phase B: gram[a, b] += Σ_{j, w in tile} bx[a, j, w] · yx[b, j, w]
    for (int p = threadIdx.x; p < BB; p += blockDim.x) {
      const int a = p / B;
      const int b = p - a * B;
      const T* xa = bx_s + static_cast<size_t>(a) * k * ld;
      const T* yb = yx_s + static_cast<size_t>(b) * k * ld;
      T acc = T(0);
      for (int j = 0; j < k; ++j) {
        for (int wl = 0; wl < tw; ++wl) {
          acc += xa[j * ld + wl] * yb[j * ld + wl];
        }
      }
      g_s[p] += acc;  // entry p belongs to this thread alone
    }
  }
  for (int p = threadIdx.x; p < BB; p += blockDim.x) {
    partials[static_cast<size_t>(blockIdx.x) * BB + p] = g_s[p];
  }
}

template <typename T>
int launch_quasi_def(const void* dinv, const void* cwinv, const void* vals,
                     const void* bx, const void* bw, void* yx, void* yw,
                     int K, int k, long long W, void* stream) {
  long long blocks = (W + kQdThreads - 1) / kQdThreads;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;
  if (blocks < 1) blocks = 1;
  quasi_def_kernel<T><<<static_cast<unsigned>(blocks), kQdThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(dinv), static_cast<const T*>(cwinv),
      static_cast<const T*>(vals), static_cast<const T*>(bx),
      static_cast<const T*>(bw), static_cast<T*>(yx), static_cast<T*>(yw), K,
      k, W);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_phi_gram(const void* dinv, const void* cwinv, const void* vals,
                    const void* bx, const void* bw, void* yx, void* yw,
                    void* partials, void* gram, int B, int k, long long W,
                    int tw, int nblocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem =
      (2 * static_cast<size_t>(B) * k * (tw + 1) + static_cast<size_t>(B) * B) *
      sizeof(T);
  phi_gram_kernel<T><<<nblocks, kQdThreads, smem, st>>>(
      static_cast<const T*>(dinv), static_cast<const T*>(cwinv),
      static_cast<const T*>(vals), static_cast<const T*>(bx),
      static_cast<const T*>(bw), static_cast<T*>(yx), static_cast<T*>(yw),
      static_cast<T*>(partials), B, k, W, tw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials_kernel<T><<<1, 256, 0, st>>>(
      static_cast<const T*>(partials), static_cast<T*>(gram), nblocks, B * B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace paropt

#define PAROPT_QD_ENTRY(suffix, T)                                          \
  extern "C" int paropt_quasi_def_apply_##suffix(                           \
      const void* dinv, const void* cwinv, const void* vals, const void* bx, \
      const void* bw, void* yx, void* yw, int K, int k, long long W,        \
      void* stream) {                                                       \
    return paropt::launch_quasi_def<T>(dinv, cwinv, vals, bx, bw, yx, yw,   \
                                       K, k, W, stream);                    \
  }                                                                         \
  extern "C" int paropt_phi_gram_##suffix(                                  \
      const void* dinv, const void* cwinv, const void* vals, const void* bx, \
      const void* bw, void* yx, void* yw, void* partials, void* gram, int B, \
      int k, long long W, int tw, int nblocks, void* stream) {              \
    return paropt::launch_phi_gram<T>(dinv, cwinv, vals, bx, bw, yx, yw,    \
                                      partials, gram, B, k, W, tw, nblocks, \
                                      stream);                              \
  }

PAROPT_QD_ENTRY(f32, float)
PAROPT_QD_ENTRY(f64, double)
