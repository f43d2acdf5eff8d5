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
// Bound: device memory, about 2 flops per byte (at K = 1, k = 8,
// nwcon = 2^17 in f32 the call moves 18.4 MB: 5.5 us at 3.35 TB/s).  A
// thread owns V adjacent columns (one 16-byte vector: 4 in f32, 2 in f64)
// and keeps their dinv, vals and cwinv in registers for all K right-hand
// sides; for k <= 8 it issues all k rows of bx before using any, so each
// thread has ~2k 16-byte loads in flight and bx is read once.  Blocks of
// 128 threads spread a K = 1 call of 2^15 vectors over every SM.  A
// ragged or misaligned nwcon takes the scalar path (V = 1) of the same
// kernel; k > 8 loops over rows with the operands re-read from L1.
//
// phi_gram_kernel replaces `phi_gram_blocked_t` (:210-255, body
// `_phi_gram_kernel` :175-207): the same apply for the stack [Z_qn; A]
// (B = 2m + ncon right-hand sides, read from two row blocks so the caller
// need not concatenate them; bw may be absent, meaning zero) plus
// gram[a, b] = Σ bx_a · yx_b in the same sweep, so factor setup reads the
// [B, n] stack once.  Bound: device memory (207 MB at B = 21, k = 8,
// nwcon = 2^17 in f32: 62 us at 3.35 TB/s); the Gram matrix costs
// B²·k FMAs per column (0.92 GFLOP there, 14 us at 67 TFLOP/s).  Design:
//
// - a persistent grid (blocks per SM × SMs, fixed for a given shape and
//   card) walks column tiles of `tw` columns; each block keeps the copies
//   of its next kPgStages - 1 tiles' bx, dinv, vals, cwinv and bw in flight
//   with cp.async (16-byte copies when nwcon % 4 == 0 and every operand is
//   16-byte aligned, element copies with zero fill otherwise) while it
//   works on the current one, in a ring of buffers in dynamic shared
//   memory (above 48 KB after cudaFuncSetAttribute);
// - the apply: a thread per (right-hand side, 4-column chunk) writes yx
//   and yw to device memory (evict-first stores) and yx back into shared
//   memory;
// - the Gram matrix as a register-tiled product: B is padded to Bp, a
//   multiple of 4, and each thread owns a 4 × 4 micro-tile of (a, b) in
//   registers for the whole sweep (8 shared 16-byte loads per 64 FMAs);
//   the threads that share a micro-tile split the tile's (j, column)
//   reduction axis in chunks of 4 columns.  Shared memory holds the tile
//   as [chunk][slot][4]: row r sits in slot r + r/4 and a chunk has an odd
//   number of slots, so the rows a warp reads at one chunk and the chunks
//   consecutive threads read in the apply fall in distinct banks;
// - the micro-tiles are summed over the threads that share them in a fixed
//   order, the per-block [B, B] sums go to a [nblocks, B, B] partial array,
//   and reduce_partials_kernel sums those in index order: no atomics, so a
//   run repeats bit for bit.
//
// Instance axis (both kernels): a batched call (k solves run as one,
// `solve_batched`) launches one grid with blockIdx.y the instance.  Every
// input has an instance stride in elements, 0 for an operand the instances
// share (vals, when only the right-hand sides differ); the outputs and
// partials are laid out [kb, ...].  An instance's blocks do exactly what a
// single launch's do (phi_gram keeps the single launch's plan and
// persistent grid per instance), so a launch over kb instances equals kb
// single launches bit for bit.  The `InstStrides` struct carries the
// strides.
//
// The Gram stays on the CUDA cores in full precision: TF32 is off in all
// solver code, and its FLOPs sit under the memory bound anyway.
//
// Offsets into [B, k, nwcon] use size_t: at 2^24 variables in f64 the byte
// offsets pass 2^31.

#include "common.cuh"

namespace paropt {

// ---------------------------------------------------------------------------
// quasi_def_apply
// ---------------------------------------------------------------------------

// instance strides, in elements, of the kernels' inputs (0 = shared)
struct InstStrides {
  long long dinv, cwinv, vals, bx, bx2, bw;
};

constexpr int kQdThreads = 128;
// k up to this keeps a column's rows in registers
constexpr int kQdRegRows = 8;

// V adjacent elements, loaded and stored as one vector when V > 1
template <typename T, int V>
struct alignas(sizeof(T) * V) Cols {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Cols<T, V> ld_cols(const T* p) {
  return *reinterpret_cast<const Cols<T, V>*>(p);
}

template <typename T, int V>
__device__ __forceinline__ void st_cols(T* p, const Cols<T, V>& c) {
  *reinterpret_cast<Cols<T, V>*>(p) = c;
}

template <typename T, int V, bool KREG>
__global__ void __launch_bounds__(kQdThreads)
quasi_def_kernel(const T* __restrict__ dinv, const T* __restrict__ cwinv,
                 const T* __restrict__ vals, const T* __restrict__ bx,
                 const T* __restrict__ bw, T* __restrict__ yx,
                 T* __restrict__ yw, int K, int k, long long W,
                 InstStrides is) {
  using C = Cols<T, V>;
  const size_t inst = blockIdx.y;
  dinv += inst * is.dinv;
  cwinv += inst * is.cwinv;
  vals += inst * is.vals;
  bx += inst * is.bx;
  bw += inst * is.bw;
  yx += inst * K * k * W;
  yw += inst * K * W;
  const long long nvec = W / V;  // V divides W on the vector path
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long vi = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
       vi < nvec; vi += stride) {
    const size_t w = static_cast<size_t>(vi) * V;
    const C cw = ld_cols<T, V>(cwinv + w);
    if constexpr (KREG) {
      C d[kQdRegRows], vl[kQdRegRows];
#pragma unroll
      for (int j = 0; j < kQdRegRows; ++j) {
        if (j < k) {
          d[j] = ld_cols<T, V>(dinv + j * W + w);
          vl[j] = ld_cols<T, V>(vals + j * W + w);
        }
      }
      for (int b = 0; b < K; ++b) {
        const size_t xb = static_cast<size_t>(b) * k * W + w;
        C x[kQdRegRows];
#pragma unroll
        for (int j = 0; j < kQdRegRows; ++j) {
          if (j < k) x[j] = ld_cols<T, V>(bx + xb + j * W);
        }
        const C bwv = ld_cols<T, V>(bw + static_cast<size_t>(b) * W + w);
        C aw, ywv;
#pragma unroll
        for (int e = 0; e < V; ++e) aw.v[e] = T(0);
#pragma unroll
        for (int j = 0; j < kQdRegRows; ++j) {
          if (j < k) {
#pragma unroll
            for (int e = 0; e < V; ++e) {
              aw.v[e] += vl[j].v[e] * (d[j].v[e] * x[j].v[e]);
            }
          }
        }
#pragma unroll
        for (int e = 0; e < V; ++e) ywv.v[e] = cw.v[e] * (bwv.v[e] - aw.v[e]);
        st_cols<T, V>(yw + static_cast<size_t>(b) * W + w, ywv);
#pragma unroll
        for (int j = 0; j < kQdRegRows; ++j) {
          if (j < k) {
            C y;
#pragma unroll
            for (int e = 0; e < V; ++e) {
              y.v[e] = d[j].v[e] * (x[j].v[e] + vl[j].v[e] * ywv.v[e]);
            }
            st_cols<T, V>(yx + xb + j * W, y);
          }
        }
      }
    } else {
      for (int b = 0; b < K; ++b) {
        const size_t xb = static_cast<size_t>(b) * k * W + w;
        C aw, ywv;
#pragma unroll
        for (int e = 0; e < V; ++e) aw.v[e] = T(0);
        for (int j = 0; j < k; ++j) {
          const C d = ld_cols<T, V>(dinv + j * W + w);
          const C vl = ld_cols<T, V>(vals + j * W + w);
          const C x = ld_cols<T, V>(bx + xb + j * W);
#pragma unroll
          for (int e = 0; e < V; ++e) aw.v[e] += vl.v[e] * (d.v[e] * x.v[e]);
        }
        const C bwv = ld_cols<T, V>(bw + static_cast<size_t>(b) * W + w);
#pragma unroll
        for (int e = 0; e < V; ++e) ywv.v[e] = cw.v[e] * (bwv.v[e] - aw.v[e]);
        st_cols<T, V>(yw + static_cast<size_t>(b) * W + w, ywv);
        for (int j = 0; j < k; ++j) {
          const C d = ld_cols<T, V>(dinv + j * W + w);
          const C vl = ld_cols<T, V>(vals + j * W + w);
          const C x = ld_cols<T, V>(bx + xb + j * W);
          C y;
#pragma unroll
          for (int e = 0; e < V; ++e) {
            y.v[e] = d.v[e] * (x.v[e] + vl.v[e] * ywv.v[e]);
          }
          st_cols<T, V>(yx + xb + j * W, y);
        }
      }
    }
  }
}

template <typename T, int V, bool KREG>
cudaError_t launch_qd(const void* dinv, const void* cwinv, const void* vals,
                      const void* bx, const void* bw, void* yx, void* yw,
                      int K, int k, long long W, int kb,
                      const InstStrides& is, cudaStream_t st) {
  long long blocks = (W / V + kQdThreads - 1) / kQdThreads;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;
  if (blocks < 1) blocks = 1;
  quasi_def_kernel<T, V, KREG><<<dim3(static_cast<unsigned>(blocks), kb),
                                 kQdThreads, 0, st>>>(
      static_cast<const T*>(dinv), static_cast<const T*>(cwinv),
      static_cast<const T*>(vals), static_cast<const T*>(bx),
      static_cast<const T*>(bw), static_cast<T*>(yx), static_cast<T*>(yw), K,
      k, W, is);
  return cudaGetLastError();
}

// vec: nwcon divides into 16-byte vectors and every operand (of every
// instance) is 16-byte aligned (the wrapper checks); otherwise one column
// per thread
template <typename T>
int launch_quasi_def(const void* dinv, const void* cwinv, const void* vals,
                     const void* bx, const void* bw, void* yx, void* yw,
                     int K, int k, long long W, int vec, int kb,
                     const InstStrides& is, void* stream) {
  if (kb < 1 || kb > 65535) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int V = 16 / sizeof(T);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool kreg = k <= kQdRegRows;
  cudaError_t err;
  if (vec && kreg) {
    err = launch_qd<T, V, true>(dinv, cwinv, vals, bx, bw, yx, yw, K, k, W,
                                kb, is, st);
  } else if (vec) {
    err = launch_qd<T, V, false>(dinv, cwinv, vals, bx, bw, yx, yw, K, k, W,
                                 kb, is, st);
  } else if (kreg) {
    err = launch_qd<T, 1, true>(dinv, cwinv, vals, bx, bw, yx, yw, K, k, W,
                                kb, is, st);
  } else {
    err = launch_qd<T, 1, false>(dinv, cwinv, vals, bx, bw, yx, yw, K, k, W,
                                 kb, is, st);
  }
  return static_cast<int>(err);
}

// ---------------------------------------------------------------------------
// phi_gram
// ---------------------------------------------------------------------------

constexpr int kPgThreads = 256;
// tiles per block in flight: the copies of the next kPgStages - 1 tiles
// overlap the work on the current one
constexpr int kPgStages = 2;
// Gram micro-tile width: a thread owns kPgMA x kPgMA entries of the Gram
// matrix
constexpr int kPgMA = 4;

template <typename T>
struct alignas(16) Vec4 {
  T v[4];
};

template <typename T>
__device__ __forceinline__ Vec4<T> ld4(const T* p) {
  return *reinterpret_cast<const Vec4<T>*>(p);
}

template <typename T>
__device__ __forceinline__ void st4(T* p, const Vec4<T>& c) {
  *reinterpret_cast<Vec4<T>*>(p) = c;
}

// slot of stack row r inside a chunk: one spare slot after every kPgMA rows,
// so the kPgMA-row blocks a warp reads at one chunk start in distinct banks
__device__ __forceinline__ int pg_slot(int r) {
  return r + r / kPgMA;
}

// Shared-memory layout of one block, in elements of T (every offset a
// multiple of 4 elements, so 16-byte aligned), with NS = kPgStages:
//   bx_s [NS][nch][S][4]  staged bx (nch = k * tw / 4 chunks)
//   yx_s [nch][S][4]      the tile's yx
//   dv_s [NS][k][tw], vl_s [NS][k][tw], cw_s [NS][tw], bw_s [NS][B][tw]
// and, after the sweep, the Gram reduction [G][nmt][kPgMA²] from offset 0.
struct PgLayout {
  size_t stage, bx, yx, dv, vl, cw, bw, total;
  __host__ __device__ PgLayout(int B, int k, int tw, int S, bool has_bw) {
    constexpr size_t NS = kPgStages;
    stage = static_cast<size_t>(k) * (tw / 4) * S * 4;
    bx = 0;
    yx = NS * stage;
    dv = yx + stage;
    vl = dv + NS * k * tw;
    cw = vl + NS * k * tw;
    bw = cw + NS * tw;
    total = bw + (has_bw ? NS * B * tw : 0);
  }
};

template <typename T, bool VEC>
__device__ __forceinline__ void pg_copy4(T* dst, const T* src, long long w,
                                         long long W) {
  if constexpr (VEC) {  // W % 4 == 0: the chunk is wholly in or out
    const bool ok = w < W;
    const T* s = ok ? src + w : src;
#pragma unroll
    for (int h = 0; h < static_cast<int>(4 * sizeof(T) / 16); ++h) {
      cp_async<16>(dst + h * (16 / sizeof(T)), s + h * (16 / sizeof(T)), ok);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = w + e < W;
      cp_async<static_cast<int>(sizeof(T))>(dst + e, ok ? src + w + e : src,
                                            ok);
    }
  }
}

// yx and yw go out with the evict-first hint (st.global.cs): the kernel
// never reads them back, and the hint took 2% (f32) to 4% (f64) off the
// sweep (PERF.md)
template <typename T, bool VEC>
__device__ __forceinline__ void pg_store4(T* dst, const Vec4<T>& v,
                                          long long w, long long W) {
  if constexpr (VEC) {
    if (w < W) {
#pragma unroll
      for (int h = 0; h < static_cast<int>(sizeof(v) / 16); ++h) {
        __stcs(reinterpret_cast<float4*>(dst + w) + h,
               reinterpret_cast<const float4*>(&v)[h]);
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (w + e < W) __stcs(dst + w + e, v.v[e]);
    }
  }
}

// One (right-hand side, 4-column chunk) of the apply: aw over the chunk's
// k rows, then yw and the k rows of yx (to shared and device memory).
template <typename T, bool VEC>
__device__ __forceinline__ void pg_apply(
    const T* bxs, const T* dvs, const T* vls, const T* cws, const T* bws,
    T* yxs, T* __restrict__ yx, T* __restrict__ yw, int b, int q, int k,
    int qt, int tw, int cs, long long w, long long W) {
  const int sl = pg_slot(b) * 4;
  const Vec4<T> cw = ld4(cws + 4 * q);
  Vec4<T> bwv, aw, ywv;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    bwv.v[e] = T(0);
    aw.v[e] = T(0);
  }
  if (bws != nullptr) bwv = ld4(bws + b * tw + 4 * q);
  for (int j = 0; j < k; ++j) {
    const Vec4<T> x = ld4(bxs + (j * qt + q) * cs + sl);
    const Vec4<T> d = ld4(dvs + j * tw + 4 * q);
    const Vec4<T> v = ld4(vls + j * tw + 4 * q);
#pragma unroll
    for (int e = 0; e < 4; ++e) aw.v[e] += v.v[e] * (d.v[e] * x.v[e]);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) ywv.v[e] = cw.v[e] * (bwv.v[e] - aw.v[e]);
  pg_store4<T, VEC>(yw + static_cast<size_t>(b) * W, ywv, w, W);
  for (int j = 0; j < k; ++j) {
    const int off = (j * qt + q) * cs + sl;
    const Vec4<T> x = ld4(bxs + off);
    const Vec4<T> d = ld4(dvs + j * tw + 4 * q);
    const Vec4<T> v = ld4(vls + j * tw + 4 * q);
    Vec4<T> y;
#pragma unroll
    for (int e = 0; e < 4; ++e) y.v[e] = d.v[e] * (x.v[e] + v.v[e] * ywv.v[e]);
    st4(yxs + off, y);
    pg_store4<T, VEC>(yx + (static_cast<size_t>(b) * k + j) * W, y, w, W);
  }
}

template <typename T, bool VEC, int MT>
__global__ void __launch_bounds__(kPgThreads, MT == 1 ? 2 : 1)
phi_gram_kernel(const T* __restrict__ dinv, const T* __restrict__ cwinv,
                const T* __restrict__ vals, const T* __restrict__ bx_top,
                const T* __restrict__ bx_bot, const T* __restrict__ bw,
                T* __restrict__ yx, T* __restrict__ yw,
                T* __restrict__ partials, int B, int Btop, int k, long long W,
                int tw, int S, InstStrides is) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  {
    const size_t inst = blockIdx.y;
    dinv += inst * is.dinv;
    cwinv += inst * is.cwinv;
    vals += inst * is.vals;
    bx_top += inst * is.bx;
    if (bx_bot != nullptr) bx_bot += inst * is.bx2;
    if (bw != nullptr) bw += inst * is.bw;
    yx += inst * B * k * W;
    yw += inst * B * W;
    partials += inst * gridDim.x * B * B;
  }
  const PgLayout L(B, k, tw, S, bw != nullptr);
  const int tid = threadIdx.x;
  const int qt = tw / 4;     // chunks per row of a tile
  const int nch = k * qt;    // chunks per right-hand side
  const int cs = 4 * S;      // elements per chunk
  const int tb_n = (B + kPgMA - 1) / kPgMA;  // micro-tiles per side
  const int nmt = tb_n * tb_n;         // micro-tiles
  const int G = MT == 1 ? kPgThreads / nmt : 1;  // threads per micro-tile
  const int g = MT == 1 ? tid / nmt : 0;

  // padded rows and spare slots are never written by the copies: zero them
  for (size_t i = tid; i < L.total; i += kPgThreads) sm[i] = T(0);
  __syncthreads();

  // a thread copies chunk q of rows r0, r0 + rstep, ... (qt divides the
  // block, so q is fixed); row r of the stack is (b, j) = (r / k, r % k)
  const int q0 = tid % qt;
  const int rstep = kPgThreads / qt;
  const int r0 = tid / qt;
  auto issue = [&](long long w0, int buf) {
    T* bxs = sm + L.bx + buf * L.stage;
    const long long w = w0 + 4 * q0;
    int b = r0 / k, j = r0 % k;
    for (int r = r0; r < B * k; r += rstep) {
      const T* row = r < Btop * k
                         ? bx_top + static_cast<size_t>(r) * W
                         : bx_bot + static_cast<size_t>(r - Btop * k) * W;
      pg_copy4<T, VEC>(bxs + (j * qt + q0) * cs + pg_slot(b) * 4, row, w, W);
      for (j += rstep; j >= k; j -= k) ++b;
    }
    T* dvs = sm + L.dv + buf * k * tw;
    T* vls = sm + L.vl + buf * k * tw;
    for (int jj = r0; jj < k; jj += rstep) {
      pg_copy4<T, VEC>(dvs + jj * tw + 4 * q0,
                       dinv + static_cast<size_t>(jj) * W, w, W);
      pg_copy4<T, VEC>(vls + jj * tw + 4 * q0,
                       vals + static_cast<size_t>(jj) * W, w, W);
    }
    if (r0 == 0) pg_copy4<T, VEC>(sm + L.cw + buf * tw + 4 * q0, cwinv, w, W);
    if (bw != nullptr) {
      T* bws = sm + L.bw + buf * B * tw;
      for (int bb = r0; bb < B; bb += rstep) {
        pg_copy4<T, VEC>(bws + bb * tw + 4 * q0,
                         bw + static_cast<size_t>(bb) * W, w, W);
      }
    }
  };

  T acc[MT][kPgMA][kPgMA];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < kPgMA; ++i)
#pragma unroll
      for (int j = 0; j < kPgMA; ++j) acc[m][i][j] = T(0);

  // a ring of kPgStages buffers; every step commits one group of copies
  // (empty past the last tile), so "all but the newest kPgStages - 2
  // groups have landed" always means "this step's tile has landed"
  const long long ntiles = (W + tw - 1) / tw;
  const long long step = gridDim.x;
#pragma unroll
  for (int s = 0; s < kPgStages - 1; ++s) {
    const long long t = blockIdx.x + s * step;
    if (t < ntiles) issue(t * tw, s);
    cp_async_commit();
  }
  long long tile = blockIdx.x;
  for (int it = 0; tile < ntiles; ++it, tile += step) {
    const int buf = it % kPgStages;
    cp_async_wait<kPgStages - 2>();
    // this tile has landed, and every thread is done with the previous
    // tile: its buffer takes the copies of the tile kPgStages - 1 ahead
    __syncthreads();
    const long long ahead = tile + (kPgStages - 1) * step;
    if (ahead < ntiles) issue(ahead * tw, (it + kPgStages - 1) % kPgStages);
    cp_async_commit();

    const long long w0 = tile * tw;
    const T* bxs = sm + L.bx + buf * L.stage;
    T* yxs = sm + L.yx;
    // the apply: one thread per (right-hand side, 4-column chunk)
    for (int item = tid; item < B * qt; item += kPgThreads) {
      const int q = item % qt;
      const int b = item / qt;
      pg_apply<T, VEC>(
          bxs, sm + L.dv + buf * k * tw, sm + L.vl + buf * k * tw,
          sm + L.cw + buf * tw,
          bw != nullptr ? sm + L.bw + buf * B * tw : nullptr, yxs, yx, yw, b,
          q, k, qt, tw, cs, w0 + 4 * q, W);
    }
    __syncthreads();

    // the Gram matrix: micro-tile (ta, tb) over chunks c = g, g + G, ...
    if (g < G) {
      for (int c = g; c < nch; c += G) {
        const T* xc = bxs + c * cs;
        const T* yc = yxs + c * cs;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int t = MT == 1 ? tid % nmt : tid + m * kPgThreads;
          if (t < nmt) {
            const int ta = t / tb_n;
            const int tb = t - ta * tb_n;
            Vec4<T> y[kPgMA];
#pragma unroll
            for (int j = 0; j < kPgMA; ++j) {
              y[j] = ld4(yc + pg_slot(kPgMA * tb + j) * 4);
            }
#pragma unroll
            for (int i = 0; i < kPgMA; ++i) {
              const Vec4<T> a = ld4(xc + pg_slot(kPgMA * ta + i) * 4);
#pragma unroll
              for (int j = 0; j < kPgMA; ++j) {
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[m][i][j] += a.v[e] * y[j].v[e];
              }
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // only empty groups are left; retire them
  __syncthreads();     // the last tile's Gram reads are done

  // fixed-order sum of each micro-tile over the G threads that share it
  constexpr int MM = kPgMA * kPgMA;
  T* red = sm;  // [G][nmt][MM]
  if (g < G) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int t = MT == 1 ? tid % nmt : tid + m * kPgThreads;
      if (t < nmt) {
#pragma unroll
        for (int i = 0; i < kPgMA; ++i)
#pragma unroll
          for (int j = 0; j < kPgMA; ++j)
            red[(static_cast<size_t>(g) * nmt + t) * MM + i * kPgMA + j] =
                acc[m][i][j];
      }
    }
  }
  __syncthreads();
  const int BB = B * B;
  for (int p = tid; p < BB; p += kPgThreads) {
    const int a = p / B;
    const int b = p - a * B;
    const size_t t = (a / kPgMA) * tb_n + b / kPgMA;
    const int e = (a % kPgMA) * kPgMA + b % kPgMA;
    T s = T(0);
    for (int gg = 0; gg < G; ++gg) s += red[(gg * nmt + t) * MM + e];
    partials[static_cast<size_t>(blockIdx.x) * BB + p] = s;
  }
}

template <typename T, bool VEC, int MT>
cudaError_t launch_pg(const void* dinv, const void* cwinv, const void* vals,
                      const void* bx_top, const void* bx_bot, const void* bw,
                      void* yx, void* yw, void* partials, int B, int Btop,
                      int k, long long W, int tw, int S, int smem,
                      int nblocks, int kb, const InstStrides& is,
                      cudaStream_t st) {
  static int opted_in = 48 * 1024;  // dynamic shared memory allowed so far
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        phi_gram_kernel<T, VEC, MT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted_in = smem;
  }
  phi_gram_kernel<T, VEC, MT><<<dim3(nblocks, kb), kPgThreads, smem, st>>>(
      static_cast<const T*>(dinv), static_cast<const T*>(cwinv),
      static_cast<const T*>(vals), static_cast<const T*>(bx_top),
      static_cast<const T*>(bx_bot), static_cast<const T*>(bw),
      static_cast<T*>(yx), static_cast<T*>(yw), static_cast<T*>(partials), B,
      Btop, k, W, tw, S, is);
  return cudaGetLastError();
}

// The plan (tw, S, mt, smem bytes, nblocks per instance) comes from the
// wrapper's planner (kernels.phi_gram_plan); a plan whose shared memory
// would not hold this layout is refused here.  kb instances: the grid is
// (nblocks, kb), partials [kb, nblocks, B, B], gram [kb, B, B].
template <typename T>
int launch_phi_gram(const void* dinv, const void* cwinv, const void* vals,
                    const void* bx_top, const void* bx_bot, const void* bw,
                    void* yx, void* yw, void* partials, void* gram, int B,
                    int Btop, int k, long long W, int tw, int S, int mt,
                    int smem, int nblocks, int vec, int kb,
                    const InstStrides& is, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tb_n = (B + kPgMA - 1) / kPgMA;
  const PgLayout L(B, k, tw, S, bw != nullptr);
  const size_t red = static_cast<size_t>(kPgThreads) * mt * kPgMA * kPgMA;
  if (tw % 4 != 0 || kPgThreads % (tw / 4) != 0 ||
      S < tb_n * (kPgMA + 1) - 1 || tb_n * tb_n > kPgThreads * mt ||
      static_cast<size_t>(smem) < (L.total > red ? L.total : red) * sizeof(T) ||
      nblocks < 1 || kb < 1 || kb > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaErrorInvalidValue;
#define PAROPT_PG_CASE(M)                                                     \
  if (mt == M) {                                                              \
    err = (vec ? launch_pg<T, true, M> : launch_pg<T, false, M>)(             \
        dinv, cwinv, vals, bx_top, bx_bot, bw, yx, yw, partials, B, Btop, k,  \
        W, tw, S, smem, nblocks, kb, is, st);                                 \
  }
  PAROPT_PG_CASE(1)
  PAROPT_PG_CASE(2)
  PAROPT_PG_CASE(4)
#undef PAROPT_PG_CASE
  if (err != cudaSuccess) return static_cast<int>(err);
  const int BB = B * B;
  const int rblocks = (BB * kb + kPgThreads / 32 - 1) / (kPgThreads / 32);
  reduce_partials_kernel<T><<<rblocks, kPgThreads, 0, st>>>(
      static_cast<const T*>(partials), static_cast<T*>(gram), nblocks, BB,
      kb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace paropt

#define PAROPT_QD_ENTRY(suffix, T)                                           \
  extern "C" int paropt_quasi_def_apply_##suffix(                            \
      const void* dinv, const void* cwinv, const void* vals, const void* bx,  \
      const void* bw, void* yx, void* yw, int K, int k, long long W, int vec, \
      void* stream) {                                                        \
    return paropt::launch_quasi_def<T>(dinv, cwinv, vals, bx, bw, yx, yw,    \
                                       K, k, W, vec, 1,                      \
                                       paropt::InstStrides{}, stream);       \
  }                                                                          \
  extern "C" int paropt_quasi_def_apply_batched_##suffix(                    \
      const void* dinv, const void* cwinv, const void* vals, const void* bx,  \
      const void* bw, void* yx, void* yw, int K, int k, long long W, int vec, \
      int kb, long long sdinv, long long scwinv, long long svals,             \
      long long sbx, long long sbw, void* stream) {                          \
    return paropt::launch_quasi_def<T>(                                      \
        dinv, cwinv, vals, bx, bw, yx, yw, K, k, W, vec, kb,                 \
        paropt::InstStrides{sdinv, scwinv, svals, sbx, 0, sbw}, stream);     \
  }                                                                          \
  extern "C" int paropt_phi_gram_##suffix(                                   \
      const void* dinv, const void* cwinv, const void* vals,                 \
      const void* bx_top, const void* bx_bot, const void* bw, void* yx,      \
      void* yw, void* partials, void* gram, int B, int Btop, int k,          \
      long long W, int tw, int S, int mt, int smem, int nblocks, int vec,    \
      void* stream) {                                                        \
    return paropt::launch_phi_gram<T>(dinv, cwinv, vals, bx_top, bx_bot, bw, \
                                      yx, yw, partials, gram, B, Btop, k, W, \
                                      tw, S, mt, smem, nblocks, vec, 1,      \
                                      paropt::InstStrides{}, stream);        \
  }                                                                          \
  extern "C" int paropt_phi_gram_batched_##suffix(                           \
      const void* dinv, const void* cwinv, const void* vals,                 \
      const void* bx_top, const void* bx_bot, const void* bw, void* yx,      \
      void* yw, void* partials, void* gram, int B, int Btop, int k,          \
      long long W, int tw, int S, int mt, int smem, int nblocks, int vec,    \
      int kb, long long sdinv, long long scwinv, long long svals,            \
      long long sbx, long long sbx2, long long sbw, void* stream) {          \
    return paropt::launch_phi_gram<T>(                                       \
        dinv, cwinv, vals, bx_top, bx_bot, bw, yx, yw, partials, gram, B,    \
        Btop, k, W, tw, S, mt, smem, nblocks, vec, kb,                       \
        paropt::InstStrides{sdinv, scwinv, svals, sbx, sbx2, sbw}, stream);  \
  }

PAROPT_QD_ENTRY(f32, float)
PAROPT_QD_ENTRY(f64, double)
