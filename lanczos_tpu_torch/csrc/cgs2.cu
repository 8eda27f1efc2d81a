// CGS2 reorthogonalization of one vector against the filled rows of the
// Lanczos basis, on Hopper (sm_90a), in p + 1 sweeps over the basis.
//
// Replaces no TPU kernel.  The JAX package's CGS2
// (lanczos_tpu/solver/lanczos.py:_orthogonalize) is two plain matmuls a
// pass left to XLA, and the port's plain version
// (lanczos_tpu_torch/ops/cgs2_kernels.py:cgs2_reference) two cuBLAS GEMVs a
// pass, h = V v and v - h V, each reading the whole (j, M) basis V[:j]:
// 2p reads of V for p passes.  At N=160^3 (M = 4,096,000, fp32, j up to
// 399) that is 16.4 MB a row, and the regular solve spends ~93% of its
// device time there.
//
// What bounds it: bytes.  A sweep does 2 flops per 4 (8) bytes of V.  But
// one pass's update v' = v - V^T h and the next pass's projection
// h' = V v' need the same column of V at the same time: column c of v'
// depends only on column c of V and on h, which is complete before the
// sweep starts.  So p passes take p + 1 sweeps:
//
//   kProject   h_1 = V v                          (reads V)
//   kFused     v_k = v_{k-1} - V^T h_{k-1};  h_k = V v_k   (reads V once)
//   kUpdate    v_p = v_{p-1} - V^T h_p            (reads V)
//
// with the same arithmetic as the plain loop in the same Gram-Schmidt
// order; only the order of the floating-point sums differs.  Sums are
// taken in the operands' type (fp32 or fp64), as cuBLAS does.
//
// The Lanczos recurrence reads V twice a step by lagging the last update
// (cgs2_step): it leaves v_j = v~ - V[:j]^T h~ unfinished in V[j] and runs
// the SpMV on v~; the next step's first sweep finishes that row tile by
// tile and projects the new vector against V[:j + 1] with it:
//
//   kFinish     V[j-1] = V[j-1] - V[:j-1]^T h~;  h_1 = V[:j] v   (reads V)
//   kFusedNorm  kFused, and |v_k|^2 beside h_k                  (reads V)
//
// cgs2_reduce_norm then scales h_p by s = 1 / sqrt(|v_{p-1}|^2 - |h_p|^2),
// which is 1 / |v_p| when the rows are orthonormal (Pythagoras), and
// writes s after it; the caller keeps s v_{p-1} and s h_p as the next
// step's v~ and h~ (ops/cgs2_kernels.py:cgs2_lagged).  Where the passes
// left less than half of a unit v (|v_p|^2 < 1/4: the Krylov space is
// spent and r is mostly rounding in the span of V), the SpMV on v~ would
// add |H| |h~| ~ |H| eps / |v_p| to the next residual, more than that
// residual holds, and the next step would lose more: so the reduction
// raises a flag, kUpdateIf finishes the row at once (otherwise it returns
// at its first instruction), and the h~ kept for the next step is zero.
//
// This design (one sweep kernel in every mode):
//   * a persistent grid of one 512-thread block per SM walks column tiles
//     [c0, c0 + C) of V, tile b, b + G, b + 2G, ... (G = the grid);
//   * each tile (the j rows of V and, as row j, the same columns of v) is
//     copied into shared memory with cp.async, two stages deep: tile i + 1
//     is in flight while tile i is used, and tile i + 2 is issued as soon
//     as tile i's stage is free;
//   * C follows j and the element size: the widest multiple of 128 bytes a
//     row with (j + 1) * C * sizeof(T) <= kTileBytes (104 KB), at most 8 KB
//     a row, so a stage holds ~100 KB whatever j is; j <= kMaxRows (831)
//     fits;
//   * the tile's 16-byte chunks are XOR-swizzled by (row & 7), so a warp
//     reading one chunk of 32 rows, or 32 chunks of few rows, takes the
//     fewest shared-memory wavefronts; every shared read is 16 bytes;
//   * step A (all but kProject): chunk k of the tile gives
//     v_new = v - sum_r h[r] V[r, k]; L adjacent lanes (a power of two up
//     to 32, as many as 512 threads allow) share a chunk, each taking
//     every L-th row, and add their sums by a butterfly of shuffles; the
//     new chunk goes to shared memory (v1v) and to `out`;
//   * step B (all but the updates): each thread owns up to kMaxPairs (row,
//     column segment) pairs and adds sum_c V[r, c] v_new[c] over its
//     segment of each tile; a tile's sum is added to the pair's running
//     sum with Neumaier's compensation (a thread adds up ~500 tiles);
//   * at the end a block adds its segments in order and writes its row
//     sums to partial[block, :]; cgs2_reduce adds the G blocks' sums in
//     block order.  No float atomics: a result is bitwise the same from
//     run to run on one card (the grid is the card's SM count).
// More rows than a stage holds (j > kMaxRows) lose only the fusion: the
// rows are taken in blocks of at most kMaxRows, and each pass projects
// block by block (kProject) and then updates block by block (kUpdate, in
// block order), 2 reads of V a pass as the plain loop, each read once.
// On an H100 80GB HBM3 at 700 W, fp32, M = 4,096,000: two passes at
// j = 399 take 6.54 ms, 89.5% of the three reads' bound (the loop: 10.0
// ms); chip_smoke.py and scripts/time_torch_kernels.py time it.
// Nothing is allocated here and nothing synchronizes with the host, so a
// call captures into a CUDA graph.  The wrapper (ops/cgs2_kernels.py)
// allocates out, h and partial.  `out` may be the input vector's buffer,
// and in kFinish it is V's row j - 1: each column is read and written by
// the one thread that owns it, after the tile holding it has landed.
//
// Entry points take plain pointers and return the first CUDA error of
// their launches (cudaGetLastError() after each), so the ctypes wrapper
// can raise on a refused launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kSmemMax = 232448;    // what one block may use on sm_90
constexpr int kTileBytes = 106496;  // one stage: (j + 1) rows of a tile
constexpr int kRowBytes = 128;      // a tile row is a multiple: 8 chunks
constexpr int kMaxColBytes = 8192;  // a tile row is at most this
constexpr int kMaxPairs = 2;        // step B's (row, segment) pairs a thread
constexpr int kMaxRows = kTileBytes / kRowBytes - 1;  // 831
constexpr int kReduceThreads = 128;
constexpr int kNormThreads = 1024;  // cgs2_reduce_norm: a row a thread
static_assert(kNormThreads > kMaxRows, "cgs2_reduce_norm takes j + 1 rows");

enum Mode {
  kProject = 0, kFused = 1, kUpdate = 2, kFinish = 3, kFusedNorm = 4,
  kUpdateIf = 5  // kUpdate where h[j + 1] (cgs2_reduce_norm's flag) is set
};

// A 16-byte chunk of T and what the sweeps do with it.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  __device__ static __forceinline__ float dot(float4 a, float4 b, float s) {
    s = fmaf(a.x, b.x, s);
    s = fmaf(a.y, b.y, s);
    s = fmaf(a.z, b.z, s);
    return fmaf(a.w, b.w, s);
  }
  __device__ static __forceinline__ void axpy(float h, float4 x, float4& s) {
    s.x = fmaf(h, x.x, s.x);
    s.y = fmaf(h, x.y, s.y);
    s.z = fmaf(h, x.z, s.z);
    s.w = fmaf(h, x.w, s.w);
  }
  __device__ static __forceinline__ float4 sub(float4 a, float4 b) {
    return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
  }
  __device__ static __forceinline__ void shfl_add(unsigned mask, float4& s,
                                                  int off, int width) {
    s.x += __shfl_xor_sync(mask, s.x, off, width);
    s.y += __shfl_xor_sync(mask, s.y, off, width);
    s.z += __shfl_xor_sync(mask, s.z, off, width);
    s.w += __shfl_xor_sync(mask, s.w, off, width);
  }
};
template <>
struct Vec<double> {
  using type = double2;
  __device__ static __forceinline__ double dot(double2 a, double2 b,
                                               double s) {
    s = fma(a.x, b.x, s);
    return fma(a.y, b.y, s);
  }
  __device__ static __forceinline__ void axpy(double h, double2 x,
                                              double2& s) {
    s.x = fma(h, x.x, s.x);
    s.y = fma(h, x.y, s.y);
  }
  __device__ static __forceinline__ double2 sub(double2 a, double2 b) {
    return make_double2(a.x - b.x, a.y - b.y);
  }
  __device__ static __forceinline__ void shfl_add(unsigned mask, double2& s,
                                                  int off, int width) {
    s.x += __shfl_xor_sync(mask, s.x, off, width);
    s.y += __shfl_xor_sync(mask, s.y, off, width);
  }
};

// Copy kBytes (16: .cg, past L1; 4 or 8: .ca); src_bytes = 0 zero-fills.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(src), "n"(kBytes), "r"(src_bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one group of this thread's copies is in flight.
__device__ __forceinline__ void cp_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Element offset of (row r, column c) in a tile of C columns: 16-byte
// chunk k of row r is stored at chunk k ^ (r & 7) of that row.
template <typename T>
__device__ __forceinline__ int swz(int r, int c, int C) {
  constexpr int kV = 16 / sizeof(T);
  return r * C + (((c / kV) ^ (r & 7)) * kV) + (c & (kV - 1));
}

// Chunk k of row r of a tile of C columns.
template <typename T>
__device__ __forceinline__ typename Vec<T>::type chunk(const T* tile, int r,
                                                       int k, int C) {
  return reinterpret_cast<const typename Vec<T>::type*>(tile + r * C)[k ^ (r & 7)];
}

// Overwrite chunk k of row r of a tile of C columns.
template <typename T>
__device__ __forceinline__ void put_chunk(T* tile, int r, int k, int C,
                                          typename Vec<T>::type x) {
  reinterpret_cast<typename Vec<T>::type*>(tile + r * C)[k ^ (r & 7)] = x;
}

// Issue the copies of one tile: rows 0..j-1 of V and, as row j, v, over
// columns [c0, c0 + C); columns at or past M are zero-filled.  kLoad
// elements a copy: 16 / sizeof(T) when rows and v are 16-byte aligned
// (M a multiple of it, so a copy is all in or all out), else 1.
template <typename T, int kLoad>
__device__ __forceinline__ void load_tile(T* stage, const T* V, const T* v,
                                          long long M, int j, int C,
                                          long long c0) {
  const int per_row = C / kLoad;
  const int dr = kThreads / per_row, dk = kThreads - dr * per_row;
  int r = threadIdx.x / per_row, k = threadIdx.x - r * per_row;
  while (r <= j) {
    const int c = k * kLoad;
    const long long g = c0 + c;
    const bool in = g < M;
    const T* row = r < j ? V + r * M : v;
    cp_async<kLoad * sizeof(T)>(stage + swz<T>(r, c, C), row + (in ? g : 0),
                                in ? kLoad * (int)sizeof(T) : 0);
    k += dk;
    r += dr;
    if (k >= per_row) {
      k -= per_row;
      ++r;
    }
  }
}

__host__ __device__ constexpr int align16(int elems, int elem_bytes) {
  const int per = 16 / elem_bytes;
  return (elems + per - 1) / per * per;
}

template <typename T>
int tile_cols(int j) {
  constexpr int unit = kRowBytes / sizeof(T);
  const int c = kTileBytes / ((j + 1) * (int)sizeof(T)) / unit * unit;
  const int cap = kMaxColBytes / (int)sizeof(T);
  return c < cap ? c : cap;
}

template <typename T>
size_t smem_bytes(int j, int C) {
  return sizeof(T) * (size_t)(2 * (j + 1) * C + align16(j, sizeof(T)) + C);
}

// Lanes of a warp that share one chunk's column sum in step A: a power of
// two up to 32, so that as many threads as there are take part.
__host__ __device__ constexpr int lanes_per_chunk(int nchunks) {
  int lanes = 1;
  while (lanes < 32 && 2 * lanes * nchunks <= kThreads) lanes *= 2;
  return lanes;
}

// Write chunk x of the new vector at columns [g, g + kV) of out (those
// below M): one 16-byte store where the rows are aligned (kLoad == kV).
template <typename T, int kLoad>
__device__ __forceinline__ void store_chunk(T* out, long long g, long long M,
                                            typename Vec<T>::type x) {
  constexpr int kV = 16 / sizeof(T);
  if (kLoad == kV) {
    if (g < M) *reinterpret_cast<typename Vec<T>::type*>(out + g) = x;
  } else {
    const T* xs = reinterpret_cast<const T*>(&x);
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      if (g + e < M) out[g + e] = xs[e];
    }
  }
}

// One sweep over the tiles of V[:j] (rows 0..j-1 of V, and v as row j).
// Step A updates row ja of the tile by rows [0, ja) and h: row j (v) but
// in kFinish, where it is row j - 1 (V's unfinished row, written back to
// the tile and to out = V[j-1]).  Step B sums rows [0, jb) of the tile
// against the new vector, v1v: rows [0, j) but in kFusedNorm, where the
// tile's row j is overwritten by the new vector, so that row j's sum is
// its squared norm.
template <typename T, int kLoad, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
    cgs2_sweep(const T* V, const T* v, T* out, const T* __restrict__ h,
               T* __restrict__ partial, long long M, int j, int C) {
  using VT = typename Vec<T>::type;
  constexpr int kV = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const stages = reinterpret_cast<T*>(smem_raw);
  const int stage_elems = (j + 1) * C;
  T* const hs = stages + 2 * stage_elems;
  VT* const v1v = reinterpret_cast<VT*>(hs + align16(j, sizeof(T)));
  const int t = threadIdx.x;
  const long long G = gridDim.x;
  const long long ntiles = (M + C - 1) / C;
  constexpr bool kStepB = kMode != kUpdate && kMode != kUpdateIf;
  const int ja = kMode == kFinish ? j - 1 : j;
  const int jb = kMode == kFusedNorm ? j + 1 : j;
  if (kMode == kUpdateIf && h[j + 1] == T(0)) return;

  if (kMode != kProject) {
    for (int r = t; r < ja; r += kThreads) hs[r] = h[r];
  }
  long long tile = blockIdx.x;
  if (tile < ntiles) load_tile<T, kLoad>(stages, V, v, M, j, C, tile * C);
  cp_commit();
  if (tile + G < ntiles) {
    load_tile<T, kLoad>(stages + stage_elems, V, v, M, j, C, (tile + G) * C);
  }
  cp_commit();

  const int nchunks = C / kV;
  // Step A: item p = (chunk p / L, row group p % L); the L lanes of a
  // chunk (adjacent, in one warp) take rows g, g + L, ... and add their
  // sums by a butterfly of shuffles.
  const int L = lanes_per_chunk(nchunks);
  const unsigned group =
      (L == 32 ? 0xffffffffu : (1u << L) - 1u) << ((t % 32) & ~(L - 1));
  // Step B: pair q = (row q % jb, column segment q / jb), nseg segments of
  // seg_len chunks; consecutive threads take consecutive rows.
  int nseg = kThreads / jb < nchunks ? kThreads / jb : nchunks;
  nseg = nseg < 1 ? 1 : nseg;
  const int seg_len = (nchunks + nseg - 1) / nseg;
  const int pairs = jb * nseg;
  int prow[kMaxPairs], pk0[kMaxPairs], pk1[kMaxPairs];
  T acc[kMaxPairs], comp[kMaxPairs];
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    const int q = t + i * kThreads;
    prow[i] = q < pairs ? q % jb : 0;
    pk0[i] = q < pairs ? (q / jb) * seg_len : 0;
    pk1[i] = q < pairs ? min(pk0[i] + seg_len, nchunks) : 0;
    acc[i] = comp[i] = T(0);
  }

  int stage = 0;
  for (; tile < ntiles; tile += G) {
    cp_wait_one();
    __syncthreads();
    T* const tl = stages + stage * stage_elems;
    const long long c0 = tile * C;

    // Step A: the tile's chunks of the updated row, into out (and v1v,
    // or the tile); kProject and kFinish take v as it is into v1v.
    if (kMode == kProject || kMode == kFinish) {
      for (int k = t; k < nchunks; k += kThreads) v1v[k] = chunk(tl, j, k, C);
    }
    if (kMode != kProject) {
      for (int p = t; p < nchunks * L; p += kThreads) {
        const int k = p / L, g = p % L;
        VT s = {};
#pragma unroll 4
        for (int r = g; r < ja; r += L) Vec<T>::axpy(hs[r], chunk(tl, r, k, C), s);
        for (int off = L / 2; off > 0; off /= 2) Vec<T>::shfl_add(group, s, off, L);
        if (g == 0) {
          const VT x = Vec<T>::sub(chunk(tl, ja, k, C), s);
          if (kMode == kFused || kMode == kFusedNorm) v1v[k] = x;
          if (kMode == kFinish || kMode == kFusedNorm) put_chunk(tl, ja, k, C, x);
          store_chunk<T, kLoad>(out, c0 + k * kV, M, x);
        }
      }
    }

    // Step B: this tile's share of each row's V[r, :] . v_new, summed
    // alone and added to the pair's running sum with Neumaier's
    // compensation, so that a thread's hundreds of tiles do not make one
    // long chain of roundings.
    if (kStepB) {
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kMaxPairs; ++i) {
        T s = T(0);
#pragma unroll 4
        for (int k = pk0[i]; k < pk1[i]; ++k) s = Vec<T>::dot(chunk(tl, prow[i], k, C), v1v[k], s);
        const T a = acc[i], sum = a + s;
        comp[i] += fabs(a) >= fabs(s) ? (a - sum) + s : (s - sum) + a;
        acc[i] = sum;
      }
    }
    __syncthreads();  // the stage and v1v are free
    if (tile + 2 * G < ntiles) {
      load_tile<T, kLoad>(stages + stage * stage_elems, V, v, M, j, C,
                          (tile + 2 * G) * C);
    }
    cp_commit();
    stage ^= 1;
  }
  if (!kStepB) return;

  // Every copy this block issued has landed (the loop waited for each
  // tile), so the stages hold the pairs' sums now.
  T* const sums = stages;
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    const int q = t + i * kThreads;
    if (q < pairs) sums[q] = acc[i] + comp[i];
  }
  __syncthreads();
  for (int r = t; r < jb; r += kThreads) {
    T s = sums[r];
    for (int g = 1; g < nseg; ++g) s += sums[g * jb + r];
    partial[(long long)blockIdx.x * jb + r] = s;
  }
}

// h[r] = sum over blocks b of partial[b, r], in block order.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
    cgs2_reduce(const T* __restrict__ partial, T* __restrict__ h, int j,
                int blocks) {
  const int r = blockIdx.x * kReduceThreads + threadIdx.x;
  if (r >= j) return;
  T s = partial[r];
#pragma unroll 8
  for (int b = 1; b < blocks; ++b) s += partial[(long long)b * j + r];
  h[r] = s;
}

// For r < j: s * sum over blocks b of partial[b, r], in block order, into
// h[r]; h[j] = s = 1 / sqrt(d), d = n - sum_r h_r^2 with n row j's sum (0
// where d is not positive: a zero vector, a breakdown); h[j + 1] = 1 where
// 0 < d < 1/4 (finish now), else 0; h[j + 2 + r] = h[r], or 0 where the
// flag is set (the h~ the next step finishes by).  One block, a row a
// thread; the squares are added by a fixed tree.
template <typename T>
__global__ void __launch_bounds__(kNormThreads)
    cgs2_reduce_norm(const T* __restrict__ partial, T* __restrict__ h, int j,
                     int blocks) {
  __shared__ T sq[kNormThreads];
  __shared__ T scale;
  __shared__ bool now;
  const int t = threadIdx.x;
  T s = T(0);
  if (t <= j) {
    s = partial[t];
#pragma unroll 8
    for (int b = 1; b < blocks; ++b) s += partial[(long long)b * (j + 1) + t];
  }
  sq[t] = t < j ? s * s : T(0);
  __syncthreads();
  for (int w = kNormThreads / 2; w > 0; w /= 2) {
    if (t < w) sq[t] += sq[t + w];
    __syncthreads();
  }
  if (t == j) {
    const T d = s - sq[0];
    scale = d > T(0) ? T(1) / sqrt(d) : T(0);
    now = d > T(0) && d < T(0.25);
  }
  __syncthreads();
  if (t < j) {
    h[t] = scale * s;
    h[j + 2 + t] = now ? T(0) : scale * s;
  } else if (t == j) {
    h[j] = scale;
    h[j + 1] = now ? T(1) : T(0);
  }
}

// One sweep and, but for kUpdate, its reduction of the blocks' sums into
// h_out (j values; j + 1, scaled, for kFusedNorm).  h_in is read by the
// sweep before the reduction writes h_out, so the two may be one buffer.
template <typename T, int kLoad, int kMode>
cudaError_t sweep(const T* V, const T* v, T* out, const T* h_in, T* h_out,
                  T* partial, long long M, int j, int blocks,
                  cudaStream_t stream) {
  const int C = tile_cols<T>(j);
  const size_t smem = smem_bytes<T>(j, C);
  if (smem > (size_t)kSmemMax) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(cgs2_sweep<T, kLoad, kMode>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (err != cudaSuccess) return err;
  }
  cgs2_sweep<T, kLoad, kMode><<<blocks, kThreads, smem, stream>>>(
      V, v, out, h_in, partial, M, j, C);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || kMode == kUpdate || kMode == kUpdateIf) return err;
  if (kMode == kFusedNorm) {
    cgs2_reduce_norm<T><<<1, kNormThreads, 0, stream>>>(partial, h_out, j,
                                                         blocks);
  } else {
    cgs2_reduce<T><<<(j + kReduceThreads - 1) / kReduceThreads,
                     kReduceThreads, 0, stream>>>(partial, h_out, j, blocks);
  }
  return cudaGetLastError();
}

// out = v - V[:j]^T h, by row blocks of at most kMaxRows rows in order
// (one block, one sweep, for j <= kMaxRows): one read of V[:j].
template <typename T, int kLoad>
cudaError_t update(const T* V, const T* v, T* out, const T* h, long long M,
                   int j, int blocks, cudaStream_t stream) {
  const int nb = (j + kMaxRows - 1) / kMaxRows, R = (j + nb - 1) / nb;
  cudaError_t err = cudaSuccess;
  const T* src = v;
  for (int r0 = 0; r0 < j && err == cudaSuccess; r0 += R) {
    err = sweep<T, kLoad, kUpdate>(V + r0 * M, src, out, h + r0, nullptr,
                                   nullptr, M, j - r0 < R ? j - r0 : R,
                                   blocks, stream);
    src = out;
  }
  return err;
}

// passes >= 1 CGS passes of v against the rows of V (j, M), result in out.
// h (j) and partial (blocks * j) are scratch.
template <typename T, int kLoad>
int run(const T* V, const T* v, T* out, T* h, T* partial, long long M, int j,
        int passes, int blocks, cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  const T* src = v;
  if (j > kMaxRows) {  // row blocks, two sweeps a pass
    const int nb = (j + kMaxRows - 1) / kMaxRows, R = (j + nb - 1) / nb;
    for (int p = 0; p < passes && err == cudaSuccess; ++p) {
      for (int r0 = 0; r0 < j && err == cudaSuccess; r0 += R) {
        err = sweep<T, kLoad, kProject>(V + r0 * M, src, nullptr, h + r0,
                                        h + r0, partial, M,
                                        j - r0 < R ? j - r0 : R, blocks,
                                        stream);
      }
      if (err == cudaSuccess) {
        err = update<T, kLoad>(V, src, out, h, M, j, blocks, stream);
      }
      src = out;
    }
    return (int)err;
  }
  err = sweep<T, kLoad, kProject>(V, v, nullptr, h, h, partial, M, j, blocks,
                                  stream);
  for (int p = 1; p < passes && err == cudaSuccess; ++p) {
    err = sweep<T, kLoad, kFused>(V, src, out, h, h, partial, M, j, blocks,
                                  stream);
    src = out;
  }
  if (err == cudaSuccess) {
    err = sweep<T, kLoad, kUpdate>(V, src, out, h, nullptr, nullptr, M, j,
                                   blocks, stream);
  }
  return (int)err;
}

// One step of the lagged recurrence, passes >= 2, 1 <= j <= kMaxRows:
// finish V[j-1] by h_pend (j - 1 values; none when h_pend is null) while
// projecting v on V[:j], then passes - 1 fused sweeps, the last with the
// norm; out gets v_{p-1}, h (2j + 2) what cgs2_reduce_norm writes.
// passes sweeps.
template <typename T, int kLoad>
int run_step(const T* V, const T* v, T* out, const T* h_pend, T* h,
             T* partial, long long M, int j, int passes, int blocks,
             cudaStream_t stream) {
  cudaError_t err =
      h_pend != nullptr
          ? sweep<T, kLoad, kFinish>(V, v, const_cast<T*>(V) + (j - 1) * M,
                                     h_pend, h, partial, M, j, blocks, stream)
          : sweep<T, kLoad, kProject>(V, v, nullptr, nullptr, h, partial, M,
                                      j, blocks, stream);
  const T* src = v;
  for (int p = 2; p < passes && err == cudaSuccess; ++p) {
    err = sweep<T, kLoad, kFused>(V, src, out, h, h, partial, M, j, blocks,
                                  stream);
    src = out;
  }
  if (err == cudaSuccess) {
    err = sweep<T, kLoad, kFusedNorm>(V, src, out, h, h, partial, M, j,
                                      blocks, stream);
  }
  return (int)err;
}

template <typename T>
bool aligned(const void* V, const void* v, const void* out, long long M) {
  return (reinterpret_cast<uintptr_t>(V) % 16 == 0) &&
         (reinterpret_cast<uintptr_t>(v) % 16 == 0) &&
         (reinterpret_cast<uintptr_t>(out) % 16 == 0) &&
         M % (16 / (long long)sizeof(T)) == 0;
}

template <typename T>
int entry(const void* V, const void* v, void* out, void* h, void* partial,
          long long M, int j, int passes, int blocks, void* stream) {
  if (j < 1 || passes < 1 || M < 1 || blocks < 1) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr int kV = 16 / sizeof(T);
  const auto fn = aligned<T>(V, v, out, M) ? run<T, kV> : run<T, 1>;
  return fn((const T*)V, (const T*)v, (T*)out, (T*)h, (T*)partial, M, j,
            passes, blocks, (cudaStream_t)stream);
}

template <typename T>
int step_entry(const void* V, const void* v, void* out, const void* h_pend,
               void* h, void* partial, long long M, int j, int passes,
               int blocks, void* stream) {
  if (j < 1 || j > kMaxRows || (h_pend != nullptr && j < 2) || passes < 2 ||
      M < 1 || blocks < 1) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr int kV = 16 / sizeof(T);
  const auto fn = aligned<T>(V, v, out, M) ? run_step<T, kV> : run_step<T, 1>;
  return fn((const T*)V, (const T*)v, (T*)out, (const T*)h_pend, (T*)h,
            (T*)partial, M, j, passes, blocks, (cudaStream_t)stream);
}

template <typename T>
int update_entry(const void* V, const void* v, void* out, const void* h,
                 long long M, int j, int flagged, int blocks, void* stream) {
  if (j < 1 || M < 1 || blocks < 1 || (flagged && j > kMaxRows)) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr int kV = 16 / sizeof(T);
  const bool al = aligned<T>(V, v, out, M);
  if (flagged) {
    const auto fn = al ? sweep<T, kV, kUpdateIf> : sweep<T, 1, kUpdateIf>;
    return (int)fn((const T*)V, (const T*)v, (T*)out, (const T*)h, nullptr,
                   nullptr, M, j, blocks, (cudaStream_t)stream);
  }
  const auto fn = al ? update<T, kV> : update<T, 1>;
  return (int)fn((const T*)V, (const T*)v, (T*)out, (const T*)h, M, j, blocks,
                 (cudaStream_t)stream);
}

}  // namespace

extern "C" {

int cgs2_f32(const void* V, const void* v, void* out, void* h, void* partial,
             long long M, int j, int passes, int blocks, void* stream) {
  return entry<float>(V, v, out, h, partial, M, j, passes, blocks, stream);
}

int cgs2_f64(const void* V, const void* v, void* out, void* h, void* partial,
             long long M, int j, int passes, int blocks, void* stream) {
  return entry<double>(V, v, out, h, partial, M, j, passes, blocks, stream);
}

// V is the whole basis: rows [0, j) are read, row j - 1 is finished in place
// when h_pend is not null.
int cgs2_step_f32(const void* V, const void* v, void* out, const void* h_pend,
                  void* h, void* partial, long long M, int j, int passes,
                  int blocks, void* stream) {
  return step_entry<float>(V, v, out, h_pend, h, partial, M, j, passes, blocks,
                           stream);
}

int cgs2_step_f64(const void* V, const void* v, void* out, const void* h_pend,
                  void* h, void* partial, long long M, int j, int passes,
                  int blocks, void* stream) {
  return step_entry<double>(V, v, out, h_pend, h, partial, M, j, passes,
                            blocks, stream);
}

// out = v - V[:j]^T h, any j (row blocks past kMaxRows); out may be v.
// flagged: only where h[j + 1] is set (cgs2_reduce_norm's flag), j <=
// kMaxRows.
int cgs2_update_f32(const void* V, const void* v, void* out, const void* h,
                    long long M, int j, int flagged, int blocks, void* stream) {
  return update_entry<float>(V, v, out, h, M, j, flagged, blocks, stream);
}

int cgs2_update_f64(const void* V, const void* v, void* out, const void* h,
                    long long M, int j, int flagged, int blocks, void* stream) {
  return update_entry<double>(V, v, out, h, M, j, flagged, blocks, stream);
}

}  // extern "C"
