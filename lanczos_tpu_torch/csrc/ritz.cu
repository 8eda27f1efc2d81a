// The Ritz rotation of the k wanted pairs, on Hopper (sm_90a):
// X = V^T W[:, cols], one read of the Lanczos basis.
//
// Replaces no TPU kernel.  The JAX package (and the port before this
// kernel) rotates every Ritz vector, X = V^T W, an (M, n) x (n, n) GEMM,
// and then keeps the k columns the selection wants: at N=160^3 (M =
// 4,096,000, n = 400, k = 20, fp32) cuBLAS spent 33.9 ms a solve on it and
// held a second 6.1 GiB block beside V, to keep 5% of its output.  The
// single-vector eigsh selects from the Ritz values first
// (solver/api.py), so the rotation it needs is the skinny one:
//
//   X[m, c] = sum_i W[i, cols[c]] V[i, m],   c < k
//
// What bounds it: bytes.  It reads V once and writes X once, (n + k) M
// elements: 6.88 GB, 2.05 ms at 3.35 TB/s.  It does 2 n k flops per point,
// 2k per element of V read: at k = 20, 10 flops a byte of fp32, half the
// card's 67 TFLOP/s fp32 over 3.35 TB/s = 20 flops a byte.  With TF32 off a
// product of fp32 operands cannot use the tensor cores, and a GEMM tile of
// 64 columns (cuBLAS's SIMT choice) wastes 44 of them at k = 20.
//
// kMaxCols = 24 is the register budget: up to KC = 24 the P x KC
// accumulators and the rest fit 128 registers a thread, so two blocks (16
// warps) share an SM.  Past it one block does, the FFMAs run at 70-80% of
// the card's rate beside the copies, and the kernel fell behind cuBLAS (H100
// 80GB HBM3, 700 W, fp32, M = 4,096,000, n = 400: k = 20 2.48 ms against
// 3.05, 24 2.81 against 3.08, 28 3.83 against 3.18, 32 4.44 against 3.13).
// So a wider k, up to every column of W, is split into chunks of `width`
// <= kMaxCols columns (ops/ritz_kernels.py:chunk_width), each block
// rotating one chunk of one range of points; the chunks of a range are
// consecutive blocks, run side by side, so V comes from DRAM about once and
// the other chunks read it from L2.  That is no longer bytes but FFMAs, at
// ~28 TFLOP/s in this design (no spills: 127 registers at KC = 24), and
// slower than cuBLAS's GEMM: all 400 columns take 46.4-46.8 ms against
// 35.7 ms, k = 25 4.6 ms against 3.1 (one launch per chunk took 49.3 and
// 6.0 ms).  Only the single-vector eigsh's k <= kMaxCols is a cell's path.
//
// This design:
//   * each thread owns P = 16 / sizeof(T) consecutive points (16 bytes of
//     every row of V) and keeps P x KC accumulators in registers, KC = the
//     chunk's width rounded up to a multiple of 4 (a template parameter, so
//     the accumulators are registers; the padded columns carry zero weights
//     and are not stored);
//   * a block of 256 threads owns one chunk of columns for 256 P
//     consecutive points (block b: chunk b % chunks of range b / chunks)
//     and walks the n rows once; each thread copies its own 16 bytes of row
//     i + kStages - 1 into a ring of kStages stages in shared memory with
//     cp.async while it works on row i, so kStages rows are in flight
//     without a register each, and no barrier is needed: a thread reads
//     only what it copied;
//   * W[:, cols] (any strides: eigh's column-major W as it comes) is
//     gathered by the block (its chunk's columns) into shared memory,
//     zero-padded to KC columns, kWBytes at a time (all 400 rows at k = 20 in fp32);
//     a row's weights are read as 16-byte broadcasts, P weights a read, so
//     a read of W feeds P x P FMAs;
//   * sums are taken row by row in the operands' type with fma, as a GEMM's
//     k-loop does; no atomics and no split over rows, so a result is bitwise
//     the same from run to run;
//   * the thread's P rows of X are P runs of the chunk's contiguous
//     elements, k apart: 16-byte stores when the chunk fills KC, all P
//     points exist and every run starts 16-byte aligned, else element
//     stores.
// Rows of V that are not 16-byte aligned (M not a multiple of P, or a V
// one element into its buffer) take element copies into the same ring.
// On an H100 80GB HBM3 at 700 W, fp32, M = 4,096,000, n = 400, k = 20 it
// takes 2.48-2.51 ms, 82% of the bound (cuBLAS's V^T W[:, cols] 3.04-3.06
// ms, the full V^T W ~34 ms); a ring of 4 or 16 stages, or blocks of 128 or
// 512 threads, ran 1-17% slower.  chip_smoke.py and
// scripts/time_torch_kernels.py time it.
// Nothing is allocated here and nothing synchronizes with the host, so a
// call captures into a CUDA graph.  The wrapper (ops/ritz_kernels.py)
// allocates X; the entry points return the first CUDA error of their
// launch (cudaGetLastError()), so the ctypes wrapper can raise.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 8;       // rows of V in flight, a power of two
constexpr int kMaxCols = 24;     // the widest k: 4 x 24 accumulators a thread
constexpr int kWBytes = 32768;   // rows of W[:, cols] staged at once
static_assert((kStages & (kStages - 1)) == 0, "the ring's index is a mask");

template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  using type = float4;
};
template <>
struct Chunk<double> {
  using type = double2;
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

// Wait until at most kPending groups of this thread's copies are in flight.
template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ float madd(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double madd(double a, double b, double c) {
  return fma(a, b, c);
}

// A weight for an index outside W's columns: the column comes out NaN.
template <typename T>
__device__ __forceinline__ T bad_index() {
  return T(__longlong_as_double(0x7ff8000000000000LL));
}

// Two blocks an SM: P x KC accumulators and the rest fit 128 registers a
// thread.
template <typename T, int KC>
__global__ void __launch_bounds__(kThreads, 2)
    ritz_rotate(const T* __restrict__ V, const T* __restrict__ W,
                const long long* __restrict__ cols, T* __restrict__ X,
                long long M, int n, long long w_row, long long w_col,
                int ncols, int k, int width, int chunks, int rows_per_stage,
                bool vec, bool vec_out) {
  constexpr int P = 16 / sizeof(T);
  static_assert(KC % 4 == 0 && KC <= kMaxCols, "KC is a multiple of 4");
  using C16 = typename Chunk<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  C16* ring = reinterpret_cast<C16*>(smem);  // [kStages][kThreads]
  T* ws = reinterpret_cast<T*>(ring + kStages * kThreads);  // [rows][KC]

  // This block's chunk: kc columns from c0, over the points from range.
  const int chunk = (int)(blockIdx.x % (unsigned)chunks);
  const long long range = blockIdx.x / (unsigned)chunks;
  const int c0 = chunk * width;
  const int kc = k - c0 < width ? k - c0 : width;
  cols += c0;
  X += c0;
  const long long m0 = (range * kThreads + threadIdx.x) * P;
  const int live = m0 < M ? (int)(M - m0 < P ? M - m0 : P) : 0;
  const T* src = V + (live ? m0 : 0);

  auto fetch = [&](int i) {
    C16* dst = ring + (i & (kStages - 1)) * kThreads + threadIdx.x;
    const T* row = src + (long long)i * M;
    if (vec) {
      cp_async<16>(dst, row, live ? 16 : 0);
    } else {
      T* d = reinterpret_cast<T*>(dst);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        cp_async<sizeof(T)>(d + p, p < live ? row + p : row,
                            p < live ? (int)sizeof(T) : 0);
      }
    }
  };

  __shared__ long long col_of[KC];
  if (threadIdx.x < KC) col_of[threadIdx.x] = threadIdx.x < kc ? cols[threadIdx.x] : 0;

  T acc[P][KC];
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int c = 0; c < KC; ++c) acc[p][c] = T(0);
  }

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n) fetch(i);
    cp_commit();
  }
  int r0 = 0;
  for (int i = 0; i < n; ++i) {
    if (i == r0 + rows_per_stage || i == 0) {
      // Stage rows [i, i + rows_per_stage) of W[:, cols], zero-padded.
      r0 = i;
      const int rows = n - r0 < rows_per_stage ? n - r0 : rows_per_stage;
      __syncthreads();
      // Column by column, row fastest: eigh's column-major W reads in runs.
#pragma unroll 4
      for (int e = threadIdx.x; e < rows * KC; e += kThreads) {
        const int c = e / rows, r = e - c * rows;
        const long long col = col_of[c];
        T w = T(0);
        if (c < kc) {
          w = col >= 0 && col < ncols ? W[(r0 + r) * w_row + col * w_col]
                                      : bad_index<T>();
        }
        ws[r * KC + c] = w;
      }
      __syncthreads();
    }
    if (i + kStages - 1 < n) fetch(i + kStages - 1);
    cp_commit();
    cp_wait<kStages - 1>();  // row i has landed
    const C16 x = ring[(i & (kStages - 1)) * kThreads + threadIdx.x];
    const T* xs = reinterpret_cast<const T*>(&x);
    const C16* w = reinterpret_cast<const C16*>(ws + (i - r0) * KC);
#pragma unroll
    for (int q = 0; q < KC / P; ++q) {
      const C16 wq = w[q];  // a broadcast: every thread reads this address
      const T* wv = reinterpret_cast<const T*>(&wq);
#pragma unroll
      for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int c = 0; c < P; ++c) {
          acc[p][q * P + c] = madd(xs[p], wv[c], acc[p][q * P + c]);
        }
      }
    }
  }
  cp_wait<0>();

  if (live == 0) return;
  T* out = X + m0 * k;
  if (kc == KC && live == P && vec_out) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int q = 0; q < KC / P; ++q) {
        C16 y;
        T* ys = reinterpret_cast<T*>(&y);
#pragma unroll
        for (int c = 0; c < P; ++c) ys[c] = acc[p][q * P + c];
        reinterpret_cast<C16*>(out + p * k)[q] = y;
      }
    }
  } else {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (p < live) {
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          if (c < kc) out[p * k + c] = acc[p][c];
        }
      }
    }
  }
}

template <typename T, int KC>
cudaError_t launch(const T* V, const T* W, const long long* cols, T* X,
                   long long M, int n, long long w_row, long long w_col,
                   int ncols, int k, int width, cudaStream_t stream) {
  constexpr int P = 16 / sizeof(T);
  const int fit = kWBytes / (KC * (int)sizeof(T));
  const int rows = n < fit ? n : fit;
  const size_t smem = (size_t)kStages * kThreads * 16 + (size_t)rows * KC * sizeof(T);
  // Always: the static col_of beside a dynamic part just under 48 KB would
  // pass the default limit too.
  const cudaError_t err = cudaFuncSetAttribute(
      ritz_rotate<T, KC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const bool vec = reinterpret_cast<uintptr_t>(V) % 16 == 0 && M % P == 0;
  const int chunks = (k + width - 1) / width;
  // Every chunk's runs 16-byte aligned: X, the row stride k and the chunk
  // starts (multiples of width) all multiples of P elements.
  const bool vec_out = reinterpret_cast<uintptr_t>(X) % 16 == 0 && k % P == 0 &&
                       (chunks == 1 || width % P == 0);
  const long long per_block = (long long)kThreads * P;
  const unsigned grid = (unsigned)((M + per_block - 1) / per_block * chunks);
  ritz_rotate<T, KC><<<grid, kThreads, smem, stream>>>(
      V, W, cols, X, M, n, w_row, w_col, ncols, k, width, chunks, rows, vec,
      vec_out);
  return cudaGetLastError();
}

template <typename T>
int entry(const void* V, const void* W, const void* cols, void* X, long long M,
          int n, long long w_row, long long w_col, int ncols, int k,
          int width, void* stream) {
  const long long per_block = (long long)kThreads * (16 / sizeof(T));
  if (M < 1 || n < 1 || k < 1 || width < 1 || width > kMaxCols || ncols < 1 ||
      (M + per_block - 1) / per_block * ((k + width - 1) / width) > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(X) % sizeof(T) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const T* v = (const T*)V;
  const T* w = (const T*)W;
  const long long* c = (const long long*)cols;
  T* x = (T*)X;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  switch ((width + 3) / 4) {
    case 1: err = launch<T, 4>(v, w, c, x, M, n, w_row, w_col, ncols, k, width, s); break;
    case 2: err = launch<T, 8>(v, w, c, x, M, n, w_row, w_col, ncols, k, width, s); break;
    case 3: err = launch<T, 12>(v, w, c, x, M, n, w_row, w_col, ncols, k, width, s); break;
    case 4: err = launch<T, 16>(v, w, c, x, M, n, w_row, w_col, ncols, k, width, s); break;
    case 5: err = launch<T, 20>(v, w, c, x, M, n, w_row, w_col, ncols, k, width, s); break;
    default: err = launch<T, 24>(v, w, c, x, M, n, w_row, w_col, ncols, k, width, s); break;
  }
  return (int)err;
}

}  // namespace

extern "C" {

int ritz_max_cols() { return kMaxCols; }

// X (M, k) row-major = V^T W[:, cols]: V (n, M) row-major; W (n, ncols),
// element (r, c) at r * w_row + c * w_col; cols, k int64 indices into W's
// columns, rotated in chunks of width <= kMaxCols columns; all on the
// device.  An index outside [0, ncols) gives a column of NaN.
int ritz_rotate_f32(const void* V, const void* W, const void* cols, void* X,
                    long long M, int n, long long w_row, long long w_col,
                    int ncols, int k, int width, void* stream) {
  return entry<float>(V, W, cols, X, M, n, w_row, w_col, ncols, k, width, stream);
}

int ritz_rotate_f64(const void* V, const void* W, const void* cols, void* X,
                    long long M, int n, long long w_row, long long w_col,
                    int ncols, int k, int width, void* stream) {
  return entry<double>(V, W, cols, X, M, n, w_row, w_col, ncols, k, width, stream);
}

}  // extern "C"
