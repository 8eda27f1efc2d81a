// Periodic 3D stencil SpMV / SpMM on Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of lanczos_tpu/ops/pallas_kernels.py:
//   stencil_spmv  <- stencil_spmv_pallas (_spmv_impl -> _build_call)
//   stencil_spmm  <- stencil_spmm_pallas (_spmm_impl -> _build_call, one
//                    pallas_call per column there; one launch here)
//
// Both compute, on a periodic (nz, ny, nx) grid stored slow -> fast
// (flat index c = x + y*nx + z*nx*ny),
//
//     y[c] = sum_k w[k] * x[(c + off_k) mod grid] + diag[c] * x[c]
//
// with every offset in {-1,0,1}^3 and at most kMaxTaps taps; spmm applies
// this to each column of a row-major (M, b) block.
//
// What bounds it: bytes.  The compulsory traffic is one read of x, one read
// of diag and one write of y: 12 B/point in fp32 (24 B in fp64), i.e. 49 MB
// per SpMV at the flagship N = 160^3.  The 27 neighbour reads per point hit
// in L1/L2: neighbouring threads own neighbouring x, so a warp's taps touch
// three rows of three planes, and a block's planes stay in the 50 MB L2 while
// the blocks of the next planes run.  So this first kernel is one thread per
// output value and relies on the caches for neighbour reuse; the TPU
// kernel's slab/halo/flat-plane layout answered the TPU's (8, 128) tiling
// and VMEM and is not carried over.  Interior points take the flat
// displacement of each tap; only points on the grid's faces pay for the
// periodic wrap in the index math.
//
// Entry points take plain pointers and return cudaGetLastError() after the
// launch, so the ctypes wrapper (ops/stencil_kernels.py) can raise on a
// refused launch.  The offsets array is a host array of 3*k ints
// (dz, dy, dx per tap); weights, x, diag and y are device arrays of the
// kernel's type.  diag may be null.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kMaxTaps = 27;
constexpr int kThreads = 256;

// Passed by value (kernel parameter space): tap k's per-axis offsets and
// its flat displacement for interior points; taps k..kMaxTaps-1 are zero.
struct Taps {
  int k;
  int delta[kMaxTaps];
  signed char dz[kMaxTaps];
  signed char dy[kMaxTaps];
  signed char dx[kMaxTaps];
};

__device__ __forceinline__ int pick(int d, int minus, int zero, int plus) {
  return d < 0 ? minus : (d > 0 ? plus : zero);
}

// One thread per output value t = point * b + col (col fastest, so a warp
// reads neighbouring addresses of X).  kSingle: b == 1, no column split.
//
// Every thread runs all kMaxTaps taps with no per-tap branch: unused taps
// have weight 0 and offset 0 (they re-read x at the point itself, an L1
// hit).  Branch-free taps let the compiler issue all neighbour loads before
// the first one returns; with a guard per tap it issued them one at a time
// and the kernel waited out one cache latency per tap.
template <typename T, bool kSingle>
__global__ void __launch_bounds__(kThreads)
    stencil_kernel(const T* __restrict__ x, const T* __restrict__ diag,
                   const T* __restrict__ w, T* __restrict__ y, int nz, int ny,
                   int nx, int b, long long total, Taps taps) {
  __shared__ T sw[kMaxTaps];
  if (threadIdx.x < kMaxTaps) {
    sw[threadIdx.x] = (int)threadIdx.x < taps.k ? w[threadIdx.x] : T(0);
  }
  __syncthreads();
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const long long p = kSingle ? t : t / b;
  const long long col = kSingle ? 0 : t - p * b;
  const int ip = (int)p;
  const int xi = ip % nx;
  const int rest = ip / nx;
  const int yi = rest % ny;
  const int zi = rest / ny;

  T acc = T(0);
  const bool interior = zi > 0 && zi < nz - 1 && yi > 0 && yi < ny - 1 &&
                        xi > 0 && xi < nx - 1;
  if (interior) {
#pragma unroll
    for (int k = 0; k < kMaxTaps; ++k) {
      const long long q = p + taps.delta[k];
      acc += sw[k] * __ldg(x + (kSingle ? q : q * b + col));
    }
  } else {
    const int zm = zi == 0 ? nz - 1 : zi - 1, zp = zi == nz - 1 ? 0 : zi + 1;
    const int ym = yi == 0 ? ny - 1 : yi - 1, yp = yi == ny - 1 ? 0 : yi + 1;
    const int xm = xi == 0 ? nx - 1 : xi - 1, xp = xi == nx - 1 ? 0 : xi + 1;
#pragma unroll
    for (int k = 0; k < kMaxTaps; ++k) {
      const int zz = pick(taps.dz[k], zm, zi, zp);
      const int yy = pick(taps.dy[k], ym, yi, yp);
      const int xx = pick(taps.dx[k], xm, xi, xp);
      const long long q = ((long long)zz * ny + yy) * nx + xx;
      acc += sw[k] * __ldg(x + (kSingle ? q : q * b + col));
    }
  }
  if (diag != nullptr) acc += __ldg(diag + p) * __ldg(x + t);
  y[t] = acc;
}

template <typename T, bool kSingle>
int launch(const void* x, const void* diag, const void* w, void* y, int nz,
           int ny, int nx, int b, const int* offsets, int k, void* stream) {
  if (nz < 1 || ny < 1 || nx < 1 || b < 1 || k < 1 || k > kMaxTaps ||
      offsets == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const long long m = (long long)nz * ny * nx;
  if (m > INT_MAX) return (int)cudaErrorInvalidValue;
  Taps taps;
  taps.k = k;
  for (int i = 0; i < k; ++i) {
    const int dz = offsets[3 * i], dy = offsets[3 * i + 1],
              dx = offsets[3 * i + 2];
    if (dz < -1 || dz > 1 || dy < -1 || dy > 1 || dx < -1 || dx > 1) {
      return (int)cudaErrorInvalidValue;
    }
    taps.dz[i] = (signed char)dz;
    taps.dy[i] = (signed char)dy;
    taps.dx[i] = (signed char)dx;
    taps.delta[i] = (dz * ny + dy) * nx + dx;
  }
  for (int i = k; i < kMaxTaps; ++i) {
    taps.dz[i] = taps.dy[i] = taps.dx[i] = 0;
    taps.delta[i] = 0;
  }
  const long long total = m * b;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  stencil_kernel<T, kSingle><<<(unsigned)blocks, kThreads, 0,
                               (cudaStream_t)stream>>>(
      (const T*)x, (const T*)diag, (const T*)w, (T*)y, nz, ny, nx, b, total,
      taps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int stencil_spmv_f32(const void* x, const void* diag, const void* w, void* y,
                     int nz, int ny, int nx, const int* offsets, int k,
                     void* stream) {
  return launch<float, true>(x, diag, w, y, nz, ny, nx, 1, offsets, k, stream);
}

int stencil_spmv_f64(const void* x, const void* diag, const void* w, void* y,
                     int nz, int ny, int nx, const int* offsets, int k,
                     void* stream) {
  return launch<double, true>(x, diag, w, y, nz, ny, nx, 1, offsets, k,
                              stream);
}

int stencil_spmm_f32(const void* x, const void* diag, const void* w, void* y,
                     int nz, int ny, int nx, int b, const int* offsets, int k,
                     void* stream) {
  return launch<float, false>(x, diag, w, y, nz, ny, nx, b, offsets, k,
                              stream);
}

int stencil_spmm_f64(const void* x, const void* diag, const void* w, void* y,
                     int nz, int ny, int nx, int b, const int* offsets, int k,
                     void* stream) {
  return launch<double, false>(x, diag, w, y, nz, ny, nx, b, offsets, k,
                               stream);
}

}  // extern "C"
