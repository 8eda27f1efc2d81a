// Fused interface classes of the CompositeV2 operator, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lanczos_tpu/ops/interface_kernel.py:
// apply_fused_interface (its calls come from _build_calls).  CompositeV2's
// interface rows (those whose stencil reads another spacing level) fall into
// a few hundred translation-equivalent classes; every row of a class has
// the same taps, and each tap reads one level region at a fixed 3D stride:
//
//     acc[i] = sum_t w[t] * x[src_t + ((z_t + sz_t*iz)*ny_t
//                                     + (y_t + sy_t*iy))*nx_t + x_t + sx_t*ix]
//     y[out]  += acc[i]    at out = row_base + ((oz + szo*iz)*ny + ...) ...
//
// for i = (iz, iy, ix) over the class's acc_shape window, taps summed in
// the operator's tap order (the Pallas kernel's order).  x and y are the operator's flat
// region-native vectors (or row-major (M, b) blocks, one grid row of blocks
// per column); y already holds the level stencils' output, masked to 0 on
// interface rows.
//
// What bounds it: latency, not bytes.  At the N=120 production lattice the
// whole interface is 11,598 rows and 421,488 tap reads (~1.7 MB in fp32):
// one launch whose blocks each make a few dependent passes over L2.  The
// TPU kernel's design answered Mosaic, which cannot read the lane dimension
// at stride 2: it phase-split the level arrays into dense operands once per
// matvec and accumulated into phase-split outputs.  A CUDA thread reads at
// any stride, so none of that is carried over: one thread per output row
// of a class, the strided addresses computed in the index math, and every
// class is served here, whatever its strides (the TPU plan sent classes
// with strides outside {1, 2} to a plain path).
//
// Tables (built once per operator on the host, ops/interface_kernel.py):
//   cls[c*16 + ...] = row_base, ny, nx, oz, oy, ox, szo, syo, sxo,
//                     az, ay, ax, tap_begin, tap_count, block_begin, 0
//   taps[t*9 + ...]  = src_base, ny, nx, z, y, x, sz, sy, sx
//   w[t]             = tap weight, in the kernel's type
//   block_class[b]   = the class block b serves (no block spans two)
// Class output windows are disjoint (asserted on the host when the tables
// are built), so every y element has one writer and no atomics are needed.
//
// Entry points take plain pointers and return cudaGetLastError() after the
// launch, so the ctypes wrapper can raise on a refused launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kClassFields = 16;
constexpr int kTapFields = 9;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    interface_kernel(const T* __restrict__ x, T* __restrict__ y, int b,
                     const int* __restrict__ cls, const int* __restrict__ taps,
                     const T* __restrict__ w,
                     const int* __restrict__ block_class) {
  const int c = __ldg(block_class + blockIdx.x);
  const int* k = cls + (long long)c * kClassFields;
  const int az = __ldg(k + 9), ay = __ldg(k + 10), ax = __ldg(k + 11);
  const int r = (blockIdx.x - __ldg(k + 14)) * kThreads + threadIdx.x;
  if (r >= az * ay * ax) return;
  const int ix = r % ax;
  const int iy = (r / ax) % ay;
  const int iz = r / (ax * ay);
  const int col = blockIdx.y;

  const int t0 = __ldg(k + 12), t1 = t0 + __ldg(k + 13);
  T acc = T(0);
  for (int t = t0; t < t1; ++t) {
    const int* p = taps + (long long)t * kTapFields;
    const long long q =
        __ldg(p) +
        ((long long)(__ldg(p + 3) + __ldg(p + 6) * iz) * __ldg(p + 1) +
         (__ldg(p + 4) + __ldg(p + 7) * iy)) * __ldg(p + 2) +
        __ldg(p + 5) + __ldg(p + 8) * ix;
    acc += __ldg(w + t) * __ldg(x + q * b + col);
  }
  const long long o =
      __ldg(k) +
      ((long long)(__ldg(k + 3) + __ldg(k + 6) * iz) * __ldg(k + 1) +
       (__ldg(k + 4) + __ldg(k + 7) * iy)) * __ldg(k + 2) +
      __ldg(k + 5) + __ldg(k + 8) * ix;
  y[o * b + col] += acc;
}

template <typename T>
int launch(const void* x, void* y, int b, const int* cls, const int* taps,
           const void* w, const int* block_class, int n_blocks,
           void* stream) {
  if (b < 1 || b > 65535 || n_blocks < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)n_blocks, (unsigned)b);
  interface_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (T*)y, b, cls, taps, (const T*)w, block_class);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fused_interface_threads() { return kThreads; }

int fused_interface_f32(const void* x, void* y, int b, const int* cls,
                        const int* taps, const void* w,
                        const int* block_class, int n_blocks, void* stream) {
  return launch<float>(x, y, b, cls, taps, w, block_class, n_blocks, stream);
}

int fused_interface_f64(const void* x, void* y, int b, const int* cls,
                        const int* taps, const void* w,
                        const int* block_class, int n_blocks, void* stream) {
  return launch<double>(x, y, b, cls, taps, w, block_class, n_blocks, stream);
}

}  // extern "C"
