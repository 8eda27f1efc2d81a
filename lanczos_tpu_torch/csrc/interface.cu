// Fused interface classes of the CompositeV2 operator, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lanczos_tpu/ops/interface_kernel.py:
// apply_fused_interface (its calls come from _build_calls).  CompositeV2's
// interface rows (those whose stencil reads another spacing level) fall into
// a few hundred translation-equivalent classes; every row of a class has
// the same taps, and each tap reads one level region at a fixed 3D stride.
// For row i = (iz, iy, ix) of a class's acc_shape window,
//
//     y[obase + OZ*iz + OY*iy + OX*ix] +=
//         sum_t w[t] * x[base_t + Z_t*iz + Y_t*iy + X_t*ix]
//
// where the host folded each tap's region base, start and 3D stride into
// one linear form (base_t, Z_t, Y_t, X_t), and each class's output window
// into (obase, OZ, OY, OX).  x and y are the operator's flat region-native
// vectors (or row-major (M, b) blocks, one grid row of blocks per column);
// y already holds the level stencils' output, masked to 0 on interface rows.
//
// What bounds it: latency, not bytes.  At the N=120 production lattice the
// whole interface is 11,598 rows and 421,488 tap reads (~1.7 MB in fp32,
// most of it L2 hits): the time is the chain of dependent round trips a row
// waits for, times the longest tap loop, unless enough loads are in flight
// to cover it.  The first port ran one thread per row in blocks that never
// spanned two classes (classes of ~18 rows left most of each block idle)
// and walked a row's 26-108 taps serially, each tap a 9-field table load
// and a multiply chain before the x load that depends on it.
//
// This design:
//   * rows of all classes are packed densely, kThreads / kLanes to a block,
//     with a row -> class table, so no thread idles because its class is small;
//   * each row has a group of kLanes = 8 lanes of one warp; lane l takes
//     taps l, l + 8, l + 16, ... in order, kUnroll = 8 at a time with
//     their descriptor loads and then their x loads in flight together, so
//     a row of up to 64 taps makes one pass and the longest (108) two;
//   * each tap is one 16-byte descriptor load (4 ints) and one weight load;
//   * the 8 lane sums are combined by a __shfl_xor_sync butterfly (offsets
//     4, 2, 1: every lane ends with the same bits), and lane 0 writes once.
// So a row waits for about five dependent round trips (row class, class
// fields, descriptors, x, y) instead of two per tap.  kLanes and kUnroll are
// template parameters; the entry points use 8 and 8, the best of a sweep of
// kLanes in {4, 8, 16, 32} and kUnroll in {2, 4, 8, 16} on the N=120 lattice
// (scripts/sweep_torch_kernels.py, which builds this file with
// -DFUSED_INTERFACE_SWEEP to get every pair).  The host tables do not depend
// on either constant.  Summation order
// differs from the plain version's tap order (lane sums, then the
// butterfly), within the kernel tests' tolerances.  The TPU kernel's
// phase-split operands answered Mosaic, which cannot read the lane
// dimension at stride 2; a CUDA thread reads at any stride, so every class
// is served here, whatever its strides.
//
// Tables (built once per operator on the host, ops/interface_kernel.py):
//   cls[c]       = 3 int4: (row_begin, ay*ax, ax, tap_begin),
//                          (tap_end, obase, OZ, OY), (OX, 0, 0, 0)
//   taps[t]      = int4 (base_t, Z_t, Y_t, X_t)
//   w[t]         = tap weight, in the kernel's type
//   row_class[r] = the class of packed row r (rows of a class contiguous)
// Every address fits in int32 (checked on the host); x and y are indexed in
// 64 bits after the column split.  Class output windows are disjoint (also
// checked on the host), so every y element has one writer and no atomics
// are needed.
//
// Entry points take plain pointers and return cudaGetLastError() after the
// launch, so the ctypes wrapper can raise on a refused launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kClassInt4 = 3;

template <typename T, int kLanes, int kUnroll>
__global__ void __launch_bounds__(kThreads)
    interface_kernel(const T* __restrict__ x, T* __restrict__ y, int b,
                     int n_rows, const int4* __restrict__ cls,
                     const int4* __restrict__ taps, const T* __restrict__ w,
                     const int* __restrict__ row_class) {
  constexpr int kRowsPerBlock = kThreads / kLanes;
  const int r = blockIdx.x * kRowsPerBlock + threadIdx.x / kLanes;
  // A row's lanes share r, so a group leaves as a whole and the shuffles
  // below see all of its lanes.
  if (r >= n_rows) return;
  const int lane = threadIdx.x % kLanes;
  constexpr unsigned kGroupBits =
      kLanes == 32 ? 0xffffffffu : (1u << (kLanes % 32)) - 1u;
  const unsigned group = kGroupBits << ((threadIdx.x % 32) & ~(kLanes - 1));
  const int col = blockIdx.y;

  const int c = __ldg(row_class + r);
  const int4 k0 = __ldg(cls + kClassInt4 * c);
  const int4 k1 = __ldg(cls + kClassInt4 * c + 1);
  const int4 k2 = __ldg(cls + kClassInt4 * c + 2);
  const int i = r - k0.x;
  const int iz = i / k0.y;
  const int rem = i - iz * k0.y;
  const int iy = rem / k0.z;
  const int ix = rem - iy * k0.z;
  const int t_end = k1.x;

  T acc = T(0);
  for (int t = k0.w + lane; t < t_end; t += kLanes * kUnroll) {
    int q[kUnroll];
    T wt[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int tt = t + u * kLanes;
      const bool ok = tt < t_end;
      const int4 d = ok ? __ldg(taps + tt) : make_int4(0, 0, 0, 0);
      wt[u] = ok ? __ldg(w + tt) : T(0);
      q[u] = d.x + d.y * iz + d.z * iy + d.w * ix;
    }
    T xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      xv[u] = t + u * kLanes < t_end ? __ldg(x + (long long)q[u] * b + col)
                                     : T(0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc += wt[u] * xv[u];
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off /= 2) {
    acc += __shfl_xor_sync(group, acc, off, kLanes);
  }
  if (lane == 0) {
    const long long o = k1.y + k1.z * iz + k1.w * iy + k2.x * ix;
    y[o * b + col] += acc;
  }
}

template <typename T, int kLanes = 8, int kUnroll = 8>
int launch(const void* x, void* y, int b, int n_rows, const int* cls,
           const int* taps, const void* w, const int* row_class,
           void* stream) {
  constexpr int kRowsPerBlock = kThreads / kLanes;
  if (b < 1 || b > 65535 || n_rows < 1) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(cls) | reinterpret_cast<uintptr_t>(taps)) &
      15) {
    return (int)cudaErrorMisalignedAddress;  // read as int4
  }
  const dim3 grid((unsigned)((n_rows + kRowsPerBlock - 1) / kRowsPerBlock),
                  (unsigned)b);
  interface_kernel<T, kLanes, kUnroll>
      <<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (T*)y, b, n_rows, (const int4*)cls, (const int4*)taps,
      (const T*)w, row_class);
  return (int)cudaGetLastError();
}

#ifdef FUSED_INTERFACE_SWEEP
using Launcher = int (*)(const void*, void*, int, int, const int*, const int*,
                         const void*, const int*, void*);

template <int kLanes>
Launcher sweep_launcher(int unroll) {
  switch (unroll) {
    case 2: return launch<float, kLanes, 2>;
    case 4: return launch<float, kLanes, 4>;
    case 8: return launch<float, kLanes, 8>;
    case 16: return launch<float, kLanes, 16>;
    default: return nullptr;
  }
}
#endif

}  // namespace

extern "C" {

#ifdef FUSED_INTERFACE_SWEEP
// fp32 with kLanes in {4, 8, 16, 32} and kUnroll in {2, 4, 8, 16}: for
// tuning only (scripts/sweep_torch_kernels.py); the package never builds it.
int fused_interface_sweep_f32(int lanes, int unroll, const void* x, void* y,
                              int b, int n_rows, const int* cls,
                              const int* taps, const void* w,
                              const int* row_class, void* stream) {
  const Launcher fn = lanes == 4    ? sweep_launcher<4>(unroll)
                      : lanes == 8  ? sweep_launcher<8>(unroll)
                      : lanes == 16 ? sweep_launcher<16>(unroll)
                      : lanes == 32 ? sweep_launcher<32>(unroll)
                                    : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return fn(x, y, b, n_rows, cls, taps, w, row_class, stream);
}
#endif

int fused_interface_f32(const void* x, void* y, int b, int n_rows,
                        const int* cls, const int* taps, const void* w,
                        const int* row_class, void* stream) {
  return launch<float>(x, y, b, n_rows, cls, taps, w, row_class, stream);
}

int fused_interface_f64(const void* x, void* y, int b, int n_rows,
                        const int* cls, const int* taps, const void* w,
                        const int* row_class, void* stream) {
  return launch<double>(x, y, b, n_rows, cls, taps, w, row_class, stream);
}

}  // extern "C"
