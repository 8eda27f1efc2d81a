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
// What bounds them: bytes.  The compulsory traffic is one read of x, one
// read of diag and one write of y: 12 B/point in fp32 (24 B in fp64), i.e.
// 49 MB per SpMV at the flagship N = 160^3.
//
// stencil_spmv: a 2.5D z-march with a shared-memory plane ring.  The first
// port ran one thread per point and made all 27 tap loads through L1/L2,
// with the periodic wrap in the index math: ~400 instructions a point, so
// it was bound by instruction throughput, at 13% of the copy rate.  Here a
// block of 32 x 8 threads owns a 32 x 8 tile of the (y, x) plane and
// marches along z over a chunk of planes:
//   * each input plane's tile, with its one-point periodic halo, and the
//     tile of diag are copied into a ring of kStages shared-memory stages
//     by cp.async, kStages - 1 planes ahead of the one in use, 16 bytes a
//     copy along x where nx and the pointers allow (the halo columns and
//     other grids take element copies).  The wrap is worked out once per
//     copy slot when the block starts, not per tap or per plane;
//   * each thread reads its 9 in-plane neighbours of a plane from shared
//     memory once, and they feed the three output planes the plane touches
//     (taps dz = +1, 0, -1) through three register accumulators that rotate
//     along z; the weights are kernel parameters, so each tap is one FMA
//     with a constant operand.  The diagonal term uses the centre value and
//     diag kept from the plane before;
//   * the host picks the z-chunk from the grid and the card's resident
//     blocks (ops/stencil_kernels.py:spmv_z_chunk), so small grids (the
//     irregular lattice's 40^3 and 60^3 level regions) still fill the card.
// Taps are summed grouped by dz and in-plane offset, not in the operator's
// tap order; absent taps weigh 0.
//
// stencil_spmm: one thread per output value t = point * b + col (col
// fastest, so a warp reads neighbouring addresses of X), all 27 taps
// branch-free (unused taps weigh 0 and re-read the point itself), the
// neighbour reuse left to L1/L2, and the periodic wrap in the index math for
// points on the grid's faces.  It is the first port's kernel, unchanged.
//
// Entry points take plain pointers and return cudaGetLastError() after the
// launch, so the ctypes wrapper (ops/stencil_kernels.py) can raise on a
// refused launch.  x, diag and y are device arrays of the kernel's type;
// diag may be null.  stencil_spmv takes its 27 dense weights as a host
// array of doubles, index (dz+1)*9 + (dy+1)*3 + (dx+1); stencil_spmm takes
// a host array of 3*k offsets (dz, dy, dx per tap) and k device weights.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxTaps = 27;

// ------------------------------------------------------------------ SpMV

constexpr int kTX = 32;
constexpr int kTY = 8;
constexpr int kMarchThreads = kTX * kTY;
constexpr int kStages = 4;

template <typename T>
struct Geom {
  static constexpr int kV = 16 / sizeof(T);     // elements per 16-byte copy
  static constexpr int kStride = kTX + 2 * kV;  // a tile row: halo at kV-1,
                                                // interior at [kV, kV + kTX)
  static constexpr int kRows = kTY + 2;
  static constexpr int kPlane = kRows * kStride;
  static constexpr int kStage = kPlane + kTY * kTX;  // x tile, then diag tile
};

template <typename T>
struct Weights {
  T w[kMaxTaps];  // (dz+1)*9 + (dy+1)*3 + (dx+1)
};

// v >= -1: its periodic image in [0, n).
__device__ __forceinline__ int wrap(int v, int n) {
  return v < 0 ? v + n : (v >= n ? v % n : v);
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(kBytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// One copy into a stage: shared offset s (-1: none), in-plane source offset
// g, 16 bytes (wide) or one element.
struct Copy {
  int s;
  int g;
  bool wide;
};

// Copy j of a plane's x tile with its halo.  kVec: each tile row is kTX/kV
// 16-byte copies and two element copies (the halo columns); else kTX + 2
// element copies.  A 16-byte copy past nx wraps as a whole (nx % kV == 0).
template <typename T, bool kVec>
__device__ __forceinline__ Copy x_copy(int j, int ty0, int tx0, int ny,
                                       int nx) {
  using G = Geom<T>;
  constexpr int kChunks = kVec ? kTX / G::kV : 0;
  constexpr int kPerRow = kVec ? kChunks + 2 : kTX + 2;
  if (j >= G::kRows * kPerRow) return Copy{-1, 0, false};
  const int row = j / kPerRow, e = j % kPerRow;
  const bool wide = kVec && e < kChunks;
  // Column of the copy relative to tx0: -1 and kTX are the halo.
  const int h = wide ? e * G::kV : (kVec ? (e == kChunks ? -1 : kTX) : e - 1);
  return Copy{row * G::kStride + G::kV + h,
              wrap(ty0 + row - 1, ny) * nx + wrap(tx0 + h, nx), wide};
}

// Copy j of a plane's diag tile (no halo).
template <typename T, bool kVec>
__device__ __forceinline__ Copy diag_copy(int j, int ty0, int tx0, int ny,
                                          int nx) {
  using G = Geom<T>;
  constexpr int kPerRow = kVec ? kTX / G::kV : kTX;
  if (j >= kTY * kPerRow) return Copy{-1, 0, false};
  const int row = j / kPerRow, h = (j % kPerRow) * (kVec ? G::kV : 1);
  return Copy{G::kPlane + row * kTX + h,
              wrap(ty0 + row, ny) * nx + wrap(tx0 + h, nx), kVec};
}

template <typename T>
__device__ __forceinline__ void stage_copy(T* stage, const T* plane, Copy c) {
  if (c.s < 0) return;
  if (c.wide) {
    cp_async<16>(stage + c.s, plane + c.g);
  } else {
    cp_async<sizeof(T)>(stage + c.s, plane + c.g);
  }
}

// Block (kTX*kTY threads) = tile (blockIdx.x, blockIdx.y) of the (y, x)
// plane, output planes [z0, z0 + zc) with z0 = blockIdx.z * zc.  Iteration
// i reads input plane p = z0 - 1 + i from ring stage i % kStages; its
// neighbours feed output p - 1 (taps dz = +1, accumulator am), p (dz = 0,
// a0) and p + 1 (dz = -1, ap); output p - 1 is then complete and written.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kMarchThreads, 3)
    spmv_kernel(const T* __restrict__ x, const T* __restrict__ diag,
                T* __restrict__ y, int nz, int ny, int nx, int zc,
                Weights<T> W) {
  using G = Geom<T>;
  __shared__ __align__(16) T smem[kStages * G::kStage];
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const int tx0 = blockIdx.x * kTX, ty0 = blockIdx.y * kTY;
  const int z0 = blockIdx.z * zc;
  const int n_planes = min(zc, nz - z0) + 2;
  const long long plane = (long long)ny * nx;

  const Copy c0 = x_copy<T, kVec>(threadIdx.x, ty0, tx0, ny, nx);
  const Copy c1 =
      x_copy<T, kVec>(threadIdx.x + kMarchThreads, ty0, tx0, ny, nx);
  const Copy cd = diag == nullptr
                      ? Copy{-1, 0, false}
                      : diag_copy<T, kVec>(threadIdx.x, ty0, tx0, ny, nx);
  auto load = [&](int i) {
    const long long off = wrap(z0 - 1 + i, nz) * plane;
    T* stage = smem + (i % kStages) * G::kStage;
    stage_copy(stage, x + off, c0);
    stage_copy(stage, x + off, c1);
    if (diag != nullptr) stage_copy(stage, diag + off, cd);
  };

  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_planes) load(i);
    cp_commit();
  }
  const bool valid = tx0 + tx < nx && ty0 + ty < ny;
  const long long out = (long long)(ty0 + ty) * nx + tx0 + tx;
  T am = T(0), a0 = T(0), ap = T(0), x_prev = T(0), d_prev = T(0);
  for (int i = 0; i < n_planes; ++i) {
    cp_wait<kStages - 2>();
    __syncthreads();
    const T* stage = smem + (i % kStages) * G::kStage;
    const T* c = stage + (ty + 1) * G::kStride + G::kV + tx;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const T v = c[(dy - 1) * G::kStride + dx - 1];
        am += W.w[18 + dy * 3 + dx] * v;
        a0 += W.w[9 + dy * 3 + dx] * v;
        ap += W.w[dy * 3 + dx] * v;
      }
    }
    if (i >= 2 && valid) {
      y[(z0 + i - 2) * plane + out] =
          diag == nullptr ? am : am + d_prev * x_prev;
    }
    am = a0;
    a0 = ap;
    ap = T(0);
    x_prev = c[0];
    d_prev = diag == nullptr ? T(0) : stage[G::kPlane + ty * kTX + tx];
    // Stage (i + kStages - 1) % kStages held plane i - 1, which every
    // thread finished reading before this iteration's barrier.
    if (i + kStages - 1 < n_planes) load(i + kStages - 1);
    cp_commit();
  }
}

template <typename T, bool kVec>
int launch_spmv_as(const T* x, const T* diag, T* y, int nz, int ny, int nx,
                   int zc, const Weights<T>& W, cudaStream_t stream) {
  const dim3 grid((unsigned)((nx + kTX - 1) / kTX),
                  (unsigned)((ny + kTY - 1) / kTY),
                  (unsigned)((nz + zc - 1) / zc));
  spmv_kernel<T, kVec><<<grid, kMarchThreads, 0, stream>>>(x, diag, y, nz, ny,
                                                         nx, zc, W);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
int launch_spmv(const void* x, const void* diag, void* y, int nz, int ny,
                int nx, int zc, const double* w27, void* stream) {
  if (nz < 1 || ny < 1 || nx < 1 || zc < 1 || w27 == nullptr ||
      ny > 65535 * kTY) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)nz * ny * nx > INT_MAX || (nz + zc - 1) / zc > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  Weights<T> W;
  for (int i = 0; i < kMaxTaps; ++i) W.w[i] = (T)w27[i];
  const bool vec = nx % Geom<T>::kV == 0 && aligned16(x) &&
                   (diag == nullptr || aligned16(diag));
  const auto s = (cudaStream_t)stream;
  return vec ? launch_spmv_as<T, true>((const T*)x, (const T*)diag, (T*)y, nz,
                                       ny, nx, zc, W, s)
             : launch_spmv_as<T, false>((const T*)x, (const T*)diag, (T*)y,
                                        nz, ny, nx, zc, W, s);
}

// Blocks of the SpMV kernel resident on the current device at once.
template <typename T>
int spmv_resident_blocks() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, spmv_kernel<T, true>, kMarchThreads, 0);
  }
  return err == cudaSuccess ? sms * per_sm : -(int)err;
}

// ------------------------------------------------------------------ SpMM

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

// One thread per output value t = point * b + col.
//
// Every thread runs all kMaxTaps taps with no per-tap branch: unused taps
// have weight 0 and offset 0 (they re-read x at the point itself, an L1
// hit).  Branch-free taps let the compiler start all neighbour loads before
// the first one returns; with a guard per tap it started them one at a time
// and the kernel waited out one cache latency per tap.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    spmm_kernel(const T* __restrict__ x, const T* __restrict__ diag,
                const T* __restrict__ w, T* __restrict__ y, int nz, int ny,
                int nx, int b, long long total, Taps taps) {
  __shared__ T sw[kMaxTaps];
  if (threadIdx.x < kMaxTaps) {
    sw[threadIdx.x] = (int)threadIdx.x < taps.k ? w[threadIdx.x] : T(0);
  }
  __syncthreads();
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const long long p = t / b;
  const long long col = t - p * b;
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
      acc += sw[k] * __ldg(x + (q * b + col));
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
      acc += sw[k] * __ldg(x + (q * b + col));
    }
  }
  if (diag != nullptr) acc += __ldg(diag + p) * __ldg(x + t);
  y[t] = acc;
}

template <typename T>
int launch_spmm(const void* x, const void* diag, const void* w, void* y,
                int nz, int ny, int nx, int b, const int* offsets, int k,
                void* stream) {
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
  spmm_kernel<T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)diag, (const T*)w, (T*)y, nz, ny, nx, b, total,
      taps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int stencil_spmv_f32(const void* x, const void* diag, void* y, int nz, int ny,
                     int nx, int zc, const double* w27, void* stream) {
  return launch_spmv<float>(x, diag, y, nz, ny, nx, zc, w27, stream);
}

int stencil_spmv_f64(const void* x, const void* diag, void* y, int nz, int ny,
                     int nx, int zc, const double* w27, void* stream) {
  return launch_spmv<double>(x, diag, y, nz, ny, nx, zc, w27, stream);
}

int stencil_spmv_tile_y() { return kTY; }

int stencil_spmv_tile_x() { return kTX; }

int stencil_spmv_resident_f32() { return spmv_resident_blocks<float>(); }

int stencil_spmv_resident_f64() { return spmv_resident_blocks<double>(); }

int stencil_spmm_f32(const void* x, const void* diag, const void* w, void* y,
                     int nz, int ny, int nx, int b, const int* offsets, int k,
                     void* stream) {
  return launch_spmm<float>(x, diag, w, y, nz, ny, nx, b, offsets, k, stream);
}

int stencil_spmm_f64(const void* x, const void* diag, const void* w, void* y,
                     int nz, int ny, int nx, int b, const int* offsets, int k,
                     void* stream) {
  return launch_spmm<double>(x, diag, w, y, nz, ny, nx, b, offsets, k, stream);
}

}  // extern "C"
