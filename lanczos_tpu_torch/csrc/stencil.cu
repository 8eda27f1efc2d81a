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
// stencil_spmm: the same z-march on a wider grid.  A row-major (M, b) block
// is a grid (nz, ny, nx*b) whose x-taps step by b elements, so one launch
// serves all b columns.  The first port's kernel (one thread per output
// value, 27 __ldg loads with the neighbour reuse left to L1/L2, z-neighbours
// nx*ny*b*4 bytes away) was issue-bound at 13% of its byte bound.  Here:
//   * a block owns a tile of ty x tx points of the (y, x) plane with all b
//     columns of each point (or a chunk of cb columns; see below) and
//     marches along z over a chunk of zc planes;
//   * cp.async copies each input plane's tile with its one-point periodic
//     halo (one row on each y side, one point = cw elements on each x
//     side), plus the diag tile, into a ring of kStages shared-memory
//     stages, kStages - 1 planes ahead.  A point's cw columns are one run
//     of 16-byte copies where b * sizeof(T) and the chunk allow it and x is
//     16-byte aligned (checked here, on the host side of the launch), else
//     element copies; each copy's source, wrap included, is worked out once
//     per block;
//   * each thread owns kSpmmOutputs = 4 consecutive rows of one (point,
//     column): per plane it reads the 6 rows of 3 in-plane neighbours those
//     outputs need from shared memory once (18 reads for 4 outputs) and
//     feeds three register accumulators per output that rotate along z
//     (taps dz = +1, 0, -1); the weights are kernel parameters, as in the
//     SpMV, and the diagonal term joins the dz = 0 accumulator when its
//     plane is read.
// The tile (ty, tx, cb) and the z-chunk are launch arguments, picked on the
// host (ops/stencil_kernels.py:spmm_tile, spmm_z_chunk).  A tile row holds
// at most about 640 bytes of outputs (tx * b * sizeof(T); 8 x 8 points at
// b = 20 in fp32), so a stage is at most ~12 KB and a block's 4-stage ring
// at most ~47 KB (33 KB at b = 20 in fp32): under the 48 KB of shared
// memory a block gets without opting in, with room for more resident
// blocks than the registers allow (64 a thread in fp32, 320 threads a
// block at b = 20: three blocks per SM).  When b is so wide that the tile
// would fall below 4 points along x, the columns are split across
// blockIdx.x into chunks of cb columns, a multiple of one 32-byte DRAM
// sector, so that blocks of neighbouring chunks never read the same
// sectors.  The compulsory traffic at b = 20 in fp32 is 164 B/point (x, y
// and diag): 0.2005 ms at N = 160^3 at the published 3.35 TB/s.
//
// Entry points take plain pointers and return cudaGetLastError() after the
// launch, so the ctypes wrapper (ops/stencil_kernels.py) can raise on a
// refused launch.  x, diag and y are device arrays of the kernel's type;
// diag may be null.  Both take their 27 dense weights as a host array of
// doubles, index (dz+1)*9 + (dy+1)*3 + (dx+1), in which the host summed any
// duplicate offsets.

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

// Outputs per thread of the package's entry points: kSpmmOutputs
// consecutive rows of one (point, column) (the sweep build adds others, at
// the end of this file).
constexpr int kSpmmOutputs = 4;
constexpr int kSpmmMaxThreads = 512;

// The tile of one block: ty x tx points, cb columns (the widest chunk).
struct SpmmTile {
  int ty, tx, cb;
};

// Elements of one ring stage: the x tile with its halo at the widest chunk,
// then the diag tile, rounded up to 16 bytes so that every stage starts
// aligned.
template <typename T>
__host__ __device__ int spmm_stage_elems(const SpmmTile& t, bool diag) {
  constexpr int kV = 16 / sizeof(T);
  const int n = (t.ty + 2) * (t.tx + 2) * t.cb + (diag ? t.ty * t.tx : 0);
  return (n + kV - 1) / kV * kV;
}

// Threads of a block: one per (point, column) of a tile row and group of
// kR rows, in whole warps.
int spmm_threads(const SpmmTile& t, int r) {
  return (t.tx * t.cb * (t.ty / r) + 31) / 32 * 32;
}

// x copies a thread makes per plane, at most, with copies of kV elements
// (the launch checks the tile): a tile of ty >= 8 rows and tx >= 4 points
// has at most 1.875 times as many halo'd cells as outputs.
__host__ __device__ constexpr int spmm_x_slots(int r, int kv) {
  return (5 * r / 2 + kv - 1) / kv + 1;
}

// Block = (column chunk, x tile) blockIdx.x, y tile blockIdx.y, output
// planes [z0, z0 + zc) with z0 = blockIdx.z * zc.  A stage holds a tile
// row of tx + 2 points (halo included) at a stride of cw elements, for
// ty + 2 rows, then the diag tile (ty x tx).  Copy j of a plane fills
// stage element j * kV: point rp = j / (cw / kV) of the halo'd tile, its
// (j % (cw / kV))-th run of kV columns.  Thread t owns element
// e = t % (tx * cw) of tile rows g * kR ... g * kR + kR - 1, g = t / (tx *
// cw) (point e / cw, column e % cw): per plane it reads the kR + 2 rows of
// 3 neighbours those outputs need once each.  Iteration i reads input
// plane p = z0 - 1 + i as the SpMV does: taps dz = +1 feed output p - 1
// (am), dz = 0 output p (a0, with the diagonal term), dz = -1 output p + 1
// (ap); output p - 1 is then complete.
template <typename T, bool kVec, int kR>
__global__ void __launch_bounds__(kSpmmMaxThreads)
    spmm_kernel(const T* __restrict__ x, const T* __restrict__ diag,
                T* __restrict__ y, int nz, int ny, int nx, int b,
                SpmmTile tile, int zc, Weights<T> W) {
  constexpr int kV = kVec ? 16 / sizeof(T) : 1;  // elements per copy
  constexpr int kXSlots = spmm_x_slots(kR, kV);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int tiles_x = (nx + tile.tx - 1) / tile.tx;
  const int chunk = blockIdx.x / tiles_x;
  const int tx0 = (blockIdx.x - chunk * tiles_x) * tile.tx;
  const int ty0 = blockIdx.y * tile.ty;
  const int z0 = blockIdx.z * zc;
  const int c0 = chunk * tile.cb;
  const int cw = min(tile.cb, b - c0);  // this chunk's columns
  const int pts = tile.tx + 2;          // points of a halo'd tile row
  const int stride = pts * cw;          // elements of a tile row
  const int row_out = tile.tx * cw;     // outputs of a tile row
  const int x_cells = (tile.ty + 2) * stride;
  const int stage_elems = spmm_stage_elems<T>(tile, diag != nullptr);
  const int n_planes = min(zc, nz - z0) + 2;
  const long long plane = (long long)ny * nx;

  // Sources of this thread's copies within a plane, wrap included.
  const int runs = cw / kV;  // copies per point
  const int n_xc = (tile.ty + 2) * pts * runs;
  int xg[kXSlots];
#pragma unroll
  for (int s = 0; s < kXSlots; ++s) {
    const int j = tid + s * nthreads;
    const int rp = j / runs, row = rp / pts, p = rp - row * pts;
    xg[s] = j < n_xc ? (wrap(ty0 + row - 1, ny) * nx + wrap(tx0 + p - 1, nx)) *
                               b +
                           c0 + (j - rp * runs) * kV
                     : -1;
  }
  int dg[kR];  // diag copies: ty * tx <= kR * blockDim.x
#pragma unroll
  for (int s = 0; s < kR; ++s) {
    const int j = tid + s * nthreads, row = j / tile.tx;
    dg[s] = diag != nullptr && j < tile.ty * tile.tx
                ? wrap(ty0 + row, ny) * nx + wrap(tx0 + j - row * tile.tx, nx)
                : -1;
  }
  // This thread's outputs: the centre cell of its first row in a stage, its
  // diag cell, its first row's offset in a plane of y, and which of its
  // rows lie on the grid (none for the spare threads of the last warp).
  const bool active = tid < row_out * (tile.ty / kR);
  const int g = active ? tid / row_out : 0;
  const int e = active ? tid - g * row_out : 0;
  const int px = e / cw, row0 = g * kR;
  const int cen = (row0 + 1) * stride + cw + e;
  const int dcen = x_cells + row0 * tile.tx + px;
  const int out0 = ((ty0 + row0) * nx + tx0 + px) * b + c0 + e - px * cw;
  const int row_step = nx * b;
  unsigned valid = 0;
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    if (active && tx0 + px < nx && ty0 + row0 + k < ny) valid |= 1u << k;
  }

  auto load = [&](int i) {
    const long long zp = wrap(z0 - 1 + i, nz);
    T* stage = smem + (i % kStages) * stage_elems;
    const T* xp = x + zp * plane * b;
#pragma unroll
    for (int s = 0; s < kXSlots; ++s) {
      if (xg[s] >= 0) {
        cp_async<kV * sizeof(T)>(stage + (tid + s * nthreads) * kV, xp + xg[s]);
      }
    }
    if (diag == nullptr) return;
    const T* dp = diag + zp * plane;
#pragma unroll
    for (int s = 0; s < kR; ++s) {
      if (dg[s] >= 0) {
        cp_async<sizeof(T)>(stage + x_cells + tid + s * nthreads, dp + dg[s]);
      }
    }
  };

  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_planes) load(i);
    cp_commit();
  }
  T am[kR], a0[kR], ap[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) am[r] = a0[r] = ap[r] = T(0);
  for (int i = 0; i < n_planes; ++i) {
    cp_wait<kStages - 2>();
    __syncthreads();
    const T* stage = smem + (i % kStages) * stage_elems;
    // Stage row row0 + k feeds output rows k - 2 .. k (in-plane dy = k - r).
#pragma unroll
    for (int k = 0; k < kR + 2; ++k) {
      const T* c = stage + cen + (k - 1) * stride;
      const T v[3] = {c[-cw], c[0], c[cw]};
#pragma unroll
      for (int r = k - 2; r <= k; ++r) {
        if (r < 0 || r >= kR) continue;
        const int dy = k - r;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          am[r] += W.w[18 + dy * 3 + dx] * v[dx];
          a0[r] += W.w[9 + dy * 3 + dx] * v[dx];
          ap[r] += W.w[dy * 3 + dx] * v[dx];
        }
      }
      if (diag != nullptr && k >= 1 && k <= kR) {
        a0[k - 1] += stage[dcen + (k - 1) * tile.tx] * v[1];
      }
    }
    if (i >= 2) {
      T* yp = y + (long long)(z0 + i - 2) * plane * b + out0;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (valid & (1u << r)) yp[r * row_step] = am[r];
      }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      am[r] = a0[r];
      a0[r] = ap[r];
      ap[r] = T(0);
    }
    // Stage (i + kStages - 1) % kStages held plane i - 1, which every
    // thread finished reading before this iteration's barrier.
    if (i + kStages - 1 < n_planes) load(i + kStages - 1);
    cp_commit();
  }
}

template <typename T, bool kVec, int kR>
cudaError_t spmm_prepare(const SpmmTile& t, bool diag, int* threads,
                         size_t* smem) {
  *threads = spmm_threads(t, kR);
  *smem = (size_t)kStages * spmm_stage_elems<T>(t, diag) * sizeof(T);
  if (*smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(spmm_kernel<T, kVec, kR>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

template <typename T, bool kVec, int kR>
int launch_spmm_as(const T* x, const T* diag, T* y, int nz, int ny, int nx,
                   int b, const SpmmTile& t, int zc, const Weights<T>& W,
                   cudaStream_t stream) {
  constexpr int kV = kVec ? 16 / sizeof(T) : 1;
  int threads = 0;
  size_t smem = 0;
  const cudaError_t err =
      spmm_prepare<T, kVec, kR>(t, diag != nullptr, &threads, &smem);
  if (err != cudaSuccess) return (int)err;
  const int x_copies = (t.ty + 2) * (t.tx + 2) * (t.cb / kV);
  if (threads > kSpmmMaxThreads ||
      (x_copies + threads - 1) / threads > spmm_x_slots(kR, kV)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long tiles_x = (nx + t.tx - 1) / t.tx;
  const long long blocks_x = tiles_x * ((b + t.cb - 1) / t.cb);
  const int blocks_y = (ny + t.ty - 1) / t.ty, blocks_z = (nz + zc - 1) / zc;
  if (blocks_x > INT_MAX || blocks_y > 65535 || blocks_z > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  spmm_kernel<T, kVec, kR>
      <<<dim3((unsigned)blocks_x, blocks_y, blocks_z), threads, smem, stream>>>(
          x, diag, y, nz, ny, nx, b, t, zc, W);
  return (int)cudaGetLastError();
}

// 16-byte copies: each point's run of the chunk is whole 16-byte pieces
// and x is 16-byte aligned (a slice of a block may not be).
template <typename T>
bool spmm_vec(const void* x, int b, int cb) {
  return (b * sizeof(T)) % 16 == 0 && (cb * sizeof(T)) % 16 == 0 &&
         (x == nullptr || aligned16(x));
}

template <typename T, int kR>
int launch_spmm(const void* x, const void* diag, void* y, int nz, int ny,
                int nx, int b, int ty, int tx, int cb, int zc,
                const double* w27, void* stream) {
  if (nz < 1 || ny < 1 || nx < 1 || b < 1 || ty < 1 || tx < 1 || cb < 1 ||
      cb > b || zc < 1 || ty % kR != 0 || w27 == nullptr ||
      (long long)(ny + ty) * nx * b > INT_MAX ||
      (long long)ty * tx * cb > (long long)kR * kSpmmMaxThreads) {
    return (int)cudaErrorInvalidValue;
  }
  Weights<T> W;
  for (int i = 0; i < kMaxTaps; ++i) W.w[i] = (T)w27[i];
  const SpmmTile t{ty, tx, cb};
  const auto s = (cudaStream_t)stream;
  const T *xt = (const T*)x, *dt = (const T*)diag;
  return spmm_vec<T>(x, b, cb)
             ? launch_spmm_as<T, true, kR>(xt, dt, (T*)y, nz, ny, nx, b, t,
                                           zc, W, s)
             : launch_spmm_as<T, false, kR>(xt, dt, (T*)y, nz, ny, nx, b, t,
                                            zc, W, s);
}

// Blocks of the SpMM kernel that launch_spmm would start for this tile,
// resident on the current device at once (16-byte copies where b and cb
// allow them).
template <typename T>
int spmm_resident_blocks(int b, int ty, int tx, int cb, int diag) {
  const SpmmTile t{ty, tx, cb};
  const bool vec = spmm_vec<T>(nullptr, b, cb);
  int dev = 0, sms = 0, per_sm = 0, threads = 0;
  size_t smem = 0;
  cudaError_t err = vec ? spmm_prepare<T, true, kSpmmOutputs>(
                              t, diag != 0, &threads, &smem)
                        : spmm_prepare<T, false, kSpmmOutputs>(
                              t, diag != 0, &threads, &smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = vec ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &per_sm, spmm_kernel<T, true, kSpmmOutputs>, threads, smem)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &per_sm, spmm_kernel<T, false, kSpmmOutputs>, threads,
                    smem);
  }
  return err == cudaSuccess ? sms * per_sm : -(int)err;
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

int stencil_spmm_f32(const void* x, const void* diag, void* y, int nz, int ny,
                     int nx, int b, int ty, int tx, int cb, int zc,
                     const double* w27, void* stream) {
  return launch_spmm<float, kSpmmOutputs>(x, diag, y, nz, ny, nx, b, ty, tx,
                                          cb, zc, w27, stream);
}

int stencil_spmm_f64(const void* x, const void* diag, void* y, int nz, int ny,
                     int nx, int b, int ty, int tx, int cb, int zc,
                     const double* w27, void* stream) {
  return launch_spmm<double, kSpmmOutputs>(x, diag, y, nz, ny, nx, b, ty, tx,
                                           cb, zc, w27, stream);
}

int stencil_spmm_outputs_per_thread() { return kSpmmOutputs; }

int stencil_spmm_resident_f32(int b, int ty, int tx, int cb, int diag) {
  return spmm_resident_blocks<float>(b, ty, tx, cb, diag);
}

int stencil_spmm_resident_f64(int b, int ty, int tx, int cb, int diag) {
  return spmm_resident_blocks<double>(b, ty, tx, cb, diag);
}

#ifdef STENCIL_SPMM_SWEEP
// fp32 SpMM with kR outputs per thread in {1, 2, 4, 8}, for
// scripts/sweep_torch_kernels.py; the tile, chunk and z-chunk are the
// entry point's own arguments.
int stencil_spmm_sweep_f32(int r, const void* x, const void* diag, void* y,
                           int nz, int ny, int nx, int b, int ty, int tx,
                           int cb, int zc, const double* w27, void* stream) {
  switch (r) {
    case 1:
      return launch_spmm<float, 1>(x, diag, y, nz, ny, nx, b, ty, tx, cb, zc,
                                   w27, stream);
    case 2:
      return launch_spmm<float, 2>(x, diag, y, nz, ny, nx, b, ty, tx, cb, zc,
                                   w27, stream);
    case 4:
      return launch_spmm<float, 4>(x, diag, y, nz, ny, nx, b, ty, tx, cb, zc,
                                   w27, stream);
    case 8:
      return launch_spmm<float, 8>(x, diag, y, nz, ny, nx, b, ty, tx, cb, zc,
                                   w27, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
#endif

}  // extern "C"
