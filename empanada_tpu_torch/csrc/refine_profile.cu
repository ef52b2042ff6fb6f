// Profiling kernels of the refine step's tile structure, bf16.
//
// Replace the TPU profiling kernels of benchmarks/profile_overhead.py:
//   tile_copy_launch        k_copy: a pure copy of (N, H, W) through
//                           16 x 128 tiles;
//   gated_tile_copy_launch  k_when, k_when_scratch and k_full_skip: per
//                           tile, 2 * s where any |s| <= thr[n], else s.
// The tiles are 16 x 128, not the TPU's 32 x 128; there is no VMEM scratch
// or phase-major layout to carry over.  The "scratch" variants become one
// template parameter: the gated copy can reserve the refine kernel's
// dynamic shared memory (refine_layout.cuh::smem_bytes) without using it,
// which shows what that footprint costs in blocks per SM.  k_full_skip only
// binds the weight inputs as well; an unused pointer changes nothing on
// CUDA, so it is this gated copy.
//
// What bounds them on an H100: bytes.  Each reads its input once and writes
// its output once (2 bytes a pixel each way; 8.4 MB at 8 x 512 x 512), so
// the bound is ~2.5 us at 3.35 TB/s.  A kernel this short is also bound by
// how soon every thread has its load in flight: blocks of 256 threads on a
// grid of (tile column, tile row, image), so that a thread finds its
// 16-byte vectors (8 bf16 of a tile row) without an integer division, and
// the whole copy is in flight in one wave.  The gated copy gives each tile
// one block, one vector a thread.  The plain copy lets a block cover
// kCopyTiles = 4 tiles of a tile row, each thread issuing its four loads
// before its first store: of one, two and four tiles a block, four was the
// fastest against copy_ (PERF.md).  Ragged edges fall back to element
// loads.  The loops over a vector are unrolled with constant
// indices, so the vectors stay in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "refine_layout.cuh"

namespace {

constexpr int kVec = 8;                    // bf16 per 16-byte vector
constexpr int kVecPerRow = kTileW / kVec;  // vectors in one tile row
constexpr int kCopyTiles = 4;              // tiles of a tile copy block
static_assert(kTileH * kVecPerRow == kThreads, "one vector per thread");

struct TileVec {
  size_t offset;  // flat index of the thread's first element
  int count;      // elements of the vector inside the image (0..8)
};

// The thread's vector of the tile at (tile column tx, tile row ty) of image
// `image`.
__device__ __forceinline__ TileVec tile_vec_at(int tx, int ty, int image, int h, int w) {
  const int r = ty * kTileH + threadIdx.x / kVecPerRow;
  const int c = tx * kTileW + (threadIdx.x % kVecPerRow) * kVec;
  TileVec t;
  t.offset = (static_cast<size_t>(image) * h + r) * w + c;
  t.count = (r < h && c < w) ? min(kVec, w - c) : 0;
  return t;
}

// The thread's vector of its block's tile: block (tile column, tile row, image).
__device__ __forceinline__ TileVec tile_vec(int h, int w) {
  return tile_vec_at(blockIdx.x, blockIdx.y, blockIdx.z, h, w);
}

// 16-byte accesses when every vector is 16-byte aligned (`vec`, from the
// launcher: W % 8 == 0 and aligned base pointers)
__device__ __forceinline__ void load_vec(const __nv_bfloat16* src, TileVec t, bool vec,
                                         __nv_bfloat16* v) {
  if (vec && t.count == kVec) {
    *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(src + t.offset);
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if (k < t.count) v[k] = src[t.offset + k];
    }
  }
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* dst, TileVec t, bool vec,
                                          const __nv_bfloat16* v) {
  if (vec && t.count == kVec) {
    *reinterpret_cast<uint4*>(dst + t.offset) = *reinterpret_cast<const uint4*>(v);
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if (k < t.count) dst[t.offset + k] = v[k];
    }
  }
}

// (tile columns / tiles a block, tile rows, images)
dim3 tile_grid(int n, int h, int w, int tiles = 1) {
  const int ntx = (w + kTileW - 1) / kTileW;
  return dim3((ntx + tiles - 1) / tiles, (h + kTileH - 1) / kTileH, n);
}

bool vectorizable(const void* x, const void* out, int w) {
  return w % kVec == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

// Block (x, y, z) copies tile columns kCopyTiles x .. kCopyTiles x +
// kCopyTiles - 1 of tile row y of image z: every load is issued before the
// first store.
__global__ void __launch_bounds__(kThreads)
tile_copy_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out, int h,
                 int w, bool vec) {
  TileVec t[kCopyTiles];
  __align__(16) __nv_bfloat16 v[kCopyTiles][kVec];
#pragma unroll
  for (int k = 0; k < kCopyTiles; ++k) {
    t[k] = tile_vec_at(blockIdx.x * kCopyTiles + k, blockIdx.y, blockIdx.z, h, w);
    load_vec(x, t[k], vec, v[k]);
  }
#pragma unroll
  for (int k = 0; k < kCopyTiles; ++k) store_vec(out, t[k], vec, v[k]);
}

// kReserve only changes the launch (the dynamic shared memory asked for);
// the body never touches shared memory beyond the block-wide OR.
template <bool kReserve>
__global__ void __launch_bounds__(kThreads)
gated_tile_copy_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ thr,
                       __nv_bfloat16* __restrict__ out, int h, int w, bool vec) {
  const TileVec t = tile_vec(h, w);
  const float thr_b = thr[blockIdx.z];
  __align__(16) __nv_bfloat16 v[kVec];
  load_vec(x, t, vec, v);
  int sel = 0;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    if (k < t.count) sel |= fabsf(__bfloat162float(v[k])) <= thr_b;
  }
  if (__syncthreads_or(sel)) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if (k < t.count) v[k] = __float2bfloat16(2.f * __bfloat162float(v[k]));
    }
  }
  store_vec(out, t, vec, v);
}

}  // namespace

extern "C" {

// Each launches on `stream` and returns cudaGetLastError() (0 on success).
int tile_copy_launch(const void* x, void* out, int n, int h, int w, void* stream) {
  tile_copy_kernel<<<tile_grid(n, h, w, kCopyTiles), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), h, w,
      vectorizable(x, out, w));
  return static_cast<int>(cudaGetLastError());
}

// F, D > 0 reserve the dynamic shared memory of a refine block of those
// widths; F = D = 0 reserve none.
int gated_tile_copy_launch(const void* x, const void* thr, void* out, int n, int h, int w,
                           int F, int D, void* stream) {
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* tp = static_cast<const float*>(thr);
  auto* op = static_cast<__nv_bfloat16*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = vectorizable(x, out, w);
  if (F > 0 && D > 0) {
    const size_t smem = smem_bytes(F, D);
    const cudaError_t err = cudaFuncSetAttribute(gated_tile_copy_kernel<true>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    gated_tile_copy_kernel<true><<<tile_grid(n, h, w), kThreads, smem, s>>>(xp, tp, op, h, w, vec);
  } else {
    gated_tile_copy_kernel<false><<<tile_grid(n, h, w), kThreads, 0, s>>>(xp, tp, op, h, w, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
