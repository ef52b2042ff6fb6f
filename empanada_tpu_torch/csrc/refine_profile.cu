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
// which shows what that footprint costs a persistent grid like the refine
// kernel's.  k_full_skip only binds the weight inputs as well; an unused
// pointer changes nothing on CUDA, so it is this gated copy.
//
// What bounds them on an H100: bytes.  Each reads its input once and writes
// its output once (2 bytes a pixel each way; 8.4 MB at 8 x 512 x 512), so
// the bound is ~2.5 us at 3.35 TB/s.  A kernel this short is also bound by
// how soon every thread has its loads in flight.  A 256-thread block
// covers a 16 x 128 tile with one 16-byte vector (8 bf16 of a tile row) a
// thread.  The plain copy runs a grid of (tile column groups, tile row,
// image), each block covering kCopyTiles = 4 tiles of a tile row and each
// thread issuing its four loads before its first store: of one, two and
// four tiles a block, four was the fastest against copy_ (PERF.md).
//
// The gated copy is persistent, in the refine kernel's shape: the tiles
// are numbered over (image, tile row, tile column), columns fastest, and
// cut into groups of kGatedTiles consecutive tiles; the grid is
// min(groups, blocks_per_sm x SMs), blocks_per_sm read once per (device,
// kernel, reserved bytes) with cudaOccupancyMaxActiveBlocksPerMultiprocessor,
// and block b walks groups b, b + grid, ...  At 8 x 512 x 512 (1024 tiles)
// and kGatedTiles = 4 that is 256 blocks, which fit on the card at once
// with or without the reservation (2 blocks an SM with it): the whole copy
// is one wave.  The earlier design gave each tile a block, 1024 blocks, and
// with the reservation ran in four waves of a load, a __syncthreads_or and
// a store each.  Per group a thread issues its kGatedTiles loads first,
// forms a kGatedTiles-bit mask of its tiles' |s| <= thr tests, ORs it over
// its warp (__reduce_or_sync), then over the block through one shared word a warp
// and one barrier (two sets of words, alternating by group, so a group
// never waits on the previous group's readers), doubles the gated tiles
// and stores.  What a group costs beyond its bytes is on every thread's
// path before its first load or store, so the group's first tile is
// divided out once and the next ones are stepped to, and where every tile
// is whole and every vector aligned (the launcher checks once and picks
// that instantiation, kWhole) a vector is tested and doubled on its four
// 32-bit words with no edge test, the doubling selected, not branched to.
// (The same work with edge tests, or with the doubling branched to, read
// slower in exploratory runs.)
// kGatedTiles = 4: of 1, 2, 4 and 8 tiles a group, chip_smoke.py
// measured, when the kernel took the group size as a template parameter
// (device us a call at all-refine, 8 x 512 x 512, reserved / unreserved,
// H100 80GB HBM3 at 700 W) 4.29 / 3.36, 3.33 / 2.96, 3.02 / 3.04 and
// 5.34 / 5.70 (8 tiles take 210 registers a thread, so one block an SM):
// 4 is the fastest reserved and within 0.1 us of 2 unreserved, 82-84 % of
// the bound either way.
//
// Ragged edges take element loads.  The loops over a vector are unrolled
// with constant indices, so the vectors stay in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

#include "refine_layout.cuh"

namespace {

constexpr int kVec = 8;                    // bf16 per 16-byte vector
constexpr int kVecPerRow = kTileW / kVec;  // vectors in one tile row
constexpr int kCopyTiles = 4;              // tiles of a tile copy block
constexpr int kGatedTiles = 4;             // tiles of a gated copy group
constexpr int kWarps = kThreads / 32;
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
dim3 tile_grid(int n, int h, int w, int tiles) {
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

// A full vector's gate and doubling, on its four 32-bit words of two bf16
// each: a bf16 is the high half of the float it widens to, so the tests
// and products are the element path's, exact, in fewer instructions.
__device__ __forceinline__ bool any_at_most(const uint4& v, float thr) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  bool sel = false;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    sel |= fabsf(__uint_as_float(w[i] << 16)) <= thr;
    sel |= fabsf(__uint_as_float(w[i] & 0xffff0000u)) <= thr;
  }
  return sel;
}

__device__ __forceinline__ uint32_t doubled(uint32_t w) {
  const __nv_bfloat162 d = __floats2bfloat162_rn(2.f * __uint_as_float(w << 16),
                                                 2.f * __uint_as_float(w & 0xffff0000u));
  return *reinterpret_cast<const uint32_t*>(&d);
}

__device__ __forceinline__ uint4 doubled(const uint4& v) {
  return make_uint4(doubled(v.x), doubled(v.y), doubled(v.z), doubled(v.w));
}

// The OR of every thread's `mask` over the block: over the warp, then
// through one word a warp and one barrier.  The words alternate by
// `parity`, so a group never waits on the previous group's readers.
__device__ __forceinline__ unsigned block_or(unsigned mask, unsigned (&warp_mask)[2][kWarps],
                                             int parity) {
  mask = __reduce_or_sync(0xffffffffu, mask);
  if (threadIdx.x % 32 == 0) warp_mask[parity][threadIdx.x / 32] = mask;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kWarps; ++i) mask |= warp_mask[parity][i];
  return mask;
}

// A tile by (image, tile row, tile column); `step` moves to the next one
// in the numbering (columns fastest).
struct TileAt {
  int image, ty, tx;
};

__device__ __forceinline__ TileAt tile_at(int q, int nty, int ntx) {
  TileAt a;
  a.image = q / (nty * ntx);
  const int rem = q - a.image * nty * ntx;
  a.ty = rem / ntx;
  a.tx = rem - a.ty * ntx;
  return a;
}

__device__ __forceinline__ void step(TileAt& a, int nty, int ntx) {
  if (++a.tx == ntx) {
    a.tx = 0;
    if (++a.ty == nty) {
      a.ty = 0;
      ++a.image;
    }
  }
}

// One group of kGatedTiles tiles from tile q (at `a`) when every tile is
// whole and every vector 16-byte aligned: no edge tests.
__device__ __forceinline__ void whole_group(const __nv_bfloat16* __restrict__ x,
                                            const float* __restrict__ thr,
                                            __nv_bfloat16* __restrict__ out, int h, int w,
                                            int nty, int ntx, int q, int tiles, TileAt a,
                                            unsigned (&warp_mask)[2][kWarps], int parity) {
  const int r = threadIdx.x / kVecPerRow;
  const int c = (threadIdx.x % kVecPerRow) * kVec;
  size_t off[kGatedTiles];
  float thr_t[kGatedTiles];
  uint4 v[kGatedTiles];
#pragma unroll
  for (int k = 0; k < kGatedTiles; ++k) {
    const bool in = q + k < tiles;
    off[k] = (static_cast<size_t>(a.image) * h + a.ty * kTileH + r) * w + a.tx * kTileW + c;
    thr_t[k] = in ? thr[a.image] : -1.f;  // past the last tile: v = 0, never gated
    v[k] = in ? *reinterpret_cast<const uint4*>(x + off[k]) : make_uint4(0, 0, 0, 0);
    step(a, nty, ntx);
  }
  unsigned mask = 0;
#pragma unroll
  for (int k = 0; k < kGatedTiles; ++k) {
    mask |= static_cast<unsigned>(any_at_most(v[k], thr_t[k])) << k;
  }
  mask = block_or(mask, warp_mask, parity);
#pragma unroll
  for (int k = 0; k < kGatedTiles; ++k) {
    if (q + k < tiles) {
      *reinterpret_cast<uint4*>(out + off[k]) = (mask >> k & 1u) ? doubled(v[k]) : v[k];
    }
  }
}

// The same group with edges: each vector holds 0..8 elements of the image,
// taken by element where it is not a whole aligned vector.
__device__ __forceinline__ void edge_group(const __nv_bfloat16* __restrict__ x,
                                           const float* __restrict__ thr,
                                           __nv_bfloat16* __restrict__ out, int h, int w,
                                           int nty, int ntx, int q, int tiles, TileAt a,
                                           bool vec, unsigned (&warp_mask)[2][kWarps],
                                           int parity) {
  TileVec t[kGatedTiles];
  float thr_t[kGatedTiles];
  __align__(16) __nv_bfloat16 v[kGatedTiles][kVec];
#pragma unroll
  for (int k = 0; k < kGatedTiles; ++k) {
    const bool in = q + k < tiles;
    t[k] = in ? tile_vec_at(a.tx, a.ty, a.image, h, w) : TileVec{0, 0};
    thr_t[k] = in ? thr[a.image] : 0.f;
    load_vec(x, t[k], vec, v[k]);
    step(a, nty, ntx);
  }
  unsigned mask = 0;
#pragma unroll
  for (int k = 0; k < kGatedTiles; ++k) {
    bool sel = false;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      if (e < t[k].count) sel |= fabsf(__bfloat162float(v[k][e])) <= thr_t[k];
    }
    mask |= static_cast<unsigned>(sel) << k;
  }
  mask = block_or(mask, warp_mask, parity);
#pragma unroll
  for (int k = 0; k < kGatedTiles; ++k) {
    if (mask >> k & 1u) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        if (e < t[k].count) v[k][e] = __float2bfloat16(2.f * __bfloat162float(v[k][e]));
      }
    }
    store_vec(out, t[k], vec, v[k]);
  }
}

// kReserve only changes the launch (the dynamic shared memory asked for);
// the body's only shared memory is the masks' words.  Block b walks groups
// b, b + gridDim.x, ... of kGatedTiles consecutive tiles; kWhole: every
// tile is whole and every vector aligned (the launcher's `whole`).
template <bool kReserve, bool kWhole>
__global__ void __launch_bounds__(kThreads)
gated_tile_copy_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ thr,
                       __nv_bfloat16* __restrict__ out, int h, int w, int nty, int ntx,
                       int tiles, bool vec) {
  __shared__ unsigned warp_mask[2][kWarps];
  const int groups = (tiles + kGatedTiles - 1) / kGatedTiles;
  int parity = 0;
  for (int g = blockIdx.x; g < groups; g += gridDim.x, parity ^= 1) {
    const TileAt a = tile_at(g * kGatedTiles, nty, ntx);
    if (kWhole) {
      whole_group(x, thr, out, h, w, nty, ntx, g * kGatedTiles, tiles, a, warp_mask, parity);
    } else {
      edge_group(x, thr, out, h, w, nty, ntx, g * kGatedTiles, tiles, a, vec, warp_mask,
                 parity);
    }
  }
}

// Blocks of a gated copy kernel that fit on one SM of the current device
// at `smem` reserved bytes, and the device's SMs: read once per (device,
// kernel, smem).  The kernel's dynamic shared memory limit is raised to
// `smem` on every call, before the query and the launch that follow it.
struct Residency {
  int device;
  const void* kernel;
  size_t smem;
  int per_sm;
  int sms;
};

std::mutex residency_mu;
std::vector<Residency> residency_cache;

cudaError_t resident(const void* kernel, size_t smem, int* per_sm, int* sms) {
  cudaError_t err = cudaSuccess;
  if (smem > 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int device = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(residency_mu);
  for (const Residency& r : residency_cache) {
    if (r.device == device && r.kernel == kernel && r.smem == smem) {
      *per_sm = r.per_sm;
      *sms = r.sms;
      return cudaSuccess;
    }
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (*per_sm <= 0) return cudaErrorInvalidConfiguration;  // no block fits
  residency_cache.push_back(Residency{device, kernel, smem, *per_sm, *sms});
  return cudaSuccess;
}

// Tile rows, tile columns and tiles of (n, h, w).
struct Tiles {
  int nty, ntx, count;
};

Tiles tiles_of(int n, int h, int w) {
  const int nty = (h + kTileH - 1) / kTileH;
  const int ntx = (w + kTileW - 1) / kTileW;
  return Tiles{nty, ntx, n * nty * ntx};
}

// The persistent grid: min(groups of kGatedTiles tiles, blocks_per_sm x
// SMs).
int gated_grid(int tiles, int per_sm, int sms) {
  const int groups = (tiles + kGatedTiles - 1) / kGatedTiles;
  return groups < per_sm * sms ? groups : per_sm * sms;
}

const void* gated_kernel(bool reserve, bool whole) {
  if (reserve) {
    return whole ? reinterpret_cast<const void*>(gated_tile_copy_kernel<true, true>)
                 : reinterpret_cast<const void*>(gated_tile_copy_kernel<true, false>);
  }
  return whole ? reinterpret_cast<const void*>(gated_tile_copy_kernel<false, true>)
               : reinterpret_cast<const void*>(gated_tile_copy_kernel<false, false>);
}

// Every tile of (n, h, w) whole and every vector 16-byte aligned.
bool whole_tiles(int h, int w, bool vec) { return vec && h % kTileH == 0 && w % kTileW == 0; }

// Reserved bytes of a launch: F, D > 0 reserve the dynamic shared memory of
// a refine block of those widths; F = D = 0 reserve none.
size_t reserved_bytes(int F, int D) { return F > 0 && D > 0 ? smem_bytes(F, D) : 0; }

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
// widths, unused; F = D = 0 reserve none.
int gated_tile_copy_launch(const void* x, const void* thr, void* out, int n, int h, int w,
                           int F, int D, void* stream) {
  bool vec = vectorizable(x, out, w);
  const void* kernel = gated_kernel(F > 0 && D > 0, whole_tiles(h, w, vec));
  const size_t smem = reserved_bytes(F, D);
  int per_sm = 0, sms = 0;
  cudaError_t err = resident(kernel, smem, &per_sm, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  Tiles t = tiles_of(n, h, w);
  void* args[] = {&x, &thr, &out, &h, &w, &t.nty, &t.ntx, &t.count, &vec};
  err = cudaLaunchKernel(kernel, dim3(gated_grid(t.count, per_sm, sms)), dim3(kThreads), args,
                         smem, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// What gated_tile_copy_launch picks for a 16-byte aligned (n, h, w) at
// (F, D): its grid and the blocks of its kernel that fit on one SM of the
// current device.  Returns 0 or the CUDA error.
int gated_tile_copy_plan(int n, int h, int w, int F, int D, int* grid, int* blocks_per_sm) {
  const void* kernel = gated_kernel(F > 0 && D > 0, whole_tiles(h, w, w % kVec == 0));
  int sms = 0;
  const cudaError_t err = resident(kernel, reserved_bytes(F, D), blocks_per_sm, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  *grid = gated_grid(tiles_of(n, h, w).count, *blocks_per_sm, sms);
  return 0;
}

}  // extern "C"
