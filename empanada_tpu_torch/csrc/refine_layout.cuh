// Tiling and shared-memory layout of the PointRend refine kernel
// (pointrend_refine.cu), shared with the profiling kernels
// (refine_profile.cu), whose gated copy can reserve the same dynamic
// shared memory to show what the refine kernel's footprint costs.
#pragma once

#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 16;     // tile rows of the profiling copies
constexpr int kTileW = 128;    // tile columns of the profiling copies
constexpr int kThreads = 256;  // block of the profiling copies

// The refine kernel: a block's two consumer warpgroups (256 threads) run
// the point MLP of a 64-point chunk, the M = 64 rows of its wgmma products,
// one warpgroup for each half of the 256 output columns; the hidden width
// runs at kN = 256 (a narrower D is padded with zero weights); each hidden
// layer's weights arrive in K-slices of 64 rows, each as two pieces of 128
// output columns, 16 KB each, through a ring of kStages pieces that one
// producer warp fills.
constexpr int kRows = 64;
constexpr int kN = 256;
constexpr int kSliceK = 64;
constexpr int kPieceBytes = kN / 2 * kSliceK * 2;
constexpr int kActBlockBytes = kRows * kSliceK * 2;  // 64 points x 64 channels
constexpr int kPointWords = 8;                       // per-point record (ints)
constexpr int kConsumers = 256;                      // consumer threads of a block
constexpr int kStages = 4;  // weight pieces in the ring: two blocks fit on an SM

// phases of the refine kernel template
constexpr int kGather = 0;
constexpr int kInterp = 1;
constexpr int kFull = 2;

struct RefineSmem {
  size_t ring;   // weight pieces, kStages x 16 KB, 1024-aligned
  size_t act;    // 64 x max(F, 256) bf16 activations
  size_t pts;    // 64 point records
  size_t bars;   // full and empty mbarriers of the ring
  size_t total;  // bytes to ask for: the base is aligned up to 1024 in the kernel
};

__host__ __device__ inline RefineSmem refine_smem(int F) {
  const int act_k = F > kN ? F : kN;
  RefineSmem s;
  s.ring = 0;
  s.act = s.ring + static_cast<size_t>(kStages) * kPieceBytes;
  s.pts = s.act + static_cast<size_t>(kRows) * act_k * 2;
  s.bars = s.pts + static_cast<size_t>(kRows) * kPointWords * 4;
  s.total = s.bars + 2 * kStages * sizeof(uint64_t) + 1024;
  return s;
}

// dynamic shared memory of one refine block (D only has to be at most kN)
inline size_t smem_bytes(int F, int D) {
  (void)D;
  return refine_smem(F).total;
}

}  // namespace
