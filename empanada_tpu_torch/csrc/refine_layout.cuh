// Tiling and shared-memory layout of the PointRend refine kernel
// (pointrend_refine.cu), shared with the profiling kernels
// (refine_profile.cu), whose gated copy can reserve the same dynamic
// shared memory to show what the refine kernel's footprint costs.
#pragma once

#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 16;     // output tile rows (the skip granularity)
constexpr int kTileW = 128;    // output tile columns
constexpr int kChunk = 64;     // points per MLP chunk (rows of the products)
constexpr int kThreads = 256;  // 8 warps; 4 threads per point in the predictor
constexpr int kPad = 8;        // row padding of the shared buffers (elements)

// phases of the refine kernel template
constexpr int kGather = 0;
constexpr int kInterp = 1;
constexpr int kFull = 2;

// dynamic shared memory of one refine block: bf16 activations, f32
// accumulators, the chunk's coarse values and the tile's point list
inline size_t smem_bytes(int F, int D) {
  const int ldx = (F > D ? F : D) + kPad;
  const int lda = D + kPad;
  return sizeof(__nv_bfloat16) * kChunk * ldx + sizeof(float) * kChunk * lda +
         sizeof(float) * kChunk + sizeof(int16_t) * kTileH * kTileW;
}

}  // namespace
