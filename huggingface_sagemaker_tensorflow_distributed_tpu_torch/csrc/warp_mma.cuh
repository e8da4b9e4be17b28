// Warp-level tensor-core, async-copy and special-function primitives
// (sm_80 and later; built for sm_90a), one small wrapper per PTX
// instruction. Fragment layouts are those of the PTX ISA for mma.m16n8k16
// with bf16 inputs and fp32 accumulators: lane = 4 * g + t (g = lane / 4,
// t = lane % 4);
// - A (16 x 16, row major): a0 = A[g][2t..2t+1], a1 = A[g+8][2t..],
//   a2 = A[g][2t+8..], a3 = A[g+8][2t+8..], the lower column in the low half;
// - B (16 x 8, "col"): b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g];
// - C/D (16 x 8 fp32): c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1].
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// D += A * B for one 16 x 8 x 16 tile: bf16 products, fp32 sums.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 b16 matrices from shared memory: lanes 8i..8i+7 give the
// addresses of matrix i's rows (16 bytes each); r[i] of a lane holds
// elements (lane / 4, 2 (lane % 4) .. +1) of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* smem_row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// As ldsm_x4, each matrix transposed: r[i] holds elements
// (2 (lane % 4) .. +1, lane / 4) of matrix i as it is stored.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* smem_row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// 16 bytes global -> shared without registers; with fill == false the
// 16 bytes are zeroed and nothing is read.
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, bool fill) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int src_bytes = fill ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared; with fill == false they are zeroed.
__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem, bool fill) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int src_bytes = fill ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 2^x on the special-function unit (relative error about 2^-22; results
// below 2^-126 flush to 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (lo, hi) rounded to bf16 and packed as one A-fragment register.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace
