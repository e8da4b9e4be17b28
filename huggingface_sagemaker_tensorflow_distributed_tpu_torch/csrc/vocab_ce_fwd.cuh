// The fused LM head + cross-entropy's forward for bf16 hidden on Hopper:
// the logits on the `wgmma` GEMM core (hopper_gemm.cuh) with the
// backward's product plan (DsPlan, vocab_ce_bwd.cuh), at every hidden
// width, and an epilogue that reduces each 128 x 128 logit tile to per-row
// softmax statistics. Included by vocab_ce.cu after vocab_ce_bwd.cuh and
// `kNegInf`, `kNoId`.
//
// Replaces the TPU kernel `_fwd_kernel` of the JAX package's
// `ops/pallas_vocab_ce.py` (reached through `_fused_ce_fwd_call`) for bf16
// hidden, with its contract (vocab_ce.cu) and the fp32-exact split of W
// (vocab_ce_bwd.cuh). The TPU kernel carries running statistics across its
// sequential vocab grid axis in VMEM; here the vocab is walked in chunks
// of Vc ids (ops/vocab_ce.py:fwd_plan picks Vc so that the scratch stays
// within a stated budget whatever V is), each chunk in order on one stream:
// 1. vocab_ce_fwd_split_w_kernel: the chunk's W rows split once into bf16
//    hi, mid, lo [Vc, H] (the backward's split without its transposes,
//    under a name of its own so that a step's profile tells the two apart);
// 2. vocab_ce_fwd_wgmma_kernel: S = h·W_hiᵀ + h·W_midᵀ + h·W_loᵀ (K = H),
//    the backward's dS product in the same order, so the forward's LSE
//    comes from the very fp32 logits that the backward recomputes. Its
//    epilogue writes one partial a (128-id vocab tile, token): the tile's
//    max, the sum-exp against it, the label logit, the logit sum (for
//    smoothing) and the first maximal id, into fp32 [4, ceil(V / 128), N]
//    and int32 [ceil(V / 128), N] scratch.
// After the last chunk vocab_ce_combine_kernel (vocab_ce.cu) merges each
// token's ceil(V / 128) partials in vocab order, the TPU kernel's running
// update and `iv == last` finish; its strict `>` across tiles in order
// keeps the first maximal id. Deterministic: each partial is one quad's
// lanes merged in a fixed order, and no atomics run.
//
// Bound: 3 bf16 passes of 2·N·V·H at 989 TFLOP/s (operations at every
// model's shape), plus the route's own traffic at 3.35 TB/s: the split W
// (16 bytes a W element: 4 read, 6 written, 6 read back) and the partials
// (20 bytes a (tile, token), written and read back). Nothing is resident
// at full depth, so H picks no route: h and W stream through the core's
// ring in 64-column boxes.

#pragma once

#include "vocab_ce_bwd.cuh"

namespace {

// The split of W rows v0 .. v0 + rows into hi, mid, lo [rows, H] alone.
// Grid (ceil(rows / 32), ceil(H / 32)) of 32 x 8 threads.
__global__ void __launch_bounds__(kTT * 8) vocab_ce_fwd_split_w_kernel(
    const float* __restrict__ w, int H, int v0, int rows, bf16* __restrict__ hi,
    bf16* __restrict__ mid, bf16* __restrict__ lo) {
  split_w_rows(w, H, v0, rows, hi, mid, lo, nullptr, nullptr, 0);
}

// Per-row statistics of a 128 x 128 logit tile of tokens n < N at chunk
// ids v0 + vl, ids >= V masked: TMA fills a box past the chunk's tensor map
// with zeros, whose logits read 0 and not the TPU kernel's -1e30 padding.
// Thread (warp w, lane) holds rows row and row + 8 and columns col + 8 j + e
// (j < 16, e < 2): its ids increase with (j, e), and the quad's 4 lanes
// (lane / 4 equal) interleave 8 ids apart, so they meet with the lower id
// taking a tie. Rows n >= N compute (every lane must shuffle) but are not
// written.
struct FwdEpilogue {
  const int* labels;
  float* part;    // [4, tiles, N]: max, sum-exp, label logit, logit sum
  int* part_ix;   // [tiles, N]: first maximal id
  int N, V, v0, tiles;

  __device__ __forceinline__ void operator()(const float (&acc)[64], int row, int col, int) const {
    const int tile = (v0 + col) / hopper::kBN;  // v0 % 128 == 0 and col % 128 < 8
    const long long tn = (long long)tiles * N;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int n = row + 8 * i;
      const int label = n < N ? labels[n] : -1;
      float m = kNegInf, ll = kNegInf, zs = 0.f;
      int ix = kNoId;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int v = v0 + col + 8 * j + e;
          if (v >= V) continue;
          const float x = acc[4 * j + 2 * i + e];
          if (x > m) {  // strict: the thread's ids come in increasing order
            m = x;
            ix = v;
          }
          if (v == label) ll = x;
          zs += x;
        }
      float l = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (v0 + col + 8 * j + e < V) l += expf(acc[4 * j + 2 * i + e] - m);
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float om = __shfl_xor_sync(0xffffffffu, m, off);
        const float ol = __shfl_xor_sync(0xffffffffu, l, off);
        const int oi = __shfl_xor_sync(0xffffffffu, ix, off);
        const float mn = fmaxf(m, om);
        l = l * expf(m - mn) + ol * expf(om - mn);
        if (om > m || (om == m && oi < ix)) ix = oi;  // ties go to the lower id
        m = mn;
        ll = fmaxf(ll, __shfl_xor_sync(0xffffffffu, ll, off));
        zs += __shfl_xor_sync(0xffffffffu, zs, off);
      }
      if ((col & 7) == 0 && n < N) {  // the quad's first lane
        const long long at = (long long)tile * N + n;
        part[at] = m;
        part[tn + at] = l;
        part[2 * tn + at] = ll;
        part[3 * tn + at] = zs;
        part_ix[at] = ix;
      }
    }
  }
};

__global__ void __launch_bounds__(hopper::kGemmThreads, 1) vocab_ce_fwd_wgmma_kernel(
    const __grid_constant__ DsMaps maps, const hopper::GemmShape sh, const FwdEpilogue epi) {
  hopper::gemm_body<DsPlan>(maps, sh, epi);
}

}  // namespace
