// The fused LM head + cross-entropy's backward for bf16 hidden on Hopper:
// dH and dW from one dS a vocab chunk, every product on `wgmma` fed by TMA
// (hopper_gemm.cuh), at every hidden width; and the split of W that the
// bf16 forward (vocab_ce_fwd.cuh) shares. Included by vocab_ce.cu.
//
// Replaces the TPU kernels `_dh_kernel` and `_dw_kernel` of the JAX
// package's `ops/pallas_vocab_ce.py` (reached through `_fused_ce_bwd_call`),
// with their contract (vocab_ce.cu).
//
// The contract's logits are fp32 products of bf16 h and fp32 W, and a
// logit error δ is a relative error δ in p = exp(s - LSE), so the logits
// need fp32 accuracy. bf16 tensor cores keep it by splitting W without
// error: W = W_hi + W_mid + W_lo: W_hi = bf16(W) (round to nearest), W_mid
// the bf16 truncation of W - W_hi, W_lo = W - W_hi - W_mid. Each
// difference is exact in fp32; W - W_hi has at most 16 significant bits,
// so the truncation leaves at most 8, which W_lo holds exactly: the three
// pieces carry W's 24 bits (`split_bf16` in ops/vocab_ce.py is the same
// split). h is bf16 and every bf16 x bf16 product is exact in fp32, so
// h·W_hiᵀ + h·W_midᵀ + h·W_loᵀ with fp32 sums is the fp32 logit up to the
// order of the sums: three bf16 passes. dS = g (softmax - target) in fp32
// is split into dS_hi (round to nearest: the contract's bf16(dS)) + dS_lo
// (truncation), dH = dS_hi·W_hi + dS_hi·W_mid + dS_lo·W_hi, dW = dS_hiᵀ·h.
//
// The TPU kernels each form the logits and dS (two pallas_calls cannot
// share VMEM). Here the vocab is walked in chunks of Vc ids (the wrapper
// picks Vc so that the scratch stays within a stated budget whatever V
// is), and each chunk runs, in order on one stream:
// 1. vocab_ce_split_w_kernel: the chunk's W rows split once into bf16 hi,
//    mid, lo [Vc, H] (the logits' B operands) and hiᵀ, midᵀ [H, Vc] (dH's
//    B operands, K-major): each fp32 W element read once a call;
// 2. vocab_ce_ds_wgmma_kernel: S = h·W_cᵀ (K = H, three products a stage
//    sharing the h box), whose epilogue forms dS from the LSE, the label
//    and the smoothing (0 past V) and writes dS_hi, dS_lo [N, Vc] and
//    dS_hiᵀ [Vc, N] (dW's A operand, K-major) to scratch;
// 3. vocab_ce_dh_wgmma_kernel: dH partials [S, N, H] fp32 += dS_hi·W_hi +
//    dS_hi·W_mid + dS_lo·W_hi (K = Vc; the first chunk stores, later ones
//    add, in chunk order; split-K S fills the card where N·H has few
//    tiles); after the last chunk vocab_ce_dh_reduce_kernel sums the S
//    partials in order and casts to h's type;
// 4. vocab_ce_dw_wgmma_kernel: dW rows of the chunk = dS_hiᵀ·hᵀᵀ (K = N,
//    hᵀ [H, N] transposed once a call by vocab_ce_transpose_h_kernel),
//    written fp32 straight into dW: each row written once.
// Deterministic: every output element is summed by one block in a fixed
// order, and no atomics run.
//
// Bound: 7 bf16 passes of 2·N·V·H (3 logits, 3 dH, 1 dW) at 989 TFLOP/s,
// plus the dS scratch (3 x 2 bytes an N x V element, written and read
// back) and the split W (10 bytes a W element) at 3.35 TB/s. A lone dH
// needs 6 passes, a lone dW 4. Nothing is resident at full depth, so H
// picks no route: h and W stream through the ring in 64-column boxes.

#pragma once

#include "hopper_gemm.cuh"

namespace {

constexpr int kTT = 32;  // transpose tile: 32 x 32, blocks of 32 x 8 threads

typedef __nv_bfloat16 bf16;

// The upper halves of (x, y): bf16 truncations, packed as one 32-bit word
// (x in the low half).
__device__ __forceinline__ uint32_t upper_halves(float x, float y) {
  return __byte_perm(__float_as_uint(x), __float_as_uint(y), 0x7632);
}

// x with its low 16 bits cleared: its bf16 truncation, as a float.
__device__ __forceinline__ float trunc_bf16(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffff0000u);
}

// ---------------------------------------------------------------------------
// 1. the split of W, 2. hᵀ
// ---------------------------------------------------------------------------

// W rows v0 .. v0 + rows (the chunk's valid ids) split into hi, mid and lo
// [rows, H] (row stride H) and, unless hi_t is null, hi and mid transposed
// [H, ld_t] (columns 0 .. rows). Blocks of 32 x 8 threads, grid
// (ceil(rows / 32), ceil(H / 32)).
__device__ __forceinline__ void split_w_rows(const float* __restrict__ w, int H, int v0, int rows,
                                             bf16* __restrict__ hi, bf16* __restrict__ mid,
                                             bf16* __restrict__ lo, bf16* __restrict__ hi_t,
                                             bf16* __restrict__ mid_t, int ld_t) {
  __shared__ bf16 t_hi[kTT][kTT + 2], t_mid[kTT][kTT + 2];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int r0 = blockIdx.x * kTT, c0 = blockIdx.y * kTT;
  const int c = c0 + tx;
#pragma unroll
  for (int k = 0; k < kTT / 8; ++k) {
    const int r = r0 + ty + 8 * k;
    if (r < rows && c < H) {
      const float x = w[(long long)(v0 + r) * H + c];
      const bf16 xh = __float2bfloat16_rn(x);
      const float rest = x - __bfloat162float(xh);
      const float rm = trunc_bf16(rest);
      const bf16 xm = __float2bfloat16_rn(rm);          // exact: rm has 8 significant bits
      const bf16 xl = __float2bfloat16_rn(trunc_bf16(rest - rm));
      const long long at = (long long)r * H + c;
      hi[at] = xh;
      mid[at] = xm;
      lo[at] = xl;
      t_hi[ty + 8 * k][tx] = xh;
      t_mid[ty + 8 * k][tx] = xm;
    }
  }
  if (hi_t == nullptr) return;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kTT / 8; ++k) {
    const int cc = c0 + ty + 8 * k, r = r0 + tx;
    if (cc < H && r < rows) {
      hi_t[(long long)cc * ld_t + r] = t_hi[tx][ty + 8 * k];
      mid_t[(long long)cc * ld_t + r] = t_mid[tx][ty + 8 * k];
    }
  }
}

__global__ void __launch_bounds__(kTT * 8) vocab_ce_split_w_kernel(
    const float* __restrict__ w, int H, int v0, int rows, bf16* __restrict__ hi,
    bf16* __restrict__ mid, bf16* __restrict__ lo, bf16* __restrict__ hi_t,
    bf16* __restrict__ mid_t, int ld_t) {
  split_w_rows(w, H, v0, rows, hi, mid, lo, hi_t, mid_t, ld_t);
}

// h [N, H] transposed into h_t [H, ld_t]. Grid (ceil(N / 32), ceil(H / 32)).
__global__ void __launch_bounds__(kTT * 8) vocab_ce_transpose_h_kernel(
    const bf16* __restrict__ h, int N, int H, bf16* __restrict__ h_t, int ld_t) {
  __shared__ bf16 t[kTT][kTT + 2];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int r0 = blockIdx.x * kTT, c0 = blockIdx.y * kTT;
#pragma unroll
  for (int k = 0; k < kTT / 8; ++k) {
    const int r = r0 + ty + 8 * k, c = c0 + tx;
    if (r < N && c < H) t[ty + 8 * k][tx] = h[(long long)r * H + c];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kTT / 8; ++k) {
    const int cc = c0 + ty + 8 * k, r = r0 + tx;
    if (cc < H && r < N) h_t[(long long)cc * ld_t + r] = t[tx][ty + 8 * k];
  }
}

// ---------------------------------------------------------------------------
// the three products
// ---------------------------------------------------------------------------

// 2. logits: A = h, B = W_hi, W_mid, W_lo
struct DsPlan {
  static constexpr int kA = 1, kB = 3, kP = 3;
  __host__ __device__ static constexpr int a_of(int) { return 0; }
  __host__ __device__ static constexpr int b_of(int p) { return p; }
};

// 3. dH: A = dS_hi, dS_lo; B = W_hiᵀ, W_midᵀ
struct DhPlan {
  static constexpr int kA = 2, kB = 2, kP = 3;
  __host__ __device__ static constexpr int a_of(int p) { return p == 2 ? 1 : 0; }
  __host__ __device__ static constexpr int b_of(int p) { return p == 1 ? 1 : 0; }
};

// 4. dW: A = dS_hiᵀ, B = hᵀ
struct DwPlan {
  static constexpr int kA = 1, kB = 1, kP = 1;
  __host__ __device__ static constexpr int a_of(int) { return 0; }
  __host__ __device__ static constexpr int b_of(int) { return 0; }
};

// dS = g (softmax - target) of tokens n < N at chunk ids v0 + vl (0 at
// ids >= V), split into hi (rounded) and lo (the truncated rest): the
// pieces [N, ld] and hiᵀ [.., ld_t], each written unless its pointer is null
struct DsEpilogue {
  const float* lse;
  const float* g;
  const int* labels;
  bf16* ds_hi;
  bf16* ds_lo;
  bf16* ds_hi_t;
  int N, V, v0, ld, ld_t;
  float eps, one_minus_eps, eps_over_v;

  __device__ __forceinline__ void operator()(const float (&acc)[64], int row, int col, int) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int n = row + 8 * i;
      if (n >= N) continue;
      const float L = lse[n], G = g[n];
      const int label = labels[n];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int vl = col + 8 * j;
        float x[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int v = v0 + vl + e;
          const float onehot = v == label ? 1.f : 0.f;
          const float target = eps > 0.f ? one_minus_eps * onehot + eps_over_v : onehot;
          x[e] = v < V ? (expf(acc[4 * j + 2 * i + e] - L) - target) * G : 0.f;
        }
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(x[0], x[1]);
        const float2 hf = __bfloat1622float2(h2);
        if (ds_hi != nullptr) {
          const long long at = (long long)n * ld + vl;
          *reinterpret_cast<__nv_bfloat162*>(ds_hi + at) = h2;
          *reinterpret_cast<uint32_t*>(ds_lo + at) = upper_halves(x[0] - hf.x, x[1] - hf.y);
        }
        if (ds_hi_t != nullptr) {
          ds_hi_t[(long long)vl * ld_t + n] = h2.x;
          ds_hi_t[(long long)(vl + 1) * ld_t + n] = h2.y;
        }
      }
    }
  }
};

// dH partial sums [splits, N, H] fp32: K range s of this chunk stored
// (first chunk) or added to what the chunks before left
struct DhEpilogue {
  float* part;
  int N, H, first;

  __device__ __forceinline__ void operator()(const float (&acc)[64], int row, int col, int s) const {
    float* base = part + (long long)s * N * H;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int n = row + 8 * i;
      if (n >= N) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = col + 8 * j;  // even, and H % 8 == 0: c + 1 < H with c
        if (c >= H) continue;
        float2* p = reinterpret_cast<float2*>(base + (long long)n * H + c);
        float2 x = make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
        if (!first) {
          const float2 o = *p;
          x.x = o.x + x.x;
          x.y = o.y + x.y;
        }
        *p = x;
      }
    }
  }
};

// dW rows of the chunk, fp32 [rows, H] at `out` (row stride H)
struct DwEpilogue {
  float* out;
  int rows, H;

  __device__ __forceinline__ void operator()(const float (&acc)[64], int row, int col, int) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = row + 8 * i;
      if (m >= rows) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = col + 8 * j;
        if (c >= H) continue;
        *reinterpret_cast<float2*>(out + (long long)m * H + c) =
            make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
      }
    }
  }
};

typedef hopper::GemmMaps<1, 3> DsMaps;
typedef hopper::GemmMaps<2, 2> DhMaps;
typedef hopper::GemmMaps<1, 1> DwMaps;

__global__ void __launch_bounds__(hopper::kGemmThreads, 1) vocab_ce_ds_wgmma_kernel(
    const __grid_constant__ DsMaps maps, const hopper::GemmShape sh, const DsEpilogue epi) {
  hopper::gemm_body<DsPlan>(maps, sh, epi);
}

__global__ void __launch_bounds__(hopper::kGemmThreads, 1) vocab_ce_dh_wgmma_kernel(
    const __grid_constant__ DhMaps maps, const hopper::GemmShape sh, const DhEpilogue epi) {
  hopper::gemm_body<DhPlan>(maps, sh, epi);
}

__global__ void __launch_bounds__(hopper::kGemmThreads, 1) vocab_ce_dw_wgmma_kernel(
    const __grid_constant__ DwMaps maps, const hopper::GemmShape sh, const DwEpilogue epi) {
  hopper::gemm_body<DwPlan>(maps, sh, epi);
}

}  // namespace
