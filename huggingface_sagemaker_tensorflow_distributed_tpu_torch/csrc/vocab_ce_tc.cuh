// Tensor-core kernels of the fused LM head + cross-entropy for bf16
// hidden: the forward, dH and dW. Included by vocab_ce.cu after `Args`,
// `target_at`, `kThreads`, `kBV`, `kFwdRows`, `kBwdRows`, `kPanel`,
// `kNegInf` and `kNoId`.
//
// They compute what `vocab_ce_fwd_kernel`, `vocab_ce_bwd_dh_kernel` and
// `vocab_ce_bwd_dw_kernel` compute for bf16 hidden (the contract of
// vocab_ce.cu), up to the order of the fp32 sums, on `mma.sync` m16n8k16
// with bf16 operands and fp32 accumulators (the wrappers of warp_mma.cuh).
//
// The contract's logits are fp32 products of bf16 h and fp32 W, and a
// logit error δ is a relative error δ in p = exp(s - LSE), so the logits
// need fp32 accuracy. bf16 tensor cores keep it by splitting W without
// error:
// - W = W_hi + W_mid + W_lo: W_hi = bf16(W) (round to nearest), W_mid the
//   bf16 truncation of W - W_hi, W_lo = W - W_hi - W_mid. Each difference
//   is exact in fp32; W - W_hi has at most 16 significant bits, so the
//   truncation leaves at most 8, which W_lo holds exactly: the three
//   pieces carry W's 24 bits (`split_bf16` in ops/vocab_ce.py is the same
//   split). h is bf16 and every bf16 x bf16 product is exact in fp32, so
//   h·W_hiᵀ + h·W_midᵀ + h·W_loᵀ with fp32 sums is the fp32 logit up to
//   the order of the sums: three bf16 passes. Only W_hi takes a conversion
//   instruction (a quarter-rate one); the rest are bit operations;
// - dH's product dS·W is fp32 by the contract (W is fp32, so
//   `ds.astype(w.dtype)` keeps dS in fp32): dS = dS_hi + dS_lo the same
//   way, and dH += dS_hi·W_hi + dS_hi·W_mid + dS_lo·W_hi; the dropped
//   terms are about 2^-16 of the product, 256 times finer than dH's bf16
//   rounding (three more passes);
// - dW's product dSᵀ·h is bf16 x bf16 by the contract (dS rounded to h's
//   type): one pass.
// The rest (statistics, target, smoothing, g, the split-order combine and
// reduce) stays fp32.
//
// What bounds them on an H100 is not the tensor cores (989 TFLOP/s) but
// the shared memory that feeds `mma.sync` through `ldmatrix` (128 bytes a
// clock an SM) and the split of W, so each design counts bytes of shared
// memory per product (an m16n8k16 `mma` is 4096 flops, about one a clock
// an SM at the tensor cores' peak; an `ldmatrix.x4` moves 512 bytes):
// - operands are staged as bf16 with a 16-byte row pad (row stride a
//   multiple of 16 bytes, odd in 16-byte units), so the 8 rows an
//   `ldmatrix` reads fall in 8 different 16-byte bank groups;
// - a logit tile is split over k across warps so that each warp's
//   fragments feed as many products as its registers allow, and the
//   partial sums meet in shared memory at the tile's end, added in k order;
// - ragged N, V and H are masked: rows past N or V and columns past H are
//   zero (`cp.async` with a source size of 0 fills them), and only rows
//   below V or N and columns below H are written.

#pragma once

#include "warp_mma.cuh"

namespace {

constexpr int kTcRows = kBwdRows;     // tokens of a dH block, vocab rows of a dW block
constexpr int kTcVocab = 32;          // vocab ids of a logit tile
constexpr int kTcChunk = 64;          // columns (H) of a W chunk
constexpr int kTcKq = kTcChunk / 16;  // k-steps of a chunk: partial logit sums
constexpr int kTcLdc = kTcChunk + 8;  // row stride of a split chunk (bf16)
constexpr int kTcLdp = kPanel + 8;    // row stride of the split panel (bf16)
constexpr int kTcLds = kTcVocab + 8;  // row stride of dS (bf16)
constexpr int kTcLdr = kTcVocab + 8;  // row stride of the partial logits (fp32)
constexpr int kTcWalks = 8;           // vocab walk starts among the token blocks
constexpr size_t kMaxSmem = 232448;   // dynamic shared memory a block may use
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

// Dynamic shared memory of the dH tensor-core kernel at depth H.
size_t dh_tc_smem_bytes(int H) {
  const size_t hc = (size_t)((H + kTcChunk - 1) / kTcChunk) * kTcChunk;
  return (size_t)kTcKq * kTcRows * kTcLdr * sizeof(float)  // partial logits
         + (size_t)kTcRows * (hc + 8) * sizeof(bf16)        // h
         + (size_t)2 * kTcVocab * kTcLdp * sizeof(bf16)     // W hi, mid of the panel
         + (size_t)6 * kTcVocab * kTcLdc * sizeof(bf16)     // W hi, mid, lo of two chunks
         + (size_t)2 * kTcRows * kTcLds * sizeof(bf16)      // dS hi, lo
         + (size_t)3 * kTcRows * sizeof(float);             // LSE, g, labels
}

// Dynamic shared memory of the forward tensor-core kernel at depth H.
size_t fwd_tc_smem_bytes(int H) {
  const size_t hc = (size_t)((H + kTcChunk - 1) / kTcChunk) * kTcChunk;
  return (size_t)kTcKq * kFwdRows * kTcLdr * sizeof(float)  // partial logits
         + (size_t)kFwdRows * (hc + 8) * sizeof(bf16)        // h
         + (size_t)6 * kTcVocab * kTcLdc * sizeof(bf16)      // W hi, mid, lo of two chunks
         + (size_t)kFwdRows * sizeof(int);                   // labels
}

// Dynamic shared memory of the dW tensor-core kernel at depth H: W's
// three pieces and the h tile at the full depth, rounded up to a k-step.
size_t dw_tc_smem_bytes(int H) {
  const size_t hk = (size_t)((H + 15) / 16) * 16;
  return (size_t)kTcKq * kTcRows * kTcLdr * sizeof(float)  // partial logits
         + (size_t)4 * kTcRows * (hk + 8) * sizeof(bf16)    // W hi, mid, lo and h
         + (size_t)kTcRows * kTcLds * sizeof(bf16)          // dSᵀ
         + (size_t)3 * kTcRows * sizeof(float);             // LSE, g, labels
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The upper halves of (x, y): bf16 truncations, packed as one fragment
// register (x in the low half).
__device__ __forceinline__ uint32_t upper_halves(float x, float y) {
  return __byte_perm(__float_as_uint(x), __float_as_uint(y), 0x7632);
}

// x with its low 16 bits cleared: its bf16 truncation, as a float.
__device__ __forceinline__ float trunc_bf16(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffff0000u);
}

// (x, y) split without error into bf16 pairs hi + mid + lo (see above):
// one conversion for hi, bit operations for the rest, which rounding has
// left exact in 16 and then 8 bits.
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h2);
  const float rx = x - hf.x, ry = y - hf.y;
  hi = bf16x2_bits(h2);
  mid = upper_halves(rx, ry);
  lo = upper_halves(rx - trunc_bf16(rx), ry - trunc_bf16(ry));
}

// Eight values split into their hi, mid and lo pieces (8 bf16 each).
__device__ __forceinline__ void split8(const float (&x)[8], uint4& hi, uint4& mid, uint4& lo) {
  split3(x[0], x[1], hi.x, mid.x, lo.x);
  split3(x[2], x[3], hi.y, mid.y, lo.y);
  split3(x[4], x[5], hi.z, mid.z, lo.z);
  split3(x[6], x[7], hi.w, mid.w, lo.w);
}

// W[v, c .. c + 8), zero past V and H; 16 bytes a load when W's rows
// allow it.
__device__ __forceinline__ void fetch_w8(float (&x)[8], const Args& a, int v, int c, bool vec) {
  const bool row_in = v < a.V;
  const float* src = a.w + (long long)v * a.H + c;
  if (vec) {  // H % 4 == 0: four columns are all below H or all past it
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float4 y = row_in && c + 4 * q < a.H
                           ? __ldg(reinterpret_cast<const float4*>(src + 4 * q))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      x[4 * q] = y.x;
      x[4 * q + 1] = y.y;
      x[4 * q + 2] = y.z;
      x[4 * q + 3] = y.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = row_in && c + e < a.H ? __ldg(src + e) : 0.f;
  }
}

// This thread's 8 values of the 32 x 64 W chunk at rows v0.., columns
// k0..: row tid / 8, columns k0 + 8 (tid % 8) .. + 8.
__device__ __forceinline__ void tc_fetch_chunk(float (&x)[8], const Args& a, int v0, int k0,
                                               bool vec) {
  fetch_w8(x, a, v0 + threadIdx.x / 8, k0 + (threadIdx.x % 8) * 8, vec);
}

// This thread's 8 values of a chunk split into the hi, mid and lo rows
// of `pieces` ([3][32][kTcLdc]), and hi and mid into `panel` unless it is
// null.
__device__ __forceinline__ void tc_split_chunk(bf16* pieces, bf16* panel, const float (&x)[8]) {
  const int r = threadIdx.x / 8, c = (threadIdx.x % 8) * 8;
  uint4 hi, mid, lo;
  split8(x, hi, mid, lo);
  bf16* d = pieces + r * kTcLdc + c;
  *reinterpret_cast<uint4*>(d) = hi;
  *reinterpret_cast<uint4*>(d + kTcVocab * kTcLdc) = mid;
  *reinterpret_cast<uint4*>(d + 2 * kTcVocab * kTcLdc) = lo;
  if (panel != nullptr) {
    *reinterpret_cast<uint4*>(panel + r * kTcLdp + c) = hi;
    *reinterpret_cast<uint4*>(panel + kTcVocab * kTcLdp + r * kTcLdp + c) = mid;
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// backward: dH on the tensor cores (bf16 hidden)
// ---------------------------------------------------------------------------
//
// Bound at the GPT-2 shape: 6 bf16 passes of 2·N·V·H (1.9 TFLOP) over the
// 989 TFLOP/s of the tensor cores, 1.9 ms, above the bytes. What holds it
// back is not the tensor cores but the shared memory (128 bytes a clock an
// SM) that feeds `mma.sync` and the W stream, so the design counts bytes
// of shared memory per product:
// - a block owns 32 tokens (h resident in shared memory as bf16) and one
//   768-column panel of H; its 8 warps hold the 32 x 768 fp32 dH panel as
//   mma accumulator fragments (each warp 32 tokens x 96 columns, 96
//   registers a thread), so no logit is recomputed at H <= 768;
// - the vocab is walked in 32-id tiles; each tile's W rows come in
//   64-column fp32 chunks straight into registers (8 values a thread,
//   fetched two chunks ahead, zero past V and H) and are split once into
//   hi, mid and lo for the chunk's logits (two buffers: chunk i + 1 is
//   split while chunk i's logits run) and hi and mid into a 32 x 768
//   panel that the dS·W product reads. Each W element is read once per
//   token block and split once. Staging W_lo for the product as well
//   would not fit beside h; the product does not take it;
// - the 32 x 32 logit tile is split over k: warp (kq, half) takes k-step
//   kq of every chunk for all 32 tokens x 16 ids (6 fragment loads for 12
//   products), and the four partial sums meet in shared memory at the
//   tile's end, added in k order; one barrier a chunk;
// - dS is split into hi and lo bf16 and goes through shared memory; the
//   product takes two 16-column groups at a time, one term at a time, so
//   consecutive products (issued in program order) do not wait on each
//   other;
// - the token blocks start their walks over a split's tiles at 8 points,
//   so they do not all ask for the same W lines at once;
// - the vocab splits and their deterministic split-order reduce are
//   those of the CUDA-core kernel (4 splits at N 4096: 512 blocks, one an
//   SM for their 198 KB of shared memory);
// - ragged N, V and H are masked: rows past N or V and columns past H are
//   zero, and only columns below H are written. 32 rows of h fit a block
//   up to H 1216; beyond, bf16 dH runs on the CUDA-core kernel.

// Grid (ceil(N / 32), splits, panels): the partial dH of 32 tokens over the
// vocab ids of one split, for one 768-column panel of H.
__global__ void __launch_bounds__(kThreads, 1) vocab_ce_bwd_dh_tc_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nch = (a.H + kTcChunk - 1) / kTcChunk;  // W chunks per vocab tile
  const int hc = nch * kTcChunk;
  const int ldh = hc + 8;
  float* sR = reinterpret_cast<float*>(smem_raw);                 // [4][32][kTcLdr]
  bf16* sH = reinterpret_cast<bf16*>(sR + kTcKq * kTcRows * kTcLdr);  // [32][ldh]
  bf16* sPanel = sH + kTcRows * ldh;                              // [2][32][kTcLdp]
  bf16* sChunk = sPanel + 2 * kTcVocab * kTcLdp;                  // [2][3][32][kTcLdc]
  bf16* sDS = sChunk + 6 * kTcVocab * kTcLdc;                     // [2][32][kTcLds]
  float* sL = reinterpret_cast<float*>(sDS + 2 * kTcRows * kTcLds);
  float* sG = sL + kTcRows;
  int* sLab = reinterpret_cast<int*>(sG + kTcRows);
  constexpr int kPieces = 3 * kTcVocab * kTcLdc;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int n0 = blockIdx.x * kTcRows, split = blockIdx.y, c0 = blockIdx.z * kPanel;
  const int pw = min(kPanel, a.H - c0);  // columns of this panel
  const int v_begin = split * a.tiles_per_split * kBV;
  const int v_end = min(a.V, v_begin + a.tiles_per_split * kBV);
  const int ntiles = v_end > v_begin ? (v_end - v_begin + kTcVocab - 1) / kTcVocab : 0;
  const int steps = ntiles * nch;
  // the token blocks start their walks over the split's tiles at kTcWalks
  // points, so they do not all read the same W rows at the same moment
  const int rot = (int)((long long)(blockIdx.x % kTcWalks) * ntiles / kTcWalks);
  const bf16* h = static_cast<const bf16*>(a.h);
  const bool w_vec = a.H % 4 == 0 && (reinterpret_cast<uintptr_t>(a.w) & 15) == 0;
  const bool h_vec = a.H % 8 == 0 && (reinterpret_cast<uintptr_t>(h) & 15) == 0;
  // logits: warp (kq, lh) sums k-step kq of every chunk for the 32 tokens
  // x ids 16 lh..; product: warp owns all 32 tokens x panel columns 96 w..
  const int kq = warp / 2, lh = warp % 2, pc = warp * (kPanel / 8);

  if (tid < kTcRows) {
    const bool ok = n0 + tid < a.N;
    sL[tid] = ok ? a.lse[n0 + tid] : 0.f;
    sG[tid] = ok ? a.g[n0 + tid] : 0.f;
    sLab[tid] = ok ? a.labels[n0 + tid] : -1;
  }
  float acc[2][kPanel / 64][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < kPanel / 64; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;

  // step i takes chunk i: vocab tile (i / nch + rot) % ntiles, columns
  // (i % nch) 64.., walked with counters (no division per step)
  auto advance = [&](int& c, int& t) {
    if (++c == nch) {
      c = 0;
      if (++t == ntiles) t = 0;
    }
  };
  int ch = 0, tile = rot;  // chunk i
  int fch = 0, ftile = rot;  // the next chunk to fetch
  // this thread's share of the next two chunks, in flight: chunk j >= 1
  // is fetched into wx[(j - 1) % 2] two steps before it is split
  float wx[2][8];
  if (steps > 0) {
    // prologue: h rows n0.. (zero past N and H); chunk 0 split; chunks 1
    // and 2 fetched
    if (h_vec) {
      for (int idx = tid; idx < kTcRows * (hc / 8); idx += kThreads) {
        const int r = idx / (hc / 8), c = (idx % (hc / 8)) * 8;
        const bool in = n0 + r < a.N && c < a.H;
        cp_async_16(sH + r * ldh + c, in ? h + (long long)(n0 + r) * a.H + c : h, in);
      }
    } else {
      for (int idx = tid; idx < kTcRows * hc; idx += kThreads) {
        const int r = idx / hc, c = idx % hc;
        sH[r * ldh + c] = (n0 + r < a.N && c < a.H) ? h[(long long)(n0 + r) * a.H + c]
                                                     : __float2bfloat16(0.f);
      }
    }
    cp_async_commit();
    tc_fetch_chunk(wx[0], a, v_begin + ftile * kTcVocab, 0, w_vec);
    tc_split_chunk(sChunk, nullptr, wx[0]);
#pragma unroll
    for (int j = 1; j <= 2; ++j) {
      advance(fch, ftile);
      if (j < steps) tc_fetch_chunk(wx[j - 1], a, v_begin + ftile * kTcVocab, fch * kTcChunk, w_vec);
    }
    advance(fch, ftile);  // chunk 3
    cp_async_wait<0>();
  }

  float lg[2][2][4];  // this warp's partial logits: 2 token x 2 id blocks
  for (int i = 0; i < steps; ++i, advance(ch, tile)) {
    // chunk i is split; every reader of step i - 1 is done
    __syncthreads();
    const bf16* pieces = sChunk + (i & 1) * kPieces;
    if (ch == 0) {
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 2; ++n) lg[m][n][0] = lg[m][n][1] = lg[m][n][2] = lg[m][n][3] = 0.f;
      // a tile's first chunk reaches the panel here, after the product
      // of the tile before
      if (c0 == 0) {
        const int r = tid / 8, c = (tid % 8) * 8;
#pragma unroll
        for (int p = 0; p < 2; ++p)
          *reinterpret_cast<uint4*>(sPanel + p * kTcVocab * kTcLdp + r * kTcLdp + c) =
              *reinterpret_cast<const uint4*>(pieces + p * kTcVocab * kTcLdc + r * kTcLdc + c);
      }
    }

    // partial logits += h·W_hiᵀ + h·W_midᵀ + h·W_loᵀ over k-step kq of
    // chunk i
    {
      uint32_t ha[2][4], wb[3][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
        ldsm_x4(ha[m], sH + (m * 16 + lane % 16) * ldh + ch * kTcChunk + kq * 16 +
                           (lane / 16) * 8);
#pragma unroll
      for (int p = 0; p < 3; ++p)
        ldsm_x4(wb[p], pieces + p * kTcVocab * kTcLdc +
                           (lh * 16 + lane % 8 + (lane / 16) * 8) * kTcLdc + kq * 16 +
                           ((lane / 8) % 2) * 8);
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int n = 0; n < 2; ++n) mma_bf16_16816(lg[m][n], ha[m], wb[p][2 * n], wb[p][2 * n + 1]);
    }

    // split chunk i + 1 (fetched two steps ago) into the other buffer,
    // and into the panel unless it starts a tile; fetch chunk i + 3 into
    // the registers it leaves (two copies: register arrays take static
    // indices)
    if (i + 1 < steps) {
      const int nc = ch + 1 == nch ? 0 : ch + 1, col = nc * kTcChunk - c0;
      bf16* dst = sChunk + ((i + 1) & 1) * kPieces;
      bf16* panel = nc != 0 && col >= 0 && col < kPanel ? sPanel + col : nullptr;
      const bool more = i + 3 < steps;
      const int fv0 = v_begin + ftile * kTcVocab, fk0 = fch * kTcChunk;
      if (i & 1) {
        tc_split_chunk(dst, panel, wx[1]);
        if (more) tc_fetch_chunk(wx[1], a, fv0, fk0, w_vec);
      } else {
        tc_split_chunk(dst, panel, wx[0]);
        if (more) tc_fetch_chunk(wx[0], a, fv0, fk0, w_vec);
      }
      advance(fch, ftile);
    }
    if (ch < nch - 1) continue;

    // tile end: the four partial logit sums meet in shared memory
    const int v0 = v_begin + tile * kTcVocab;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(sR + kq * kTcRows * kTcLdr +
                                     (m * 16 + g + r * 8) * kTcLdr + lh * 16 + n * 8 + tg * 2) =
              make_float2(lg[m][n][2 * r], lg[m][n][2 * r + 1]);
    __syncthreads();
    // dS = g (softmax - target) in fp32 (0 past N and V), split into hi
    // and lo bf16: 4 ids of one token a thread, partial sums in k order
    {
      const int t = tid / 8, vl = (tid % 8) * 4;
      float4 z = *reinterpret_cast<const float4*>(sR + t * kTcLdr + vl);
#pragma unroll
      for (int q = 1; q < kTcKq; ++q) {
        const float4 y = *reinterpret_cast<const float4*>(sR + q * kTcRows * kTcLdr +
                                                          t * kTcLdr + vl);
        z.x += y.x;
        z.y += y.y;
        z.z += y.z;
        z.w += y.w;
      }
      const float zs[4] = {z.x, z.y, z.z, z.w};
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int v = v0 + vl + e;
        ds[e] = (v < a.V && n0 + t < a.N)
                    ? (expf(zs[e] - sL[t]) - target_at(a, v, sLab[t])) * sG[t]
                    : 0.f;
      }
      uint32_t hi[2], lo[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(ds[2 * e], ds[2 * e + 1]);
        const float2 hf = __bfloat1622float2(h2);
        hi[e] = bf16x2_bits(h2);
        lo[e] = upper_halves(ds[2 * e] - hf.x, ds[2 * e + 1] - hf.y);
      }
      *reinterpret_cast<uint2*>(sDS + t * kTcLds + vl) = make_uint2(hi[0], hi[1]);
      *reinterpret_cast<uint2*>(sDS + kTcRows * kTcLds + t * kTcLds + vl) =
          make_uint2(lo[0], lo[1]);
    }
    __syncthreads();  // dS and the panel are complete

    // dH += dS_hi·W_hi + dS_hi·W_mid + dS_lo·W_hi over the tile's 32 ids:
    // a warp's 32 tokens x 96 columns, two 16-column groups at a time, one
    // term at a time (products issue in program order: each waits on the
    // one 8 places back)
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t da[2][2][4];  // [token block][dS hi, lo]
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int d = 0; d < 2; ++d)
          ldsm_x4(da[m][d], sDS + d * kTcRows * kTcLds + (m * 16 + lane % 16) * kTcLds +
                                ks * 16 + (lane / 16) * 8);
      const int br = ks * 16 + lane % 8 + ((lane / 8) % 2) * 8;
#pragma unroll
      for (int gp = 0; gp < kPanel / 8 / 32; ++gp) {
        uint32_t bw[2][2][4];  // [group][W hi, mid]
#pragma unroll
        for (int gg = 0; gg < 2; ++gg) {
          const int col = pc + (2 * gp + gg) * 16;
          if (col >= pw) continue;  // past H in the last panel
#pragma unroll
          for (int p = 0; p < 2; ++p)
            ldsm_x4_trans(bw[gg][p], sPanel + p * kTcVocab * kTcLdp + br * kTcLdp + col +
                                         (lane / 16) * 8);
        }
#pragma unroll
        for (int term = 0; term < 3; ++term)
#pragma unroll
          for (int gg = 0; gg < 2; ++gg) {
            if (pc + (2 * gp + gg) * 16 >= pw) continue;
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
              for (int n = 0; n < 2; ++n)
                mma_bf16_16816(acc[m][2 * (2 * gp + gg) + n], da[m][term == 2],
                               bw[gg][term == 1][2 * n], bw[gg][term == 1][2 * n + 1]);
          }
      }
    }
  }

  float* out = a.part + (long long)split * a.N * a.H;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < kPanel / 64; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + m * 16 + g + (e >> 1) * 8;
        const int c = c0 + pc + j * 8 + tg * 2 + (e & 1);
        if (n < a.N && c < a.H) out[(long long)n * a.H + c] = acc[m][j][e];
      }
}

// ---------------------------------------------------------------------------
// forward on the tensor cores (bf16 hidden)
// ---------------------------------------------------------------------------
//
// Bound at the GPT-2 shape (N 4096, V 50257, H 768): 3 bf16 passes of
// 2·N·V·H (0.95 TFLOP) at 989 TFLOP/s, 0.96 ms, above the bytes (W read
// once, 154 MB, 0.046 ms). The design is the logit half of the dH kernel
// below, with twice its tokens:
// - a block owns 64 tokens (h resident in shared memory as bf16, 99 KB at
//   H 768: the forward has no dS·W product and no 32 x 768 panel, so the
//   panel's room holds a larger token tile) and walks the 32-id tiles of
//   one vocab split; each W element is fetched from L2 once per 64 tokens
//   (half dH's W traffic per token) and split once;
// - each tile's W rows come in 64-column fp32 chunks straight into
//   registers (8 values a thread, fetched two chunks ahead) and are split
//   into hi, mid and lo bf16 in one of two buffers (chunk i + 1 is split
//   while chunk i's logits run); one barrier a chunk;
// - the 64 x 32 logit tile is split over k: warp (kq, half) takes k-step
//   kq of every chunk for 32 tokens x the tile's 32 ids: 8 fragment loads
//   (2 of h, 6 of W's pieces) for 24 products. Shared memory per chunk:
//   32 KB of fragments + 12 KB of split writes + the tile end's partial
//   sums (64 KB a tile, 5 KB a chunk at H 768) for 192 products, about
//   260 bytes a product;
// - statistics at the tile's end: the four partial sums meet in shared
//   memory, and thread t takes token t / 4 and 8 ids: the tile's max over
//   its ids first, then one `ex2` per logit against the new running max;
//   the label logit and the logit sum (smoothing) ride along; the first
//   maximal id under a strict `>` within the thread's increasing ids, and
//   the lower id on equal values when a tile's best meets the running best
//   (the walk is rotated, below) and when the 4 threads of a token meet at
//   the end with shuffles;
// - the blocks of a split are launched together (token tile fastest in
//   the grid), so the 132 blocks in flight share about two splits' W rows
//   (20 MB at the GPT-2 shape, within the 50 MB L2): W comes from HBM about
//   once. The token blocks start their walks at 8 points of the split, so
//   they do not all ask for the same W lines at once;
// - the vocab splits and the split-order combine are those of the
//   CUDA-core kernel (fwd_splits: 16 at N 4096, 1024 blocks of 168 KB,
//   one an SM). 64 rows of h fit a block up to H 1216; beyond, bf16 runs
//   on the CUDA-core forward.

// Grid (ceil(N / 64), splits): the partial statistics of 64 tokens over
// the vocab ids of one split.
__global__ void __launch_bounds__(kThreads, 1) vocab_ce_fwd_tc_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nch = (a.H + kTcChunk - 1) / kTcChunk;  // W chunks per vocab tile
  const int hc = nch * kTcChunk;
  const int ldh = hc + 8;
  float* sR = reinterpret_cast<float*>(smem_raw);                       // [4][64][kTcLdr]
  bf16* sH = reinterpret_cast<bf16*>(sR + kTcKq * kFwdRows * kTcLdr);   // [64][ldh]
  bf16* sChunk = sH + kFwdRows * ldh;                                   // [2][3][32][kTcLdc]
  int* sLab = reinterpret_cast<int*>(sChunk + 6 * kTcVocab * kTcLdc);
  constexpr int kPieces = 3 * kTcVocab * kTcLdc;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int n0 = blockIdx.x * kFwdRows, split = blockIdx.y;
  const int v_begin = split * a.tiles_per_split * kBV;
  const int v_end = min(a.V, v_begin + a.tiles_per_split * kBV);
  const int ntiles = v_end > v_begin ? (v_end - v_begin + kTcVocab - 1) / kTcVocab : 0;
  const int steps = ntiles * nch;
  const int rot = (int)((long long)(blockIdx.x % kTcWalks) * ntiles / kTcWalks);
  const bf16* h = static_cast<const bf16*>(a.h);
  const bool w_vec = a.H % 4 == 0 && (reinterpret_cast<uintptr_t>(a.w) & 15) == 0;
  const bool h_vec = a.H % 8 == 0 && (reinterpret_cast<uintptr_t>(h) & 15) == 0;
  // logits: warp (kq, th) sums k-step kq of every chunk for tokens 32 th..
  // x the tile's 32 ids; statistics: thread owns token st, ids sq.. of a tile
  const int kq = warp / 2, th = warp % 2;
  const int st = tid / 4, sq = (tid % 4) * 8;

  if (tid < kFwdRows) sLab[tid] = n0 + tid < a.N ? a.labels[n0 + tid] : -1;
  // the TPU kernel's `iv == 0` init, per thread over its own ids
  float m = kNegInf, l = 0.f, ll = kNegInf, zs = 0.f;
  int ix = kNoId;

  auto advance = [&](int& c, int& t) {
    if (++c == nch) {
      c = 0;
      if (++t == ntiles) t = 0;
    }
  };
  int ch = 0, tile = rot;    // chunk i
  int fch = 0, ftile = rot;  // the next chunk to fetch
  float wx[2][8];
  if (steps > 0) {
    // prologue: h rows n0.. (zero past N and H); chunk 0 split; chunks 1
    // and 2 fetched
    if (h_vec) {
      for (int idx = tid; idx < kFwdRows * (hc / 8); idx += kThreads) {
        const int r = idx / (hc / 8), c = (idx % (hc / 8)) * 8;
        const bool in = n0 + r < a.N && c < a.H;
        cp_async_16(sH + r * ldh + c, in ? h + (long long)(n0 + r) * a.H + c : h, in);
      }
    } else {
      for (int idx = tid; idx < kFwdRows * hc; idx += kThreads) {
        const int r = idx / hc, c = idx % hc;
        sH[r * ldh + c] = (n0 + r < a.N && c < a.H) ? h[(long long)(n0 + r) * a.H + c]
                                                     : __float2bfloat16(0.f);
      }
    }
    cp_async_commit();
    tc_fetch_chunk(wx[0], a, v_begin + ftile * kTcVocab, 0, w_vec);
    tc_split_chunk(sChunk, nullptr, wx[0]);
#pragma unroll
    for (int j = 1; j <= 2; ++j) {
      advance(fch, ftile);
      if (j < steps) tc_fetch_chunk(wx[j - 1], a, v_begin + ftile * kTcVocab, fch * kTcChunk, w_vec);
    }
    advance(fch, ftile);  // chunk 3
    cp_async_wait<0>();
  }

  float lg[2][4][4];  // this warp's partial logits: 2 token x 4 id blocks
  for (int i = 0; i < steps; ++i, advance(ch, tile)) {
    // chunk i is split; every reader of step i - 1 is done
    __syncthreads();
    const bf16* pieces = sChunk + (i & 1) * kPieces;
    if (ch == 0) {
#pragma unroll
      for (int mm = 0; mm < 2; ++mm)
#pragma unroll
        for (int n = 0; n < 4; ++n) lg[mm][n][0] = lg[mm][n][1] = lg[mm][n][2] = lg[mm][n][3] = 0.f;
    }

    // partial logits += h·W_hiᵀ + h·W_midᵀ + h·W_loᵀ over k-step kq of
    // chunk i
    {
      uint32_t ha[2][4];
#pragma unroll
      for (int mm = 0; mm < 2; ++mm)
        ldsm_x4(ha[mm], sH + (32 * th + mm * 16 + lane % 16) * ldh + ch * kTcChunk + kq * 16 +
                            (lane / 16) * 8);
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          uint32_t wb[4];
          ldsm_x4(wb, pieces + p * kTcVocab * kTcLdc +
                          (nb * 16 + lane % 8 + (lane / 16) * 8) * kTcLdc + kq * 16 +
                          ((lane / 8) % 2) * 8);
#pragma unroll
          for (int mm = 0; mm < 2; ++mm)
#pragma unroll
            for (int n = 0; n < 2; ++n)
              mma_bf16_16816(lg[mm][2 * nb + n], ha[mm], wb[2 * n], wb[2 * n + 1]);
        }
    }

    // split chunk i + 1 (fetched two steps ago) into the other buffer;
    // fetch chunk i + 3 into the registers it leaves
    if (i + 1 < steps) {
      bf16* dst = sChunk + ((i + 1) & 1) * kPieces;
      const bool more = i + 3 < steps;
      const int fv0 = v_begin + ftile * kTcVocab, fk0 = fch * kTcChunk;
      if (i & 1) {
        tc_split_chunk(dst, nullptr, wx[1]);
        if (more) tc_fetch_chunk(wx[1], a, fv0, fk0, w_vec);
      } else {
        tc_split_chunk(dst, nullptr, wx[0]);
        if (more) tc_fetch_chunk(wx[0], a, fv0, fk0, w_vec);
      }
      advance(fch, ftile);
    }
    if (ch < nch - 1) continue;

    // tile end: the four partial logit sums meet in shared memory
#pragma unroll
    for (int mm = 0; mm < 2; ++mm)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(sR + kq * kFwdRows * kTcLdr +
                                     (32 * th + mm * 16 + g + r * 8) * kTcLdr + n * 8 + tg * 2) =
              make_float2(lg[mm][n][2 * r], lg[mm][n][2 * r + 1]);
    __syncthreads();
    // this thread's 8 logits of token st, summed in k order
    float z[8];
    {
      const float* row = sR + st * kTcLdr + sq;
      float4 x0 = *reinterpret_cast<const float4*>(row);
      float4 x1 = *reinterpret_cast<const float4*>(row + 4);
#pragma unroll
      for (int q = 1; q < kTcKq; ++q) {
        const float4 y0 = *reinterpret_cast<const float4*>(row + q * kFwdRows * kTcLdr);
        const float4 y1 = *reinterpret_cast<const float4*>(row + q * kFwdRows * kTcLdr + 4);
        x0.x += y0.x; x0.y += y0.y; x0.z += y0.z; x0.w += y0.w;
        x1.x += y1.x; x1.y += y1.y; x1.z += y1.z; x1.w += y1.w;
      }
      z[0] = x0.x; z[1] = x0.y; z[2] = x0.z; z[3] = x0.w;
      z[4] = x1.x; z[5] = x1.y; z[6] = x1.z; z[7] = x1.w;
    }
    const int v0 = v_begin + tile * kTcVocab + sq;
    const int label = sLab[st];
    const int nv = min(8, a.V - v0);  // ids below V (the TPU kernel's -1e30 padding adds nothing)
    float tm = kNegInf;
    int ti = kNoId;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (e >= nv) continue;
      if (z[e] > tm) {  // strict: the thread's ids come in increasing order
        tm = z[e];
        ti = v0 + e;
      }
      if (v0 + e == label) ll = z[e];
      zs += z[e];
    }
    if (nv > 0) {
      const float mn = fmaxf(m, tm);
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (e < nv) sum += exp2_approx((z[e] - mn) * kLog2e);
      l = l * exp2_approx((m - mn) * kLog2e) + sum;
      if (tm > m || (tm == m && ti < ix)) ix = ti;  // ties go to the lower id
      m = mn;
    }
  }

  // the 4 threads of each token meet once
  const int SN = a.splits * a.N, base = split * a.N;
  const float mx = quad_max(m);
  const float sum = quad_sum(l * exp2_approx((m - mx) * kLog2e));
  const float lab = quad_max(ll);
  const float lsum = quad_sum(zs);
  float bm = m;
  int bi = ix;
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, bm, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (om > bm || (om == bm && oi < bi)) {  // ties go to the lower id
      bm = om;
      bi = oi;
    }
  }
  const int n = n0 + st;
  if (tid % 4 == 0 && n < a.N) {
    a.part[base + n] = mx;
    a.part[SN + base + n] = sum;
    a.part[2 * SN + base + n] = lab;
    a.part[3 * SN + base + n] = lsum;
    a.part_ix[base + n] = bi;
  }
}

// ---------------------------------------------------------------------------
// backward: dW on the tensor cores (bf16 hidden)
// ---------------------------------------------------------------------------
//
// Bound at the GPT-2 shape: 4 bf16 passes of 2·N·V·H (3 for the logits,
// 1 for dSᵀ·h; 1.26 TFLOP) at 989 TFLOP/s, 1.28 ms, above the bytes. The
// design is the dK/dV kernel's: a block owns 32 vocab rows (the "keys")
// and walks the 32-token tiles (the "queries"):
// - W's rows are read and split once, at the block's start, into hi, mid
//   and lo bf16 pieces at the full depth, which stay resident: each W
//   element is read from device memory and split once per panel of the
//   whole call, and the walk fetches no W at all;
// - the shared memory sets the tiles. W's three pieces for 32 rows at H
//   768 (row stride H + 8) take 32 x 776 x 2 x 3 = 148,992 B; a resident
//   32-token h tile 49,664 B; the four partial logit sums 20,480 B and dSᵀ
//   2,560 B: 222,080 B of the 232,448 a block may use, one block an SM. A
//   64-token tile, or a second h buffer, does not fit beside the pieces,
//   and streaming h in k-chunks for the logits and again for the product
//   would read h from L2 twice; so the h tile is loaded once (16-byte
//   `cp.async`, zero past N and H) in two column halves, and the logits of
//   the first half run while the second half lands;
// - the logit tile Sᵀ (32 ids x 32 tokens) is split over k: warp (kq,
//   half) takes k-steps kq, kq + 4, .. for 16 ids x all 32 tokens: 5
//   fragment loads (3 of W's pieces, 2 of h) for 12 products;
// - dSᵀ = g (exp(Sᵀ - LSE) - target) is taken from the summed partials,
//   one id and 4 tokens a thread, rounded to bf16 as the contract asks and
//   stored once (2 KB); every warp reads it as its A fragments. (Its logits
//   are split over k, so no warp holds whole rows of Sᵀ to repack in
//   registers, and 8 warps computing all of it would take 8 times the
//   exponentials);
// - dW_tile += dSᵀ·h_tile: each warp owns all 32 ids x 96 columns of the
//   768-column panel as mma accumulators (96 registers a thread) and
//   reads h as B fragments with `ldmatrix.trans` (2 + 6 loads for 48
//   products a k-step);
// - shared memory per 32-token tile at H 768: 240 KB of logit fragments
//   for 1,152 products, 64 KB of product fragments for 384, 32 KB of
//   partial sums, 48 KB of h written: about 256 bytes a product. L2 per
//   call: each of the ceil(V / 32) blocks reads h once (9.9 GB at the
//   GPT-2 shape, 1,571 blocks x 6.3 MB; h stays in the 50 MB L2);
// - H > 768 takes further panels (blocks along y), each recomputing the
//   logits. The pieces and the h tile fit a block up to H 800
//   (dw_tc_smem_bytes); beyond, bf16 dW runs on the CUDA-core kernel.

// Grid (ceil(V / 32), panels): dW of 32 vocab rows over all tokens, for
// one 768-column panel of H.
__global__ void __launch_bounds__(kThreads, 1) vocab_ce_bwd_dw_tc_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hk = (a.H + 15) / 16 * 16;  // depth rounded up to a k-step
  const int ldw = hk + 8;
  const int nks = hk / 16, kmid = nks / 2;  // k-steps; those of the first half
  const int cmid = kmid * 16;
  float* sR = reinterpret_cast<float*>(smem_raw);                      // [4][32][kTcLdr]
  bf16* sW = reinterpret_cast<bf16*>(sR + kTcKq * kTcRows * kTcLdr);   // [3][32][ldw]
  bf16* sH = sW + 3 * kTcRows * ldw;                                   // [32][ldw]
  bf16* sDS = sH + kTcRows * ldw;                                      // dSᵀ [32][kTcLds]
  float* sL = reinterpret_cast<float*>(sDS + kTcRows * kTcLds);
  float* sG = sL + kTcRows;
  int* sLab = reinterpret_cast<int*>(sG + kTcRows);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int v0 = blockIdx.x * kTcRows, c0 = blockIdx.y * kPanel;
  const int pw = min(kPanel, a.H - c0);  // columns of this panel
  const bf16* h = static_cast<const bf16*>(a.h);
  const bool w_vec = a.H % 4 == 0 && (reinterpret_cast<uintptr_t>(a.w) & 15) == 0;
  const bool h_vec = a.H % 8 == 0 && (reinterpret_cast<uintptr_t>(h) & 15) == 0;
  // logits: warp (kq, vh) sums k-steps kq, kq + 4, .. for ids 16 vh.. x
  // the 32 tokens; product: warp owns the 32 ids x panel columns 96 w..
  const int kq = warp / 2, vh = warp % 2, pc = warp * (kPanel / 8);

  // columns [c_lo, c_hi) of the h tile at tokens n0.. (zero past N and
  // H), and with `stats` the tile's LSE, g and labels: one cp.async group
  auto load_h = [&](int n0, int c_lo, int c_hi, bool stats) {
    if (h_vec) {
      const int groups = (c_hi - c_lo) / 8;
      for (int idx = tid; idx < kTcRows * groups; idx += kThreads) {
        const int r = idx / groups, c = c_lo + (idx % groups) * 8;
        const bool in = n0 + r < a.N && c < a.H;
        cp_async_16(sH + r * ldw + c, in ? h + (long long)(n0 + r) * a.H + c : h, in);
      }
    } else {
      const int cols = c_hi - c_lo;
      for (int idx = tid; idx < kTcRows * cols; idx += kThreads) {
        const int r = idx / cols, c = c_lo + idx % cols;
        sH[r * ldw + c] = (n0 + r < a.N && c < a.H) ? h[(long long)(n0 + r) * a.H + c]
                                                     : __float2bfloat16(0.f);
      }
    }
    if (stats && tid < kTcRows) {
      const bool in = n0 + tid < a.N;
      cp_async_4(sL + tid, in ? a.lse + n0 + tid : a.lse, in);
      cp_async_4(sG + tid, in ? a.g + n0 + tid : a.g, in);
      cp_async_4(sLab + tid, in ? a.labels + n0 + tid : a.labels, in);
    }
    cp_async_commit();
  };

  load_h(0, 0, cmid, true);
  load_h(0, cmid, hk, false);
  // W rows v0.. split once into the resident pieces (zero past V and H)
  for (int idx = tid; idx < kTcRows * (hk / 8); idx += kThreads) {
    const int r = idx / (hk / 8), c = (idx % (hk / 8)) * 8;
    float x[8];
    fetch_w8(x, a, v0 + r, c, w_vec);
    uint4 hi, mid, lo;
    split8(x, hi, mid, lo);
    bf16* d = sW + r * ldw + c;
    *reinterpret_cast<uint4*>(d) = hi;
    *reinterpret_cast<uint4*>(d + kTcRows * ldw) = mid;
    *reinterpret_cast<uint4*>(d + 2 * kTcRows * ldw) = lo;
  }

  float acc[2][kPanel / 64][4];  // [id block][n8 block of the warp's columns]
#pragma unroll
  for (int mm = 0; mm < 2; ++mm)
#pragma unroll
    for (int j = 0; j < kPanel / 64; ++j) acc[mm][j][0] = acc[mm][j][1] = acc[mm][j][2] = acc[mm][j][3] = 0.f;

  float lg[4][4];  // this warp's partial Sᵀ: 16 ids x 4 token blocks
  // partial Sᵀ += W_hi·hᵀ + W_mid·hᵀ + W_lo·hᵀ over k-step ks
  auto logit_step = [&](int ks) {
    uint32_t hb[2][4];
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
      ldsm_x4(hb[nb], sH + (nb * 16 + lane % 8 + (lane / 16) * 8) * ldw + ks * 16 +
                          ((lane / 8) % 2) * 8);
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      uint32_t wa[4];
      ldsm_x4(wa, sW + p * kTcRows * ldw + (vh * 16 + lane % 16) * ldw + ks * 16 +
                      (lane / 16) * 8);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int n = 0; n < 2; ++n) mma_bf16_16816(lg[2 * nb + n], wa, hb[nb][2 * n], hb[nb][2 * n + 1]);
    }
  };

  const int ntok = (a.N + kTcRows - 1) / kTcRows;
  for (int t = 0; t < ntok; ++t) {
    const int n0 = t * kTcRows;
#pragma unroll
    for (int n = 0; n < 4; ++n) lg[n][0] = lg[n][1] = lg[n][2] = lg[n][3] = 0.f;
    cp_async_wait<1>();
    __syncthreads();  // the tile's first half and statistics (and W's pieces) are in
    int ks = kq;
    for (; ks < kmid; ks += kTcKq) logit_step(ks);
    cp_async_wait<0>();
    __syncthreads();  // the second half is in
    for (; ks < nks; ks += kTcKq) logit_step(ks);

    // the four partial sums meet in shared memory
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(sR + kq * kTcRows * kTcLdr + (vh * 16 + g + r * 8) * kTcLdr +
                                   n * 8 + tg * 2) = make_float2(lg[n][2 * r], lg[n][2 * r + 1]);
    __syncthreads();
    // dSᵀ = g (softmax - target) (0 past V and N), rounded to bf16
    // (`ds.astype(h.dtype)`): id r, tokens tq.. a thread, partial sums in
    // k order
    {
      const int r = tid / 8, tq = (tid % 8) * 4, v = v0 + r;
      float4 z = *reinterpret_cast<const float4*>(sR + r * kTcLdr + tq);
#pragma unroll
      for (int q = 1; q < kTcKq; ++q) {
        const float4 y = *reinterpret_cast<const float4*>(sR + q * kTcRows * kTcLdr +
                                                          r * kTcLdr + tq);
        z.x += y.x;
        z.y += y.y;
        z.z += y.z;
        z.w += y.w;
      }
      const float zs[4] = {z.x, z.y, z.z, z.w};
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = tq + e;
        ds[e] = (v < a.V && n0 + k < a.N)
                    ? (expf(zs[e] - sL[k]) - target_at(a, v, sLab[k])) * sG[k]
                    : 0.f;
      }
      *reinterpret_cast<uint2*>(sDS + r * kTcLds + tq) =
          make_uint2(pack_bf16x2(ds[0], ds[1]), pack_bf16x2(ds[2], ds[3]));
    }
    __syncthreads();  // dSᵀ is complete

    // dW += dSᵀ·h over the tile's 32 tokens: a warp's 32 ids x 96 columns
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t da[2][4];
#pragma unroll
      for (int mm = 0; mm < 2; ++mm)
        ldsm_x4(da[mm], sDS + (mm * 16 + lane % 16) * kTcLds + kk * 16 + (lane / 16) * 8);
      const int br = kk * 16 + lane % 8 + ((lane / 8) % 2) * 8;
#pragma unroll
      for (int gp = 0; gp < kPanel / 8 / 16; ++gp) {
        const int col = pc + gp * 16;
        if (col >= pw) continue;  // past H in the last panel
        uint32_t bw[4];
        ldsm_x4_trans(bw, sH + br * ldw + c0 + col + (lane / 16) * 8);
#pragma unroll
        for (int mm = 0; mm < 2; ++mm)
#pragma unroll
          for (int n = 0; n < 2; ++n)
            mma_bf16_16816(acc[mm][2 * gp + n], da[mm], bw[2 * n], bw[2 * n + 1]);
      }
    }
    if (t + 1 < ntok) {
      __syncthreads();  // every reader of the tile is done
      load_h(n0 + kTcRows, 0, cmid, true);
      load_h(n0 + kTcRows, cmid, hk, false);
    }
  }

  float* dw = static_cast<float*>(a.out);
#pragma unroll
  for (int mm = 0; mm < 2; ++mm)
#pragma unroll
    for (int j = 0; j < kPanel / 64; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int v = v0 + mm * 16 + g + (e >> 1) * 8;
        const int c = c0 + pc + j * 8 + tg * 2 + (e & 1);
        if (v < a.V && c < a.H) dw[(long long)v * a.H + c] = acc[mm][j][e];
      }
}

}  // namespace
