// The tensor-core forward of the fused LM head + cross-entropy for bf16
// hidden, and the split helpers it shares with the backward
// (vocab_ce_bwd.cuh). Included by vocab_ce.cu after `Args`, `kThreads`,
// `kBV`, `kFwdRows`, `kNegInf` and `kNoId`.
//
// It computes what `vocab_ce_fwd_kernel` computes for bf16 hidden (the
// contract of vocab_ce.cu), up to the order of the fp32 sums, on
// `mma.sync` m16n8k16 with bf16 operands and fp32 accumulators (the
// wrappers of warp_mma.cuh).
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
// order of the sums: three bf16 passes. Only W_hi takes a conversion
// instruction (a quarter-rate one); the rest are bit operations. The
// statistics, the target, the smoothing and the split-order combine stay
// fp32.
//
// What bounds it on an H100 is not the tensor cores (989 TFLOP/s) but the
// shared memory that feeds `mma.sync` through `ldmatrix` (128 bytes a
// clock an SM) and the split of W, so the design counts bytes of shared
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
//   below N are written.
// The backward (vocab_ce_bwd.cuh) runs on `wgmma` fed by TMA instead; the
// forward moving there too is later work.

#pragma once

#include "warp_mma.cuh"

namespace {

constexpr int kTcVocab = 32;          // vocab ids of a logit tile
constexpr int kTcChunk = 64;          // columns (H) of a W chunk
constexpr int kTcKq = kTcChunk / 16;  // k-steps of a chunk: partial logit sums
constexpr int kTcLdc = kTcChunk + 8;  // row stride of a split chunk (bf16)
constexpr int kTcLdr = kTcVocab + 8;  // row stride of the partial logits (fp32)
constexpr int kTcWalks = 8;           // vocab walk starts among the token blocks
constexpr size_t kMaxSmem = 232448;   // dynamic shared memory a block may use
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

// Dynamic shared memory of the forward tensor-core kernel at depth H.
size_t fwd_tc_smem_bytes(int H) {
  const size_t hc = (size_t)((H + kTcChunk - 1) / kTcChunk) * kTcChunk;
  return (size_t)kTcKq * kFwdRows * kTcLdr * sizeof(float)  // partial logits
         + (size_t)kFwdRows * (hc + 8) * sizeof(bf16)        // h
         + (size_t)6 * kTcVocab * kTcLdc * sizeof(bf16)      // W hi, mid, lo of two chunks
         + (size_t)kFwdRows * sizeof(int);                   // labels
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
// of `pieces` ([3][32][kTcLdc]).
__device__ __forceinline__ void tc_split_chunk(bf16* pieces, const float (&x)[8]) {
  const int r = threadIdx.x / 8, c = (threadIdx.x % 8) * 8;
  uint4 hi, mid, lo;
  split8(x, hi, mid, lo);
  bf16* d = pieces + r * kTcLdc + c;
  *reinterpret_cast<uint4*>(d) = hi;
  *reinterpret_cast<uint4*>(d + kTcVocab * kTcLdc) = mid;
  *reinterpret_cast<uint4*>(d + 2 * kTcVocab * kTcLdc) = lo;
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
// forward on the tensor cores (bf16 hidden)
// ---------------------------------------------------------------------------
//
// Bound at the GPT-2 shape (N 4096, V 50257, H 768): 3 bf16 passes of
// 2·N·V·H (0.95 TFLOP) at 989 TFLOP/s, 0.96 ms, above the bytes (W read
// once, 154 MB, 0.046 ms):
// - a block owns 64 tokens (h resident in shared memory as bf16, 99 KB at
//   H 768) and walks the 32-id tiles of one vocab split; each W element is
//   fetched from L2 once per 64 tokens and split once;
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
    tc_split_chunk(sChunk, wx[0]);
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
        tc_split_chunk(dst, wx[1]);
        if (more) tc_fetch_chunk(wx[1], a, fv0, fk0, w_vec);
      } else {
        tc_split_chunk(dst, wx[0]);
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

}  // namespace
