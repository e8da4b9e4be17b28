// Fused LM head + softmax cross-entropy for Hopper (sm_90a): the forward,
// dH and dW kernels of a per-token cross-entropy over logits = H · Wᵀ that
// never writes the [N, V] logit matrix to device memory.
//
// Replaces the TPU kernels of the JAX package's `ops/pallas_vocab_ce.py`:
// - vocab_ce_fwd_kernel (+ vocab_ce_combine_kernel) <- `_fwd_kernel`,
//   reached through `_fused_ce_fwd_call`
// - vocab_ce_bwd_dh_tc_kernel (bf16 hidden, tensor cores) and
//   vocab_ce_bwd_dh_kernel (+ vocab_ce_dh_reduce_kernel) <- `_dh_kernel`,
//   reached through `_fused_ce_bwd_call`
// - vocab_ce_bwd_dw_kernel <- `_dw_kernel`, reached through `_fused_ce_bwd_call`
// with the same contract: hidden h [N, H] in bf16 or fp32, weight W [V, H]
// in fp32, labels [N] int32 in [0, V); logits, the running max / sum-exp /
// label logit / logit sum and the LSE in fp32; the loss lse - label logit
// (lse - (1 - eps) * label logit - eps * mean logit with label smoothing
// eps); pred the FIRST maximal id (`jnp.argmax` parity); the backward's
// dS = g * (softmax - target) with target the one-hot label, or
// (1 - eps) * one-hot + eps / V; dS stays fp32 before dS · W (W is fp32)
// and is rounded to h's type before dSᵀ · h; accumulation in fp32 and each
// gradient written in its input's type. Vocab ids >= V, token rows >= N and
// depth >= H are masked here (the TPU zero-pads W to its vocab block and
// sends shapes that do not tile to XLA); the TPU's 128-lane broadcast of
// the per-token values is a layout of that chip and is not carried over.
//
// Bound on an H100: operations. Each kernel does 2 * N * V * H flops (the
// logits; the backward kernels as much again for their product) against
// V * H * 4 bytes of W read once, so at the GPT-2 shape (N 4096, V 50257,
// H 768) the floor is the flops over the card's peak: 67 TFLOP/s with an
// fp32 operand on CUDA cores. The forward, dW and fp32-hidden dH kernels
// run every product in fp32 on CUDA cores; the bf16-hidden dH runs on the
// bf16 tensor cores with W and dS split into bf16 pieces that keep the
// fp32 products (vocab_ce_bwd_dh_tc_kernel, its note below).
//
// What the CUDA-core design does about it:
// - the TPU's sequential vocab grid axis (and its VMEM scratch carried
//   across grid steps) becomes a loop over 64-id vocab tiles inside a block;
// - a 64 x 64 (forward) or 32 x 64 (backward) logit tile is one register-
//   tiled fp32 product: 256 threads, each owning 4 x 4 or 2 x 4 logits
//   (rows ty + 16 i, columns tx + 16 j), fed from 32-deep chunks of both
//   operands staged in shared memory as fp32 with a row stride of 33, so
//   the column-strided reads hit 32 banks and a warp's row reads broadcast;
// - forward statistics are per thread over the thread's own columns (an
//   online max / sum-exp, the first argmax under a strict `>`, the label
//   logit, the logit sum) and meet across the 16 lanes of a row only once,
//   at the end: no shuffle per tile. Ties across lanes go to the lower id;
// - occupancy: 4096 tokens are only 64 forward blocks of 64 rows, so the
//   vocab is split across blocks (16-32 splits at the GPT-2 shapes) and a
//   combine kernel merges the partial statistics split by split, in vocab
//   order, like flash-decoding's combine;
// - the backward accumulators do not fit a block as the TPU holds them
//   ([256, H] and [512, H] fp32 in VMEM): a dH block owns 32 tokens and a
//   dW block 32 vocab rows, each with a 32 x 768 fp32 accumulator panel in
//   registers (4 x 24 per thread, one warp per 8 rows); the product operand
//   (W rows for dH, h rows for dW) streams through shared memory 8 rows at
//   a time. H > 768 takes further panels (blocks along z / y), each
//   recomputing the logits, which H <= 768 never pays;
// - dH splits the vocab across blocks too (4 splits at N 4096) into fp32
//   partial sums that a reduce kernel adds in split order and casts, so the
//   result does not depend on the schedule; dW has ceil(V / 32) blocks.
// Tensor cores for the forward and dW, TMA and persistent schedules are
// left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kKC = 32;             // depth (H) of one staged operand chunk
constexpr int kKS = kKC + 1;        // its row stride in shared memory
constexpr int kBV = 64;             // columns of a logit tile
constexpr int kFwdRows = 64;        // tokens of a forward block
constexpr int kBwdRows = 32;        // tokens of a dH block, vocab rows of a dW block
constexpr int kPanel = 768;         // accumulator columns of a backward block
constexpr int kPJ = kPanel / 32;    // accumulator columns per thread
constexpr int kSub = 8;             // product-operand rows staged per step
constexpr int kDS = kBV + 1;        // row stride of the dS tile
constexpr float kNegInf = -1e30f;   // the TPU kernel's mask value
constexpr int kNoId = 0x7fffffff;   // argmax id of a lane that saw no vocab

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// x rounded to the element type T, as a float (`.astype(T)` before a product)
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

// max / sum over the 16 lanes of a half warp (the lanes sharing ty)
__device__ __forceinline__ float row_max(float x) {
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

struct Args {
  const void* h;        // [N, H] bf16 or fp32
  const float* w;       // [V, H]
  const int* labels;    // [N]
  const float* lse;     // [N] (backward)
  const float* g;       // [N] cotangent of the loss (backward)
  float* loss;          // [N] (forward)
  float* lse_out;       // [N] (forward)
  int* pred;            // [N] (forward)
  float* part;          // forward: 4 x [splits, N] statistics; dH: [splits, N, H]
  int* part_ix;         // forward: [splits, N] argmax ids
  void* out;            // dH: [N, H] in h's type; dW: [V, H] fp32
  int N, V, H, splits, tiles_per_split;
  float eps, one_minus_eps, eps_over_v;  // label smoothing (eps 0: none)
};

// The (possibly smoothed) label distribution at vocab id v < V.
__device__ __forceinline__ float target_at(const Args& a, int v, int label) {
  const float onehot = v == label ? 1.f : 0.f;
  return a.eps > 0.f ? a.one_minus_eps * onehot + a.eps_over_v : onehot;
}

// s[i][j] = Σ_k A[a0 + ty + 16 i, k] · B[b0 + tx + 16 j, k] over k < H, fp32,
// for the (16 RI) x 64 tile of rows a0.. of A and b0.. of B (both [*, H]
// row-major); rows at or past a_rows / b_rows read as zero. Starts with a
// __syncthreads, so shared values written before the call are visible
// after it.
template <int RI, typename TA, typename TB>
__device__ __forceinline__ void logit_tile(float (&s)[RI][4], float* sA, float* sB,
                                           const TA* A, int a0, int a_rows, const TB* B,
                                           int b0, int b_rows, int H) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int k0 = 0; k0 < H; k0 += kKC) {
    __syncthreads();  // the previous chunk's (or tile's) readers are done
    for (int idx = tid; idx < 16 * RI * kKC; idx += kThreads) {
      const int r = idx / kKC, c = idx % kKC;
      float x = 0.f;
      if (a0 + r < a_rows && k0 + c < H) x = to_float(A[(long long)(a0 + r) * H + k0 + c]);
      sA[r * kKS + c] = x;
    }
    for (int idx = tid; idx < kBV * kKC; idx += kThreads) {
      const int r = idx / kKC, c = idx % kKC;
      float x = 0.f;
      if (b0 + r < b_rows && k0 + c < H) x = to_float(B[(long long)(b0 + r) * H + k0 + c]);
      sB[r * kKS + c] = x;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kKC; ++kk) {
      float av[RI], bv[4];
#pragma unroll
      for (int i = 0; i < RI; ++i) av[i] = sA[(ty + 16 * i) * kKS + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sB[(tx + 16 * j) * kKS + kk];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += av[i] * bv[j];
    }
  }
}

// acc[i][j] (row ry + 8 i, column c0 + rx + 32 j of a 32 x 768 panel) +=
// Σ_k sDS[ry + 8 i][k] · X[x0 + k, c0 + rx + 32 j] over the 64 columns of
// the dS tile; X rows at or past x_rows and columns at or past H read as
// zero. X ([*, H] row-major) streams through sP eight rows at a time.
template <typename TX>
__device__ __forceinline__ void panel_product(float (&acc)[4][kPJ], const float* sDS, float* sP,
                                              const TX* X, int x0, int x_rows, int c0, int H) {
  const int tid = threadIdx.x, ry = tid / 32, rx = tid % 32;
  for (int kc = 0; kc < kBV; kc += kSub) {
    __syncthreads();  // dS is written (kc == 0) / the previous rows' readers are done
    for (int idx = tid; idx < kSub * kPanel; idx += kThreads) {
      const int r = idx / kPanel, c = idx % kPanel;
      float x = 0.f;
      if (x0 + kc + r < x_rows && c0 + c < H) x = to_float(X[(long long)(x0 + kc + r) * H + c0 + c]);
      sP[idx] = x;
    }
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < kSub; ++kk) {
      float d[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) d[i] = sDS[(ry + 8 * i) * kDS + kc + kk];
#pragma unroll
      for (int j = 0; j < kPJ; ++j) {
        const float x = sP[kk * kPanel + rx + 32 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += d[i] * x;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// Grid (ceil(N / 64), splits): the partial statistics of 64 tokens over the
// vocab tiles of one split.
template <typename T>
__global__ void __launch_bounds__(kThreads) vocab_ce_fwd_kernel(Args a) {
  __shared__ float sA[kFwdRows * kKS];
  __shared__ float sB[kBV * kKS];
  __shared__ int sLab[kFwdRows];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int n0 = blockIdx.x * kFwdRows, split = blockIdx.y;
  const int vtiles = (a.V + kBV - 1) / kBV;
  const int vt0 = split * a.tiles_per_split;
  const int vt1 = min(vtiles, vt0 + a.tiles_per_split);
  if (tid < kFwdRows) sLab[tid] = n0 + tid < a.N ? a.labels[n0 + tid] : -1;

  // the TPU kernel's `iv == 0` init, per thread over its own columns
  float m[4], l[4], ll[4], zs[4];
  int ix[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    ll[i] = kNegInf;
    zs[i] = 0.f;
    ix[i] = kNoId;
  }
  for (int vt = vt0; vt < vt1; ++vt) {
    const int v0 = vt * kBV;
    float s[4][4];
    logit_tile<4>(s, sA, sB, static_cast<const T*>(a.h), n0, a.N, a.w, v0, a.V, a.H);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int label = sLab[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int v = v0 + tx + 16 * j;
        if (v >= a.V) continue;  // the TPU kernel's -1e30 vocab padding adds nothing
        const float x = s[i][j];
        if (x > m[i]) {  // strict: a lane's columns come in increasing id order
          l[i] = l[i] * expf(m[i] - x) + 1.f;
          m[i] = x;
          ix[i] = v;
        } else {
          l[i] += expf(x - m[i]);
        }
        if (v == label) ll[i] = x;
        zs[i] += x;
      }
    }
  }

  // the 16 lanes of each row meet once
  const int SN = a.splits * a.N, base = split * a.N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float mx = row_max(m[i]);
    const float sum = row_sum(l[i] * expf(m[i] - mx));
    const float lab = row_max(ll[i]);
    const float lsum = row_sum(zs[i]);
    float bm = m[i];
    int bi = ix[i];
    for (int off = 8; off > 0; off >>= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, bm, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (om > bm || (om == bm && oi < bi)) {  // ties go to the lower id
        bm = om;
        bi = oi;
      }
    }
    const int n = n0 + ty + 16 * i;
    if (tx == 0 && n < a.N) {
      a.part[base + n] = mx;
      a.part[SN + base + n] = sum;
      a.part[2 * SN + base + n] = lab;
      a.part[3 * SN + base + n] = lsum;
      a.part_ix[base + n] = bi;
    }
  }
}

// One thread per token: the splits' statistics merged in vocab order (the
// TPU kernel's running update across its vocab grid axis, then its
// `iv == last` finish).
__global__ void vocab_ce_combine_kernel(Args a) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= a.N) return;
  const int SN = a.splits * a.N;
  float m = kNegInf, l = 0.f, ll = kNegInf, zs = 0.f;
  int ix = 0;
  for (int s = 0; s < a.splits; ++s) {
    const int at = s * a.N + n;
    const float ms = a.part[at];
    if (ms > m) ix = a.part_ix[at];  // strict: the first maximal id across splits
    const float m_new = fmaxf(m, ms);
    l = l * expf(m - m_new) + a.part[SN + at] * expf(ms - m_new);
    m = m_new;
    ll = fmaxf(ll, a.part[2 * SN + at]);
    zs += a.part[3 * SN + at];
  }
  const float lse = m + logf(l);
  const float target = a.eps > 0.f ? a.one_minus_eps * ll + a.eps * zs / (float)a.V : ll;
  a.loss[n] = lse - target;
  a.lse_out[n] = lse;
  a.pred[n] = ix;
}

// ---------------------------------------------------------------------------
// backward: dH
// ---------------------------------------------------------------------------

// Grid (ceil(N / 32), splits, panels): the partial dH of 32 tokens over the
// vocab tiles of one split, for one 768-column panel of H.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) vocab_ce_bwd_dh_kernel(Args a) {
  __shared__ float sA[kBwdRows * kKS];   // h chunk
  __shared__ float sB[kBV * kKS];        // W chunk
  __shared__ float sDS[kBwdRows * kDS];  // dS [token][vocab]
  __shared__ float sP[kSub * kPanel];    // W rows for the product
  __shared__ float sL[kBwdRows], sG[kBwdRows];
  __shared__ int sLab[kBwdRows];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16, ry = tid / 32, rx = tid % 32;
  const int n0 = blockIdx.x * kBwdRows, split = blockIdx.y, c0 = blockIdx.z * kPanel;
  const int vtiles = (a.V + kBV - 1) / kBV;
  const int vt0 = split * a.tiles_per_split;
  const int vt1 = min(vtiles, vt0 + a.tiles_per_split);
  if (tid < kBwdRows) {
    const bool ok = n0 + tid < a.N;
    sL[tid] = ok ? a.lse[n0 + tid] : 0.f;
    sG[tid] = ok ? a.g[n0 + tid] : 0.f;
    sLab[tid] = ok ? a.labels[n0 + tid] : -1;
  }
  float acc[4][kPJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kPJ; ++j) acc[i][j] = 0.f;

  const T* h = static_cast<const T*>(a.h);
  for (int vt = vt0; vt < vt1; ++vt) {
    const int v0 = vt * kBV;
    float s[2][4];
    logit_tile<2>(s, sA, sB, h, n0, a.N, a.w, v0, a.V, a.H);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int v = v0 + tx + 16 * j;
        float ds = 0.f;
        if (v < a.V && n0 + r < a.N)
          ds = (expf(s[i][j] - sL[r]) - target_at(a, v, sLab[r])) * sG[r];
        sDS[r * kDS + tx + 16 * j] = ds;  // W is fp32: `ds.astype(w.dtype)` keeps it
      }
    }
    panel_product(acc, sDS, sP, a.w, v0, a.V, c0, a.H);
  }

  float* out = a.part + (long long)split * a.N * a.H;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ry + 8 * i;
    if (n >= a.N) continue;
#pragma unroll
    for (int j = 0; j < kPJ; ++j) {
      const int c = c0 + rx + 32 * j;
      if (c < a.H) out[(long long)n * a.H + c] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// backward: dH on the tensor cores (bf16 hidden)
// ---------------------------------------------------------------------------
//
// The contract's products are fp32 (W is fp32, so `ds.astype(w.dtype)`
// keeps dS in fp32), and a logit error δ is a relative error δ in
// p = exp(s - LSE), so the logits need fp32 accuracy. bf16 tensor cores
// keep it by splitting the fp32 operands without error:
// - W = W_hi + W_mid + W_lo: W_hi = bf16(W) (round to nearest), W_mid the
//   bf16 truncation of W - W_hi, W_lo = W - W_hi - W_mid. Each difference
//   is exact in fp32; W - W_hi has at most 16 significant bits, so the
//   truncation leaves at most 8, which W_lo holds exactly: the three
//   pieces carry W's 24 bits (`split_bf16` in ops/vocab_ce.py is the same
//   split). h is bf16 and every bf16 x bf16 product is exact in fp32, so
//   h·W_hiᵀ + h·W_midᵀ + h·W_loᵀ with fp32 sums is the fp32 logit up to
//   the order of the sums. Only W_hi takes a conversion instruction (a
//   quarter-rate one); the rest are bit operations;
// - dS = dS_hi + dS_lo the same way (fp32 dS in two pieces), and dH +=
//   dS_hi·W_hi + dS_hi·W_mid + dS_lo·W_hi: the dropped terms are about
//   2^-16 of the product, 256 times finer than dH's bf16 rounding.
// The rest (target, smoothing, g, the split-order reduce) stays fp32.
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

constexpr int kTcRows = kBwdRows;     // tokens of a block
constexpr int kTcVocab = 32;          // vocab ids of a logit tile
constexpr int kTcChunk = 64;          // columns (H) of a W chunk
constexpr int kTcKq = kTcChunk / 16;  // k-steps of a chunk: partial logit sums
constexpr int kTcLdc = kTcChunk + 8;  // row stride of a split chunk (bf16)
constexpr int kTcLdp = kPanel + 8;    // row stride of the split panel (bf16)
constexpr int kTcLds = kTcVocab + 8;  // row stride of dS (bf16)
constexpr int kTcLdr = kTcVocab + 8;  // row stride of the partial logits (fp32)
constexpr int kTcWalks = 8;           // vocab walk starts among the token blocks
constexpr size_t kMaxSmem = 232448;   // dynamic shared memory a block may use

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

// This thread's 8 values of the W chunk at rows v0.., columns k0..: row
// tid / 8, columns k0 + 8 (tid % 8) .. + 8, zero past V and H; 16 bytes a
// load when W's rows allow it.
__device__ __forceinline__ void dh_tc_fetch_w(float (&x)[8], const Args& a, int v0, int k0,
                                              bool vec) {
  const int r = threadIdx.x / 8, c = k0 + (threadIdx.x % 8) * 8;
  const bool row_in = v0 + r < a.V;
  const float* src = a.w + (long long)(v0 + r) * a.H + c;
  if (vec) {  // H % 4 == 0: four columns are all below H or all past it
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float4 v = row_in && c + 4 * q < a.H
                           ? __ldg(reinterpret_cast<const float4*>(src + 4 * q))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      x[4 * q] = v.x;
      x[4 * q + 1] = v.y;
      x[4 * q + 2] = v.z;
      x[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = row_in && c + e < a.H ? __ldg(src + e) : 0.f;
  }
}

// This thread's 8 values of a chunk split into the hi, mid and lo rows
// of `pieces` ([3][32][kTcLdc]), and hi and mid into `panel` unless it is
// null.
__device__ __forceinline__ void dh_tc_split(bf16* pieces, bf16* panel, const float (&x)[8]) {
  const int r = threadIdx.x / 8, c = (threadIdx.x % 8) * 8;
  uint4 hi, mid, lo;
  split3(x[0], x[1], hi.x, mid.x, lo.x);
  split3(x[2], x[3], hi.y, mid.y, lo.y);
  split3(x[4], x[5], hi.z, mid.z, lo.z);
  split3(x[6], x[7], hi.w, mid.w, lo.w);
  bf16* d = pieces + r * kTcLdc + c;
  *reinterpret_cast<uint4*>(d) = hi;
  *reinterpret_cast<uint4*>(d + kTcVocab * kTcLdc) = mid;
  *reinterpret_cast<uint4*>(d + 2 * kTcVocab * kTcLdc) = lo;
  if (panel != nullptr) {
    *reinterpret_cast<uint4*>(panel + r * kTcLdp + c) = hi;
    *reinterpret_cast<uint4*>(panel + kTcVocab * kTcLdp + r * kTcLdp + c) = mid;
  }
}

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
    dh_tc_fetch_w(wx[0], a, v_begin + ftile * kTcVocab, 0, w_vec);
    dh_tc_split(sChunk, nullptr, wx[0]);
#pragma unroll
    for (int j = 1; j <= 2; ++j) {
      advance(fch, ftile);
      if (j < steps) dh_tc_fetch_w(wx[j - 1], a, v_begin + ftile * kTcVocab, fch * kTcChunk, w_vec);
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
        dh_tc_split(dst, panel, wx[1]);
        if (more) dh_tc_fetch_w(wx[1], a, fv0, fk0, w_vec);
      } else {
        dh_tc_split(dst, panel, wx[0]);
        if (more) dh_tc_fetch_w(wx[0], a, fv0, fk0, w_vec);
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

// dH = Σ over splits of the partial sums, in split order, in h's type (the
// TPU kernel's `iv == last` finish).
template <typename T>
__global__ void vocab_ce_dh_reduce_kernel(Args a) {
  const long long total = (long long)a.N * a.H;
  T* dh = static_cast<T*>(a.out);
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    float x = 0.f;
    for (int s = 0; s < a.splits; ++s) x += a.part[s * total + e];
    store(dh + e, x);
  }
}

// ---------------------------------------------------------------------------
// backward: dW
// ---------------------------------------------------------------------------

// Grid (ceil(V / 32), panels): dW of 32 vocab rows over all tokens, for one
// 768-column panel of H.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) vocab_ce_bwd_dw_kernel(Args a) {
  __shared__ float sA[kBwdRows * kKS];   // W chunk
  __shared__ float sB[kBV * kKS];        // h chunk
  __shared__ float sDS[kBwdRows * kDS];  // dSᵀ [vocab][token], rounded to T
  __shared__ float sP[kSub * kPanel];    // h rows for the product
  __shared__ float sL[kBV], sG[kBV];
  __shared__ int sLab[kBV];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16, ry = tid / 32, rx = tid % 32;
  const int v0 = blockIdx.x * kBwdRows, c0 = blockIdx.y * kPanel;
  float acc[4][kPJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kPJ; ++j) acc[i][j] = 0.f;

  const T* h = static_cast<const T*>(a.h);
  for (int n0 = 0; n0 < a.N; n0 += kBV) {
    __syncthreads();  // the previous token tile's readers of sL / sG / sLab are done
    if (tid < kBV) {
      const bool ok = n0 + tid < a.N;
      sL[tid] = ok ? a.lse[n0 + tid] : 0.f;
      sG[tid] = ok ? a.g[n0 + tid] : 0.f;
      sLab[tid] = ok ? a.labels[n0 + tid] : -1;
    }
    // the transposed tile: rows are this block's vocab ids, columns tokens
    float s[2][4];
    logit_tile<2>(s, sA, sB, a.w, v0, a.V, h, n0, a.N, a.H);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ty + 16 * i;
      const int v = v0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = tx + 16 * j;
        float ds = 0.f;
        if (v < a.V && n0 + t < a.N) ds = (expf(s[i][j] - sL[t]) - target_at(a, v, sLab[t])) * sG[t];
        sDS[r * kDS + t] = round_to(ds, T());  // `ds.astype(h.dtype)` before dSᵀ · h
      }
    }
    panel_product(acc, sDS, sP, h, n0, a.N, c0, a.H);
  }

  float* dw = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int v = v0 + ry + 8 * i;
    if (v >= a.V) continue;
#pragma unroll
    for (int j = 0; j < kPJ; ++j) {
      const int c = c0 + rx + 32 * j;
      if (c < a.H) dw[(long long)v * a.H + c] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

int panels(int H) { return (H + kPanel - 1) / kPanel; }

int check_shapes(const Args& a) {
  const long long vtiles = (a.V + kBV - 1) / kBV;
  // 4 * splits * N indexes the forward's scratch in int
  if (a.N <= 0 || a.V <= 0 || a.H <= 0 || a.splits <= 0 || a.splits > vtiles ||
      a.splits > 65535 || 4LL * a.splits * a.N > 0x7fffffffLL || panels(a.H) > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

Args make_args(const void* h, const float* w, const int* labels, int N, int V, int H, int splits,
               float eps, float one_minus_eps, float eps_over_v) {
  Args a = {};
  a.h = h; a.w = w; a.labels = labels;
  a.N = N; a.V = V; a.H = H; a.splits = splits;
  const int vtiles = (V + kBV - 1) / kBV;
  a.tiles_per_split = splits > 0 ? (vtiles + splits - 1) / splits : 0;
  a.eps = eps; a.one_minus_eps = one_minus_eps; a.eps_over_v = eps_over_v;
  return a;
}

}  // namespace

extern "C" {

// Each launch runs on `stream` and returns the launch status (cudaSuccess
// == 0); none allocates or synchronizes. h: [N, H] contiguous, bfloat16
// when bf16 else float32; w: [V, H] float32 contiguous; labels: [N] int32
// in [0, V). Label smoothing eps (0: none) comes with its (1 - eps) and
// eps / V rounded once on the host, as the JAX kernel's constants are.
// `splits` cuts the vocab across blocks, 1 <= splits <= ceil(V / 64).

// loss, lse [N] float32 and pred [N] int32; scratch: float32 [4, splits, N]
// and int32 [splits, N].
int vocab_ce_fwd_launch(const void* h, const float* w, const int* labels, float* loss, float* lse,
                        int* pred, float* scratch, int* scratch_ix, int N, int V, int H, int splits,
                        float eps, float one_minus_eps, float eps_over_v, int bf16, void* stream) {
  Args a = make_args(h, w, labels, N, V, H, splits, eps, one_minus_eps, eps_over_v);
  a.loss = loss; a.lse_out = lse; a.pred = pred; a.part = scratch; a.part_ix = scratch_ix;
  const int bad = check_shapes(a);
  if (bad) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kFwdRows - 1) / kFwdRows, splits);
  if (bf16)
    vocab_ce_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(a);
  else
    vocab_ce_fwd_kernel<float><<<grid, kThreads, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  vocab_ce_combine_kernel<<<(N + kThreads - 1) / kThreads, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// dH [N, H] in h's type from the forward's lse [N] and the loss cotangent
// g [N] (both float32); scratch: float32 [splits, N, H]. bf16 hidden runs
// on the tensor cores (vocab_ce_bwd_dh_tc_kernel) while its 32 rows of h
// fit in shared memory (vocab_ce_dh_tc_smem_bytes >= 0, H up to 1216),
// on CUDA cores beyond; float32 hidden on CUDA cores.
int vocab_ce_bwd_dh_launch(const void* h, const float* w, const int* labels, const float* lse,
                           const float* g, void* dh, float* scratch, int N, int V, int H,
                           int splits, float eps, float one_minus_eps, float eps_over_v, int bf16,
                           void* stream) {
  Args a = make_args(h, w, labels, N, V, H, splits, eps, one_minus_eps, eps_over_v);
  a.lse = lse; a.g = g; a.part = scratch; a.out = dh;
  const int bad = check_shapes(a);
  if (bad) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kBwdRows - 1) / kBwdRows, splits, panels(H));
  const long long total = (long long)N * H;
  const int reduce_blocks = (int)((total + kThreads - 1) / kThreads < 65536
                                      ? (total + kThreads - 1) / kThreads : 65536);
  const size_t tc_bytes = dh_tc_smem_bytes(H);
  if (bf16 && tc_bytes <= kMaxSmem) {
    const cudaError_t attr = cudaFuncSetAttribute(
        vocab_ce_bwd_dh_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tc_bytes);
    if (attr != cudaSuccess) return (int)attr;
    vocab_ce_bwd_dh_tc_kernel<<<grid, kThreads, tc_bytes, st>>>(a);
  } else if (bf16) {
    vocab_ce_bwd_dh_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(a);
  } else {
    vocab_ce_bwd_dh_kernel<float><<<grid, kThreads, 0, st>>>(a);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (bf16)
    vocab_ce_dh_reduce_kernel<__nv_bfloat16><<<reduce_blocks, kThreads, 0, st>>>(a);
  else
    vocab_ce_dh_reduce_kernel<float><<<reduce_blocks, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// dW [V, H] float32 from the forward's lse [N] and the loss cotangent g [N].
int vocab_ce_bwd_dw_launch(const void* h, const float* w, const int* labels, const float* lse,
                           const float* g, float* dw, int N, int V, int H, float eps,
                           float one_minus_eps, float eps_over_v, int bf16, void* stream) {
  Args a = make_args(h, w, labels, N, V, H, 1, eps, one_minus_eps, eps_over_v);
  a.lse = lse; a.g = g; a.out = dw;
  const int bad = check_shapes(a);
  if (bad) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((V + kBwdRows - 1) / kBwdRows, panels(H));
  if (bf16)
    vocab_ce_bwd_dw_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(a);
  else
    vocab_ce_bwd_dw_kernel<float><<<grid, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// Dynamic shared memory per block of vocab_ce_bwd_dh_tc_kernel at depth
// H, or -1 where it does not fit a block (bf16 dH then runs on CUDA cores).
long long vocab_ce_dh_tc_smem_bytes(int H) {
  const size_t bytes = dh_tc_smem_bytes(H);
  return bytes <= kMaxSmem ? (long long)bytes : -1;
}

const char* vocab_ce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
