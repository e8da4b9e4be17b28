// Fused LM head + softmax cross-entropy for Hopper (sm_90a): the forward,
// dH and dW kernels of a per-token cross-entropy over logits = H · Wᵀ that
// never writes the [N, V] logit matrix to device memory.
//
// Replaces the TPU kernels of the JAX package's `ops/pallas_vocab_ce.py`:
// - bf16 hidden: the split of W and vocab_ce_fwd_wgmma_kernel a vocab
//   chunk (vocab_ce_fwd.cuh), then vocab_ce_combine_kernel; fp32 hidden:
//   vocab_ce_fwd_kernel (+ vocab_ce_combine_kernel) <- `_fwd_kernel`,
//   reached through `_fused_ce_fwd_call`
// - bf16 hidden: one route for dH and dW together (vocab_ce_bwd.cuh: the
//   split of W, dS on `wgmma`, the dH and dW products on `wgmma`, the dH
//   cast) <- `_dh_kernel` and `_dw_kernel`, reached through
//   `_fused_ce_bwd_call`; fp32 hidden: vocab_ce_bwd_dh_kernel (+
//   vocab_ce_dh_reduce_kernel) <- `_dh_kernel` and vocab_ce_bwd_dw_kernel
//   <- `_dw_kernel`
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
// logits; the backward as much again for each product) against V * H * 4
// bytes of W read once, so at the GPT-2 shape (N 4096, V 50257, H 768) the
// floor is the flops over the card's peak. With bf16 hidden every product
// runs on the bf16 tensor cores (989 TFLOP/s) on `wgmma` at every H, with
// W split into bf16 pieces that keep the fp32 products (vocab_ce_fwd.cuh,
// vocab_ce_bwd.cuh, hopper_gemm.cuh note their bound and design). fp32
// hidden runs in fp32 on CUDA cores (67 TFLOP/s; TF32 would not keep the
// fp32 contract), in the kernels of this file.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

}  // namespace

#include "vocab_ce_bwd.cuh"
#include "vocab_ce_fwd.cuh"

namespace {

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

// The dH reduce over a.splits partials, in split order, into a.out.
template <typename T>
int vocab_ce_dh_reduce(const Args& a, cudaStream_t st) {
  const long long total = (long long)a.N * a.H;
  const long long blocks = (total + kThreads - 1) / kThreads;
  vocab_ce_dh_reduce_kernel<T><<<(int)(blocks < 65536 ? blocks : 65536), kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each launch runs on `stream` and returns the launch status (cudaSuccess
// == 0); none allocates or synchronizes. h: [N, H] contiguous, float32 or
// bfloat16 as each launch says; w: [V, H] float32 contiguous; labels: [N]
// int32 in [0, V). Label smoothing eps (0: none) comes with its (1 - eps)
// and eps / V rounded once on the host, as the JAX kernel's constants are.
// The CUDA-core launches' `splits` cuts the vocab across blocks,
// 1 <= splits <= ceil(V / 64).

// loss, lse [N] float32 and pred [N] int32 of float32 hidden, on CUDA
// cores (bf16 runs the route below); scratch: float32 [4, splits, N] and
// int32 [splits, N].
int vocab_ce_fwd_launch(const float* h, const float* w, const int* labels, float* loss, float* lse,
                        int* pred, float* scratch, int* scratch_ix, int N, int V, int H, int splits,
                        float eps, float one_minus_eps, float eps_over_v, void* stream) {
  Args a = make_args(h, w, labels, N, V, H, splits, eps, one_minus_eps, eps_over_v);
  a.loss = loss; a.lse_out = lse; a.pred = pred; a.part = scratch; a.part_ix = scratch_ix;
  const int bad = check_shapes(a);
  if (bad) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kFwdRows - 1) / kFwdRows, splits);
  vocab_ce_fwd_kernel<float><<<grid, kThreads, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  vocab_ce_combine_kernel<<<(N + kThreads - 1) / kThreads, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// The bf16-hidden forward (vocab_ce_fwd.cuh), launched chunk by chunk by
// ops/vocab_ce.py:fused_ce_fwd; its operands follow TMA's rule as the
// backward's below (H % 8 == 0, 16-byte aligned bases).

// 1. W rows v0 .. v0 + rows split into hi, mid, lo [rows, H].
int vocab_ce_fwd_split_w_launch(const float* w, int H, int v0, int rows, void* hi, void* mid,
                                void* lo, void* stream) {
  if (rows <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((rows + kTT - 1) / kTT, (H + kTT - 1) / kTT), block(kTT, 8);
  vocab_ce_fwd_split_w_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      w, H, v0, rows, static_cast<bf16*>(hi), static_cast<bf16*>(mid), static_cast<bf16*>(lo));
  return (int)cudaGetLastError();
}

// 2. The statistics of tokens [0, N) over each 128-id vocab tile of chunk
// ids v0 .. v0 + rows (v0 a multiple of 128) from h [N, H] and the chunk's
// pieces [rows, H], into part [4, ceil(V / 128), N] and part_ix
// [ceil(V / 128), N] at the chunk's tiles.
int vocab_ce_fwd_wgmma_launch(const void* h, const void* hi, const void* mid, const void* lo,
                              const int* labels, float* part, int* part_ix, int N, int H, int V,
                              int v0, int rows, void* stream) {
  const int tiles = hopper::cdiv(V, hopper::kBN);
  // the combine indexes 4 x tiles x N in int
  if (V <= 0 || v0 % hopper::kBN != 0 || v0 + rows > V || 4LL * tiles * N > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  DsMaps maps;
  int err = hopper::make_operand_map(&maps.a[0], h, N, H, H);
  const void* pieces[3] = {hi, mid, lo};
  for (int p = 0; p < 3 && !err; ++p) err = hopper::make_operand_map(&maps.b[p], pieces[p], rows, H, H);
  if (err) return err;
  const hopper::GemmShape sh = {N, rows, H, 1};
  const FwdEpilogue epi = {labels, part, part_ix, N, V, v0, tiles};
  return hopper::launch_gemm(vocab_ce_fwd_wgmma_kernel, maps, sh, epi,
                             static_cast<cudaStream_t>(stream));
}

// 3. loss, lse and pred [N] from the partials of `splits` vocab ranges,
// part [4, splits, N] and part_ix [splits, N], merged in range order.
int vocab_ce_fwd_combine_launch(const float* part, const int* part_ix, float* loss, float* lse,
                                int* pred, int N, int V, int splits, float eps,
                                float one_minus_eps, float eps_over_v, void* stream) {
  if (N <= 0 || V <= 0 || splits <= 0 || 4LL * splits * N > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Args a = make_args(nullptr, nullptr, nullptr, N, V, 0, splits, eps, one_minus_eps, eps_over_v);
  a.part = const_cast<float*>(part); a.part_ix = const_cast<int*>(part_ix);
  a.loss = loss; a.lse_out = lse; a.pred = pred;
  vocab_ce_combine_kernel<<<(N + kThreads - 1) / kThreads, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// dH [N, H] float32 from the forward's lse [N] and the loss cotangent
// g [N] (both float32), float32 hidden (bf16 runs the route below);
// scratch: float32 [splits, N, H].
int vocab_ce_bwd_dh_launch(const float* h, const float* w, const int* labels, const float* lse,
                           const float* g, float* dh, float* scratch, int N, int V, int H,
                           int splits, float eps, float one_minus_eps, float eps_over_v,
                           void* stream) {
  Args a = make_args(h, w, labels, N, V, H, splits, eps, one_minus_eps, eps_over_v);
  a.lse = lse; a.g = g; a.part = scratch; a.out = dh;
  const int bad = check_shapes(a);
  if (bad) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kBwdRows - 1) / kBwdRows, splits, panels(H));
  vocab_ce_bwd_dh_kernel<float><<<grid, kThreads, 0, st>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return vocab_ce_dh_reduce<float>(a, st);
}

// dW [V, H] float32 from the forward's lse [N] and the loss cotangent g
// [N], float32 hidden (bf16 runs the route below).
int vocab_ce_bwd_dw_launch(const float* h, const float* w, const int* labels, const float* lse,
                           const float* g, float* dw, int N, int V, int H, float eps,
                           float one_minus_eps, float eps_over_v, void* stream) {
  Args a = make_args(h, w, labels, N, V, H, 1, eps, one_minus_eps, eps_over_v);
  a.lse = lse; a.g = g; a.out = dw;
  const int bad = check_shapes(a);
  if (bad) return bad;
  const dim3 grid((V + kBwdRows - 1) / kBwdRows, panels(H));
  vocab_ce_bwd_dw_kernel<float><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// The bf16-hidden backward (vocab_ce_bwd.cuh), one launch a step of a
// vocab chunk; ops/vocab_ce.py:fused_ce_bwd runs them chunk by chunk. Every
// bf16 operand is K-major with a row stride that is a multiple of 8
// elements and a 16-byte aligned base (TMA's rule): H % 8 == 0.

// 1. W rows v0 .. v0 + rows split into hi, mid, lo [rows, H] and, unless
// hi_t is null, hiᵀ and midᵀ [H, ld_t].
int vocab_ce_split_w_launch(const float* w, int H, int v0, int rows, void* hi, void* mid,
                            void* lo, void* hi_t, void* mid_t, int ld_t, void* stream) {
  if (rows <= 0 || H <= 0 || (hi_t != nullptr && ld_t < rows)) return (int)cudaErrorInvalidValue;
  const dim3 grid((rows + kTT - 1) / kTT, (H + kTT - 1) / kTT), block(kTT, 8);
  vocab_ce_split_w_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      w, H, v0, rows, static_cast<bf16*>(hi), static_cast<bf16*>(mid), static_cast<bf16*>(lo),
      static_cast<bf16*>(hi_t), static_cast<bf16*>(mid_t), ld_t);
  return (int)cudaGetLastError();
}

// hᵀ [H, ld_t] of h [N, H].
int vocab_ce_transpose_h_launch(const void* h, int N, int H, void* h_t, int ld_t, void* stream) {
  if (N <= 0 || H <= 0 || ld_t < N) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kTT - 1) / kTT, (H + kTT - 1) / kTT), block(kTT, 8);
  vocab_ce_transpose_h_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(h), N, H, static_cast<bf16*>(h_t), ld_t);
  return (int)cudaGetLastError();
}

// 2. dS of tokens [0, N) x chunk ids v0 .. v0 + rows from h [N, H] and the
// chunk's pieces [rows, H]: dS_hi, dS_lo [N, ld] unless ds_hi is null,
// dS_hiᵀ [rows, ld_t] unless ds_hi_t is null.
int vocab_ce_ds_launch(const void* h, const void* hi, const void* mid, const void* lo,
                       const float* lse, const float* g, const int* labels, void* ds_hi,
                       void* ds_lo, void* ds_hi_t, int N, int H, int V, int v0, int rows, int ld,
                       int ld_t, float eps, float one_minus_eps, float eps_over_v, void* stream) {
  DsMaps maps;
  int err = hopper::make_operand_map(&maps.a[0], h, N, H, H);
  const void* pieces[3] = {hi, mid, lo};
  for (int p = 0; p < 3 && !err; ++p) err = hopper::make_operand_map(&maps.b[p], pieces[p], rows, H, H);
  if (err) return err;
  const hopper::GemmShape sh = {N, rows, H, 1};
  const DsEpilogue epi = {lse, g, labels, static_cast<bf16*>(ds_hi), static_cast<bf16*>(ds_lo),
                          static_cast<bf16*>(ds_hi_t), N, V, v0, ld, ld_t,
                          eps, one_minus_eps, eps_over_v};
  return hopper::launch_gemm(vocab_ce_ds_wgmma_kernel, maps, sh, epi,
                             static_cast<cudaStream_t>(stream));
}

// 3. dH partials part [splits, N, H] (stored when `first`, else added to)
// += dS_hi·W_hi + dS_hi·W_mid + dS_lo·W_hi over the chunk's rows ids:
// dS_hi, dS_lo [N, ld], hiᵀ and midᵀ [H, ld_t].
int vocab_ce_dh_product_launch(const void* ds_hi, const void* ds_lo, const void* hi_t,
                               const void* mid_t, float* part, int N, int H, int rows, int ld,
                               int ld_t, int splits, int first, void* stream) {
  if (splits <= 0) return (int)cudaErrorInvalidValue;
  DhMaps maps;
  int err = hopper::make_operand_map(&maps.a[0], ds_hi, N, rows, ld);
  if (!err) err = hopper::make_operand_map(&maps.a[1], ds_lo, N, rows, ld);
  if (!err) err = hopper::make_operand_map(&maps.b[0], hi_t, H, rows, ld_t);
  if (!err) err = hopper::make_operand_map(&maps.b[1], mid_t, H, rows, ld_t);
  if (err) return err;
  const hopper::GemmShape sh = {N, H, rows, splits};
  const DhEpilogue epi = {part, N, H, first};
  return hopper::launch_gemm(vocab_ce_dh_wgmma_kernel, maps, sh, epi,
                             static_cast<cudaStream_t>(stream));
}

// 4. dW rows of the chunk, out [rows, H] fp32 (row stride H), = dS_hiᵀ·h
// from dS_hiᵀ [rows, ld_t] and hᵀ [H, ld_t] (K = N).
int vocab_ce_dw_product_launch(const void* ds_hi_t, const void* h_t, float* out, int N, int H,
                               int rows, int ld_t, void* stream) {
  DwMaps maps;
  int err = hopper::make_operand_map(&maps.a[0], ds_hi_t, rows, N, ld_t);
  if (!err) err = hopper::make_operand_map(&maps.b[0], h_t, H, N, ld_t);
  if (err) return err;
  const hopper::GemmShape sh = {rows, H, N, 1};
  const DwEpilogue epi = {out, rows, H};
  return hopper::launch_gemm(vocab_ce_dw_wgmma_kernel, maps, sh, epi,
                             static_cast<cudaStream_t>(stream));
}

// dH [N, H] bf16: the splits' partials summed in split order and cast.
int vocab_ce_dh_cast_launch(const float* part, void* dh, int N, int H, int splits, void* stream) {
  Args a = {};
  a.part = const_cast<float*>(part); a.out = dh; a.N = N; a.H = H; a.splits = splits;
  return vocab_ce_dh_reduce<__nv_bfloat16>(a, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory per block of each `wgmma` kernel of the forward
// and the backward (the stage ring, its alignment and its barriers),
// whatever H.
long long vocab_ce_wgmma_smem_bytes() { return hopper::kSmemBytes; }

const char* vocab_ce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
