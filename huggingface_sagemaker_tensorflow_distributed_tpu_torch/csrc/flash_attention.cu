// Flash attention for Hopper (sm_90a): the forward, dQ and dK/dV/dmask
// kernels of a blocked online-softmax attention that never writes the
// [S, S] score matrix to device memory.
//
// Replaces the TPU kernels of the JAX package's `ops/pallas_attention.py`:
// - flash_fwd_kernel, flash_fwd_tc_kernel <- `_fwd_kernel`, reached through
//   `_flash_fwd_call`
// - flash_bwd_dq_kernel, flash_bwd_dq_tc_kernel <- `_dq_kernel`, reached
//   through `_flash_bwd_call`
// - flash_bwd_dkv_kernel, flash_bwd_dkv_tc_kernel <- `_dkv_kernel`, reached
//   through `_flash_bwd_call`
// with the same contract: q, k, v [B, H, S, D] in fp32 or bf16; an optional
// additive fp32 key mask [B, S_k]; fp32 logits, running max/sum and
// log-sum-exp; probabilities (and dS) rounded to the input type before
// the products that take them; the output in the input type; `causal`
// and `window` with the TPU kernel's tile-skip rule (`_tile_runs`) and its
// -1e30 in-tile mask (`_causal_mask_block`); rows whose running sum is 0
// divide by 1. LSE is [B, H, S_q] fp32 (the TPU's 128-lane broadcast is a
// layout of that chip and is not carried over). Ragged S (not a multiple
// of the tile) is masked here rather than sent to the plain path.
//
// Bound on an H100: in fp32, operations. At BERT-base (S = 512, D = 64)
// the forward does 4 * S * D flops per query row against about 4 * D
// elements of input per row, so the floor is the flops over the CUDA
// cores' peak; in bf16 the tensor cores bring the operations below the
// bytes (see flash_attention_tc.cuh). Two families:
// - bf16: `flash_fwd_tc_kernel`, `flash_bwd_dq_tc_kernel` and
//   `flash_bwd_dkv_tc_kernel` (flash_attention_tc.cuh) run their products
//   on the tensor cores (mma.sync m16n8k16, bf16 in, fp32 sums; 989
//   TFLOP/s peak), with bf16 tiles double-buffered by cp.async;
// - fp32: the kernels below run the products in fp32 on CUDA cores (67
//   TFLOP/s peak). fp32 stays there because TF32 tensor cores would not
//   hold fp32's 1e-4 parity.
//
// What the CUDA-core design does:
// - one block of 256 threads per (b, h, 64-row tile); the TPU kernel's
//   sequential innermost grid axis becomes a loop inside the block, and
//   its `pl.when(first)` / `pl.when(last)` scratch init and finish become
//   the loop's prologue and epilogue. The running max/sum and the output
//   (or gradient) accumulator live in registers across the loop;
// - each thread owns a 4 x 4 patch of the 64 x 64 score tile (rows
//   ty + 16 i, columns tx + 16 j) and the matching rows of the
//   accumulator, so a row's max and sum reduce over 16 lanes of one warp
//   with shuffles and never touch shared memory;
// - tiles are staged in shared memory as fp32 with a row stride of D + 1
//   (64 + 1 for score tiles), so the column-strided reads of the products
//   hit 32 different banks; about 67-166 KB per block, so dynamic shared
//   memory above the 48 KB static limit;
// - tiles that the causal/window rule skips are never loaded;
// - at D 256 (Gemma) four 64-row fp32 tiles take 263 KB, over the 227 KB
//   a block may hold: the backward kernels keep three (`kShareTiles`).
//   dQ stages V, takes dP, then stages K in its place for S and dS·K;
//   dK/dV stages Q for Sᵀ, dO in its place for dPᵀ and dV, then Q again
//   for dK, with Pᵀ and dSᵀ in turn in one score tile (215 KB a block).
//   Every sum keeps its order; Q is read twice.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;          // query rows and key rows per tile
constexpr int kTS = kTile + 1;     // row stride of a score tile in shared memory
constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value

// max / sum over the 16 lanes of a half warp (the lanes sharing ty)
__device__ __forceinline__ float row_max(float x) {
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Element strides (batch, head, row) of a [B, H, S, D] tensor whose last
// dimension is contiguous.
struct Strides {
  long long b, h, s;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* mask;    // [B, Sk] additive, or null
  const void* o;        // forward output (backward kernels)
  const void* dout;     // gradient of the output (backward kernels)
  const float* lse;     // [B, H, Sq] (backward kernels)
  void* out;            // forward: O; dq kernel: dQ; dkv kernel: dK
  void* out2;           // dkv kernel: dV
  float* lse_out;       // forward: LSE or null; dkv kernel: dmask [B, H, Sk] or null
  Strides sq, sk, sv, so, sdo, sout, sout2;
  int H, Sq, Sk;
  float scale;
  int causal, window;   // window <= 0: none
};

// The TPU kernel's `_tile_runs`: whether the (iq, ik) tile can hold a
// key some query of the tile may see.
__device__ __forceinline__ bool tile_runs(const Args& a, int iq, int ik) {
  if (!a.causal) return true;
  bool run = ik * kTile <= iq * kTile + kTile - 1;
  if (a.window > 0) run = run && ((ik + 1) * kTile - 1 >= iq * kTile - a.window + 1);
  return run;
}

// The TPU kernel's `_causal_mask_block` for one (query, key) position.
__device__ __forceinline__ float causal_add(const Args& a, int qpos, int kpos) {
  if (!a.causal) return 0.f;
  bool keep = kpos <= qpos;
  if (a.window > 0) keep = keep && (kpos > qpos - a.window);
  return keep ? 0.f : kNegInf;
}

// rows [row0, row0 + 64) of a head's [S, D] slab -> fp32 shared memory
// with row stride D + 1; rows at or past `rows` are zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* base, long long row_stride,
                                          int row0, int rows) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx % D;
    float x = 0.f;
    if (row0 + r < rows) x = base[(long long)(row0 + r) * row_stride + d];
    dst[r * (D + 1) + d] = x;
  }
}

template <typename T>
__device__ __forceinline__ const T* head_ptr(const void* p, const Strides& s, int b, int h) {
  return static_cast<const T*>(p) + b * s.b + h * s.h;
}

template <typename T>
__device__ __forceinline__ T* head_ptr_mut(void* p, const Strides& s, int b, int h) {
  return static_cast<T*>(p) + b * s.b + h * s.h;
}

// Δ_r = Σ_d dO[r, d] · O[r, d] for the 64 rows of a query tile: one warp
// per row, lanes across D.
template <int D>
__device__ __forceinline__ void tile_delta(float* delta, const float* o, const float* dout,
                                           const Strides& so, const Strides& sdo, int q0,
                                           int Sq) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < kTile; r += kThreads / 32) {
    float acc = 0.f;
    if (q0 + r < Sq) {
      const float* orow = o + (long long)(q0 + r) * so.s;
      const float* grow = dout + (long long)(q0 + r) * sdo.s;
      for (int d = lane; d < D; d += 32) acc += grow[d] * orow[d];
    }
    acc = warp_sum(acc);
    if (lane == 0) delta[r] = acc;
  }
}

// acc[i][j] += Σ_d A[ty + 16 i][d] · B[tx + 16 j][d] over two tiles in
// shared memory (row stride D + 1), d in order.
template <int D>
__device__ __forceinline__ void tile_products(float (&acc)[4][4], const float* A, const float* B,
                                              int ty, int tx) {
  constexpr int DS = D + 1;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = A[(ty + 16 * i) * DS + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = B[(tx + 16 * j) * DS + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
  }
}

// Whether the backward kernels hold one D-wide tile fewer (and load a
// tile again) to fit 227 KB of shared memory: at D 256 four fp32 tiles
// of 64 rows take 263 KB.
template <int D>
constexpr bool kShareTiles = D > 128;

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t fwd_smem_floats() {
  return 3 * (size_t)kTile * (D + 1) + (size_t)kTile * kTS + kTile;
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  constexpr int DS = D + 1;
  constexpr int NJ = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                  // [64][D + 1]
  float* sK = sQ + kTile * DS;       // [64][D + 1]
  float* sV = sK + kTile * DS;       // [64][D + 1]
  float* sP = sV + kTile * DS;       // [64][65]
  float* sM = sP + kTile * kTS;      // [64] mask of the key tile

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = iq * kTile;
  const float* q = head_ptr<float>(a.q, a.sq, b, h);
  const float* k = head_ptr<float>(a.k, a.sk, b, h);
  const float* v = head_ptr<float>(a.v, a.sv, b, h);

  load_tile<D>(sQ, q, a.sq.s, q0, a.Sq);
  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int nk = (a.Sk + kTile - 1) / kTile;
  for (int ik = 0; ik < nk; ++ik) {
    if (!tile_runs(a, iq, ik)) continue;
    const int k0 = ik * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(sK, k, a.sk.s, k0, a.Sk);
    load_tile<D>(sV, v, a.sv.s, k0, a.Sk);
    if (tid < kTile) sM[tid] = (a.mask && k0 + tid < a.Sk) ? a.mask[(long long)b * a.Sk + k0 + tid] : 0.f;
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * DS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * DS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * a.scale + sM[tx + 16 * j];
        x += causal_add(a, qpos, kpos);
        s[i][j] = x;
        if (kpos < a.Sk) mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const float p = kpos < a.Sk ? expf(s[i][j] - m_new) : 0.f;
        psum += p;
        sP[(ty + 16 * i) * kTS + tx + 16 * j] = p;
      }
      l[i] = alpha * l[i] + row_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float pv[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 16 * i) * kTS + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = sV[kk * DS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] += pv[i] * vv[j];
    }
  }

  float* out = head_ptr_mut<float>(a.out, a.sout, b, h);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= a.Sq) continue;
    const float safe_l = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < NJ; ++j) out[(long long)r * a.sout.s + tx + 16 * j] = acc[i][j] / safe_l;
    if (a.lse_out && tx == 0)
      a.lse_out[((long long)b * a.H + h) * a.Sq + r] = m[i] + logf(safe_l);
  }
}

// ---------------------------------------------------------------------------
// backward: dQ
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t dq_smem_floats() {
  return (kShareTiles<D> ? 3 : 4) * (size_t)kTile * (D + 1) + (size_t)kTile * kTS + 3 * kTile;
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Args a) {
  constexpr int DS = D + 1;
  constexpr int NJ = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;                  // [64][D + 1]
  float* sDO = sQ + kTile * DS;      // [64][D + 1]
  float* sK = sDO + kTile * DS;      // [64][D + 1]
  // at D 256 V and then K pass through one buffer
  float* sV = kShareTiles<D> ? sK : sK + kTile * DS;  // [64][D + 1]
  float* sDS = sV + kTile * DS;      // [64][65]
  float* sM = sDS + kTile * kTS;     // [64] mask of the key tile
  float* sL = sM + kTile;            // [64] LSE of the query rows
  float* sD = sL + kTile;            // [64] Δ of the query rows

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = iq * kTile;
  const float* q = head_ptr<float>(a.q, a.sq, b, h);
  const float* k = head_ptr<float>(a.k, a.sk, b, h);
  const float* v = head_ptr<float>(a.v, a.sv, b, h);
  const float* o = head_ptr<float>(a.o, a.so, b, h);
  const float* dout = head_ptr<float>(a.dout, a.sdo, b, h);
  const float* lse = a.lse + ((long long)b * a.H + h) * a.Sq;

  // prologue (the TPU kernel's `ik == 0` init): Q, dO, LSE and Δ once per
  // query tile
  load_tile<D>(sQ, q, a.sq.s, q0, a.Sq);
  load_tile<D>(sDO, dout, a.sdo.s, q0, a.Sq);
  if (tid < kTile) sL[tid] = q0 + tid < a.Sq ? lse[q0 + tid] : 0.f;
  tile_delta<D>(sD, o, dout, a.so, a.sdo, q0, a.Sq);
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int nk = (a.Sk + kTile - 1) / kTile;
  for (int ik = 0; ik < nk; ++ik) {
    if (!tile_runs(a, iq, ik)) continue;
    const int k0 = ik * kTile;
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    __syncthreads();
    if constexpr (kShareTiles<D>) {
      // dP = dO Vᵀ with V in the buffer, then K in its place for S = Q Kᵀ
      // (and for dS K below)
      load_tile<D>(sV, v, a.sv.s, k0, a.Sk);
      if (tid < kTile) sM[tid] = (a.mask && k0 + tid < a.Sk) ? a.mask[(long long)b * a.Sk + k0 + tid] : 0.f;
      __syncthreads();
      tile_products<D>(dp, sDO, sV, ty, tx);
      __syncthreads();
      load_tile<D>(sK, k, a.sk.s, k0, a.Sk);
      __syncthreads();
      tile_products<D>(s, sQ, sK, ty, tx);
    } else {
      load_tile<D>(sK, k, a.sk.s, k0, a.Sk);
      load_tile<D>(sV, v, a.sv.s, k0, a.Sk);
      if (tid < kTile) sM[tid] = (a.mask && k0 + tid < a.Sk) ? a.mask[(long long)b * a.Sk + k0 + tid] : 0.f;
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qv[i] = sQ[(ty + 16 * i) * DS + d];
          gv[i] = sDO[(ty + 16 * i) * DS + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          kv[j] = sK[(tx + 16 * j) * DS + d];
          vv[j] = sV[(tx + 16 * j) * DS + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] += qv[i] * kv[j];
            dp[i][j] += gv[i] * vv[j];
          }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = ty + 16 * i;
      const int qpos = q0 + rl;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * a.scale + sM[tx + 16 * j];
        x += causal_add(a, qpos, kpos);
        const float p = (qpos < a.Sq && kpos < a.Sk) ? expf(x - sL[rl]) : 0.f;
        const float ds = p * (dp[i][j] - sD[rl]);
        sDS[rl * kTS + tx + 16 * j] = ds;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float dv[4], kv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dv[i] = sDS[(ty + 16 * i) * kTS + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kv[j] = sK[kk * DS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] += dv[i] * kv[j];
    }
  }

  // epilogue (the TPU kernel's `ik == last` finish)
  float* dq = head_ptr_mut<float>(a.out, a.sout, b, h);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= a.Sq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq[(long long)r * a.sout.s + tx + 16 * j] = acc[i][j] * a.scale;
  }
}

// ---------------------------------------------------------------------------
// backward: dK, dV and the mask's cotangent
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t dkv_smem_floats() {
  return kShareTiles<D> ? 3 * (size_t)kTile * (D + 1) + (size_t)kTile * kTS + 3 * kTile
                        : 4 * (size_t)kTile * (D + 1) + 2 * (size_t)kTile * kTS + 3 * kTile;
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Args a) {
  constexpr int DS = D + 1;
  constexpr int NJ = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;                  // [64][D + 1] key rows of this block
  float* sV = sK + kTile * DS;       // [64][D + 1]
  float* sQ = sV + kTile * DS;       // [64][D + 1] query rows of the current tile
  // at D 256 Q, dO and Q again pass through one buffer, and Pᵀ then dSᵀ
  // through one score tile
  float* sDO = kShareTiles<D> ? sQ : sQ + kTile * DS;  // [64][D + 1]
  float* sPt = sDO + kTile * DS;     // [64 keys][65] P^T rounded to T
  float* sDSt = kShareTiles<D> ? sPt : sPt + kTile * kTS;  // [64 keys][65] dS^T rounded to T
  float* sM = sDSt + kTile * kTS;    // [64] mask of this key tile
  float* sL = sM + kTile;            // [64] LSE of the query rows
  float* sD = sL + kTile;            // [64] Δ of the query rows

  const int ik = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int k0 = ik * kTile;
  const float* q = head_ptr<float>(a.q, a.sq, b, h);
  const float* k = head_ptr<float>(a.k, a.sk, b, h);
  const float* v = head_ptr<float>(a.v, a.sv, b, h);
  const float* o = head_ptr<float>(a.o, a.so, b, h);
  const float* dout = head_ptr<float>(a.dout, a.sdo, b, h);
  const float* lse = a.lse + ((long long)b * a.H + h) * a.Sq;

  // prologue (the TPU kernel's `iq == 0` init)
  load_tile<D>(sK, k, a.sk.s, k0, a.Sk);
  load_tile<D>(sV, v, a.sv.s, k0, a.Sk);
  if (tid < kTile) sM[tid] = (a.mask && k0 + tid < a.Sk) ? a.mask[(long long)b * a.Sk + k0 + tid] : 0.f;
  float dk[4][NJ], dv[4][NJ], dm[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dm[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.f;
  }

  const int nq = (a.Sq + kTile - 1) / kTile;
  if constexpr (kShareTiles<D>) {
    for (int iq = 0; iq < nq; ++iq) {
      if (!tile_runs(a, iq, ik)) continue;
      const int q0 = iq * kTile;
      __syncthreads();
      load_tile<D>(sQ, q, a.sq.s, q0, a.Sq);
      if (tid < kTile) sL[tid] = q0 + tid < a.Sq ? lse[q0 + tid] : 0.f;
      tile_delta<D>(sD, o, dout, a.so, a.sdo, q0, a.Sq);
      __syncthreads();
      // Sᵀ = K Qᵀ (rows: this block's keys ty + 16 i; columns: the tile's
      // queries tx + 16 j), then dO in Q's place for dPᵀ = V dOᵀ
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
      tile_products<D>(st, sK, sQ, ty, tx);
      __syncthreads();
      load_tile<D>(sDO, dout, a.sdo.s, q0, a.Sq);
      __syncthreads();
      tile_products<D>(dpt, sV, sDO, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kl = ty + 16 * i;
        const int kpos = k0 + kl;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ql = tx + 16 * j;
          const int qpos = q0 + ql;
          float x = st[i][j] * a.scale + sM[kl];
          x += causal_add(a, qpos, kpos);
          const float p = (qpos < a.Sq && kpos < a.Sk) ? expf(x - sL[ql]) : 0.f;
          const float ds = p * (dpt[i][j] - sD[ql]);
          dm[i] += ds;
          dpt[i][j] = ds;
          sPt[kl * kTS + ql] = p;
        }
      }
      __syncthreads();
      // dV += Pᵀ dO
#pragma unroll 4
      for (int qq = 0; qq < kTile; ++qq) {
        float pt[4], gv[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) pt[i] = sPt[(ty + 16 * i) * kTS + qq];
#pragma unroll
        for (int j = 0; j < NJ; ++j) gv[j] = sDO[qq * DS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) dv[i][j] += pt[i] * gv[j];
      }
      __syncthreads();
      // dSᵀ in Pᵀ's place and Q again in dO's, for dK += dSᵀ Q
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sDSt[(ty + 16 * i) * kTS + tx + 16 * j] = dpt[i][j];
      load_tile<D>(sQ, q, a.sq.s, q0, a.Sq);
      __syncthreads();
#pragma unroll 4
      for (int qq = 0; qq < kTile; ++qq) {
        float dst[4], qv[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) dst[i] = sDSt[(ty + 16 * i) * kTS + qq];
#pragma unroll
        for (int j = 0; j < NJ; ++j) qv[j] = sQ[qq * DS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) dk[i][j] += dst[i] * qv[j];
      }
    }
  } else {
    for (int iq = 0; iq < nq; ++iq) {
      if (!tile_runs(a, iq, ik)) continue;
      const int q0 = iq * kTile;
      __syncthreads();
      load_tile<D>(sQ, q, a.sq.s, q0, a.Sq);
      load_tile<D>(sDO, dout, a.sdo.s, q0, a.Sq);
      if (tid < kTile) sL[tid] = q0 + tid < a.Sq ? lse[q0 + tid] : 0.f;
      // Δ recomputed per (key tile, query tile) from dO and O, as the TPU
      // kernel does
      tile_delta<D>(sD, o, dout, a.so, a.sdo, q0, a.Sq);
      __syncthreads();

      // transposed tile: rows are this block's keys (ty + 16 i), columns
      // the tile's queries (tx + 16 j)
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[4], vv[4], qv[4], gv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = sK[(ty + 16 * i) * DS + d];
          vv[i] = sV[(ty + 16 * i) * DS + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = sQ[(tx + 16 * j) * DS + d];
          gv[j] = sDO[(tx + 16 * j) * DS + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            st[i][j] += kv[i] * qv[j];
            dpt[i][j] += vv[i] * gv[j];
          }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kl = ty + 16 * i;
        const int kpos = k0 + kl;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ql = tx + 16 * j;
          const int qpos = q0 + ql;
          float x = st[i][j] * a.scale + sM[kl];
          x += causal_add(a, qpos, kpos);
          const float p = (qpos < a.Sq && kpos < a.Sk) ? expf(x - sL[ql]) : 0.f;
          const float ds = p * (dpt[i][j] - sD[ql]);
          dm[i] += ds;
          sPt[kl * kTS + ql] = p;
          sDSt[kl * kTS + ql] = ds;
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int qq = 0; qq < kTile; ++qq) {
        float pt[4], dst[4], gv[NJ], qv[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pt[i] = sPt[(ty + 16 * i) * kTS + qq];
          dst[i] = sDSt[(ty + 16 * i) * kTS + qq];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          gv[j] = sDO[qq * DS + tx + 16 * j];
          qv[j] = sQ[qq * DS + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            dv[i][j] += pt[i] * gv[j];
            dk[i][j] += dst[i] * qv[j];
          }
      }
    }
  }

  // epilogue (the TPU kernel's `iq == last` finish)
  float* dkp = head_ptr_mut<float>(a.out, a.sout, b, h);
  float* dvp = head_ptr_mut<float>(a.out2, a.sout2, b, h);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty + 16 * i;
    const float dmr = row_sum(dm[i]);  // every lane of the half warp joins
    if (r >= a.Sk) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dkp[(long long)r * a.sout.s + tx + 16 * j] = dk[i][j] * a.scale;
      dvp[(long long)r * a.sout2.s + tx + 16 * j] = dv[i][j];
    }
    if (a.lse_out && tx == 0) a.lse_out[((long long)b * a.H + h) * a.Sk + r] = dmr;
  }
}

}  // namespace

#include "flash_attention_tc.cuh"

namespace {

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, size_t bytes, int tiles, int H, int B,
                   const Args& a, cudaStream_t stream) {
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(tiles, H, B), threads, bytes, stream>>>(a);
  return cudaGetLastError();
}

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

// Dynamic shared memory per block of the kernel that `dispatch` launches.
template <typename T, int D>
size_t smem_bytes(Which which) {
  if constexpr (sizeof(T) == 2)
    return which == kFwd ? fwd_tc_smem_bytes<D>()
                         : which == kDq ? dq_tc_smem_bytes<D>() : dkv_tc_smem_bytes<D>();
  else
    return (which == kFwd ? fwd_smem_floats<D>()
                          : which == kDq ? dq_smem_floats<D>() : dkv_smem_floats<D>()) *
           sizeof(float);
}

// bf16 goes to the tensor-core kernels, fp32 to the CUDA-core ones.
template <typename T, int D>
cudaError_t launch_typed(Which which, int B, const Args& a, cudaStream_t stream) {
  const int q_tiles = (a.Sq + kTile - 1) / kTile;
  const int k_tiles = (a.Sk + kTile - 1) / kTile;
  const size_t bytes = smem_bytes<T, D>(which);
  if constexpr (sizeof(T) == 2) {
    if (which == kFwd)
      return launch(flash_fwd_tc_kernel<D>, kTcThreads, bytes, q_tiles, a.H, B, a, stream);
    if (which == kDq)
      return launch(flash_bwd_dq_tc_kernel<D>, kTcThreads, bytes, q_tiles, a.H, B, a, stream);
    return launch(flash_bwd_dkv_tc_kernel<D>, dkv_tc_threads<D>(), bytes, k_tiles, a.H, B, a,
                  stream);
  } else {
    if (which == kFwd)
      return launch(flash_fwd_kernel<D>, kThreads, bytes, q_tiles, a.H, B, a, stream);
    if (which == kDq)
      return launch(flash_bwd_dq_kernel<D>, kThreads, bytes, q_tiles, a.H, B, a, stream);
    return launch(flash_bwd_dkv_kernel<D>, kThreads, bytes, k_tiles, a.H, B, a, stream);
  }
}

// The launch status, or kNoInstance for a head dim without a kernel
// instance: such a D is never sent to another instance's kernel.
constexpr int kNoInstance = -1;

int dispatch(Which which, int B, int D, int bf16, const Args& a, void* stream) {
  if (B <= 0 || a.H <= 0 || a.Sq <= 0 || a.Sk <= 0 || a.H > 65535 || B > 65535 ||
      (a.window > 0 && !a.causal))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return bf16 ? (int)launch_typed<__nv_bfloat16, 64>(which, B, a, st)
                  : (int)launch_typed<float, 64>(which, B, a, st);
    case 128:
      return bf16 ? (int)launch_typed<__nv_bfloat16, 128>(which, B, a, st)
                  : (int)launch_typed<float, 128>(which, B, a, st);
    case 256:
      return bf16 ? (int)launch_typed<__nv_bfloat16, 256>(which, B, a, st)
                  : (int)launch_typed<float, 256>(which, B, a, st);
    default:
      return kNoInstance;
  }
}

Strides strides_at(const long long* s, int i) { return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

}  // namespace

extern "C" {

// Each launch runs on `stream` and returns the launch status (cudaSuccess
// == 0); none allocates or synchronizes. q, k, v (and o, dout, and the
// gradients) are [B, H, S, D] with a contiguous last dimension and the
// element strides given in `strides`, three (batch, head, row) per tensor
// in the order of the pointer arguments. bf16: every such tensor is
// bfloat16, else float32. mask: [B, Sk] fp32 additive, or null. lse:
// [B, H, Sq] fp32. window <= 0: no sliding window (and window needs
// causal). D is 64, 128 or 256 (another D returns kNoInstance, -1,
// and launches nothing). The bf16 kernels copy rows 16 bytes at a
// time: every bf16 tensor's base pointer and (batch, head, row) strides
// must be multiples of 16 bytes (the caller checks).

// O = softmax(q k^T * scale + mask) v; LSE as well when lse is not null.
int flash_fwd_launch(const void* q, const void* k, const void* v, const float* mask, void* out,
                     float* lse, const long long* strides, int B, int H, int Sq, int Sk, int D,
                     float scale, int causal, int window, int bf16, void* stream) {
  Args a = {};
  a.q = q; a.k = k; a.v = v; a.mask = mask; a.out = out; a.lse_out = lse;
  a.sq = strides_at(strides, 0); a.sk = strides_at(strides, 1);
  a.sv = strides_at(strides, 2); a.sout = strides_at(strides, 3);
  a.H = H; a.Sq = Sq; a.Sk = Sk; a.scale = scale; a.causal = causal; a.window = window;
  return dispatch(kFwd, B, D, bf16, a, stream);
}

// dQ from q, k, v, mask, the forward's o and lse, and dout.
int flash_bwd_dq_launch(const void* q, const void* k, const void* v, const float* mask,
                        const void* o, const void* dout, const float* lse, void* dq,
                        const long long* strides, int B, int H, int Sq, int Sk, int D,
                        float scale, int causal, int window, int bf16, void* stream) {
  Args a = {};
  a.q = q; a.k = k; a.v = v; a.mask = mask; a.o = o; a.dout = dout; a.lse = lse; a.out = dq;
  a.sq = strides_at(strides, 0); a.sk = strides_at(strides, 1);
  a.sv = strides_at(strides, 2); a.so = strides_at(strides, 3);
  a.sdo = strides_at(strides, 4); a.sout = strides_at(strides, 5);
  a.H = H; a.Sq = Sq; a.Sk = Sk; a.scale = scale; a.causal = causal; a.window = window;
  return dispatch(kDq, B, D, bf16, a, stream);
}

// dK, dV, and (when dmask is not null) the mask's cotangent per head,
// dmask [B, H, Sk] fp32 = Σ_q dS.
int flash_bwd_dkv_launch(const void* q, const void* k, const void* v, const float* mask,
                         const void* o, const void* dout, const float* lse, void* dk, void* dv,
                         float* dmask, const long long* strides, int B, int H, int Sq, int Sk,
                         int D, float scale, int causal, int window, int bf16, void* stream) {
  Args a = {};
  a.q = q; a.k = k; a.v = v; a.mask = mask; a.o = o; a.dout = dout; a.lse = lse;
  a.out = dk; a.out2 = dv; a.lse_out = dmask;
  a.sq = strides_at(strides, 0); a.sk = strides_at(strides, 1);
  a.sv = strides_at(strides, 2); a.so = strides_at(strides, 3);
  a.sdo = strides_at(strides, 4); a.sout = strides_at(strides, 5);
  a.sout2 = strides_at(strides, 6);
  a.H = H; a.Sq = Sq; a.Sk = Sk; a.scale = scale; a.causal = causal; a.window = window;
  return dispatch(kDkv, B, D, bf16, a, stream);
}

// Dynamic shared memory per block, in bytes, of the kernel that launches
// for `which` (0 forward, 1 dQ, 2 dK/dV) at head dim D; -1 for a D the
// kernels do not take.
long long flash_attention_smem_bytes(int which, int D, int bf16) {
  const Which w = static_cast<Which>(which);
  if (D == 64)
    return (long long)(bf16 ? smem_bytes<__nv_bfloat16, 64>(w) : smem_bytes<float, 64>(w));
  if (D == 128)
    return (long long)(bf16 ? smem_bytes<__nv_bfloat16, 128>(w) : smem_bytes<float, 128>(w));
  if (D == 256)
    return (long long)(bf16 ? smem_bytes<__nv_bfloat16, 256>(w) : smem_bytes<float, 256>(w));
  return -1;
}

const char* flash_attention_error_string(int code) {
  if (code == kNoInstance) return "no kernel instance for this head_dim";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
