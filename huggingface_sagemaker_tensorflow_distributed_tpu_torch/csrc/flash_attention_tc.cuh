// Tensor-core forward, dQ and dK/dV/dmask kernels of flash attention for
// bf16 inputs (D 64, 128 or 256). Included by flash_attention.cu after `Args`,
// `kTile`, `kNegInf`, `tile_runs`, `causal_add` and `head_ptr`.
//
// They compute what `flash_fwd_kernel`, `flash_bwd_dq_kernel` and
// `flash_bwd_dkv_kernel` compute for bf16 (the same contract, see
// flash_attention.cu), up to the order of the fp32 sums: both operands of
// every product are bf16 (q, k, v, dO, and P and dS rounded to bf16 as the
// contract asks), so `mma.sync` m16n8k16 with fp32 accumulators takes the
// products the CUDA-core kernels took.
//
// Bound on an H100 at BERT-base (B 8, H 12, S 512, D 64, padded rows): the
// bytes (q, k, v and O once, 7.6 us at 3.35 TB/s) just above the operations
// (4.5 GFLOP on the valid keys, 4.5 us at the 989 TFLOP/s of the bf16
// tensor cores); the forward runs at about 6x that floor. The design:
// - 4 warps a block, each owning 16 rows of a 64-row tile (query rows in
//   the forward and dQ, key rows in dK/dV), so a row's max and sum reduce
//   over the 4 lanes of a quad with shuffles;
// - tiles are staged in shared memory as bf16 with a 16-byte row pad
//   (row stride D + 8), so the 8 rows an `ldmatrix` reads fall in 8
//   different 16-byte bank groups;
// - the streamed tiles are double-buffered with `cp.async`: tile i + 1 is
//   in flight while tile i is computed; rows at or past S are zero-filled
//   by the copy (nothing is read there);
// - the score fragment is turned into the bf16 A fragment of the next
//   product in registers (P of P·V, dS of dS·K, Pᵀ and dSᵀ of dV and dK),
//   so P and dS never go through shared memory; V, K (in dQ), dO and Q
//   are read as B fragments with `ldmatrix.trans`;
// - the elementwise softmax work between the products is what the tensor
//   cores wait on: exponentials go to the special-function unit as 2^x,
//   and the in-tile causal/window mask and the ragged-edge tests run only
//   on the tiles that need them (a uniform branch per tile);
// - registers set the blocks an SM holds: the forward keeps Q's fragments
//   in registers (138 at D 64, 3 blocks an SM; a cap of 128 for a 4th
//   block spills); dQ reads its Q and dO fragments from shared memory per
//   product so S, dP and the dQ accumulator fit a cap of 168 (3 blocks at
//   D 64); dK/dV takes 32 queries per product step and is capped for 3
//   blocks at D 64 (167 registers).
// The running tiles of a tile row or column form one interval under the
// causal/window rule of `tile_runs`, so the loops walk that interval.
//
// At D 256 (Gemma) a 16-row warp's fp32 output stripe is 128 registers a
// thread, and the D 128 design does not fit: the dK/dV block would need
// 271 KB of shared memory and 256 accumulators a thread. So at D 256:
// the forward reads Q's fragments from shared memory per product; dQ
// takes S and dP 32 keys at a time; dK/dV runs 8 warps split by role
// (`dkv_tc_roles`: 4 warps hold dV, 4 hold dK, each recomputing Sᵀ) and
// reads Δ from device memory instead of staging O (204 KB a block). Every
// sum keeps the order of the D 64/128 kernels.

#pragma once

#include "warp_mma.cuh"

namespace {

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// Rows [row0, row0 + 64) of a head's [S, D] bf16 slab into shared memory
// with row stride D + 8, by 16-byte async copies; rows at or past `rows`
// are zero-filled.
template <int D>
__device__ __forceinline__ void tc_load_tile(bf16* dst, const bf16* base, long long row_stride,
                                             int row0, int rows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks in a row
  for (int idx = threadIdx.x; idx < kTile * kChunks; idx += kTcThreads) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    const bool in = row0 + r < rows;
    const bf16* src = in ? base + (long long)(row0 + r) * row_stride + c * 8 : base;
    cp_async_16(dst + r * (D + 8) + c * 8, src, in);
  }
}

// 64 fp32 values src[first .. first + 64) into shared memory, zero at or
// past `count` or without `src`.
__device__ __forceinline__ void tc_load_row(float* dst, const float* src, int first, int count) {
  const int i = threadIdx.x;
  if (i >= kTile) return;
  if (src == nullptr) {
    dst[i] = 0.f;
    return;
  }
  const bool in = first + i < count;
  cp_async_4(dst + i, in ? src + first + i : src, in);
}

// e^x as 2^(x log2 e) on the special-function unit. x is a difference of
// logits (s - max, s - LSE), so its rounding does not grow with |s|.
__device__ __forceinline__ float exp_sfu(float x) { return exp2_approx(x * kLog2e); }

// Whether the (q0, k0) tile pair holds a (query, key) position that the
// causal/window rule masks; the in-tile mask is skipped for the others.
__device__ __forceinline__ bool tile_needs_band(const Args& a, int q0, int k0) {
  if (!a.causal) return false;
  const bool all_past = k0 + kTile - 1 <= q0;  // every key at or before every query
  const bool all_in_window = a.window <= 0 || k0 > q0 + kTile - 1 - a.window;
  return !(all_past && all_in_window);
}

// [first, last] of the running key tiles of query tile iq (first > last:
// none).
__device__ __forceinline__ void key_tile_range(const Args& a, int iq, int n, int& first,
                                               int& last) {
  first = n;
  last = -1;
  for (int ik = 0; ik < n; ++ik)
    if (tile_runs(a, iq, ik)) {
      first = min(first, ik);
      last = ik;
    }
}

// [first, last] of the running query tiles of key tile ik.
__device__ __forceinline__ void query_tile_range(const Args& a, int ik, int n, int& first,
                                                 int& last) {
  first = n;
  last = -1;
  for (int iq = 0; iq < n; ++iq)
    if (tile_runs(a, iq, ik)) {
      first = min(first, iq);
      last = iq;
    }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// Q; two stages of (K, V); two stages of the key tile's mask row.
template <int D>
constexpr size_t fwd_tc_smem_bytes() {
  return (size_t)5 * kTile * (D + 8) * sizeof(bf16) + 2 * kTile * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads) flash_fwd_tc_kernel(Args a) {
  constexpr int LD = D + 8;
  constexpr int KD = D / 16;     // k-steps over the head dim
  constexpr int ND = D / 8;      // 8-column blocks of the output
  constexpr int NK = kTile / 8;  // 8-key blocks of a score tile
  // Q's fragments stay in registers up to D 128; at D 256 the O stripe
  // alone is 128 fp32 a thread, so they are read from shared memory per
  // product (the same values: the arithmetic does not change)
  constexpr bool kQInRegs = D <= 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]
  bf16* sK = sQ + kTile * LD;                    // [2][64][LD]
  bf16* sV = sK + 2 * kTile * LD;                // [2][64][LD]
  float* sM = reinterpret_cast<float*>(sV + 2 * kTile * LD);  // [2][64]

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4;
  const int q0 = iq * kTile;
  const int row = warp * 16 + g;  // this lane's rows of the tile: row, row + 8
  const bf16* q = head_ptr<bf16>(a.q, a.sq, b, h);
  const bf16* k = head_ptr<bf16>(a.k, a.sk, b, h);
  const bf16* v = head_ptr<bf16>(a.v, a.sv, b, h);
  const float* mask = a.mask ? a.mask + (long long)b * a.Sk : nullptr;

  int first, last;
  key_tile_range(a, iq, (a.Sk + kTile - 1) / kTile, first, last);

  float o[ND][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < ND; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  uint32_t qf[kQInRegs ? KD : 1][4];

  if (first <= last) {
    tc_load_tile<D>(sQ, q, a.sq.s, q0, a.Sq);
    tc_load_tile<D>(sK, k, a.sk.s, first * kTile, a.Sk);
    tc_load_tile<D>(sV, v, a.sv.s, first * kTile, a.Sk);
    tc_load_row(sM, mask, first * kTile, a.Sk);
    cp_async_commit();
  }
  for (int ik = first; ik <= last; ++ik) {
    const int st = (ik - first) & 1;
    if (ik < last) {  // the next tile loads while this one is computed
      const int nx = (ik + 1) * kTile;
      tc_load_tile<D>(sK + (st ^ 1) * kTile * LD, k, a.sk.s, nx, a.Sk);
      tc_load_tile<D>(sV + (st ^ 1) * kTile * LD, v, a.sv.s, nx, a.Sk);
      tc_load_row(sM + (st ^ 1) * kTile, mask, nx, a.Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kQInRegs && ik == first) {
#pragma unroll
      for (int kk = 0; kk < (kQInRegs ? KD : 0); ++kk)
        ldsm_x4(qf[kk], sQ + (warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8);
    }
    const bf16* tK = sK + st * kTile * LD;
    const bf16* tV = sV + st * kTile * LD;
    const float* tM = sM + st * kTile;
    const int k0 = ik * kTile;

    // S = Q Kᵀ: 16 rows x 64 keys a warp
    float s[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    auto qk_step = [&](int kk, const uint32_t(&qa)[4]) {
#pragma unroll
      for (int np = 0; np < NK / 2; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, tK + (np * 16 + lane % 8 + (lane / 16) * 8) * LD + kk * 16 +
                        ((lane / 8) % 2) * 8);
        mma_bf16_16816(s[2 * np], qa, kb[0], kb[1]);
        mma_bf16_16816(s[2 * np + 1], qa, kb[2], kb[3]);
      }
    };
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      if constexpr (kQInRegs) {
        qk_step(kk, qf[kk]);
      } else {
        uint32_t qa[4];
        ldsm_x4(qa, sQ + (warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8);
        qk_step(kk, qa);
      }
    }

    // logits, the running max, P (fp32) and the running sum; keys at or
    // past Sk take no part in the max and get p = 0. The band mask and the
    // key bound are tested only on the tiles that need them.
    const bool band = tile_needs_band(a, q0, k0);
    const bool ragged = k0 + kTile > a.Sk;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = j * 8 + tg * 2 + (e & 1);
        float x = s[j][e] * a.scale + tM[kl];
        if (band) x += causal_add(a, q0 + row + (e >> 1) * 8, k0 + kl);
        s[j][e] = x;
        if (!ragged || k0 + kl < a.Sk) mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = exp_sfu(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];  // this lane's share of the row sum
    }
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = j * 8 + tg * 2 + (e & 1);
        const float p = (!ragged || k0 + kl < a.Sk) ? exp_sfu(s[j][e] - m[e >> 1]) : 0.f;
        l[e >> 1] += p;
        s[j][e] = p;
      }
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P V, P rounded to bf16 in the A fragment
#pragma unroll
    for (int t = 0; t < NK / 2; ++t) {
      const uint32_t pa[4] = {pack_bf16x2(s[2 * t][0], s[2 * t][1]),
                              pack_bf16x2(s[2 * t][2], s[2 * t][3]),
                              pack_bf16x2(s[2 * t + 1][0], s[2 * t + 1][1]),
                              pack_bf16x2(s[2 * t + 1][2], s[2 * t + 1][3])};
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, tV + (t * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD + dp * 16 +
                              (lane / 16) * 8);
        mma_bf16_16816(o[2 * dp], pa, vb[0], vb[1]);
        mma_bf16_16816(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // this stage's readers are done before it is refilled
  }

  bf16* out = head_ptr_mut<bf16>(a.out, a.sout, b, h);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lsum = quad_sum(l[r]);
    const int qpos = q0 + row + r * 8;
    if (qpos >= a.Sq) continue;
    const float safe_l = lsum == 0.f ? 1.f : lsum;
    bf16* orow = out + (long long)qpos * a.sout.s + tg * 2;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
          __floats2bfloat162_rn(o[j][2 * r] / safe_l, o[j][2 * r + 1] / safe_l);
    if (a.lse_out && tg == 0)
      a.lse_out[((long long)b * a.H + h) * a.Sq + qpos] = m[r] + logf(safe_l);
  }
}

// Δ_r = Σ_d dO[r, d] O[r, d] in fp32 for the 64 rows of query tile q0, two
// threads a row reading 16 bytes at a time; rows past Sq are zero.
template <int D>
__device__ __forceinline__ void tc_tile_delta(float* delta, const bf16* o, long long o_stride,
                                              const bf16* dout, long long do_stride, int q0,
                                              int Sq) {
  const int r = threadIdx.x / 2, half = threadIdx.x % 2;
  float acc = 0.f;
  if (q0 + r < Sq) {
    const uint4* orow = reinterpret_cast<const uint4*>(o + (long long)(q0 + r) * o_stride + half * (D / 2));
    const uint4* grow = reinterpret_cast<const uint4*>(dout + (long long)(q0 + r) * do_stride + half * (D / 2));
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const uint4 ov = orow[c], gv = grow[c];
      const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 of = __bfloat1622float2(op[e]), gf = __bfloat1622float2(gp[e]);
        acc += gf.x * of.x;
        acc += gf.y * of.y;
      }
    }
  }
  acc += __shfl_xor_sync(kFull, acc, 1);
  if (half == 0) delta[r] = acc;
}

// ---------------------------------------------------------------------------
// backward: dK, dV and the mask's cotangent
// ---------------------------------------------------------------------------

// K, V; two stages of (Q, dO, O); two stages of the LSE rows; Δ; the
// key tile's mask row. At D 256 (`dkv_tc_roles`) O is not staged: Δ is
// read from device memory, and the block fits 227 KB.
template <int D>
constexpr size_t dkv_tc_smem_bytes() {
  return (size_t)(D <= 128 ? 8 : 6) * kTile * (D + 8) * sizeof(bf16) +
         4 * kTile * sizeof(float);
}

// Threads of a dK/dV block: 4 warps up to D 128, 8 at D 256.
template <int D>
constexpr int dkv_tc_threads() {
  return D <= 128 ? kTcThreads : 2 * kTcThreads;
}

// Up to D 128: 4 warps, each owning 16 key rows of the 64-key tile and
// both of their accumulators, dK and dV.
template <int D>
__device__ __forceinline__ void dkv_tc_tile(const Args& a) {
  constexpr int LD = D + 8;
  constexpr int KD = D / 16;
  constexpr int ND = D / 8;
  // queries a warp takes per product step: 32, so the Sᵀ and dPᵀ
  // fragments beside the dK/dV accumulators leave room for 3 blocks an SM
  // at D 64
  constexpr int NQ = 32;
  constexpr int NJ = NQ / 8;  // 8-query blocks of a product step
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]
  bf16* sV = sK + kTile * LD;                    // [64][LD]
  bf16* sQ = sV + kTile * LD;                    // [2][64][LD]
  bf16* sDO = sQ + 2 * kTile * LD;               // [2][64][LD]
  bf16* sO = sDO + 2 * kTile * LD;               // [2][64][LD]
  float* sL = reinterpret_cast<float*>(sO + 2 * kTile * LD);  // [2][64]
  float* sD = sL + 2 * kTile;                                 // [64] Δ
  float* sMk = sD + kTile;                                    // [64] mask of the keys

  const int ik = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4;
  const int k0 = ik * kTile;
  const int krow = warp * 16 + g;  // this lane's key rows of the tile: krow, krow + 8
  const bf16* q = head_ptr<bf16>(a.q, a.sq, b, h);
  const bf16* k = head_ptr<bf16>(a.k, a.sk, b, h);
  const bf16* v = head_ptr<bf16>(a.v, a.sv, b, h);
  const bf16* o = head_ptr<bf16>(a.o, a.so, b, h);
  const bf16* dout = head_ptr<bf16>(a.dout, a.sdo, b, h);
  const float* lse = a.lse + ((long long)b * a.H + h) * a.Sq;

  int first, last;
  query_tile_range(a, ik, (a.Sq + kTile - 1) / kTile, first, last);

  float dk[ND][4], dv[ND][4], dm[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  if (first <= last) {
    tc_load_tile<D>(sK, k, a.sk.s, k0, a.Sk);
    tc_load_tile<D>(sV, v, a.sv.s, k0, a.Sk);
    tc_load_row(sMk, a.mask ? a.mask + (long long)b * a.Sk : nullptr, k0, a.Sk);
    const int q0 = first * kTile;
    tc_load_tile<D>(sQ, q, a.sq.s, q0, a.Sq);
    tc_load_tile<D>(sDO, dout, a.sdo.s, q0, a.Sq);
    tc_load_tile<D>(sO, o, a.so.s, q0, a.Sq);
    tc_load_row(sL, lse, q0, a.Sq);
    cp_async_commit();
  }
  for (int iq = first; iq <= last; ++iq) {
    const int st = (iq - first) & 1;
    if (iq < last) {  // the next query tile loads while this one is computed
      const int nx = (iq + 1) * kTile;
      const int off = (st ^ 1) * kTile * LD;
      tc_load_tile<D>(sQ + off, q, a.sq.s, nx, a.Sq);
      tc_load_tile<D>(sDO + off, dout, a.sdo.s, nx, a.Sq);
      tc_load_tile<D>(sO + off, o, a.so.s, nx, a.Sq);
      tc_load_row(sL + (st ^ 1) * kTile, lse, nx, a.Sq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* tQ = sQ + st * kTile * LD;
    const bf16* tDO = sDO + st * kTile * LD;
    const float* tL = sL + st * kTile;
    const int q0 = iq * kTile;
    const bool band = tile_needs_band(a, q0, k0);
    const bool ragged = q0 + kTile > a.Sq || k0 + kTile > a.Sk;

    // Δ_r = Σ_d dO[r, d] O[r, d] in fp32 for the tile's 64 rows, two
    // threads a row (rows past Sq are zero)
    {
      const int r = threadIdx.x / 2, half = threadIdx.x % 2;
      const bf16* gr = tDO + r * LD + half * (D / 2);
      const bf16* orow = sO + st * kTile * LD + r * LD + half * (D / 2);
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < D / 2; d += 2) {
        const float2 gv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(gr + d));
        const float2 ov = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(orow + d));
        acc += gv.x * ov.x;
        acc += gv.y * ov.y;
      }
      acc += __shfl_xor_sync(kFull, acc, 1);
      if (half == 0) sD[r] = acc;
    }
    __syncthreads();

#pragma unroll 1
    for (int qs = 0; qs < kTile; qs += NQ) {
      // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ: 16 keys x NQ queries a warp
      float sT[NJ][4], dpT[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ka[4], va[4];
        ldsm_x4(ka, sK + (warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8);
        ldsm_x4(va, sV + (warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8);
#pragma unroll
        for (int np = 0; np < NJ / 2; ++np) {
          const int r = qs + np * 16 + lane % 8 + (lane / 16) * 8;
          const int c = kk * 16 + ((lane / 8) % 2) * 8;
          uint32_t qb[4], gb[4];
          ldsm_x4(qb, tQ + r * LD + c);
          ldsm_x4(gb, tDO + r * LD + c);
          mma_bf16_16816(sT[2 * np], ka, qb[0], qb[1]);
          mma_bf16_16816(sT[2 * np + 1], ka, qb[2], qb[3]);
          mma_bf16_16816(dpT[2 * np], va, gb[0], gb[1]);
          mma_bf16_16816(dpT[2 * np + 1], va, gb[2], gb[3]);
        }
      }

      // Pᵀ = exp(Sᵀ scale + mask - LSE), dSᵀ = Pᵀ (dPᵀ - Δ); entries past
      // Sq or Sk are 0
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = krow + (e >> 1) * 8;
          const int ql = qs + j * 8 + tg * 2 + (e & 1);
          const int qpos = q0 + ql, kpos = k0 + kl;
          float x = sT[j][e] * a.scale + sMk[kl];
          if (band) x += causal_add(a, qpos, kpos);
          const bool in = !ragged || (qpos < a.Sq && kpos < a.Sk);
          const float p = in ? exp_sfu(x - tL[ql]) : 0.f;
          const float ds = p * (dpT[j][e] - sD[ql]);
          dm[e >> 1] += ds;
          sT[j][e] = p;
          dpT[j][e] = ds;
        }

      // dV += Pᵀ dO and dK += dSᵀ Q, Pᵀ and dSᵀ rounded to bf16 in the A
      // fragments
#pragma unroll
      for (int t = 0; t < NJ / 2; ++t) {
        const uint32_t pa[4] = {pack_bf16x2(sT[2 * t][0], sT[2 * t][1]),
                                pack_bf16x2(sT[2 * t][2], sT[2 * t][3]),
                                pack_bf16x2(sT[2 * t + 1][0], sT[2 * t + 1][1]),
                                pack_bf16x2(sT[2 * t + 1][2], sT[2 * t + 1][3])};
        const uint32_t da[4] = {pack_bf16x2(dpT[2 * t][0], dpT[2 * t][1]),
                                pack_bf16x2(dpT[2 * t][2], dpT[2 * t][3]),
                                pack_bf16x2(dpT[2 * t + 1][0], dpT[2 * t + 1][1]),
                                pack_bf16x2(dpT[2 * t + 1][2], dpT[2 * t + 1][3])};
        const int r = qs + t * 16 + lane % 8 + ((lane / 8) % 2) * 8;
#pragma unroll
        for (int dp = 0; dp < ND / 2; ++dp) {
          const int c = dp * 16 + (lane / 16) * 8;
          uint32_t gb[4], qb[4];
          ldsm_x4_trans(gb, tDO + r * LD + c);
          ldsm_x4_trans(qb, tQ + r * LD + c);
          mma_bf16_16816(dv[2 * dp], pa, gb[0], gb[1]);
          mma_bf16_16816(dv[2 * dp + 1], pa, gb[2], gb[3]);
          mma_bf16_16816(dk[2 * dp], da, qb[0], qb[1]);
          mma_bf16_16816(dk[2 * dp + 1], da, qb[2], qb[3]);
        }
      }
    }
    __syncthreads();  // this stage's readers (and Δ's) are done before a refill
  }

  bf16* dkp = head_ptr_mut<bf16>(a.out, a.sout, b, h);
  bf16* dvp = head_ptr_mut<bf16>(a.out2, a.sout2, b, h);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float dmr = quad_sum(dm[r]);
    const int kpos = k0 + krow + r * 8;
    if (kpos >= a.Sk) continue;
    bf16* krow_dk = dkp + (long long)kpos * a.sout.s + tg * 2;
    bf16* krow_dv = dvp + (long long)kpos * a.sout2.s + tg * 2;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(krow_dk + j * 8) =
          __floats2bfloat162_rn(dk[j][2 * r] * a.scale, dk[j][2 * r + 1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(krow_dv + j * 8) =
          __floats2bfloat162_rn(dv[j][2 * r], dv[j][2 * r + 1]);
    }
    if (a.lse_out && tg == 0) a.lse_out[((long long)b * a.H + h) * a.Sk + kpos] = dmr;
  }
}

// At D 256 a 16-key warp's dK and dV stripes would be 256 fp32 a thread:
// 8 warps split the work by role instead. Warps 0-3 (the dV role) and
// warps 4-7 (the dK role) each own 16 key rows of the 64-key tile; both
// take Sᵀ = K Qᵀ and P, the dV warps then dV += Pᵀ dO, the dK warps dPᵀ =
// V dOᵀ, dSᵀ, the mask's cotangent and dK += dSᵀ Q. Sᵀ is taken twice (5
// products a tile pair instead of 4), and no warp waits on another's
// fragments. Every product sums in the order of the 4-warp kernel. Δ of a
// query tile is read from O and dO in device memory by the first 4 warps
// (`tc_tile_delta`, the dQ kernel's), so O is not staged.
template <int D>
__device__ __forceinline__ void dkv_tc_roles(const Args& a) {
  constexpr int LD = D + 8;
  constexpr int KD = D / 16;
  constexpr int ND = D / 8;
  constexpr int NQ = 32;      // queries a warp takes per product step
  constexpr int NJ = NQ / 8;  // 8-query blocks of a product step
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]
  bf16* sV = sK + kTile * LD;                    // [64][LD]
  bf16* sQ = sV + kTile * LD;                    // [2][64][LD]
  bf16* sDO = sQ + 2 * kTile * LD;               // [2][64][LD]
  float* sL = reinterpret_cast<float*>(sDO + 2 * kTile * LD);  // [2][64]
  float* sD = sL + 2 * kTile;                                  // [64] Δ
  float* sMk = sD + kTile;                                     // [64] mask of the keys

  const int ik = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4;
  const bool dk_role = warp >= 4;  // warp-uniform
  const int kw = warp % 4;         // the warp's 16 key rows of the tile
  const int k0 = ik * kTile;
  const int krow = kw * 16 + g;    // this lane's key rows: krow, krow + 8
  const bf16* q = head_ptr<bf16>(a.q, a.sq, b, h);
  const bf16* k = head_ptr<bf16>(a.k, a.sk, b, h);
  const bf16* v = head_ptr<bf16>(a.v, a.sv, b, h);
  const bf16* o = head_ptr<bf16>(a.o, a.so, b, h);
  const bf16* dout = head_ptr<bf16>(a.dout, a.sdo, b, h);
  const float* lse = a.lse + ((long long)b * a.H + h) * a.Sq;

  int first, last;
  query_tile_range(a, ik, (a.Sq + kTile - 1) / kTile, first, last);

  // dV (warps 0-3) or dK (warps 4-7) of the warp's 16 keys
  float acc[ND][4], dm[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  if (first <= last) {
    tc_load_tile<D>(sK, k, a.sk.s, k0, a.Sk);
    tc_load_tile<D>(sV, v, a.sv.s, k0, a.Sk);
    tc_load_row(sMk, a.mask ? a.mask + (long long)b * a.Sk : nullptr, k0, a.Sk);
    const int q0 = first * kTile;
    tc_load_tile<D>(sQ, q, a.sq.s, q0, a.Sq);
    tc_load_tile<D>(sDO, dout, a.sdo.s, q0, a.Sq);
    tc_load_row(sL, lse, q0, a.Sq);
    cp_async_commit();
  }
  for (int iq = first; iq <= last; ++iq) {
    const int st = (iq - first) & 1;
    const int q0 = iq * kTile;
    // Δ of this query tile (the last tile's readers are done with sD)
    if (threadIdx.x < kTcThreads) tc_tile_delta<D>(sD, o, a.so.s, dout, a.sdo.s, q0, a.Sq);
    if (iq < last) {  // the next query tile loads while this one is computed
      const int nx = (iq + 1) * kTile;
      const int off = (st ^ 1) * kTile * LD;
      tc_load_tile<D>(sQ + off, q, a.sq.s, nx, a.Sq);
      tc_load_tile<D>(sDO + off, dout, a.sdo.s, nx, a.Sq);
      tc_load_row(sL + (st ^ 1) * kTile, lse, nx, a.Sq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* tQ = sQ + st * kTile * LD;
    const bf16* tDO = sDO + st * kTile * LD;
    const float* tL = sL + st * kTile;
    const bool band = tile_needs_band(a, q0, k0);
    const bool ragged = q0 + kTile > a.Sq || k0 + kTile > a.Sk;

#pragma unroll 1
    for (int qs = 0; qs < kTile; qs += NQ) {
      // Sᵀ = K Qᵀ (both roles) and dPᵀ = V dOᵀ (the dK role): 16 keys x
      // NQ queries a warp
      float sT[NJ][4], dpT[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const int ar = (kw * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8;
        uint32_t ka[4];
        ldsm_x4(ka, sK + ar);
#pragma unroll
        for (int np = 0; np < NJ / 2; ++np) {
          const int r = qs + np * 16 + lane % 8 + (lane / 16) * 8;
          const int c = kk * 16 + ((lane / 8) % 2) * 8;
          uint32_t qb[4];
          ldsm_x4(qb, tQ + r * LD + c);
          mma_bf16_16816(sT[2 * np], ka, qb[0], qb[1]);
          mma_bf16_16816(sT[2 * np + 1], ka, qb[2], qb[3]);
        }
        if (dk_role) {
          uint32_t va[4];
          ldsm_x4(va, sV + ar);
#pragma unroll
          for (int np = 0; np < NJ / 2; ++np) {
            const int r = qs + np * 16 + lane % 8 + (lane / 16) * 8;
            const int c = kk * 16 + ((lane / 8) % 2) * 8;
            uint32_t gb[4];
            ldsm_x4(gb, tDO + r * LD + c);
            mma_bf16_16816(dpT[2 * np], va, gb[0], gb[1]);
            mma_bf16_16816(dpT[2 * np + 1], va, gb[2], gb[3]);
          }
        }
      }

      // Pᵀ = exp(Sᵀ scale + mask - LSE); the dK role also dSᵀ = Pᵀ (dPᵀ -
      // Δ) and the mask's cotangent; entries past Sq or Sk are 0
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = krow + (e >> 1) * 8;
          const int ql = qs + j * 8 + tg * 2 + (e & 1);
          const int qpos = q0 + ql, kpos = k0 + kl;
          float x = sT[j][e] * a.scale + sMk[kl];
          if (band) x += causal_add(a, qpos, kpos);
          const bool in = !ragged || (qpos < a.Sq && kpos < a.Sk);
          const float p = in ? exp_sfu(x - tL[ql]) : 0.f;
          sT[j][e] = p;
          if (dk_role) {
            const float ds = p * (dpT[j][e] - sD[ql]);
            dm[e >> 1] += ds;
            dpT[j][e] = ds;
          }
        }

      // dV += Pᵀ dO (the dV role) or dK += dSᵀ Q (the dK role), Pᵀ and dSᵀ
      // rounded to bf16 in the A fragments
#pragma unroll
      for (int t = 0; t < NJ / 2; ++t) {
        // a register select per element (no array is indexed at run time)
        auto f = [&](int j, int e) { return dk_role ? dpT[j][e] : sT[j][e]; };
        const uint32_t fa[4] = {pack_bf16x2(f(2 * t, 0), f(2 * t, 1)),
                                pack_bf16x2(f(2 * t, 2), f(2 * t, 3)),
                                pack_bf16x2(f(2 * t + 1, 0), f(2 * t + 1, 1)),
                                pack_bf16x2(f(2 * t + 1, 2), f(2 * t + 1, 3))};
        const bf16* src = dk_role ? tQ : tDO;
        const int r = qs + t * 16 + lane % 8 + ((lane / 8) % 2) * 8;
#pragma unroll
        for (int dp = 0; dp < ND / 2; ++dp) {
          uint32_t bb[4];
          ldsm_x4_trans(bb, src + r * LD + dp * 16 + (lane / 16) * 8);
          mma_bf16_16816(acc[2 * dp], fa, bb[0], bb[1]);
          mma_bf16_16816(acc[2 * dp + 1], fa, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // this stage's readers (and Δ's) are done before a refill
  }

  bf16* dst = head_ptr_mut<bf16>(dk_role ? a.out : a.out2, dk_role ? a.sout : a.sout2, b, h);
  const long long row_stride = dk_role ? a.sout.s : a.sout2.s;
  const float mul = dk_role ? a.scale : 1.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float dmr = quad_sum(dm[r]);
    const int kpos = k0 + krow + r * 8;
    if (kpos >= a.Sk) continue;
    bf16* drow = dst + (long long)kpos * row_stride + tg * 2;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<__nv_bfloat162*>(drow + j * 8) =
          __floats2bfloat162_rn(acc[j][2 * r] * mul, acc[j][2 * r + 1] * mul);
    if (dk_role && a.lse_out && tg == 0)
      a.lse_out[((long long)b * a.H + h) * a.Sk + kpos] = dmr;
  }
}

template <int D>
__global__ void __launch_bounds__(D <= 128 ? kTcThreads : 2 * kTcThreads, D == 64 ? 3 : 1)
    flash_bwd_dkv_tc_kernel(Args a) {
  if constexpr (D <= 128)
    dkv_tc_tile<D>(a);
  else
    dkv_tc_roles<D>(a);
}

// ---------------------------------------------------------------------------
// backward: dQ
// ---------------------------------------------------------------------------

// Q, dO; two stages of (K, V); two stages of the key tile's mask row; the
// LSE and Δ of the query rows.
template <int D>
constexpr size_t dq_tc_smem_bytes() {
  return (size_t)6 * kTile * (D + 8) * sizeof(bf16) + 4 * kTile * sizeof(float);
}

// One block per (b, h, 64-query tile), each warp owning 16 query rows.
// S = Q Kᵀ and dP = dO Vᵀ on the tensor cores; dS = P (dP - Δ) in the fp32
// accumulator fragments, rounded to bf16 only as the A fragment of
// dQ += dS K (K read again, transposed by `ldmatrix.trans`, as V is in
// the forward's P V). Q and dO stay in shared memory and their fragments
// are read per product, so S, dP and dQ fit beside them in registers.
template <int D>
__global__ void __launch_bounds__(kTcThreads, D == 64 ? 3 : 1) flash_bwd_dq_tc_kernel(Args a) {
  constexpr int LD = D + 8;
  constexpr int KD = D / 16;
  constexpr int ND = D / 8;
  // keys a product step takes: the whole tile up to D 128; at D 256 the
  // dQ stripe is 128 fp32 a thread, so S and dP are taken 32 keys at a
  // time (the sums over D and over the keys keep their order)
  constexpr int NKS = D <= 128 ? kTile : 32;
  constexpr int NK = NKS / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]
  bf16* sDO = sQ + kTile * LD;                   // [64][LD]
  bf16* sK = sDO + kTile * LD;                   // [2][64][LD]
  bf16* sV = sK + 2 * kTile * LD;                // [2][64][LD]
  float* sM = reinterpret_cast<float*>(sV + 2 * kTile * LD);  // [2][64]
  float* sL = sM + 2 * kTile;                                 // [64] LSE
  float* sD = sL + kTile;                                     // [64] Δ

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4;
  const int q0 = iq * kTile;
  const int row = warp * 16 + g;  // this lane's rows of the tile: row, row + 8
  const bf16* q = head_ptr<bf16>(a.q, a.sq, b, h);
  const bf16* k = head_ptr<bf16>(a.k, a.sk, b, h);
  const bf16* v = head_ptr<bf16>(a.v, a.sv, b, h);
  const bf16* o = head_ptr<bf16>(a.o, a.so, b, h);
  const bf16* dout = head_ptr<bf16>(a.dout, a.sdo, b, h);
  const float* lse = a.lse + ((long long)b * a.H + h) * a.Sq;
  const float* mask = a.mask ? a.mask + (long long)b * a.Sk : nullptr;

  int first, last;
  key_tile_range(a, iq, (a.Sk + kTile - 1) / kTile, first, last);

  float dq[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
  float lse_r[2] = {0.f, 0.f}, delta_r[2] = {0.f, 0.f};

  // prologue (the TPU kernel's `_init`): Q, dO, LSE and Δ once per query
  // tile, with the first key tile
  if (first <= last) {
    tc_load_tile<D>(sQ, q, a.sq.s, q0, a.Sq);
    tc_load_tile<D>(sDO, dout, a.sdo.s, q0, a.Sq);
    tc_load_row(sL, lse, q0, a.Sq);
    tc_load_tile<D>(sK, k, a.sk.s, first * kTile, a.Sk);
    tc_load_tile<D>(sV, v, a.sv.s, first * kTile, a.Sk);
    tc_load_row(sM, mask, first * kTile, a.Sk);
    cp_async_commit();
    tc_tile_delta<D>(sD, o, a.so.s, dout, a.sdo.s, q0, a.Sq);
  }
  for (int ik = first; ik <= last; ++ik) {
    const int st = (ik - first) & 1;
    if (ik < last) {  // the next key tile loads while this one is computed
      const int nx = (ik + 1) * kTile;
      tc_load_tile<D>(sK + (st ^ 1) * kTile * LD, k, a.sk.s, nx, a.Sk);
      tc_load_tile<D>(sV + (st ^ 1) * kTile * LD, v, a.sv.s, nx, a.Sk);
      tc_load_row(sM + (st ^ 1) * kTile, mask, nx, a.Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (ik == first) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lse_r[r] = sL[row + r * 8];
        delta_r[r] = sD[row + r * 8];
      }
    }
    const bf16* tK = sK + st * kTile * LD;
    const bf16* tV = sV + st * kTile * LD;
    const float* tM = sM + st * kTile;
    const int k0 = ik * kTile;

    const bool band = tile_needs_band(a, q0, k0);
    const bool ragged = k0 + kTile > a.Sk;
#pragma unroll 1
    for (int ks = 0; ks < kTile; ks += NKS) {
      // S = Q Kᵀ and dP = dO Vᵀ: 16 rows x NKS keys a warp
      float s[NK][4], dp[NK][4];
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t qa[4], ga[4];
        const int ar = (warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8;
        ldsm_x4(qa, sQ + ar);
        ldsm_x4(ga, sDO + ar);
#pragma unroll
        for (int np = 0; np < NK / 2; ++np) {
          const int br = (ks + np * 16 + lane % 8 + (lane / 16) * 8) * LD + kk * 16 +
                         ((lane / 8) % 2) * 8;
          uint32_t kb[4], vb[4];
          ldsm_x4(kb, tK + br);
          ldsm_x4(vb, tV + br);
          mma_bf16_16816(s[2 * np], qa, kb[0], kb[1]);
          mma_bf16_16816(s[2 * np + 1], qa, kb[2], kb[3]);
          mma_bf16_16816(dp[2 * np], ga, vb[0], vb[1]);
          mma_bf16_16816(dp[2 * np + 1], ga, vb[2], vb[3]);
        }
      }

      // P = exp(S scale + mask - LSE), dS = P (dP - Δ) in fp32; keys at or
      // past Sk get P = 0. The band mask and the key bound are tested only
      // on the tiles that need them.
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = ks + j * 8 + tg * 2 + (e & 1);
          float x = s[j][e] * a.scale + tM[kl];
          if (band) x += causal_add(a, q0 + row + (e >> 1) * 8, k0 + kl);
          const float p = (!ragged || k0 + kl < a.Sk) ? exp_sfu(x - lse_r[e >> 1]) : 0.f;
          s[j][e] = p * (dp[j][e] - delta_r[e >> 1]);
        }

      // dQ += dS K, dS rounded to bf16 in the A fragment
#pragma unroll
      for (int t = 0; t < NK / 2; ++t) {
        const uint32_t da[4] = {pack_bf16x2(s[2 * t][0], s[2 * t][1]),
                                pack_bf16x2(s[2 * t][2], s[2 * t][3]),
                                pack_bf16x2(s[2 * t + 1][0], s[2 * t + 1][1]),
                                pack_bf16x2(s[2 * t + 1][2], s[2 * t + 1][3])};
#pragma unroll
        for (int dn = 0; dn < ND / 2; ++dn) {
          uint32_t kb[4];
          ldsm_x4_trans(kb, tK + (ks + t * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD +
                                dn * 16 + (lane / 16) * 8);
          mma_bf16_16816(dq[2 * dn], da, kb[0], kb[1]);
          mma_bf16_16816(dq[2 * dn + 1], da, kb[2], kb[3]);
        }
      }
    }
    __syncthreads();  // this stage's readers are done before it is refilled
  }

  // epilogue (the TPU kernel's last-tile finish): scale · dQ in bf16
  bf16* dqp = head_ptr_mut<bf16>(a.out, a.sout, b, h);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = q0 + row + r * 8;
    if (qpos >= a.Sq) continue;
    bf16* orow = dqp + (long long)qpos * a.sout.s + tg * 2;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
          __floats2bfloat162_rn(dq[j][2 * r] * a.scale, dq[j][2 * r + 1] * a.scale);
  }
}

}  // namespace
