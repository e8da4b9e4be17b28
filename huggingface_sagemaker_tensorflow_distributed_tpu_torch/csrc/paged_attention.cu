// Paged single-token decode attention for Hopper (sm_90a), split over the
// context (flash-decoding).
//
// Replaces the TPU kernel `ops/pallas_paged_attention.py::_paged_kernel`
// of the JAX package (reached through `_paged_call`): one query per
// slot attends over that slot's KV, read straight out of the paged pools
// through its block table, with GQA query grouping, context and
// sliding-window masking, int8 dequantization, fp32 softmax and
// accumulation, and zeros for rows with no valid key (context 0).
//
// Bound on an H100: memory. Per layer the call must read
// sum_s ctx_s * Hkv * D * 2 K/V elements (plus one fp32 scale per
// position and head for int8 pools) and does 4 flops per K/V element pair
// per query head: 0.5 flop per byte for fp32 MHA, about 4 for bf16 with
// G 4, 8 for int8 with G 4, against the fp32 CUDA cores' balance of
// about 20. So the floor is those bytes over 3.35 TB/s, and the design is
// about parallelism and bytes in flight, not tensor cores.
//
// What the design does about it:
// - the split: each slot's walked span [lo, hi) (lo = max(0, ctx - window)
//   with a window, else 0; hi = min(ctx, nb * bs)) is cut into chunks of
//   `chunk` positions counted from lo (so a windowed walk starts no block
//   below its band), one block per (kv head, slot, chunk). The wrapper
//   picks `chunk` on the host from the slots, kv heads and the span
//   (`ops/paged_attention.py:split_plan`) so that the grid holds several
//   blocks per SM even for one request. A block whose chunk starts at or
//   past hi exits at once: past the context, and every chunk of a
//   context-0 row. Nothing syncs with the host;
// - within a block each of the 4 warps streams its own keys: stage i of
//   warp w is the 8 positions chunk_start + (4 i + w) * 8 + [0, 8). The
//   stages' K and V rows (and int8 scales) come in with 16-byte (4-byte)
//   `cp.async` copies, in their stored dtype, into a per-warp ring of 2
//   stages in shared memory, one stage ahead of the one being computed
//   (4 warps a block, several blocks an SM: 4 KB a warp in flight at fp32
//   D 64; a third stage measured no faster and halves the blocks an SM
//   holds at fp32 D 128). The chunk's block-table entries are read into
//   shared memory once (without a window, while the context length is in
//   flight), behind the block's first `__syncthreads`; inside the walk a
//   warp waits only on its own copies (`cp.async.wait_group`,
//   `__syncwarp`);
// - logits: D / 8 lanes per key (3 shuffle levels at D 64, 4 at D 128,
//   5 at D 256, where a key takes the whole warp and lane j % 8 keeps key
//   j's logit, so a head's 8 logits of a stage take one register a lane),
//   each lane holding 8 elements of q per head in registers; int8 and
//   bf16 are converted when read, the int8 scales applied per position
//   to the logit and to the probability;
// - each warp keeps its own online softmax (running max and sum per head,
//   the [G, D] accumulator in registers, D / 32 values a lane per head);
//   at the end of the chunk the warps leave their states in their rings
//   and, after the block's second `__syncthreads`, the block merges them into
//   the chunk's partial (m, l, acc), written in fp32 to a workspace the
//   wrapper allocates;
// - `paged_decode_combine_kernel`, one warp per (slot, query head), merges
//   the partials of the chunks that hold keys in chunk order (rescaled to
//   their common max, 8 partials' loads in flight at once) and writes the
//   output in q's dtype; a row whose sum is 0 (context 0) is written as
//   zeros. An empty state (m = -1e30, l = 0) gets weight 0 in both merges.
// Left for later: TMA for the K/V stages, and `mma` for large G (no
// ported model has one yet).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "warp_mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kKeys = 8;                 // positions a warp takes per stage
constexpr int kTile = kWarps * kKeys;    // positions a block takes per round
constexpr int kStages = 2;               // per-warp ring depth
constexpr int kMaxGroup = 8;             // query heads per kv head
constexpr float kNegInf = -1e30f;        // the TPU kernel's mask value

struct Args {
  const void* q;             // [S, Hkv * G, D] float or bf16
  const void* k_pool;        // [N, bs, Hkv, D] q's dtype or int8
  const void* v_pool;
  const float* k_scale;      // [N, bs, Hkv, 1] fp32, or null
  const float* v_scale;
  const int* block_tables;   // [S, table_stride]
  const int* context_lens;   // [S]
  void* out;                 // [S, Hkv * G, D] q's dtype
  float* part_ml;            // [S, Hkv * G, chunks, 2]: running max, sum
  float* part_acc;           // [S, Hkv * G, chunks, D]
  int S, Hkv, G, bs, nb, table_stride, window, chunk, parts;  // parts: chunks
  float scale;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// The 8 elements of a K row that lane r of a key's lane group holds, as
// units read from shared memory: 2 x 4 floats, 1 x 8 bf16 or 1 x 8 int8.
// Unit u of lane r is unit u * LK + r of the row, so the 8 lanes of a
// quarter warp read 128 consecutive bytes.
template <typename T>
struct Lane8 {
  static constexpr int kElems = sizeof(T) == 4 ? 4 : 8;  // elements per unit
  // row element held as a lane's element e
  __device__ static int elem(int e, int r, int LK) {
    return ((e / kElems) * LK + r) * kElems + e % kElems;
  }
};

__device__ __forceinline__ void unpack8(const unsigned char* row, int r, int LK, float (&f)[8],
                                        float) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const float4 x = *reinterpret_cast<const float4*>(row + (u * LK + r) * 16);
    f[4 * u] = x.x;
    f[4 * u + 1] = x.y;
    f[4 * u + 2] = x.z;
    f[4 * u + 3] = x.w;
  }
}

__device__ __forceinline__ void unpack8(const unsigned char* row, int r, int, float (&f)[8],
                                        __nv_bfloat16) {
  const uint4 x = *reinterpret_cast<const uint4*>(row + r * 16);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 y = __bfloat1622float2(b[k]);
    f[2 * k] = y.x;
    f[2 * k + 1] = y.y;
  }
}

__device__ __forceinline__ void unpack8(const unsigned char* row, int r, int, float (&f)[8],
                                        int8_t) {
  const uint2 x = *reinterpret_cast<const uint2*>(row + r * 8);
  const int8_t* b = reinterpret_cast<const int8_t*>(&x);
#pragma unroll
  for (int k = 0; k < 8; ++k) f[k] = static_cast<float>(b[k]);
}

// The DL = D / 32 consecutive elements lane..lane + DL of a V row that a
// lane accumulates, as floats.
template <int DL>
__device__ __forceinline__ void load_v(const unsigned char* row, int lane, float (&f)[DL], float) {
  const float* p = reinterpret_cast<const float*>(row) + lane * DL;
  if constexpr (DL >= 4) {
#pragma unroll
    for (int u = 0; u < DL / 4; ++u) {
      const float4 x = *reinterpret_cast<const float4*>(p + 4 * u);
      f[4 * u] = x.x, f[4 * u + 1] = x.y, f[4 * u + 2] = x.z, f[4 * u + 3] = x.w;
    }
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    f[0] = x.x, f[1] = x.y;
  }
}

template <int DL>
__device__ __forceinline__ void load_v(const unsigned char* row, int lane, float (&f)[DL],
                                       __nv_bfloat16) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(row) + lane * DL / 2;
#pragma unroll
  for (int k = 0; k < DL / 2; ++k) {
    const float2 y = __bfloat1622float2(p[k]);
    f[2 * k] = y.x;
    f[2 * k + 1] = y.y;
  }
}

template <int DL>
__device__ __forceinline__ void load_v(const unsigned char* row, int lane, float (&f)[DL], int8_t) {
  const int8_t* p = reinterpret_cast<const int8_t*>(row) + lane * DL;
  if constexpr (DL >= 4) {
#pragma unroll
    for (int u = 0; u < DL / 4; ++u) {
      const char4 x = *reinterpret_cast<const char4*>(p + 4 * u);
      f[4 * u] = x.x, f[4 * u + 1] = x.y, f[4 * u + 2] = x.z, f[4 * u + 3] = x.w;
    }
  } else {
    const char2 x = *reinterpret_cast<const char2*>(p);
    f[0] = x.x, f[1] = x.y;
  }
}

// Bytes of one warp's ring stage: 8 K rows, 8 V rows, 8 + 8 scales.
template <typename KVT, int D>
__host__ __device__ constexpr int stage_bytes() {
  return 2 * kKeys * D * (int)sizeof(KVT) + 2 * kKeys * (int)sizeof(float);
}

// Bytes of one warp's shared memory: its ring and its probabilities.
template <typename KVT, int D, int GM>
__host__ __device__ constexpr int warp_smem_bytes() {
  return kStages * stage_bytes<KVT, D>() + GM * kKeys * (int)sizeof(float);
}

// Dynamic shared memory of a split block: the warps' rings and
// probabilities, then the chunk's block-table entries (a chunk of
// `chunk` positions starting anywhere touches at most chunk / bs + 1
// blocks).
template <typename KVT, int D, int GM>
size_t split_smem_bytes(int chunk, int bs) {
  return (size_t)kWarps * warp_smem_bytes<KVT, D, GM>() + (size_t)(chunk / bs + 1) * sizeof(int);
}

// The span of positions that can hold a valid key of slot s: below the
// context, inside the walked table span, and (with a window) inside the
// band 0 <= (ctx - 1) - pos < window.
__device__ __forceinline__ void valid_span(const Args& a, int s, int& lo, int& hi) {
  const int ctx = a.context_lens[s];
  hi = min(ctx, a.nb * a.bs);
  lo = a.window > 0 ? max(0, ctx - a.window) : 0;
}

// One (kv head, slot, chunk): each warp's partial (m, l, acc) of its
// stages. Grid (Hkv, S, chunks), kThreads threads.
template <typename QT, typename KVT, int D, int GM>
__device__ __forceinline__ void split_block(const Args& a) {
  constexpr int LK = D / 8;            // lanes per key
  constexpr int KPP = 32 / LK;         // keys per pass of the warp
  constexpr int NP = kKeys / KPP;      // passes per stage
  constexpr int RB = D * (int)sizeof(KVT);  // bytes per K/V row
  constexpr int CPR = RB / 16;         // 16-byte copies per row
  constexpr int CPL = kKeys * CPR / 32;  // of K (and of V) per lane per stage
  constexpr int DL = D / 32;           // accumulated dims per lane
  constexpr int SB = stage_bytes<KVT, D>();
  static_assert(kKeys * CPR % 32 == 0, "a stage's copies must split over the lanes");
  static_assert(NP * KPP == kKeys, "a stage must be whole passes");
  static_assert(GM * (D + 2) * (int)sizeof(float) <= kStages * SB,
                "a warp's final state must fit its ring");
  using L8 = Lane8<KVT>;

  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int c = blockIdx.z;
  const int tid = threadIdx.x;
  int* table_s = reinterpret_cast<int*>(smem + kWarps * warp_smem_bytes<KVT, D, GM>());
  const int* table = a.block_tables + (size_t)s * a.table_stride;
  // without a window the chunk's table columns do not depend on the
  // context: read them while its length is in flight
  if (a.window <= 0) {
    const int b0 = c * a.chunk / a.bs;
    for (int i = tid; i < min(a.nb - b0, a.chunk / a.bs); i += kThreads)
      table_s[i] = table[b0 + i];
  }
  int lo, hi;
  valid_span(a, s, lo, hi);
  const int cs = lo + c * a.chunk;          // the chunk's first position
  if (cs >= hi) return;                     // no valid key in this chunk
  const int ce = min(hi, cs + a.chunk);     // one past its last
  const int b0 = cs / a.bs;                 // its first table column
  if (a.window > 0)
    for (int i = tid; i < (ce - 1) / a.bs - b0 + 1; i += kThreads) table_s[i] = table[b0 + i];
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r = lane % LK;                  // lane within its key's group
  const int grp = lane / LK;                // the group's key within a pass
  const bool int8 = a.k_scale != nullptr;

  unsigned char* ring = smem + warp * warp_smem_bytes<KVT, D, GM>();
  float* p_s = reinterpret_cast<float*>(ring + kStages * SB);           // [GM][kKeys]

  // q in registers: element e of head g at row element elem(e)
  const int Hq = a.Hkv * a.G;
  const QT* q = static_cast<const QT*>(a.q) + ((size_t)s * Hq + (size_t)h * a.G) * D;
  float qr[GM][8];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      qr[g][e] = g < a.G ? to_float(q[g * D + L8::elem(e, r, LK)]) : 0.f;
  __syncthreads();  // the table entries

  const int first = warp * kKeys;           // the warp's offset in a round
  const int len = ce - cs;
  const int nst = len > first ? (len - first + kTile - 1) / kTile : 0;
  const unsigned char* kp = static_cast<const unsigned char*>(a.k_pool);
  const unsigned char* vp = static_cast<const unsigned char*>(a.v_pool);

  // the copies of stage i into its ring slot (positions >= ce skipped)
  auto fetch = [&](int i) {
    unsigned char* slot = ring + (i % kStages) * SB;
    const int p0 = cs + i * kTile + first;
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      const int idx = lane + 32 * t;
      const int j = idx / CPR;
      const int piece = idx % CPR;
      const int pos = p0 + j;
      if (pos < ce) {
        const size_t row = (size_t)table_s[pos / a.bs - b0] * a.bs + pos % a.bs;
        const size_t off = (row * a.Hkv + h) * RB + piece * 16;
        cp_async_16(slot + j * RB + piece * 16, kp + off, true);
        cp_async_16(slot + (kKeys + j) * RB + piece * 16, vp + off, true);
      }
    }
    if (int8 && lane < 2 * kKeys) {
      const int j = lane % kKeys;
      const int pos = p0 + j;
      if (pos < ce) {
        const size_t row = (size_t)table_s[pos / a.bs - b0] * a.bs + pos % a.bs;
        const float* src = (lane < kKeys ? a.k_scale : a.v_scale) + row * a.Hkv + h;
        cp_async_4(slot + 2 * kKeys * RB + lane * 4, src, true);
      }
    }
  };

  float m[GM], l[GM], acc[GM][DL];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;  // this lane's key group's share of the sum
#pragma unroll
    for (int d = 0; d < DL; ++d) acc[g][d] = 0.f;
  }

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nst) fetch(i);
    cp_async_commit();
  }
  for (int i = 0; i < nst; ++i) {
    if (i + kStages - 1 < nst) fetch(i + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // stage i landed (this lane's copies)
    __syncwarp();                  // and every lane's
    const unsigned char* slot = ring + (i % kStages) * SB;
    const float* ks = reinterpret_cast<const float*>(slot + 2 * kKeys * RB);
    const float* vs = ks + kKeys;
    const int nk = min(kKeys, ce - (cs + i * kTile + first));  // valid keys, >= 1

    if constexpr (KPP == 1) {
      // D 256: a key takes the whole warp, so every lane ends its reduction
      // with the key's logit; lane j % kKeys keeps key j's, and the stage's
      // max and sum reduce over those 8 lanes (registers for 8 logits a
      // head, not 8 x 8)
      float xk[GM];
#pragma unroll
      for (int g = 0; g < GM; ++g) xk[g] = kNegInf;
#pragma unroll
      for (int p = 0; p < kKeys; ++p) {
        float kf[8];
        unpack8(slot + p * RB, r, LK, kf, KVT());
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) dot += qr[g][e] * kf[e];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
          const float kscale = int8 ? ks[p] : 1.f;
          const float x = p < nk ? dot * a.scale * kscale : kNegInf;
          if ((lane % kKeys) == p) xk[g] = x;
        }
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float mx = xk[g];
#pragma unroll
        for (int off = 1; off < kKeys; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[g], mx);
        const float alpha = expf(m[g] - m_new);
        m[g] = m_new;
        const float e = expf(xk[g] - m_new);
        if (lane < kKeys) p_s[g * kKeys + lane] = e;
        float psum = e;
#pragma unroll
        for (int off = 1; off < kKeys; off <<= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
        l[g] = l[g] * alpha + psum;
#pragma unroll
        for (int d = 0; d < DL; ++d) acc[g][d] *= alpha;
      }
    } else {
      // logits of the stage's keys: key p * KPP + grp in pass p
      float x[NP][GM];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int j = p * KPP + grp;
        float kf[8];
        unpack8(slot + j * RB, r, LK, kf, KVT());
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) dot += qr[g][e] * kf[e];
#pragma unroll
          for (int off = LK / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
          const float kscale = int8 ? ks[j] : 1.f;
          x[p][g] = j < nk ? dot * a.scale * kscale : kNegInf;  // a stale row is never used
        }
      }
      // online softmax per head: the stage's max, the rescale, P
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float mx = x[0][g];
#pragma unroll
        for (int p = 1; p < NP; ++p) mx = fmaxf(mx, x[p][g]);
#pragma unroll
        for (int off = LK; off < 32; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[g], mx);
        const float alpha = expf(m[g] - m_new);
        m[g] = m_new;
        float psum = 0.f;
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const float e = expf(x[p][g] - m_new);
          psum += e;
          if (r == 0) p_s[g * kKeys + p * KPP + grp] = e;
        }
        l[g] = l[g] * alpha + psum;
#pragma unroll
        for (int d = 0; d < DL; ++d) acc[g][d] *= alpha;
      }
    }
    __syncwarp();  // P visible to every lane
    // acc += P . V over the stage's valid keys
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      if (j < nk) {
        float vf[DL];
        load_v<DL>(slot + (kKeys + j) * RB, lane, vf, KVT());
        const float vscale = int8 ? vs[j] : 1.f;
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          const float pj = p_s[g * kKeys + j] * vscale;
#pragma unroll
          for (int d = 0; d < DL; ++d) acc[g][d] += pj * vf[d];
        }
      }
    }
    __syncwarp();  // the slot and P are free for the next stage
  }

  // the warps' states merged into the chunk's partial: each warp leaves
  // (acc [GM][D], m [GM], l [GM]) in its ring (an empty warp: 0, -1e30,
  // 0), then the block rescales them to their common max
  float* mine = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    float lt = l[g];
#pragma unroll
    for (int off = LK; off < 32; off <<= 1) lt += __shfl_xor_sync(0xffffffffu, lt, off);
#pragma unroll
    for (int d = 0; d < DL; ++d) mine[g * D + lane * DL + d] = acc[g][d];
    if (lane == 0) {
      mine[GM * D + g] = m[g];
      mine[GM * D + GM + g] = lt;
    }
  }
  __syncthreads();
  for (int i = tid; i < a.G * D; i += kThreads) {
    const int g = i / D;
    float wm[kWarps], wl[kWarps], big = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* st = reinterpret_cast<const float*>(smem + w * warp_smem_bytes<KVT, D, GM>());
      wm[w] = st[GM * D + g];
      wl[w] = st[GM * D + GM + g];
      if (wl[w] > 0.f) big = fmaxf(big, wm[w]);
    }
    float sum = 0.f, out = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* st = reinterpret_cast<const float*>(smem + w * warp_smem_bytes<KVT, D, GM>());
      const float wt = wl[w] > 0.f ? expf(wm[w] - big) : 0.f;
      sum += wt * wl[w];
      out += wt * st[i];
    }
    const size_t idx = ((size_t)s * Hq + (size_t)h * a.G + g) * a.parts + c;
    a.part_acc[idx * D + i % D] = out;
    if (i % D == 0) {
      a.part_ml[2 * idx] = big;
      a.part_ml[2 * idx + 1] = sum;
    }
  }
}

// Whether a split block at this pool type and width holds the SM alone:
// at D 256 an fp32 block's ring is 133 KB. ptxas is then told so (a
// minimum of 1 block an SM), or it caps a block at 128 registers for an
// occupancy that shared memory forbids, and G 2 spills.
template <typename KVT, int D>
constexpr bool kSoleBlock = D == 256 && sizeof(KVT) == 4;

template <typename QT, typename KVT, int D, int GM,
          std::enable_if_t<!kSoleBlock<KVT, D>, int> = 0>
__global__ void __launch_bounds__(kThreads) paged_decode_split_kernel(const Args a) {
  split_block<QT, KVT, D, GM>(a);
}

template <typename QT, typename KVT, int D, int GM,
          std::enable_if_t<kSoleBlock<KVT, D>, int> = 0>
__global__ void __launch_bounds__(kThreads, 1) paged_decode_split_kernel(const Args a) {
  split_block<QT, KVT, D, GM>(a);
}

// One warp per (slot, query head): the partials of the chunks that hold
// keys, merged in order. Grid ceil(S * Hq / kWarps), kThreads threads.
template <typename QT, int D>
__global__ void __launch_bounds__(kThreads) paged_decode_combine_kernel(const Args a) {
  constexpr int DL = D / 32;
  const int Hq = a.Hkv * a.G;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;  // s * Hq + head
  const int lane = threadIdx.x % 32;
  if (row >= a.S * Hq) return;
  const int s = row / Hq;
  int lo, hi;
  valid_span(a, s, lo, hi);
  // the split kernel wrote the partial of every chunk that starts below hi
  const int n = hi > lo ? (hi - lo + a.chunk - 1) / a.chunk : 0;
  const float2* ml = reinterpret_cast<const float2*>(a.part_ml) + (size_t)row * a.parts;
  const float* pacc = a.part_acc + (size_t)row * a.parts * D + lane * DL;

  float M = kNegInf;
  for (int p = lane; p < n; p += 32) {
    const float2 x = ml[p];
    if (x.y > 0.f) M = fmaxf(M, x.x);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
  float L = 0.f, o[DL];
#pragma unroll
  for (int d = 0; d < DL; ++d) o[d] = 0.f;
  for (int b = 0; b < n; b += 32) {
    const float2 x = b + lane < n ? ml[b + lane] : make_float2(kNegInf, 0.f);
    const float w = x.y > 0.f ? expf(x.x - M) : 0.f;  // an empty partial: weight 0
    L += w * x.y;
    const int cnt = min(32, n - b);
    // 8 partials' loads in flight at once; a lane past cnt has w = 0
    for (int k0 = 0; k0 < cnt; k0 += 8) {
      float v[8][DL];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float* src = pacc + (size_t)(b + min(k0 + k, cnt - 1)) * D;
#pragma unroll
        for (int d = 0; d < DL; ++d) v[k][d] = src[d];
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float wk = __shfl_sync(0xffffffffu, w, k0 + k);
#pragma unroll
        for (int d = 0; d < DL; ++d) o[d] += wk * v[k][d];
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) L += __shfl_xor_sync(0xffffffffu, L, off);
  QT* dst = static_cast<QT*>(a.out) + (size_t)row * D + lane * DL;
#pragma unroll
  for (int d = 0; d < DL; ++d) store(dst + d, L > 0.f ? o[d] / L : 0.f);  // no valid key: zeros
}

template <typename QT, typename KVT, int D, int GM>
cudaError_t launch(const Args& a, int chunks, cudaStream_t stream) {
  const size_t bytes = split_smem_bytes<KVT, D, GM>(a.chunk, a.bs);
  auto split = paged_decode_split_kernel<QT, KVT, D, GM>;
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(split, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  split<<<dim3(a.Hkv, a.S, chunks), kThreads, bytes, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows = a.S * a.Hkv * a.G;
  paged_decode_combine_kernel<QT, D><<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// GM: the group size the registers are laid out for, G rounded up to a
// power of two.
inline int group_slots(int G) { return G <= 1 ? 1 : G <= 2 ? 2 : G <= 4 ? 4 : 8; }

template <typename QT, typename KVT, int D>
cudaError_t dispatch_group(const Args& a, int chunks, cudaStream_t st) {
  switch (group_slots(a.G)) {
    case 1: return launch<QT, KVT, D, 1>(a, chunks, st);
    case 2: return launch<QT, KVT, D, 2>(a, chunks, st);
    case 4: return launch<QT, KVT, D, 4>(a, chunks, st);
    default: return launch<QT, KVT, D, 8>(a, chunks, st);
  }
}

// A head dim without an instance is refused (never sent to another
// instance's kernel).
template <typename QT, typename KVT>
cudaError_t dispatch_dim(const Args& a, int D, int chunks, cudaStream_t st) {
  switch (D) {
    case 64: return dispatch_group<QT, KVT, 64>(a, chunks, st);
    case 128: return dispatch_group<QT, KVT, 128>(a, chunks, st);
    case 256: return dispatch_group<QT, KVT, 256>(a, chunks, st);
    default: return cudaErrorInvalidValue;
  }
}

inline bool has_instance(int D) { return D == 64 || D == 128 || D == 256; }

template <typename KVT, int D>
size_t smem_for(int G, int chunk, int bs) {
  switch (group_slots(G)) {
    case 1: return split_smem_bytes<KVT, D, 1>(chunk, bs);
    case 2: return split_smem_bytes<KVT, D, 2>(chunk, bs);
    case 4: return split_smem_bytes<KVT, D, 4>(chunk, bs);
    default: return split_smem_bytes<KVT, D, 8>(chunk, bs);
  }
}

template <int D>
size_t smem_for_kv(int G, int chunk, int bs, int q_bf16, int kv_int8) {
  if (kv_int8) return smem_for<int8_t, D>(G, chunk, bs);
  return q_bf16 ? smem_for<__nv_bfloat16, D>(G, chunk, bs) : smem_for<float, D>(G, chunk, bs);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one split block, in bytes (0 for a head_dim
// the kernel does not take).
size_t paged_decode_split_smem_bytes(int D, int G, int chunk, int bs, int q_bf16, int kv_int8) {
  if (D == 64) return smem_for_kv<64>(G, chunk, bs, q_bf16, kv_int8);
  if (D == 128) return smem_for_kv<128>(G, chunk, bs, q_bf16, kv_int8);
  if (D == 256) return smem_for_kv<256>(G, chunk, bs, q_bf16, kv_int8);
  return 0;
}

// Launches the split kernel and the combine kernel on `stream` and returns
// the launch status (cudaSuccess == 0). q_bf16: q, out (and fp pools) are
// bfloat16, else float32. kv_int8: the pools are int8 and k_scale/v_scale
// hold their fp32 scales. window <= 0 means no sliding window. `chunk`
// positions per split block (a multiple of 32 and of bs), `chunks` blocks
// per (slot, kv head), enough to cover the walked span. `workspace` holds
// S * Hq * chunks * (D + 2) floats. The pools must be 16-byte aligned.
// Allocates nothing and does not synchronize.
int paged_decode_attention_launch(const void* q, const void* k_pool, const void* v_pool,
                                  const void* k_scale, const void* v_scale,
                                  const void* block_tables, const void* context_lens,
                                  void* out, void* workspace, int S, int Hq, int Hkv, int D,
                                  int bs, int nb, int table_stride, int chunk, int chunks,
                                  float scale, int window, int q_bf16, int kv_int8,
                                  void* stream) {
  if (S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxGroup || bs <= 0 || bs % 4 != 0 ||
      nb < 0 || table_stride < nb || (kv_int8 && (k_scale == nullptr || v_scale == nullptr)) ||
      reinterpret_cast<uintptr_t>(k_pool) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v_pool) % 16 != 0 || !has_instance(D) || chunk <= 0 ||
      chunk % kTile != 0 || chunk % bs != 0 || chunks <= 0 || chunks > 65535 || S > 65535)
    return (int)cudaErrorInvalidValue;
  const long span = window > 0 ? (long)(window < nb * bs ? window : nb * bs) : (long)nb * bs;
  if ((long)chunk * chunks < span) return (int)cudaErrorInvalidValue;  // positions left out
  const int G = Hq / Hkv;
  if (paged_decode_split_smem_bytes(D, G, chunk, bs, q_bf16, kv_int8) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k_pool = k_pool;
  a.v_pool = v_pool;
  a.k_scale = kv_int8 ? static_cast<const float*>(k_scale) : nullptr;
  a.v_scale = kv_int8 ? static_cast<const float*>(v_scale) : nullptr;
  a.block_tables = static_cast<const int*>(block_tables);
  a.context_lens = static_cast<const int*>(context_lens);
  a.out = out;
  a.parts = chunks;
  a.part_ml = static_cast<float*>(workspace);
  a.part_acc = a.part_ml + (size_t)S * Hq * a.parts * 2;
  a.S = S;
  a.Hkv = Hkv;
  a.G = G;
  a.bs = bs;
  a.nb = nb;
  a.table_stride = table_stride;
  a.window = window;
  a.chunk = chunk;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (kv_int8)
    err = q_bf16 ? dispatch_dim<__nv_bfloat16, int8_t>(a, D, chunks, st)
                 : dispatch_dim<float, int8_t>(a, D, chunks, st);
  else
    err = q_bf16 ? dispatch_dim<__nv_bfloat16, __nv_bfloat16>(a, D, chunks, st)
                 : dispatch_dim<float, float>(a, D, chunks, st);
  return (int)err;
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
