// Paged single-token decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `ops/pallas_paged_attention.py::_paged_kernel`
// of the JAX package (reached through `_paged_call`): one query per
// slot attends over that slot's KV, read straight out of the paged pools
// through its block table, with GQA query grouping, context and
// sliding-window masking, in-tile int8 dequantization, fp32 softmax and
// accumulation, and zeros for rows with no valid key (context 0).
//
// Bound on an H100: memory. Per layer the kernel must read
// sum_s ctx_s * Hkv * D * 2 K/V elements (plus one fp32 scale per
// position and head for int8 pools) and does about 4 flops per K/V
// element pair per query head, far below the card's ~20 flops per byte
// of fp32 balance point, so the floor is those bytes over 3.35 TB/s.
//
// What the design does about it:
// - one thread block per (slot, kv_head). The block reads its own row of
//   the block table and its context length, then loops over the context
//   in tiles of kTile positions; the TPU kernel's sequential grid axis
//   becomes this loop, and the online-softmax state (running max, sum
//   and the [G, D] accumulator) stays in shared memory across it;
// - each K/V element is read from device memory once per group: the
//   G = Hq / Hkv query heads that share a KV head are computed against
//   every tile while it sits in shared memory, so a GQA model does not
//   read its KV G times;
// - only the positions that can hold a valid key are walked:
//   [max(0, ctx - window), min(ctx, nb * bs)). Tiles past the context or
//   below the band are never loaded, so the bytes read follow the data;
// - a tile is read with 16-byte loads, all of a thread's loads of the
//   tile issued together, and the next tile's loads are issued into
//   registers before the current tile is computed, so one tile's memory
//   latency overlaps the previous tile's arithmetic.
// With one block per (slot, kv_head) a decode batch fills only
// slots * Hkv SMs and each block walks its context alone; split-K over
// the context (flash-decoding), cp.async / TMA and tensor cores are left
// for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;          // context positions per tile; equals the warp width
constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// 16 bytes of pool elements -> 16 / sizeof(T) floats.
__device__ __forceinline__ void unpack(const uint4& r, float* f, float) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}

__device__ __forceinline__ void unpack(const uint4& r, float* f, __nv_bfloat16) {
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 x = __bfloat1622float2(b[k]);
    f[2 * k] = x.x;
    f[2 * k + 1] = x.y;
  }
}

__device__ __forceinline__ void unpack(const uint4& r, float* f, int8_t) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&r);
#pragma unroll
  for (int k = 0; k < 16; ++k) f[k] = static_cast<float>(b[k]);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Shared-memory floats one block needs for a group of G query heads.
__host__ __device__ constexpr size_t smem_floats(int G, int D) {
  return 2 * (size_t)G * D                  // q, accumulator
         + 2 * (size_t)kTile * D            // K and V tiles
         + (size_t)G * kTile                // logits / probabilities of the tile
         + 3 * (size_t)G;                   // running max, running sum, rescale factor
}

// One thread's share of a K/V tile, held in registers between the load
// and the store to shared memory.
template <typename KVT, int D>
struct TileRegs {
  static constexpr int kVec = 16 / sizeof(KVT);          // elements per 16-byte load
  static constexpr int kVecPerRow = D / kVec;
  static constexpr int kPerThread = kTile * kVecPerRow / kThreads;
  static_assert(kTile * kVecPerRow % kThreads == 0, "tile must split evenly");
  uint4 k[kPerThread];
  uint4 v[kPerThread];
  float ks[kPerThread];
  float vs[kPerThread];
};

// q [S, Hkv*G, D]; pools [N, bs, Hkv, D]; scale pools [N, bs, Hkv, 1] fp32
// or null; block_tables [S, table_stride] int32 of which the first nb
// columns are walked; context_lens [S] int32; out [S, Hkv*G, D].
template <typename QT, typename KVT, int D>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const QT* __restrict__ q, const KVT* __restrict__ k_pool, const KVT* __restrict__ v_pool,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ block_tables, const int* __restrict__ context_lens,
    QT* __restrict__ out, int Hkv, int G, int bs, int nb, int table_stride, float scale,
    int window) {
  using Regs = TileRegs<KVT, D>;
  extern __shared__ float smem[];
  float* q_s = smem;                    // [G][D]
  float* acc_s = q_s + G * D;           // [G][D]
  float* k_s = acc_s + G * D;           // [kTile][D]
  float* v_s = k_s + kTile * D;         // [kTile][D]
  float* p_s = v_s + kTile * D;         // [G][kTile]
  float* m_s = p_s + G * kTile;         // [G]
  float* l_s = m_s + G;                 // [G]
  float* alpha_s = l_s + G;             // [G]

  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int Hq = Hkv * G;
  const int ctx = context_lens[s];
  // positions that can hold a valid key: below the context, inside the
  // walked table span, and (with a window) inside the band
  // 0 <= (ctx - 1) - pos < window
  const int hi = min(ctx, nb * bs);
  const int lo = window > 0 ? max(0, ctx - window) : 0;
  const int* table = block_tables + (size_t)s * table_stride;
  const bool int8 = k_scale != nullptr;

  // issue every load of the tile starting at t0 (positions >= hi skipped)
  auto load_tile = [&](Regs& r, int t0) {
#pragma unroll
    for (int i = 0; i < Regs::kPerThread; ++i) {
      const int vec = tid + i * kThreads;
      const int pos = t0 + vec / Regs::kVecPerRow;
      if (pos < hi) {
        const size_t row = (size_t)table[pos / bs] * bs + pos % bs;  // pool row of `pos`
        const size_t off = (row * Hkv + h) * D + (vec % Regs::kVecPerRow) * Regs::kVec;
        r.k[i] = __ldg(reinterpret_cast<const uint4*>(k_pool + off));
        r.v[i] = __ldg(reinterpret_cast<const uint4*>(v_pool + off));
        if (int8) {
          r.ks[i] = __ldg(k_scale + row * Hkv + h);
          r.vs[i] = __ldg(v_scale + row * Hkv + h);
        }
      }
    }
  };
  // registers -> shared memory as fp32, dequantized for int8 pools
  auto store_tile = [&](const Regs& r, int n) {
#pragma unroll
    for (int i = 0; i < Regs::kPerThread; ++i) {
      const int vec = tid + i * kThreads;
      const int j = vec / Regs::kVecPerRow;
      if (j < n) {
        float kf[Regs::kVec], vf[Regs::kVec];
        unpack(r.k[i], kf, KVT());
        unpack(r.v[i], vf, KVT());
        float* kd = k_s + j * D + (vec % Regs::kVecPerRow) * Regs::kVec;
        float* vd = v_s + j * D + (vec % Regs::kVecPerRow) * Regs::kVec;
#pragma unroll
        for (int e = 0; e < Regs::kVec; ++e) {
          kd[e] = int8 ? kf[e] * r.ks[i] : kf[e];
          vd[e] = int8 ? vf[e] * r.vs[i] : vf[e];
        }
      }
    }
  };

  const size_t head0 = (size_t)s * Hq + (size_t)h * G;
  const QT* q_row = q + head0 * D;
  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i] = to_float(q_row[i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  Regs regs;
  if (lo < hi) load_tile(regs, lo);
  for (int t0 = lo; t0 < hi; t0 += kTile) {
    const int n = min(kTile, hi - t0);
    store_tile(regs, n);
    __syncthreads();
    if (t0 + kTile < hi) load_tile(regs, t0 + kTile);   // in flight during the math below
    // logits: one warp per position, lanes across head_dim
    for (int j = warp; j < n; j += kWarps) {
      const float* kj = k_s + j * D;
      for (int g = 0; g < G; ++g) {
        const float* qg = q_s + g * D;
        float dot = 0.f;
#pragma unroll
        for (int d = lane; d < D; d += 32) dot += qg[d] * kj[d];
        dot = warp_sum(dot);
        if (lane == 0) p_s[g * kTile + j] = dot * scale;
      }
    }
    __syncthreads();
    // online softmax: one warp per head, one lane per tile position
    for (int g = warp; g < G; g += kWarps) {
      float* pg = p_s + g * kTile;
      const float x = lane < n ? pg[lane] : kNegInf;
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(x));
      const float p = lane < n ? expf(x - m_new) : 0.f;
      const float tile_sum = warp_sum(p);
      if (lane < n) pg[lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + tile_sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // rescale the accumulator and add P.V
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D;
      const int d = i % D;
      const float* pg = p_s + g * kTile;
      float pv = 0.f;
      for (int j = 0; j < n; ++j) pv += pg[j] * v_s[j * D + d];
      acc_s[i] = acc_s[i] * alpha_s[g] + pv;
    }
    __syncthreads();
  }
  __syncthreads();  // the initialisation above when no tile ran

  QT* o_row = out + head0 * D;
  for (int i = tid; i < G * D; i += kThreads) {
    const float l = l_s[i / D];
    store(o_row + i, l == 0.f ? 0.f : acc_s[i] / l);  // no valid key: zeros
  }
}

template <typename QT, typename KVT, int D>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
                   const void* v_scale, const void* block_tables, const void* context_lens,
                   void* out, int S, int Hkv, int G, int bs, int nb, int table_stride,
                   float scale, int window, cudaStream_t stream) {
  const size_t bytes = smem_floats(G, D) * sizeof(float);
  auto kernel = paged_decode_kernel<QT, KVT, D>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(Hkv, S), kThreads, bytes, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k_pool),
      static_cast<const KVT*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(block_tables),
      static_cast<const int*>(context_lens), static_cast<QT*>(out), Hkv, G, bs, nb,
      table_stride, scale, window);
  return cudaGetLastError();
}

template <typename QT, int D>
cudaError_t dispatch_kv(int kv_int8, const void* q, const void* k_pool, const void* v_pool,
                        const void* k_scale, const void* v_scale, const void* block_tables,
                        const void* context_lens, void* out, int S, int Hkv, int G, int bs,
                        int nb, int table_stride, float scale, int window,
                        cudaStream_t stream) {
  if (kv_int8)
    return launch<QT, int8_t, D>(q, k_pool, v_pool, k_scale, v_scale, block_tables,
                                 context_lens, out, S, Hkv, G, bs, nb, table_stride, scale,
                                 window, stream);
  return launch<QT, QT, D>(q, k_pool, v_pool, nullptr, nullptr, block_tables, context_lens,
                           out, S, Hkv, G, bs, nb, table_stride, scale, window, stream);
}

template <int D>
cudaError_t dispatch_q(int q_bf16, int kv_int8, const void* q, const void* k_pool,
                       const void* v_pool, const void* k_scale, const void* v_scale,
                       const void* block_tables, const void* context_lens, void* out, int S,
                       int Hkv, int G, int bs, int nb, int table_stride, float scale,
                       int window, cudaStream_t stream) {
  if (q_bf16)
    return dispatch_kv<__nv_bfloat16, D>(kv_int8, q, k_pool, v_pool, k_scale, v_scale,
                                         block_tables, context_lens, out, S, Hkv, G, bs, nb,
                                         table_stride, scale, window, stream);
  return dispatch_kv<float, D>(kv_int8, q, k_pool, v_pool, k_scale, v_scale, block_tables,
                               context_lens, out, S, Hkv, G, bs, nb, table_stride, scale,
                               window, stream);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the launch status (cudaSuccess == 0).
// q_bf16: q, out (and fp pools) are bfloat16, else float32. kv_int8: the
// pools are int8 and k_scale/v_scale hold their fp32 scales. window <= 0
// means no sliding window. The pools must be 16-byte aligned. Allocates
// nothing and does not synchronize.
int paged_decode_attention_launch(const void* q, const void* k_pool, const void* v_pool,
                                  const void* k_scale, const void* v_scale,
                                  const void* block_tables, const void* context_lens,
                                  void* out, int S, int Hq, int Hkv, int D, int bs, int nb,
                                  int table_stride, float scale, int window, int q_bf16,
                                  int kv_int8, void* stream) {
  if (S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || bs <= 0 || bs % 4 != 0 || nb < 0 ||
      table_stride < nb || (kv_int8 && (k_scale == nullptr || v_scale == nullptr)) ||
      reinterpret_cast<uintptr_t>(k_pool) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v_pool) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  if (smem_floats(G, D) * sizeof(float) > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)dispatch_q<64>(q_bf16, kv_int8, q, k_pool, v_pool, k_scale, v_scale,
                                 block_tables, context_lens, out, S, Hkv, G, bs, nb,
                                 table_stride, scale, window, st);
    case 128:
      return (int)dispatch_q<128>(q_bf16, kv_int8, q, k_pool, v_pool, k_scale, v_scale,
                                  block_tables, context_lens, out, S, Hkv, G, bs, nb,
                                  table_stride, scale, window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
