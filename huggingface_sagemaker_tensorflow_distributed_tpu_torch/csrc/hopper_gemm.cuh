// A pipelined GEMM core for Hopper (sm_90a): for each 128 x 128 tile of
// C [M, N], acc = Σ_p A_{a(p)} · B_{b(p)}ᵀ over up to a few bf16 products
// that share one K loop, every operand K-major in device memory (row-major
// [rows, K] bf16), fp32 accumulators in registers, then an epilogue that
// the caller supplies. The vocab-CE backward (vocab_ce_bwd.cuh) builds its
// three products on it; it replaces no TPU kernel by itself.
//
// Bound: operations (2·M·N·K a product at 989 TFLOP/s) for the shapes it
// is used at. What the design does about it:
// - one producer warp keeps TMA loads (`cp.async.bulk.tensor`, one thread)
//   in flight into a ring of stages in shared memory (192 KB: 3 stages of
//   four 16 KB operand tiles, or 6 of two); each stage has a `full`
//   barrier (the TMA's bytes arrive on it) and an `empty` one (every
//   consumer thread arrives once it no longer reads the stage);
// - two consumer warpgroups take 64 rows of the tile each and issue
//   `wgmma.mma_async` m64n128k16 (bf16 in, fp32 out) straight from shared
//   memory: operands are 128 x 64 bf16 boxes that TMA writes with the
//   128-byte swizzle, which the wgmma descriptors name, so no thread copies
//   an operand and no `ldmatrix` runs; one wgmma group a stage stays in
//   flight while the next is issued;
// - the grid is persistent: min(tiles, SMs) blocks walk the tiles in a
//   static order (M fastest, so the blocks in flight share B tiles in L2),
//   and a block's epilogue overlaps the producer's loads of its next tile;
// - split-K: `splits` > 1 cuts K into that many ranges, each its own tile
//   (the caller's epilogue gets the range's index and keeps the sums apart,
//   so the result does not depend on the schedule); a range past K leaves
//   the accumulators zero;
// - ragged M, N and K are TMA's: a box that reaches past a tensor map's
//   extent is filled with zeros, so the products stay exact, and the
//   epilogue stores only what lies inside.
// A barrier wait that spins past kSpinLimit tries traps: a schedule fault
// ends the kernel with an error instead of hanging the card.
//
// Each PTX instruction sits in its own one-line wrapper below, so a CPU
// emulator can stand in for them.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace hopper {

constexpr int kBM = 128;                       // tile rows (M)
constexpr int kBN = 128;                       // tile columns (N)
constexpr int kBK = 64;                        // depth of a stage: 64 bf16, one 128-byte swizzle row
constexpr int kOperandBytes = kBM * kBK * 2;   // one A or B box (kBM == kBN): 16 KB
constexpr int kConsumerGroups = 2;             // wgmma warpgroups, 64 tile rows each
constexpr int kGemmThreads = 128 * (1 + kConsumerGroups);  // + the producer warpgroup
constexpr int kRingBytes = 196608;             // the stage ring
constexpr int kSmemBytes = kRingBytes + 1024 + 256;  // + 1024-byte alignment + barriers
constexpr long long kSpinLimit = 1LL << 26;

// ---------------------------------------------------------------------------
// one wrapper per PTX instruction
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive once and expect `bytes` more of transactions in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// whether the phase of parity `parity` has completed
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n" : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  return done != 0;
}

// box (c0, c1) of `map` (c0 the inner, K, coordinate) into shared memory
// at `dst`; its bytes complete a transaction on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1) : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

// wait until at most N committed wgmma groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory"); }

// d[64] (a warpgroup's 64 x 128 fp32 tile) += A (64 x 16, descriptor a) ·
// Bᵀ (B 128 x 16, descriptor b), both K-major bf16 in shared memory.
// Thread t of the warpgroup holds rows 16 (t / 32) + (t % 32) / 4 (+ 8) and,
// for each 8-column block j, columns 8 j + 2 (t % 4) (+ 1): d[4 j + 2 i + e]
// is row + 8 i, column 8 j + 2 (t % 4) + e.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// pins the accumulators after a wgmma wait: no read of them moves above it
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ---------------------------------------------------------------------------
// the core
// ---------------------------------------------------------------------------

// A wgmma descriptor of a K-major operand in shared memory that TMA wrote
// with the 128-byte swizzle: 8-row groups 1024 bytes apart (SBO 64 units
// of 16 bytes), the leading offset unused (1), layout SWIZZLE_128B. Adding
// 2 to it steps 16 bf16 (32 bytes) along K inside the 128-byte rows.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (long long spin = 0; !mbar_try_wait(bar, parity); ++spin)
    if (spin == kSpinLimit) __trap();
}

template <int NA, int NB>
struct GemmMaps {
  CUtensorMap a[NA];
  CUtensorMap b[NB];
};

struct GemmShape {
  int M, N, K;  // C [M, N], depth K
  int splits;   // K ranges, each its own tile
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// tile t of the static schedule: rows m0.., columns n0.., K range s
struct TileCoord {
  int m0, n0, s, kb0, kb1;
};

__device__ __forceinline__ TileCoord tile_coord(const GemmShape& sh, int t) {
  const int tiles_m = cdiv(sh.M, kBM), tiles_n = cdiv(sh.N, kBN);
  const int nkb = cdiv(sh.K, kBK), per = cdiv(nkb, sh.splits);
  TileCoord c;
  c.m0 = (t % tiles_m) * kBM;
  c.n0 = (t / tiles_m % tiles_n) * kBN;
  c.s = t / (tiles_m * tiles_n);
  c.kb0 = min(nkb, c.s * per);
  c.kb1 = min(nkb, c.kb0 + per);
  return c;
}

__host__ __device__ constexpr int gemm_tiles(const GemmShape& sh) {
  return cdiv(sh.M, kBM) * cdiv(sh.N, kBN) * sh.splits;
}

// The kernel body. Plan: kA A operands and kB B operands a stage, kP
// products, product p = A[a_of(p)] · B[b_of(p)]ᵀ. Epi: a callable
// epi(acc, row, col, s) with this thread's rows row, row + 8 and first
// column col of the tile (the layout of wgmma_m64n128k16), and the K range.
template <class Plan, class Epi>
__device__ __forceinline__ void gemm_body(const GemmMaps<Plan::kA, Plan::kB>& maps,
                                          const GemmShape& sh, const Epi& epi) {
  constexpr int kStageBytes = (Plan::kA + Plan::kB) * kOperandBytes;
  constexpr int kStages = kRingBytes / kStageBytes;
  static_assert(kStages >= 3, "a ring of at least three stages");
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kRingBytes);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x, wg = tid / 128;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * kConsumerGroups);
    }
    fence_mbar_init();
  }
  __syncthreads();
  const int tiles = gemm_tiles(sh);

  if (wg == 0) {
    // the producer: one thread issues every load
    if (tid != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const TileCoord c = tile_coord(sh, t);
      for (int kb = c.kb0; kb < c.kb1; ++kb) {
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* st = ring + stage * kStageBytes;
        mbar_expect_tx(&full[stage], kStageBytes);
#pragma unroll
        for (int i = 0; i < Plan::kA; ++i)
          tma_load_2d(st + i * kOperandBytes, &maps.a[i], &full[stage], kb * kBK, c.m0);
#pragma unroll
        for (int i = 0; i < Plan::kB; ++i)
          tma_load_2d(st + (Plan::kA + i) * kOperandBytes, &maps.b[i], &full[stage], kb * kBK, c.n0);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // the consumers: warpgroup cg takes rows 64 cg.. of each tile
  const int cg = wg - 1, warp = (tid % 128) / 32, lane = tid % 32;
  int stage = 0;
  uint32_t phase = 0;
  float acc[64];
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const TileCoord c = tile_coord(sh, t);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    int held = -1;  // the stage the wgmma group in flight reads
    for (int kb = c.kb0; kb < c.kb1; ++kb) {
      mbar_wait(&full[stage], phase);
      const uint8_t* st = ring + stage * kStageBytes;
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < Plan::kP; ++p) {
        const uint64_t da = sw128_desc(st + Plan::a_of(p) * kOperandBytes + cg * (kOperandBytes / 2));
        const uint64_t db = sw128_desc(st + (Plan::kA + Plan::b_of(p)) * kOperandBytes);
#pragma unroll
        for (int k = 0; k < kBK / 16; ++k) wgmma_m64n128k16(acc, da + 2 * k, db + 2 * k);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the group before this one is done: its stage is free
      if (held >= 0) mbar_arrive(&empty[held]);
      held = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (held >= 0) mbar_arrive(&empty[held]);
    epi(acc, c.m0 + cg * 64 + warp * 16 + lane / 4, c.n0 + 2 * (lane % 4), c.s);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, from the libcuda.so.1 the runtime
// has loaded (no link against the driver library).
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr) fn = reinterpret_cast<EncodeTiledFn>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A tensor map of a K-major bf16 operand: `rows` x `cols` (cols = K) with
// a row stride of `ld` elements, boxes of 128 rows x 64 columns written
// with the 128-byte swizzle, zeros past the extent. Returns a cudaError_t.
inline int make_operand_map(CUtensorMap* map, const void* base, long long rows, long long cols,
                            long long ld) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  if (rows <= 0 || cols <= 0 || (ld * 2) % 16 != 0 || (reinterpret_cast<uintptr_t>(base) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)kBM};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
}

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

// Launches kernel (a __global__ wrapper of gemm_body) on a persistent grid
// of min(tiles, SMs) blocks; returns the launch status.
template <class Maps, class Epi>
int launch_gemm(void (*kernel)(const Maps, const GemmShape, const Epi), const Maps& maps,
                const GemmShape& sh, const Epi& epi, cudaStream_t stream) {
  const int tiles = gemm_tiles(sh);
  if (tiles <= 0) return (int)cudaSuccess;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  const int grid = tiles < sm_count() ? tiles : sm_count();
  kernel<<<grid, kGemmThreads, kSmemBytes, stream>>>(maps, sh, epi);
  return (int)cudaGetLastError();
}

}  // namespace hopper
