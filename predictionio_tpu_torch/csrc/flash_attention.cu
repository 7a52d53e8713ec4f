// Forward flash attention for Hopper (sm_90a), plain C entry point.
//
// Replaces: predictionio_tpu/ops/pallas_attention.py `_flash_kernel`
// (launched by `pl.pallas_call` in `_flash_call`, dispatched by
// `flash_attention`). Same function: attention over (B, H, S, D)
// flattened to (B*H, S, D), scale 1/sqrt(D) (given by the caller, so a
// head dim zero-padded up to D keeps its own scale), a per-key mask (B, S)
// shared by the heads, an optional causal mask, an online softmax whose
// running max, denominator and numerator are f32, and zero output for a
// row whose keys are all masked. Output in q's dtype.
//
// Beyond the Pallas kernel, two things a grouped-query, sliding-window
// model needs (models/moe_seqrec.py):
// - GQA: k and v hold H_kv heads that divide q's H; query head h of row
//   b reads KV head h / (H / H_kv) of that row. With bh = b*H + h that is
//   KV row bh / group of the (B*H_kv, S, D) K/V, so the K/V tensor maps
//   and the f32 route's K/V pointers index by bh / group and no copy of
//   K or V is made. group = 1 is the MHA path, unchanged.
// - A sliding window W (> 0): query i sees keys j with i - W < j <= i.
//   A query tile starting at q0 starts its key loop at the tile that
//   holds key q0 - W + 1, so tiles wholly before the window are never
//   loaded; a tile that crosses the window's lower edge is masked as a
//   diagonal tile is. W = 0 is no window: the key loop starts at tile 0,
//   as before.
//
// Bound at the serving shape (B=1, H=4, S=2048, D=64, bf16, causal):
// QK^T and PV over the S(S+1)/2 causal pairs are 4*D flops a pair,
// 4 * 2048*2049/2 * 256 = 2.15 GFLOP, 2.2 us at the card's 989 TFLOP/s
// bf16 tensor-core rate; q, k, v and o are 4 * 2048*64*4 * 2 B = 4.2 MB,
// 1.3 us at 3.35 TB/s. The bound is compute: about 2.2 us per launch.
//
// bfloat16, the serving route (`flash_fwd_bf16_wgmma`). Both products run
// on the tensor cores with wgmma, which is the only way to that rate.
// Each block owns one 64-row query tile of one (b, h), the M of one wgmma
// (a 128-row tile would leave half of the 132 SMs idle at B=1, where the
// grid is 4 heads x 32 tiles). One producer warp loads Q once and each
// 64-key K/V tile by TMA into a ring of four shared-memory stages, each
// with a full and an empty mbarrier; a 3-D tensor map over (D, S, B*H)
// makes a tile that runs past S fill with zeros inside its own head.
// Tiles land swizzled (128B for 128-byte rows, 64B for D=32, 32B for
// D=16; D=128 is two 64-column boxes) in the layout wgmma reads. Two
// consumer warpgroups share the query tile and take every other KV tile,
// so one's softmax overlaps the other's products; each keeps its own
// running statistics, and the first merges the second's at the end.
// QK^T takes Q and K from shared memory, both K-major; the f32 logits
// stay in registers, where the online softmax works on the accumulator
// layout (a row spread over four threads, reduced with shuffles, in the
// log2 domain); P is rounded to bf16 in registers and is the A operand
// of PV, whose B is the V tile read MN-major (transposed) from shared
// memory. The denominator sums the f32 P; rounding P to bf16 before PV is
// the one numerical change from the f32 reference
// (tests/test_torch_flash_attention.py emulates it tile by tile against
// the JAX kernel). The key mask is read coalesced a tile ahead and turned
// into bit words by a warp ballot; only a tile with a padded key or one
// that crosses the diagonal is masked. Causal blocks stop at the
// diagonal; query tiles are issued longest-first across all heads.
//
// What is left for later: within a warpgroup the softmax and the two
// products still run in turn; at B=1 the time is the longest causal
// block (32 tiles of 64 keys on one SM), which split-KV across blocks
// would shorten; no FP8, no persistent grid.
//
// Prediction, written before the first timed run: 0.015-0.030 ms at
// (1,4,2048,64) bf16 causal (7-15 % of the bound), 0.05-0.10 ms at
// (8,4,2048,64). Measured (chip_smoke.py, 100 back-to-back launches, on
// an NVIDIA H100 80GB HBM3 at a 700 W limit): 0.0182 ms at B=1 (12 % of
// the bound) and 0.0579 ms at B=8 (30 %), with 64-key tiles. 128-key
// tiles took 0.0353 and 0.1568 ms: they need 168 registers a thread, so
// one block fits on an SM; the KV tile is therefore fixed at 64 keys. A first version with one consumer warpgroup,
// which read the key mask one key at a time, was several times slower:
// the serial mask loads, then the softmax's latency, set its time.
//
// float32 (`flash_fwd_f32_simt`) keeps this kernel's first, CUDA-core
// design, for exactness: wgmma on f32 operands would be TF32, which the
// f32 tolerance rules out. One block per (b*h, 64-row query tile), 256
// threads, four threads per query row, K/V tiles staged as f32 in shared
// memory, both products as f32 FMAs on the CUDA cores.

#include <cuda.h>  // CUtensorMap and its enums; the driver call is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kTileQ = 64;

// ------------------------------------------------------------------ f32

constexpr int kSimtTileK = 64;
constexpr int kThreadsPerRow = 4;
constexpr int kSimtThreads = kTileQ * kThreadsPerRow;           // 256
constexpr int kKeysPerThread = kSimtTileK / kThreadsPerRow;     // 16
constexpr int kLdP = kSimtTileK + 1;

template <int D>
constexpr size_t simt_smem_bytes() {
  // sQ, sK: kTile x (D+1); sV: kTileK x D; sP: kTileQ x kLdP; sMask: kTileK
  return sizeof(float) * (size_t(kTileQ) * (D + 1) + size_t(kSimtTileK) * (D + 1) +
                          size_t(kSimtTileK) * D + size_t(kTileQ) * kLdP + kSimtTileK);
}

template <int D>
__global__ void __launch_bounds__(kSimtThreads)
flash_fwd_f32_simt(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ kv_mask,
                   float* __restrict__ out, int heads, int group, int seq_len, int causal,
                   int window, float scale) {
  static_assert(D % kThreadsPerRow == 0, "D must split over the threads of a row");
  constexpr int kLd = D + 1;
  constexpr int kCols = D / kThreadsPerRow;

  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTileQ * kLd;
  float* sV = sK + kSimtTileK * kLd;
  float* sP = sV + kSimtTileK * D;
  float* sMask = sP + kTileQ * kLdP;

  const int qtile = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const size_t base = size_t(bh) * seq_len * D;
  const size_t kv_base = size_t(bh / group) * seq_len * D;  // GQA: this head's KV row
  const int q0 = qtile * kTileQ;
  const int tid = threadIdx.x;
  const int row = tid / kThreadsPerRow;
  const int sub = tid % kThreadsPerRow;
  const int q_pos = q0 + row;

  for (int i = tid; i < kTileQ * D; i += kSimtThreads) {
    const int r = i / D, d = i - r * D;
    const int s = q0 + r;
    sQ[r * kLd + d] = s < seq_len ? q[base + size_t(s) * D + d] : 0.f;
  }

  float m = kNeg;  // running max of this row's logits
  float l = 0.f;   // running softmax denominator
  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;

  int n_kv = (seq_len + kSimtTileK - 1) / kSimtTileK;
  if (causal) n_kv = min(n_kv, (q0 + kTileQ + kSimtTileK - 1) / kSimtTileK);  // stop at the diagonal
  // a window starts at the tile of the tile's first row's first key
  const int t_lo = window > 0 ? max(0, q0 - window + 1) / kSimtTileK : 0;

  for (int t = t_lo; t < n_kv; ++t) {
    const int k0 = t * kSimtTileK;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int i = tid; i < kSimtTileK * D; i += kSimtThreads) {
      const int j = i / D, d = i - j * D;
      const int s = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (s < seq_len) {
        kx = k[kv_base + size_t(s) * D + d];
        vx = v[kv_base + size_t(s) * D + d];
      }
      sK[j * kLd + d] = kx;
      sV[j * D + d] = vx;
    }
    if (tid < kSimtTileK) {
      const int s = k0 + tid;
      sMask[tid] = s < seq_len ? kv_mask[size_t(b) * seq_len + s] : 0.f;
    }
    __syncthreads();

    // logits of keys j = jj*4 + sub for this thread's row
    float logit[kKeysPerThread];
#pragma unroll
    for (int jj = 0; jj < kKeysPerThread; ++jj) logit[jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = sQ[row * kLd + d];
#pragma unroll
      for (int jj = 0; jj < kKeysPerThread; ++jj)
        logit[jj] = fmaf(qd, sK[(jj * kThreadsPerRow + sub) * kLd + d], logit[jj]);
    }

    unsigned valid_bits = 0;
    float tile_max = kNeg;
#pragma unroll
    for (int jj = 0; jj < kKeysPerThread; ++jj) {
      const int j = jj * kThreadsPerRow + sub;
      const bool valid = sMask[j] > 0.f && (!causal || k0 + j <= q_pos) &&
                         (window <= 0 || k0 + j > q_pos - window);
      valid_bits |= unsigned(valid) << jj;
      logit[jj] = valid ? logit[jj] * scale : kNeg;
      tile_max = fmaxf(tile_max, logit[jj]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));

    const float m_new = fmaxf(m, tile_max);
    const bool seen = m_new > kNeg * 0.5f;  // any valid key so far
    const float alpha = seen ? expf(m - m_new) : 0.f;
    float row_sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < kKeysPerThread; ++jj) {
      const bool valid = (valid_bits >> jj) & 1u;
      const float p = (valid && seen) ? expf(logit[jj] - m_new) : 0.f;
      sP[row * kLdP + jj * kThreadsPerRow + sub] = p;
      row_sum += p;
    }
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 1);
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 2);
    l = l * alpha + row_sum;
    m = m_new;
    __syncwarp();  // a row's four threads share one warp: its P is complete

#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] *= alpha;
#pragma unroll 4
    for (int j = 0; j < kSimtTileK; ++j) {
      const float p = sP[row * kLdP + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        acc[c] = fmaf(p, sV[j * D + c * kThreadsPerRow + sub], acc[c]);
    }
  }

  if (q_pos < seq_len) {
    const float denom = fmaxf(l, 1e-20f);
    float* o = out + base + size_t(q_pos) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[c * kThreadsPerRow + sub] = l > 0.f ? acc[c] / denom : 0.f;
  }
}

template <int D>
cudaError_t launch_f32_simt(const void* q, const void* k, const void* v, const void* kv_mask,
                            void* out, int batch_heads, int heads, int group, int seq_len,
                            int causal, int window, double softmax_scale, cudaStream_t stream) {
  constexpr size_t smem = simt_smem_bytes<D>();
  auto kernel = flash_fwd_f32_simt<D>;
  // above 48 KB a block's shared memory must be asked for explicitly
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const float scale = float(softmax_scale);
  const dim3 grid((seq_len + kTileQ - 1) / kTileQ, batch_heads);
  kernel<<<grid, kSimtThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(kv_mask), static_cast<float*>(out), heads, group, seq_len, causal,
      window, scale);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- bf16

constexpr int kWarpgroup = 128;
constexpr int kConsumers = 2;  // warpgroups; each takes every other KV tile
constexpr int kWgThreads = kConsumers * kWarpgroup + 32;  // + one producer warp
constexpr int kKvTile = 64;  // keys per K/V tile: the N of one QK^T wgmma
constexpr int kStages = 4;   // K/V ring depth
constexpr size_t kMaxSmem = 227 * 1024;  // a block's most on sm_90
// a barrier wait that lasts this long is a fault: trap rather than hang
constexpr uint64_t kWatchdogNs = 10ull * 1000 * 1000 * 1000;

// The shared-memory layout of one head dim: TMA boxes are at most 64
// columns (128 bytes) wide, so D=128 is two boxes side by side.
template <int D>
struct Geometry {
  static constexpr int kBoxCols = D < 64 ? D : 64;
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kRowBytes = kBoxCols * 2;   // 32, 64 or 128: the swizzle span
  static constexpr int kAtomBytes = 8 * kRowBytes;  // eight rows: one swizzle atom
  // wgmma descriptor layout type: 1 = 128B, 2 = 64B, 3 = 32B swizzle
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
};

template <int D>
struct Smem {
  static constexpr int kQBytes = kTileQ * D * 2;
  static constexpr int kKVBytes = kKvTile * D * 2;  // one K or one V tile
  static constexpr int kK = kQBytes;  // Q at 0
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBars = kV + kStages * kKVBytes;  // full[kStages], empty[kStages], q
  static constexpr int kBytes = kBars + 8 * (2 * kStages + 1);
  static constexpr size_t kAlloc = 1024 + kBytes;  // slack to align the base to 1024
  // the other warpgroups hand their m, l and O to the first through the
  // K/V ring once every tile is consumed
  static_assert((kConsumers - 1) * (D / 2 + 4) * kWarpgroup * 4 <= 2 * kStages * kKVBytes,
                "the merge fits in the ring");
  static_assert(kAlloc <= kMaxSmem, "the ring fits in a block's shared memory");
};
// Warpgroup w takes tiles w, w + kConsumers, ..., so every stage belongs
// to one warpgroup, and the full-barrier phase it waits on is one that
// it consumed itself the round before.
static_assert(kStages % kConsumers == 0, "each stage serves one warpgroup");

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the phase of `bar` with this parity to complete.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > kWatchdogNs) __trap();
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ float fast_exp2(float x) {  // exp2(-inf) == 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Barrier 1 over the consumer warpgroups only (the producer warp has left).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers * kWarpgroup) : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units) and the swizzle layout type.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving register reads or writes across an
// asynchronous wgmma that owns these registers.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define PIO_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define PIO_F8(i) PIO_F4(i), PIO_F4(i + 4)
#define PIO_F16(i) PIO_F8(i), PIO_F8(i + 8)
#define PIO_F32(i) PIO_F16(i), PIO_F16(i + 16)

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16"
      " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : PIO_F32(0)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x N] += A[64 x 16] B[16 x N], A in registers (bf16 pairs), B
// MN-major (transposed) in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16"
      " {%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : PIO_F8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16"
      " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : PIO_F16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16"
      " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : PIO_F32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef PIO_F32
#undef PIO_F16
#undef PIO_F8
#undef PIO_F4

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Threads 0-255 are two consumer warpgroups, warp 8 is the producer.
// Warpgroup w takes KV tiles w, w + 2, ... of the block's query tile, so
// the two overlap one's softmax with the other's products; at the end
// the second hands its m, l and O to the first, which merges them and
// writes the tile. In the wgmma accumulator layout thread t of a
// warpgroup holds rows (t/32)*16 + (t%32)/4 and that + 8, and in each
// 8-column chunk n the columns 8n + 2(t%4) and that + 1: register
// 4n + 2r + j is (row r, column j) of chunk n. Where 96 registers a
// thread are enough (D <= 64), two blocks share an SM.
template <int D>
__global__ void __launch_bounds__(kWgThreads, D <= 64 ? 2 : 1)
flash_fwd_bf16_wgmma(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const float* __restrict__ kv_mask, __nv_bfloat16* __restrict__ out,
                     int heads, int group, int seq_len, int causal, int window,
                     float scale_log2) {
  using G = Geometry<D>;
  using L = Smem<D>;
  constexpr int BN = kKvTile;
  constexpr int kNv = D < 64 ? D : 64;  // N of one PV wgmma: one box of V
  constexpr int kWords = BN / 32;       // key-mask words of one tile

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;  // 128B swizzle wants 1024-byte alignment
  const uint32_t sQ = base;
  const uint32_t sK = base + L::kK;
  const uint32_t sV = base + L::kV;
  const uint32_t full_bar = base + L::kBars;
  const uint32_t empty_bar = full_bar + 8 * kStages;
  const uint32_t q_bar = empty_bar + 8 * kStages;

  const int bh = blockIdx.x;
  const int kv_bh = bh / group;  // GQA: the K/V row this query head reads
  const int qtile = gridDim.y - 1 - blockIdx.y;  // longest causal rows first, all heads
  const int q0 = qtile * kTileQ;
  int n_kv = (seq_len + BN - 1) / BN;
  if (causal) n_kv = min(n_kv, (q0 + kTileQ + BN - 1) / BN);  // stop at the diagonal
  // the block walks KV tiles t_lo .. n_kv - 1; a window skips the tiles
  // wholly before the first row's first key. Ring stages and warpgroups
  // go by the tile's place i = t - t_lo in the walk.
  const int t_lo = window > 0 ? max(0, q0 - window + 1) / BN : 0;
  const int n_walk = max(n_kv - t_lo, 0);

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kWarpgroup);  // each tile is one warpgroup's
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers * kWarpgroup) {
    // producer: one thread issues every copy; the others have nothing to do
    if (tid != kConsumers * kWarpgroup) return;
    mbar_expect_tx(q_bar, L::kQBytes);
#pragma unroll
    for (int x = 0; x < G::kBoxes; ++x)
      tma_load_3d(sQ + x * kTileQ * G::kRowBytes, &tm_q, q_bar, x * G::kBoxCols, q0, bh);
    for (int i = 0; i < n_walk; ++i) {
      const int s = i % kStages;
      if (i >= kStages) mbar_wait(empty_bar + 8 * s, ((i / kStages) & 1) ^ 1);
      mbar_expect_tx(full_bar + 8 * s, 2 * L::kKVBytes);
      const int k0 = (t_lo + i) * BN;
#pragma unroll
      for (int x = 0; x < G::kBoxes; ++x) {
        const uint32_t off = s * L::kKVBytes + x * BN * G::kRowBytes;
        tma_load_3d(sK + off, &tm_k, full_bar + 8 * s, x * G::kBoxCols, k0, kv_bh);
        tma_load_3d(sV + off, &tm_v, full_bar + 8 * s, x * G::kBoxCols, k0, kv_bh);
      }
    }
    return;
  }

  // consumers
  const int wg = tid / kWarpgroup;
  const int t_wg = tid % kWarpgroup;
  const int warp = t_wg / 32, lane = tid % 32;
  const int row0 = warp * 16 + lane / 4;  // this thread's rows: row0 and row0 + 8
  const int col0 = 2 * (lane % 4);
  const float* mask_row = kv_mask + size_t(bh / heads) * seq_len;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNeg, kNeg};  // running max, log2 domain
  float l[2] = {0.f, 0.f};    // this thread's part of the running denominator

  // the key mask of the warpgroup's next tile: this lane's keys 32c + lane,
  // read coalesced a tile ahead and turned into bit words by a ballot
  float mk[kWords];
#pragma unroll
  for (int c = 0; c < kWords; ++c) {
    const int key = (t_lo + wg) * BN + 32 * c + lane;
    mk[c] = (wg < n_walk && key < seq_len) ? __ldg(mask_row + key) : 0.f;
  }

  mbar_wait(q_bar, 0);
  __syncwarp();

  for (int i = wg; i < n_walk; i += kConsumers) {
    const int s = i % kStages;
    const int k0 = (t_lo + i) * BN;
    uint32_t words[kWords];  // bit i of word c: key 32c + i of this tile is real
    bool all_real = true;
#pragma unroll
    for (int c = 0; c < kWords; ++c) {
      words[c] = __ballot_sync(0xffffffffu, mk[c] > 0.f);
      all_real &= words[c] == 0xffffffffu;
    }
#pragma unroll
    for (int c = 0; c < kWords; ++c) {
      const int key = k0 + kConsumers * BN + 32 * c + lane;
      mk[c] = (i + kConsumers < n_walk && key < seq_len) ? __ldg(mask_row + key) : 0.f;
    }

    mbar_wait(full_bar + 8 * s, (i / kStages) & 1);
    __syncwarp();

    // S = Q K^T, f32 in registers
    float sc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
    fence_regs<BN / 2>(sc);
    wgmma_fence();
    const uint32_t k_tile = sK + s * L::kKVBytes;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int x = kk * 16 / G::kBoxCols;                 // box
      const int in_row = (kk * 16 % G::kBoxCols) * 2;      // bytes into the swizzled row
      const uint64_t a = smem_desc(sQ + x * kTileQ * G::kRowBytes + in_row, 16, G::kAtomBytes,
                                   G::kLayout);
      const uint64_t b = smem_desc(k_tile + x * BN * G::kRowBytes + in_row, 16, G::kAtomBytes,
                                   G::kLayout);
      wgmma_ss_n64(sc, a, b, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<BN / 2>(sc);

    // masked logits become -inf; only a tile with a padded key, one that
    // crosses the diagonal or one that crosses the window's lower edge
    // (a key at or before the tile's last row - W) has any
    const bool diagonal = causal && k0 + BN > q0 + 1;
    const bool edge = window > 0 && k0 <= q0 + kTileQ - 1 - window;
    if (diagonal || edge || !all_real) {
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int key = 8 * n + col0 + j;  // in the tile
          const bool real = (words[n / 4] >> (key % 32)) & 1u;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = q0 + row0 + 8 * r;
            if (!real || (diagonal && k0 + key > row) || (edge && k0 + key <= row - window))
              sc[4 * n + 2 * r + j] = -INFINITY;
          }
        }
    }

    // online softmax on the accumulator layout, in the log2 domain
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float part[BN / 8];  // tree reductions keep the dependency chains short
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) part[n] = fmaxf(sc[4 * n + 2 * r], sc[4 * n + 2 * r + 1]);
#pragma unroll
      for (int w = BN / 16; w >= 1; w /= 2)
#pragma unroll
        for (int n = 0; n < w; ++n) part[n] = fmaxf(part[n], part[n + w]);
      float mx = part[0];
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx * scale_log2);
      const bool seen = m_new > kNeg * 0.5f;  // any valid key so far
      const float alpha = seen ? fast_exp2(m[r] - m_new) : 0.f;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        float& x0 = sc[4 * n + 2 * r];
        float& x1 = sc[4 * n + 2 * r + 1];
        x0 = fast_exp2(fmaf(x0, scale_log2, -m_new));  // a masked key gives 0
        x1 = fast_exp2(fmaf(x1, scale_log2, -m_new));
        part[n] = x0 + x1;
      }
#pragma unroll
      for (int w = BN / 16; w >= 1; w /= 2)
#pragma unroll
        for (int n = 0; n < w; ++n) part[n] += part[n + w];
      l[r] = l[r] * alpha + part[0];
      m[r] = m_new;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[4 * n + 2 * r] *= alpha;
        o[4 * n + 2 * r + 1] *= alpha;
      }
    }
    // P as the A operand of PV: the logits' accumulator layout of keys
    // 16kk..16kk+15 is the register layout of a 64 x 16 A tile
    uint32_t p[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) p[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);

    // O += P V
    fence_regs<D / 2>(o);
    fence_regs<BN / 4>(&p[0][0]);
    wgmma_fence();
    const uint32_t v_tile = sV + s * L::kKVBytes;
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int x = 0; x < G::kBoxes; ++x) {
        const uint64_t b = smem_desc(v_tile + x * BN * G::kRowBytes + kk * 16 * G::kRowBytes,
                                     BN * G::kRowBytes, G::kAtomBytes, G::kLayout);
        wgmma_rs<kNv>(o + x * (kNv / 2), p[kk], b);
      }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<D / 2>(o);
    fence_regs<BN / 4>(&p[0][0]);
    mbar_arrive(empty_bar + 8 * s);  // this thread no longer reads stage s
  }

  // merge: every tile is consumed, so the ring is free to carry each
  // other warpgroup's m, l and O to the first
  constexpr int kPart = (D / 2 + 4) * kWarpgroup;  // floats one warpgroup hands over
  float* xchg = reinterpret_cast<float*>(smem_raw + (base - raw) + L::kK);
  consumers_sync();
  if (wg > 0) {
    float* mine = xchg + (wg - 1) * kPart;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) mine[i * kWarpgroup + t_wg] = o[i];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mine[(D / 2 + r) * kWarpgroup + t_wg] = m[r];
      mine[(D / 2 + 2 + r) * kWarpgroup + t_wg] = l[r];
    }
  }
  consumers_sync();
  if (wg > 0) return;

  for (int g = 1; g < kConsumers; ++g) {
    const float* other = xchg + (g - 1) * kPart;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m1 = other[(D / 2 + r) * kWarpgroup + t_wg];
      const float mm = fmaxf(m[r], m1);
      const float a0 = m[r] > kNeg * 0.5f ? fast_exp2(m[r] - mm) : 0.f;
      const float a1 = m1 > kNeg * 0.5f ? fast_exp2(m1 - mm) : 0.f;
      l[r] = l[r] * a0 + other[(D / 2 + 2 + r) * kWarpgroup + t_wg] * a1;
      m[r] = mm;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int i = 4 * n + 2 * r + j;
          o[i] = o[i] * a0 + other[i * kWarpgroup + t_wg] * a1;
        }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float denom = l[r];
    denom += __shfl_xor_sync(0xffffffffu, denom, 1);
    denom += __shfl_xor_sync(0xffffffffu, denom, 2);
    const int q_pos = q0 + row0 + 8 * r;
    if (q_pos >= seq_len) continue;
    const float inv = denom > 0.f ? 1.f / fmaxf(denom, 1e-20f) : 0.f;
    __nv_bfloat16* dst = out + (size_t(bh) * seq_len + q_pos) * D + col0;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
          __floats2bfloat162_rn(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so
// the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &sym,
                                                             12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(sym)
               : nullptr;
  }();
  return fn;
}

// A map over one of q, k, v seen as (D, S, B*H), innermost first, whose
// box is one tile of `rows` rows and at most 64 columns.
template <int D>
bool encode_map(CUtensorMap* map, const void* ptr, int batch_heads, int seq_len, int rows) {
  using G = Geometry<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return false;
  const cuuint64_t dims[3] = {cuuint64_t(D), cuuint64_t(seq_len), cuuint64_t(batch_heads)};
  const cuuint64_t strides[2] = {cuuint64_t(D) * 2, cuuint64_t(seq_len) * D * 2};
  const cuuint32_t box[3] = {cuuint32_t(G::kBoxCols), cuuint32_t(rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = G::kRowBytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : G::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                          : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_bf16_wgmma(const void* q, const void* k, const void* v, const void* kv_mask,
                              void* out, int batch_heads, int heads, int group, int seq_len,
                              int causal, int window, double softmax_scale,
                              cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  // q over (D, S, B*H); k and v over (D, S, B*H_kv)
  if (!encode_map<D>(&tm_q, q, batch_heads, seq_len, kTileQ) ||
      !encode_map<D>(&tm_k, k, batch_heads / group, seq_len, kKvTile) ||
      !encode_map<D>(&tm_v, v, batch_heads / group, seq_len, kKvTile))
    return cudaErrorInvalidValue;
  constexpr size_t smem = Smem<D>::kAlloc;
  auto kernel = flash_fwd_bf16_wgmma<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const float scale_log2 = float(1.4426950408889634 * softmax_scale);
  const dim3 grid(batch_heads, (seq_len + kTileQ - 1) / kTileQ);
  kernel<<<grid, kWgThreads, smem, stream>>>(tm_q, tm_k, tm_v, static_cast<const float*>(kv_mask),
                                            static_cast<__nv_bfloat16*>(out), heads, group,
                                            seq_len, causal, window, scale_log2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_head_dim(int dtype, const void* q, const void* k, const void* v,
                            const void* kv_mask, void* out, int batch_heads, int heads,
                            int group, int seq_len, int causal, int window,
                            double softmax_scale, cudaStream_t stream) {
  return dtype == 0 ? launch_f32_simt<D>(q, k, v, kv_mask, out, batch_heads, heads, group,
                                         seq_len, causal, window, softmax_scale, stream)
                    : launch_bf16_wgmma<D>(q, k, v, kv_mask, out, batch_heads, heads, group,
                                           seq_len, causal, window, softmax_scale, stream);
}

}  // namespace

// q, out: contiguous (batch_heads, seq_len, head_dim); k, v: contiguous
// (batch_heads / heads * kv_heads, seq_len, head_dim), kv_heads dividing
// heads; all in the type `dtype` names (0 = float32, 1 = bfloat16; bf16
// pointers 16-byte aligned); kv_mask: contiguous float32 (batch_heads /
// heads, seq_len), > 0 where the key is real; window: 0 for none, else
// the sliding window's width in keys; softmax_scale: the factor of the
// logits (1/sqrt(d) for a head dim d zero-padded to head_dim). Launches on
// `stream` and does not synchronise. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int pio_flash_attention_fwd(const void* q, const void* k, const void* v,
                                       const void* kv_mask, void* out, int batch_heads,
                                       int heads, int kv_heads, int seq_len, int head_dim,
                                       int dtype, int causal, int window,
                                       double softmax_scale, void* stream) {
  if (batch_heads <= 0 || heads <= 0 || batch_heads % heads != 0 || kv_heads <= 0 ||
      heads % kv_heads != 0 || window < 0 || seq_len <= 0 || batch_heads > 65535 ||
      (seq_len + kTileQ - 1) / kTileQ > 65535 || (dtype != 0 && dtype != 1) ||
      !(softmax_scale > 0.0))
    return int(cudaErrorInvalidValue);
  const int g = heads / kv_heads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return int(launch_head_dim<16>(dtype, q, k, v, kv_mask, out, batch_heads, heads, g, seq_len, causal, window, softmax_scale, s));
    case 32: return int(launch_head_dim<32>(dtype, q, k, v, kv_mask, out, batch_heads, heads, g, seq_len, causal, window, softmax_scale, s));
    case 64: return int(launch_head_dim<64>(dtype, q, k, v, kv_mask, out, batch_heads, heads, g, seq_len, causal, window, softmax_scale, s));
    case 128: return int(launch_head_dim<128>(dtype, q, k, v, kv_mask, out, batch_heads, heads, g, seq_len, causal, window, softmax_scale, s));
    default: return int(cudaErrorInvalidValue);
  }
}
