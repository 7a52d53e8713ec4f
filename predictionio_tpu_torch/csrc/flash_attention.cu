// Forward flash attention for Hopper (sm_90a), plain C entry point.
//
// Replaces: predictionio_tpu/ops/pallas_attention.py `_flash_kernel`
// (launched by `pl.pallas_call` in `_flash_call`, dispatched by
// `flash_attention`). Same function: attention over (B, H, S, D)
// flattened to (B*H, S, D), scale 1/sqrt(D), a per-key mask (B, S)
// shared by the heads, an optional causal mask, an online softmax whose
// running max, denominator and numerator are f32, and zero output for a
// row whose keys are all masked.
//
// Bound at the serving shape (B=1, H=4, S=2048, D=64, bf16, causal):
// QK^T and PV over the S(S+1)/2 causal pairs are 4*D flops a pair,
// 4 * 2048*2049/2 * 256 = 2.15 GFLOP, 2.2 us at the card's 989 TFLOP/s
// bf16 tensor-core rate; q, k, v and o are 4 * 2048*64*4 * 2 B = 4.2 MB,
// 1.3 us at 3.35 TB/s. The bound is compute: about 2.2 us per launch.
//
// What this design does about it: this first version is simple and
// right, not fast. It keeps the work the bound counts and no more: the
// S x S logits never reach device memory, each K/V tile is read once per
// query tile, and the loop over KV tiles stops at the diagonal when
// causal, so only the causal half is computed. It does the products on
// the CUDA cores in f32 (67 TFLOP/s), not on the tensor cores, so it
// cannot come near the bound; mma.sync / wgmma with TMA-fed tiles are
// the next step.
//
// Layout: one thread block per (b*h, 64-row query tile), 256 threads,
// four threads per query row. The block stages its Q tile once, then for
// each 64-key tile stages K, V and the key mask in shared memory (f32,
// rows padded by one float so the rows a warp reads fall on different
// banks). Each thread computes 16 of its row's 64 logits; the row max
// and sum are reduced over the four threads with shuffles; the
// probabilities go through shared memory to the P*V product, where each
// thread owns D/4 output columns. A query or key tile that runs past S
// is masked here, so S need not divide the tile. Query tiles are issued
// longest-first (the causal rows near the end of the sequence visit the
// most KV tiles), so the short tiles fill in behind them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kTileQ = 64;
constexpr int kTileK = 64;
constexpr int kThreadsPerRow = 4;
constexpr int kThreads = kTileQ * kThreadsPerRow;           // 256
constexpr int kKeysPerThread = kTileK / kThreadsPerRow;     // 16
constexpr int kLdP = kTileK + 1;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

template <int D>
constexpr size_t smem_bytes() {
  // sQ, sK: kTile x (D+1); sV: kTileK x D; sP: kTileQ x kLdP; sMask: kTileK
  return sizeof(float) *
         (size_t(kTileQ) * (D + 1) + size_t(kTileK) * (D + 1) + size_t(kTileK) * D +
          size_t(kTileQ) * kLdP + kTileK);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ kv_mask, T* __restrict__ out, int heads,
                 int seq_len, int causal, float scale) {
  static_assert(D % kThreadsPerRow == 0, "D must split over the threads of a row");
  constexpr int kLd = D + 1;
  constexpr int kCols = D / kThreadsPerRow;

  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTileQ * kLd;
  float* sV = sK + kTileK * kLd;
  float* sP = sV + kTileK * D;
  float* sMask = sP + kTileQ * kLdP;

  const int qtile = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const size_t base = size_t(bh) * seq_len * D;
  const int q0 = qtile * kTileQ;
  const int tid = threadIdx.x;
  const int row = tid / kThreadsPerRow;
  const int sub = tid % kThreadsPerRow;
  const int q_pos = q0 + row;

  for (int i = tid; i < kTileQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int s = q0 + r;
    sQ[r * kLd + d] = s < seq_len ? to_float(q[base + size_t(s) * D + d]) : 0.f;
  }

  float m = kNeg;  // running max of this row's logits
  float l = 0.f;   // running softmax denominator
  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;

  int n_kv = (seq_len + kTileK - 1) / kTileK;
  if (causal) n_kv = min(n_kv, (q0 + kTileQ + kTileK - 1) / kTileK);  // stop at the diagonal

  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * kTileK;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int i = tid; i < kTileK * D; i += kThreads) {
      const int j = i / D, d = i - j * D;
      const int s = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (s < seq_len) {
        kx = to_float(k[base + size_t(s) * D + d]);
        vx = to_float(v[base + size_t(s) * D + d]);
      }
      sK[j * kLd + d] = kx;
      sV[j * D + d] = vx;
    }
    if (tid < kTileK) {
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
      const bool valid = sMask[j] > 0.f && (!causal || k0 + j <= q_pos);
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
    for (int j = 0; j < kTileK; ++j) {
      const float p = sP[row * kLdP + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        acc[c] = fmaf(p, sV[j * D + c * kThreadsPerRow + sub], acc[c]);
    }
  }

  if (q_pos < seq_len) {
    const float denom = fmaxf(l, 1e-20f);
    T* o = out + base + size_t(q_pos) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      o[c * kThreadsPerRow + sub] = from_float<T>(l > 0.f ? acc[c] / denom : 0.f);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* kv_mask, void* out,
                   int batch_heads, int heads, int seq_len, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_fwd_kernel<T, D>;
  // above 48 KB a block's shared memory must be asked for explicitly
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const float scale = float(1.0 / std::sqrt(double(D)));
  const dim3 grid((seq_len + kTileQ - 1) / kTileQ, batch_heads);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(kv_mask), static_cast<T*>(out), heads, seq_len, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for_head_dim(int head_dim, const void* q, const void* k, const void* v,
                                const void* kv_mask, void* out, int batch_heads, int heads,
                                int seq_len, int causal, cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<T, 16>(q, k, v, kv_mask, out, batch_heads, heads, seq_len, causal, stream);
    case 32: return launch<T, 32>(q, k, v, kv_mask, out, batch_heads, heads, seq_len, causal, stream);
    case 64: return launch<T, 64>(q, k, v, kv_mask, out, batch_heads, heads, seq_len, causal, stream);
    case 128: return launch<T, 128>(q, k, v, kv_mask, out, batch_heads, heads, seq_len, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: contiguous (batch_heads, seq_len, head_dim) in the type
// `dtype` names (0 = float32, 1 = bfloat16); kv_mask: contiguous float32
// (batch_heads / heads, seq_len), > 0 where the key is real. Launches on
// `stream` and does not synchronise. Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for arguments it does not take.
extern "C" int pio_flash_attention_fwd(const void* q, const void* k, const void* v,
                                       const void* kv_mask, void* out, int batch_heads,
                                       int heads, int seq_len, int head_dim, int dtype,
                                       int causal, void* stream) {
  if (batch_heads <= 0 || heads <= 0 || batch_heads % heads != 0 || seq_len <= 0 ||
      batch_heads > 65535)
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return int(launch_for_head_dim<float>(head_dim, q, k, v, kv_mask, out, batch_heads, heads,
                                            seq_len, causal, s));
    case 1:
      return int(launch_for_head_dim<__nv_bfloat16>(head_dim, q, k, v, kv_mask, out, batch_heads,
                                                    heads, seq_len, causal, s));
    default:
      return int(cudaErrorInvalidValue);
  }
}
