// Flash attention forward (GQA, causal or not) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_flash_kernel` of
// src/repro/kernels/flash_attention.py (wrapper `flash_attention`). The TPU
// kernel walks the k blocks as the sequential minor grid axis and carries
// the online-softmax state (m, l, acc) in VMEM scratch across grid steps.
// On the GPU the blocks of a grid run in parallel and in no order, so the
// k walk becomes a loop inside the block and the state lives in registers.
//
// Layout (the JAX package's): q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D), all
// contiguous; query head h reads kv head h / (Hq / Hkv). Output (B, Sq, Hq, D)
// in q's dtype. fp32 or bf16 inputs; bf16 is widened to fp32 as a tile is
// stored to shared memory, so every product and sum is fp32, as in the
// Pallas body (`q_ref[0].astype(jnp.float32) * scale`).
//
// Design: one block of 256 threads per (64-row q tile, batch*q-head). Each
// k tile of 64 rows is staged through shared memory; four threads share a
// q row, each owning 16 logits and D/4 output columns. Masks: k_pos < Sk
// for the ragged edge (no host-side padding), and k_pos <= q_pos when
// causal; the causal walk stops at the tile that holds the diagonal. A
// masked logit is -1e30 and the result is acc / max(l, 1e-30), as in the
// Pallas kernel.
//
// What bounds it on the card: at the serving shapes (S <= 512, D = 128) the
// bytes are a few MB and the function needs well under a GFLOP, so on an
// H100 SXM (3.35 TB/s, 989 bf16 TFLOP/s at 700 W) the bound is bytes, a few
// microseconds. This kernel runs its products on the fp32 CUDA cores from
// shared memory (no mma/wgmma), which makes shared-memory bandwidth its
// limit. Moving the two products to tensor cores is a later step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // k rows per tile
constexpr int NT = 256;       // threads per block: 4 per q row
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int Sq, int Sk, int Hq, int Hkv, float scale, int causal) {
  constexpr int LDQ = D + 1;   // +1: rows of Q and K fall on distinct banks
  constexpr int LDK = D + 1;
  constexpr int LDV = D;
  constexpr int LDP = BK + 1;
  constexpr int NS = BK / 4;   // logits per thread
  constexpr int NO = D / 4;    // output columns per thread

  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LDQ;
  float* sV = sK + BK * LDK;
  float* sP = sV + BK * LDV;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / Hq;
  const int h = blockIdx.y % Hq;
  const int hk = h / (Hq / Hkv);
  const long q_stride = (long)Hq * D;     // between consecutive positions
  const long k_stride = (long)Hkv * D;
  const T* qb = q + ((long)b * Sq * Hq + h) * D;
  const T* kb = k + ((long)b * Sk * Hkv + hk) * D;
  const T* vb = v + ((long)b * Sk * Hkv + hk) * D;
  T* ob = o + ((long)b * Sq * Hq + h) * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D;
    const int qp = q0 + r;
    sQ[r * LDQ + d] = qp < Sq ? to_f32(qb[qp * q_stride + d]) * scale : 0.f;
  }

  const int r = tid >> 2;      // this thread's q row in the tile
  const int c = tid & 3;       // its column phase: logits c + 4j, outputs c + 4j
  const int q_pos = q0 + r;
  float acc[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j] = 0.f;
  float m = NEG_INF, l = 0.f;

  int nk = (Sk + BK - 1) / BK;
  if (causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();           // the previous tile is no longer read
    for (int i = tid; i < BK * D; i += NT) {
      const int rr = i / D, d = i % D;
      const int kp = k0 + rr;
      float kv = 0.f, vv = 0.f;
      if (kp < Sk) {
        kv = to_f32(kb[kp * k_stride + d]);
        vv = to_f32(vb[kp * k_stride + d]);
      }
      sK[rr * LDK + d] = kv;
      sV[rr * LDV + d] = vv;
    }
    __syncthreads();

    float s[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = sQ[r * LDQ + d];
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j] += qd * sK[(c + 4 * j) * LDK + d];
    }
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int k_pos = k0 + c + 4 * j;
      const bool ok = k_pos < Sk && (!causal || k_pos <= q_pos);
      s[j] = ok ? s[j] : NEG_INF;
      mx = fmaxf(mx, s[j]);
    }
    // the four threads of a row are adjacent lanes of one warp
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float p = expf(s[j] - m_new);
      sP[r * LDP + c + 4 * j] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l = l * corr + sum;
    m = m_new;
    __syncwarp();              // a row of P is written and read by one warp
#pragma unroll
    for (int j = 0; j < NO; ++j) acc[j] *= corr;
    for (int kk = 0; kk < BK; ++kk) {
      const float p = sP[r * LDP + kk];
#pragma unroll
      for (int j = 0; j < NO; ++j) acc[j] += p * sV[kk * LDV + c + 4 * j];
    }
  }

  if (q_pos < Sq) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < NO; ++j) store(&ob[q_pos * q_stride + c + 4 * j], acc[j] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int Sq, int Sk, int Hq, int Hkv, float scale, int causal,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // above 48 KB of dynamic shared memory must be opted into, once per
  // instantiation and device (not on every launch: a launch may be
  // captured in a CUDA graph)
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted_in[dev] = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, B * Hq);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, Hq, Hkv, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o, int B,
                     int Sq, int Sk, int Hq, int Hkv, int D, float scale,
                     int causal, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, Sq, Sk, Hq, Hkv, scale, causal, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, Sq, Sk, Hq, Hkv, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Sk, Hq, Hkv, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Sk, Hq, Hkv, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int Sq, int Sk, int Hq,
                                   int Hkv, int D, float scale, int causal,
                                   int dtype, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk <= 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_d<float>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, scale, causal, s);
  if (dtype == 1)
    return (int)launch_d<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
