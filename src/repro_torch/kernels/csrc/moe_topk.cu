// MoE top-k gating (softmax over experts, then k max-and-mask sweeps) for
// Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_gate_kernel` of
// src/repro/kernels/moe_dispatch.py (wrapper `moe_topk`). The TPU kernel
// takes a (1024, E) tile of logits per grid step into VMEM; here one warp
// owns one token row, so a row's E <= 64 logits sit two to a lane in
// registers and every reduction is a warp shuffle: no shared memory, no
// block-wide barrier, and no padding of T to a block multiple.
//
// Semantics (the Pallas kernel's): fp32 softmax over E, then k sweeps that
// each take the largest remaining probability, the LOWEST expert index
// winning a tie (as `lax.top_k` does), and mask it to -1e30; optional
// renormalisation of the k weights. Outputs weights (T, k) fp32 and ids
// (T, k) int32. Inputs fp32 or bf16 logits (T, E), contiguous.
//
// What bounds it on the card: it reads T*E logits and writes T*k*8 bytes,
// with a few operations per logit, so at the serving shapes (T <= 1024,
// E = 60) the bound on an H100 SXM (3.35 TB/s at 700 W) is bytes, well under
// a microsecond, and the launch itself is the cost. The design keeps it to
// one pass over device memory: each logit is read once, coalesced across a
// warp.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;      // token rows per block
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// (value, index) argmax over the warp; ties go to the lower index
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
moe_topk_kernel(const T* __restrict__ logits, float* __restrict__ w,
                int* __restrict__ idx, int T_rows, int E, int k, int norm) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= T_rows) return;   // a whole warp leaves together
  const T* x = logits + (long)row * E;
  const int e0 = lane, e1 = lane + 32;
  const bool has0 = e0 < E, has1 = e1 < E;
  // lanes past E hold -inf: they add exp(-inf) = 0 to the sum and lose
  // every sweep against a real probability (>= 0) or a masked -1e30
  const float x0 = has0 ? to_f32(x[e0]) : -INFINITY;
  const float x1 = has1 ? to_f32(x[e1]) : -INFINITY;
  const float mx = warp_max(fmaxf(x0, x1));
  const float ex0 = has0 ? expf(x0 - mx) : 0.f;
  const float ex1 = has1 ? expf(x1 - mx) : 0.f;
  const float denom = warp_sum(ex0 + ex1);
  float p0 = has0 ? ex0 / denom : -INFINITY;
  float p1 = has1 ? ex1 / denom : -INFINITY;

  float mine = 0.f;            // lane j keeps the j-th chosen weight
  int mine_id = 0;
  for (int j = 0; j < k; ++j) {
    float v;
    int i;
    if (p1 > p0) { v = p1; i = e1; } else { v = p0; i = e0; }   // e0 < e1 wins ties
    warp_argmax(v, i);
    if (lane == j) { mine = v; mine_id = i; }
    if (i == e0) p0 = NEG_INF;
    if (i == e1) p1 = NEG_INF;
  }
  float scale = 1.f;
  if (norm) scale = warp_sum(lane < k ? mine : 0.f);
  if (lane < k) {
    w[(long)row * k + lane] = norm ? mine / scale : mine;
    idx[(long)row * k + lane] = mine_id;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Requires 1 <= k <= E <= 64 and k <= 32.
// Returns the launch's cudaError_t.
extern "C" int moe_topk_fwd(const void* logits, void* w, void* idx, int T_rows,
                            int E, int k, int norm, int dtype, void* stream) {
  if (T_rows <= 0 || E <= 0 || E > 64 || k <= 0 || k > E || k > 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((T_rows + WARPS - 1) / WARPS);
  if (dtype == 0)
    moe_topk_kernel<float><<<grid, WARPS * 32, 0, s>>>(
        static_cast<const float*>(logits), static_cast<float*>(w),
        static_cast<int*>(idx), T_rows, E, k, norm);
  else if (dtype == 1)
    moe_topk_kernel<__nv_bfloat16><<<grid, WARPS * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits), static_cast<float*>(w),
        static_cast<int*>(idx), T_rows, E, k, norm);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
