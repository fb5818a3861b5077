// MoE top-k gating (softmax over experts, then k max-and-mask sweeps) for
// Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_gate_kernel` of
// src/repro/kernels/moe_dispatch.py (wrapper `moe_topk`). The TPU kernel
// takes a (1024, E) tile of logits per grid step into VMEM and reduces along
// E in its vector unit; here a group of LANES lanes of one warp owns one
// token row, and its E <= 64 logits sit in the group's registers.
//
// Semantics (the Pallas kernel's): fp32 softmax over E, then k sweeps that
// each take the largest remaining probability, the LOWEST expert index
// winning a tie (as `lax.top_k` does), and mask it; optional
// renormalisation of the k weights. Outputs weights (T, k) fp32 and ids
// (T, k) int32. Inputs fp32 or bf16 logits (T, E), contiguous.
//
// What bounds it on the card: it reads T*E logits and writes T*k*8 bytes,
// with a few operations per logit, so at the serving shapes (T <= 2048,
// E <= 64) the bound on an H100 SXM (3.35 TB/s at 700 W) is bytes, a few
// hundredths of a microsecond: below what any launch takes. What a launch
// pays on top of the launch itself is the chain of dependent steps of one
// row (a load, a max and a sum across lanes, k argmax reductions); every
// row runs at once. The design shortens that chain:
//
// * Layout. Lane g of a row's group holds experts g*PER_LANE ...
//   (g+1)*PER_LANE - 1 in registers, read VEC at a time (one 4- to 16-byte
//   load), so lane order is expert order. A lane takes its max, its exp-sum
//   and its best expert in registers first (pairwise trees); log2(LANES)
//   exchange stages cross lanes.
// * Keys. A probability p >= 0 orders as the unsigned integer of its bits,
//   so each expert's key is bits(p) + 1, and 0 for an expert already taken
//   or absent (e >= E). A lane's best is its largest key, the lowest
//   register among equals.
// * Sweeps. Each sweep takes the group's largest key (`redux.sync` max with
//   REDUX, else shuffle stages), and a ballot of the lanes whose best equals
//   it: the lowest such lane holds the lowest expert among equals, which is
//   the tie rule, with no index in the exchange. Only that lane changes: it
//   zeroes the key, notes the pick's number and takes its next best. After
//   the k sweeps each lane writes the picks it holds; every lane saw each
//   pick's probability, so the weights' sum for `norm` is kept on the way.
// * Grid. A warp holds 32 / LANES rows, a block BLOCK_WARPS warps.
//
// Chosen by measurement on an H100 (tools/moe_topk_sweep.py; PERF.md): 32
// lanes a row with REDUX beat 8 and 16 lanes (more registers a lane, and
// `redux.sync` over fewer than 32 lanes is slower than the shuffles it
// replaces); blocks of 4 or 8 warps, or warps per block fitted to spread
// the rows over the SMs, time the same within the noise (1-warp blocks
// lose at T = 2048), so blocks take 8 warps. The absent experts' division
// by 1 keeps the IEEE division on its fast path (a zero numerator takes
// the slow one).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The design's choices, one constant each; tools/moe_topk_sweep.py builds
// copies of this source with them changed and times each.
constexpr int LANES = 32;         // lanes that share a row: 8, 16 or 32
constexpr int BLOCK_WARPS = 8;    // warps per block, 1..8
constexpr bool REDUX = true;      // the max across lanes on redux.sync, not shuffles

constexpr int MAX_E = 64;
constexpr int PER_LANE = MAX_E / LANES;              // logits a lane holds
constexpr int VEC = PER_LANE < 4 ? PER_LANE : 4;     // logits per load
constexpr int ROWS_PER_WARP = 32 / LANES;
constexpr unsigned FULL = 0xffffffffu;

static_assert(LANES == 8 || LANES == 16 || LANES == 32, "LANES is 8, 16 or 32");
static_assert(BLOCK_WARPS >= 1 && BLOCK_WARPS <= 8, "BLOCK_WARPS is 1..8");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// VEC neighbouring logits from a VEC-aligned address, widened to fp32 (a
// bf16 is the upper half of its fp32)
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (VEC == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    out[0] = q.x; out[1] = q.y; out[2] = q.z; out[3] = q.w;
  } else {
    const float2 q = *reinterpret_cast<const float2*>(p);
    out[0] = q.x; out[1] = q.y;
  }
}
__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  if constexpr (VEC == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    out[0] = bf16_lo(q.x); out[1] = bf16_hi(q.x); out[2] = bf16_lo(q.y); out[3] = bf16_hi(q.y);
  } else {
    const uint32_t q = *reinterpret_cast<const uint32_t*>(p);
    out[0] = bf16_lo(q); out[1] = bf16_hi(q);
  }
}

// pairwise trees over a lane's registers
__device__ __forceinline__ float lane_max(const float (&v)[PER_LANE]) {
  float t[PER_LANE];
#pragma unroll
  for (int c = 0; c < PER_LANE; ++c) t[c] = v[c];
#pragma unroll
  for (int w = PER_LANE / 2; w > 0; w /= 2)
#pragma unroll
    for (int c = 0; c < w; ++c) t[c] = fmaxf(t[2 * c], t[2 * c + 1]);
  return t[0];
}

__device__ __forceinline__ float lane_sum(const float (&v)[PER_LANE]) {
  float t[PER_LANE];
#pragma unroll
  for (int c = 0; c < PER_LANE; ++c) t[c] = v[c];
#pragma unroll
  for (int w = PER_LANE / 2; w > 0; w /= 2)
#pragma unroll
    for (int c = 0; c < w; ++c) t[c] = t[2 * c] + t[2 * c + 1];
  return t[0];
}

// the largest key and its register; the left of each pair is the lower
// register, and it keeps a tie
__device__ __forceinline__ void lane_best(const uint32_t (&key)[PER_LANE], uint32_t& bk, int& bc) {
  uint32_t t[PER_LANE];
  int c_of[PER_LANE];
#pragma unroll
  for (int c = 0; c < PER_LANE; ++c) { t[c] = key[c]; c_of[c] = c; }
#pragma unroll
  for (int w = PER_LANE / 2; w > 0; w /= 2)
#pragma unroll
    for (int c = 0; c < w; ++c) {
      const bool right = t[2 * c + 1] > t[2 * c];
      t[c] = right ? t[2 * c + 1] : t[2 * c];
      c_of[c] = right ? c_of[2 * c + 1] : c_of[2 * c];
    }
  bk = t[0];
  bc = c_of[0];
}

// exchanges within the group: every lane ends with the result
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

__device__ __forceinline__ unsigned group_mask(int lane) {
  return LANES == 32 ? FULL : ((1u << (LANES % 32)) - 1u) << (lane / LANES * LANES);
}

__device__ __forceinline__ uint32_t group_umax(uint32_t x, int lane) {
  if constexpr (REDUX) {
    return __reduce_max_sync(group_mask(lane), x);
  } else {
#pragma unroll
    for (int o = LANES / 2; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(FULL, x, o));
    return x;
  }
}

// float -> unsigned int of the same order
__device__ __forceinline__ uint32_t ordered(float x) {
  const uint32_t b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : b | 0x80000000u;
}
__device__ __forceinline__ float unordered(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? u & 0x7fffffffu : ~u);
}

__device__ __forceinline__ float group_max(float x, int lane) {
  if constexpr (REDUX) {
    return unordered(group_umax(ordered(x), lane));
  } else {
#pragma unroll
    for (int o = LANES / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
    return x;
  }
}

// VECLOAD: E % VEC == 0 and the logits start on a VEC-element boundary, so
// every row's VEC-groups load whole
template <typename T, bool VECLOAD>
__global__ void __launch_bounds__(BLOCK_WARPS * 32)
moe_topk_kernel(const T* __restrict__ logits, float* __restrict__ w,
                int* __restrict__ idx, int T_rows, int E, int k, int norm) {
  const int lane = threadIdx.x & 31;
  const int e_lo = (lane % LANES) * PER_LANE;   // this lane's first expert
  const int row0 = (blockIdx.x * BLOCK_WARPS + (threadIdx.x >> 5)) * ROWS_PER_WARP;
  if (row0 >= T_rows) return;   // a whole warp leaves together
  const int row = row0 + lane / LANES;
  const bool live = row < T_rows;
  // a group past the last row reads the last row and writes nothing, so
  // that every lane of the warp takes part in the exchanges
  const T* x = logits + (long)(live ? row : T_rows - 1) * E;

  float v[PER_LANE];   // absent experts (e >= E) hold -inf: exp gives 0
#pragma unroll
  for (int s = 0; s < PER_LANE / VEC; ++s) {
    const int e0 = e_lo + s * VEC;
    if constexpr (VECLOAD) {
      if (e0 < E) {
        load_vec(x + e0, v + s * VEC);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) v[s * VEC + j] = -INFINITY;
      }
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[s * VEC + j] = e0 + j < E ? to_f32(x[e0 + j]) : -INFINITY;
    }
  }

  const float mx = group_max(lane_max(v), lane);
  float p[PER_LANE];
#pragma unroll
  for (int c = 0; c < PER_LANE; ++c) p[c] = expf(v[c] - mx);
  const float denom = group_sum(lane_sum(p));
  uint32_t key[PER_LANE];
  int taken[PER_LANE];   // the number of the sweep that took the register, or -1
#pragma unroll
  for (int c = 0; c < PER_LANE; ++c) {
    // an absent expert divides 1 (its p is never read): a zero numerator
    // would send the IEEE division down its slow path, and the warp with it
    const bool present = e_lo + c < E;
    p[c] = (present ? p[c] : 1.f) / denom;
    key[c] = present ? __float_as_uint(p[c]) + 1u : 0u;
    taken[c] = -1;
  }

  const unsigned group = group_mask(lane);
  float total = 0.f;
  uint32_t bk;
  int bc;
  lane_best(key, bk, bc);
  for (int j = 0; j < k; ++j) {
    const uint32_t top = group_umax(bk, lane);
    total += __uint_as_float(top - 1u);
    const unsigned holders = __ballot_sync(FULL, bk == top) & group;
    const bool mine = lane == __ffs(holders) - 1;
#pragma unroll
    for (int c = 0; c < PER_LANE; ++c) {
      const bool hit = mine && c == bc;
      key[c] = hit ? 0u : key[c];
      taken[c] = hit ? j : taken[c];
    }
    lane_best(key, bk, bc);
  }
  if (live) {
#pragma unroll
    for (int c = 0; c < PER_LANE; ++c) {
      if (taken[c] >= 0) {
        w[(long)row * k + taken[c]] = norm ? p[c] / total : p[c];
        idx[(long)row * k + taken[c]] = e_lo + c;
      }
    }
  }
}

template <typename T>
void launch(const void* logits, void* w, void* idx, int T_rows, int E, int k, int norm,
            cudaStream_t s) {
  constexpr int rows = BLOCK_WARPS * ROWS_PER_WARP;
  const dim3 grid((T_rows + rows - 1) / rows), block(BLOCK_WARPS * 32);
  const bool vec = E % VEC == 0 && reinterpret_cast<uintptr_t>(logits) % (VEC * sizeof(T)) == 0;
  const T* x = static_cast<const T*>(logits);
  float* wp = static_cast<float*>(w);
  int* ip = static_cast<int*>(idx);
  if (vec)
    moe_topk_kernel<T, true><<<grid, block, 0, s>>>(x, wp, ip, T_rows, E, k, norm);
  else
    moe_topk_kernel<T, false><<<grid, block, 0, s>>>(x, wp, ip, T_rows, E, k, norm);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Requires 1 <= k <= E <= 64. Returns the
// launch's cudaError_t.
extern "C" int moe_topk_fwd(const void* logits, void* w, void* idx, int T_rows,
                            int E, int k, int norm, int dtype, void* stream) {
  if (T_rows <= 0 || E <= 0 || E > MAX_E || k <= 0 || k > E)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(logits, w, idx, T_rows, E, k, norm, s);
  else if (dtype == 1)
    launch<__nv_bfloat16>(logits, w, idx, T_rows, E, k, norm, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
