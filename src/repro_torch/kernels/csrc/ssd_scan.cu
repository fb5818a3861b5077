// Mamba2 SSD chunked scan (forward) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` of src/repro/kernels/ssd_scan.py
// (wrapper `ssd_scan`). The TPU kernel runs a grid (B, H, n_chunks) whose
// chunk axis is sequential, carries the (P, N) fp32 state in VMEM scratch
// across it, and holds a whole chunk's two L x L fp32 tiles at once. On the
// GPU the blocks of a grid run in parallel and in no order, and a block has
// at most 227 KB of shared memory, so:
//
//  * one block of 256 threads per (batch, head) walks the chunks in a loop,
//    with the state h (P x N fp32) in shared memory for the whole walk;
//  * a chunk is cut into T-row sub-tiles (T = 64, or 32 / 16 for a chunk that
//    64 does not divide). For row tile i the block walks the column tiles
//    j <= i (the causal structure of flash attention without the softmax):
//      S_ij = (C_i B_jᵀ) ⊙ exp(cum_i - cum_j) [row >= col]
//      y_i += S_ij (dt ⊙ x)_j
//    then adds the state term y_i += exp(cum_i) ⊙ (C_i hᵀ) from the state
//    that entered the chunk, and writes y_i in x's dtype. Every y row of a
//    chunk is computed from the old h before h is updated:
//      h <- h exp(cum_last) + ((dt ⊙ x) ⊙ exp(cum_last - cum))ᵀ B;
//  * exp is evaluated only where row >= col: above the diagonal the segment
//    sum is positive and its exp could overflow;
//  * the ragged tail needs no host padding: rows t >= S load as dt = 0,
//    x = B = C = 0 (exact, as the reference's zero padding is), and a
//    chunk's tile walk stops at its last valid row.
//
// Layout (the JAX package's): x (B, S, H, P) and B, C (B, S, G, N) in fp32 or
// bf16 (B and C in x's dtype), dt (B, S, H) fp32 after softplus, A (H,) fp32;
// head h reads group h / (H / G). Out: y (B, S, H, P) in x's dtype and the
// final state (B, H, P, N) fp32. Inputs are widened to fp32 as they are
// stored to shared memory; every product and sum is fp32. dA_cum is the
// chunk's inclusive prefix sum of dt * A, taken by one thread in sequence as
// the plain version's cumsum takes it: the decays exp(cum_i - cum_j) subtract
// two sums of up to a chunk of terms, so a sum in another order would move
// them by an ulp of |cum| (~1e-4 relative at chunk 256), far more than the
// products' own rounding.
//
// What bounds it on the card: at the serving shapes (S <= 1024, H = 32,
// P = 64, N = 128) the function moves ~10 MB and needs ~3 GFLOP, so on an
// H100 SXM (3.35 TB/s, 989 bf16 TFLOP/s at 700 W) the bound is bytes, a few
// microseconds. This kernel runs its products on the fp32 CUDA cores out of
// shared memory (no mma/wgmma) with one block per (batch, head): 32 blocks on
// 132 SMs for one full-width sequence. Shared-memory bandwidth and the idle
// SMs are its limits; splitting P over blocks and tensor cores come later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;         // threads per block: a 16 x 16 grid
constexpr int MAX_P = 64;       // y columns per thread: P / 16 <= 4
constexpr int MAX_N = 128;      // state columns per thread: N / 16 <= 8
constexpr int MAX_T = 64;       // rows per sub-tile
constexpr int MAX_CHUNK = 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// floats of dynamic shared memory for one launch
__host__ __device__ constexpr int smem_floats(int T, int P, int N, int L) {
  return P * (N + 1)        // sH: the state
         + 2 * T * (N + 1)  // sC, sB: one row tile of C, one column tile of B
         + T * P            // sX: one column tile of dt * x (times a decay)
         + T * (T + 1)      // sS: one T x T score tile
         + 2 * L;           // sDt, sCum: the chunk's dt and its dA prefix sum
}
constexpr size_t MAX_SMEM = sizeof(float) * smem_floats(MAX_T, MAX_P, MAX_N, MAX_CHUNK);

// rows [t0, t0 + T) of a (S, row_stride) matrix, `cols` wide, into shared
// memory with leading dimension ld; rows at or past `valid` load as zero
template <typename Tin>
__device__ __forceinline__ void load_tile(float* dst, int ld, const Tin* src,
                                          long row_stride, int t0, int valid,
                                          int T, int cols) {
  for (int i = threadIdx.x; i < T * cols; i += NT) {
    const int r = i / cols, c = i % cols;
    dst[r * ld + c] = r < valid ? to_f32(src[(long)(t0 + r) * row_stride + c]) : 0.f;
  }
}

template <typename Tin, int T>
__global__ void __launch_bounds__(NT)
ssd_scan_kernel(const Tin* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const Tin* __restrict__ Bm,
                const Tin* __restrict__ Cm, Tin* __restrict__ y,
                float* __restrict__ h_out, int S, int H, int G, int P, int N,
                int L) {
  constexpr int RT = T / 16;           // rows per thread in S and y tiles
  const int LDN = N + 1;               // odd: 16 rows at one column hit 16 banks
  constexpr int LDS = T + 1;
  const int pb = P / 16, nb = N / 16;

  extern __shared__ float smem[];
  float* sH = smem;
  float* sC = sH + P * LDN;
  float* sB = sC + T * LDN;
  float* sX = sB + T * LDN;
  float* sS = sX + T * P;
  float* sDt = sS + T * LDS;
  float* sCum = sDt + L;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int g = h / (H / G);
  const float a = A[h];
  const long x_row = (long)H * P;      // between consecutive positions
  const long bc_row = (long)G * N;
  const Tin* xb = x + (long)b * S * x_row + (long)h * P;
  const float* dtb = dt + (long)b * S * H + h;
  const Tin* Bb = Bm + (long)b * S * bc_row + (long)g * N;
  const Tin* Cb = Cm + (long)b * S * bc_row + (long)g * N;
  Tin* yb = y + (long)b * S * x_row + (long)h * P;

  for (int i = tid; i < P * LDN; i += NT) sH[i] = 0.f;

  for (int t0 = 0; t0 < S; t0 += L) {
    const int Lc = min(L, S - t0);     // valid rows of this chunk
    const int nT = (Lc + T - 1) / T;
    __syncthreads();                   // the last chunk's state update is done
    for (int l = tid; l < L; l += NT) sDt[l] = l < Lc ? dtb[(long)(t0 + l) * H] : 0.f;
    __syncthreads();
    if (tid == 0) {                    // inclusive prefix sum of dt * A, in order
      float cum = 0.f;                 // (the plain version's cumsum, bit for bit:
      for (int l = 0; l < L; ++l) {    //  no fused multiply-add, same sequence)
        cum = __fadd_rn(cum, __fmul_rn(sDt[l], a));
        sCum[l] = cum;
      }
    }

    for (int it = 0; it < nT; ++it) {
      const int i0 = it * T;
      float acc[RT][4];
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * T;
        __syncthreads();               // sS, sB, sX (and sC, sCum) are free
        if (jt == 0) load_tile(sC, LDN, Cb, bc_row, t0 + i0, Lc - i0, T, N);
        load_tile(sB, LDN, Bb, bc_row, t0 + j0, Lc - j0, T, N);
        for (int i = tid; i < T * P; i += NT) {
          const int r = i / P, c = i % P;
          sX[i] = r < Lc - j0 ? to_f32(xb[(long)(t0 + j0 + r) * x_row + c]) * sDt[j0 + r] : 0.f;
        }
        __syncthreads();

        // S_ij = C_i B_jᵀ: rows ty + 16 r, columns tx + 16 c
        float s[RT][RT];
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int c = 0; c < RT; ++c) s[r][c] = 0.f;
        for (int k = 0; k < N; ++k) {
          float cr[RT], br[RT];
#pragma unroll
          for (int r = 0; r < RT; ++r) cr[r] = sC[(ty + 16 * r) * LDN + k];
#pragma unroll
          for (int c = 0; c < RT; ++c) br[c] = sB[(tx + 16 * c) * LDN + k];
#pragma unroll
          for (int r = 0; r < RT; ++r)
#pragma unroll
            for (int c = 0; c < RT; ++c) s[r][c] += cr[r] * br[c];
        }
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int c = 0; c < RT; ++c) {
            const int gi = i0 + ty + 16 * r, gj = j0 + tx + 16 * c;
            sS[(ty + 16 * r) * LDS + tx + 16 * c] =
                gi >= gj ? s[r][c] * expf(sCum[gi] - sCum[gj]) : 0.f;
          }
        __syncthreads();

        // y_i += S_ij (dt x)_j: rows ty + 16 r, columns tx + 16 c
        for (int k = 0; k < T; ++k) {
          float sr[RT];
#pragma unroll
          for (int r = 0; r < RT; ++r) sr[r] = sS[(ty + 16 * r) * LDS + k];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (c < pb) {
              const float xv = sX[k * P + tx + 16 * c];
#pragma unroll
              for (int r = 0; r < RT; ++r) acc[r][c] += sr[r] * xv;
            }
          }
        }
      }

      // y_i += exp(cum_i) (C_i hᵀ), from the state that entered the chunk
      float off[RT][4];
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) off[r][c] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cr[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) cr[r] = sC[(ty + 16 * r) * LDN + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (c < pb) {
            const float hv = sH[(tx + 16 * c) * LDN + n];
#pragma unroll
            for (int r = 0; r < RT; ++r) off[r][c] += cr[r] * hv;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int li = i0 + ty + 16 * r;
        if (li < Lc) {
          const float e = expf(sCum[li]);
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (c < pb)
              store(&yb[(long)(t0 + li) * x_row + tx + 16 * c], acc[r][c] + e * off[r][c]);
        }
      }
    }

    // h <- h exp(cum_last) + ((dt x) exp(cum_last - cum))ᵀ B; each thread
    // owns rows ty + 16 r and columns tx + 16 c of h
    const float last = sCum[Lc - 1];
    float hacc[4][8];
    const float hdecay = expf(last);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        hacc[r][c] = (r < pb && c < nb) ? sH[(ty + 16 * r) * LDN + tx + 16 * c] * hdecay : 0.f;
    for (int jt = 0; jt < nT; ++jt) {
      const int j0 = jt * T;
      __syncthreads();                 // y's reads of sB, sX, sC, sH are done
      load_tile(sB, LDN, Bb, bc_row, t0 + j0, Lc - j0, T, N);
      for (int i = tid; i < T * P; i += NT) {
        const int r = i / P, c = i % P;
        const int l = j0 + r;
        sX[i] = r < Lc - j0
                    ? to_f32(xb[(long)(t0 + l) * x_row + c]) * sDt[l] * expf(last - sCum[l])
                    : 0.f;
      }
      __syncthreads();
      for (int l = 0; l < T; ++l) {
        float xr[4], br[8];
#pragma unroll
        for (int r = 0; r < 4; ++r) xr[r] = r < pb ? sX[l * P + ty + 16 * r] : 0.f;
#pragma unroll
        for (int c = 0; c < 8; ++c) br[c] = c < nb ? sB[l * LDN + tx + 16 * c] : 0.f;
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) hacc[r][c] += xr[r] * br[c];
      }
    }
    __syncthreads();                   // every thread has read its old h
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (r < pb && c < nb) sH[(ty + 16 * r) * LDN + tx + 16 * c] = hacc[r][c];
  }

  __syncthreads();
  float* hb = h_out + ((long)b * H + h) * P * N;
  for (int i = tid; i < P * N; i += NT) hb[i] = sH[(i / N) * LDN + i % N];
}

template <typename Tin, int T>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* Bm,
                   const void* Cm, void* y, void* h_out, int Bsz, int S, int H,
                   int G, int P, int N, int L, cudaStream_t stream) {
  // above 48 KB of dynamic shared memory must be opted into, once per
  // instantiation and device (not on every launch: a launch may be captured
  // in a CUDA graph); the opt-in covers the largest shapes the kernel takes
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(ssd_scan_kernel<Tin, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_SMEM);
    if (err != cudaSuccess) return err;
    opted_in[dev] = true;
  }
  const size_t smem = sizeof(float) * smem_floats(T, P, N, L);
  ssd_scan_kernel<Tin, T><<<Bsz * H, NT, smem, stream>>>(
      static_cast<const Tin*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const Tin*>(Bm),
      static_cast<const Tin*>(Cm), static_cast<Tin*>(y), static_cast<float*>(h_out),
      S, H, G, P, N, L);
  return cudaGetLastError();
}

template <typename Tin>
cudaError_t launch_t(const void* x, const void* dt, const void* A, const void* Bm,
                     const void* Cm, void* y, void* h_out, int Bsz, int S, int H,
                     int G, int P, int N, int L, cudaStream_t stream) {
  if (L % 64 == 0) return launch<Tin, 64>(x, dt, A, Bm, Cm, y, h_out, Bsz, S, H, G, P, N, L, stream);
  if (L % 32 == 0) return launch<Tin, 32>(x, dt, A, Bm, Cm, y, h_out, Bsz, S, H, G, P, N, L, stream);
  return launch<Tin, 16>(x, dt, A, Bm, Cm, y, h_out, Bsz, S, H, G, P, N, L, stream);
}

}  // namespace

// dtype of x, B, C and y: 0 = float32, 1 = bfloat16. Takes P and N multiples
// of 16 up to 64 and 128, a chunk L that is a multiple of 16 up to 1024, and
// H a multiple of G. Returns the launch's cudaError_t.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, void* y, void* h_out,
                            int Bsz, int S, int H, int G, int P, int N, int L,
                            int dtype, void* stream) {
  if (Bsz <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 ||
      P % 16 != 0 || P > MAX_P || N <= 0 || N % 16 != 0 || N > MAX_N ||
      L <= 0 || L % 16 != 0 || L > MAX_CHUNK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_t<float>(x, dt, A, Bm, Cm, y, h_out, Bsz, S, H, G, P, N, L, s);
  if (dtype == 1)
    return (int)launch_t<__nv_bfloat16>(x, dt, A, Bm, Cm, y, h_out, Bsz, S, H, G, P, N, L, s);
  return (int)cudaErrorInvalidValue;
}
