// Mamba2 SSD chunked scan (forward) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` of src/repro/kernels/ssd_scan.py
// (wrapper `ssd_scan`). The TPU kernel runs a grid (B, H, n_chunks) whose
// chunk axis is sequential, carries the (P, N) fp32 state in VMEM scratch
// across it, and holds a whole chunk's two L x L fp32 tiles at once. On the
// GPU the blocks of a grid run in parallel and in no order, and a block has
// at most 227 KB of shared memory, so:
//
//  * rows p of the state h (P x N) and columns p of y depend only on x[:, p],
//    so P is split into tiles of 16: one block per (batch, head, 16 columns
//    of P) walks the chunks in a loop and carries its 16 x N rows of the fp32
//    state for the whole walk. For one full-width Mamba2 sequence (H = 32,
//    P = 64) that is 128 blocks on 132 SMs. Each block recomputes the
//    chunk's prefix sum and its C Bᵀ scores;
//  * a chunk is cut into row tiles. For row tile i the block walks the
//    column tiles j <= i (the causal structure of flash attention without
//    the softmax):
//      S_ij = (C_i B_jᵀ) ⊙ exp(cum_i - cum_j) [row >= col]
//      y_i += S_ij (dt ⊙ x)_j
//    then adds the state term y_i += exp(cum_i) ⊙ (C_i hᵀ) from the state
//    that entered the chunk, and writes y_i in x's dtype. Every y row of a
//    chunk is computed from the old h before h is updated:
//      h <- h exp(cum_last) + ((dt ⊙ x) ⊙ exp(cum_last - cum))ᵀ B;
//  * above the diagonal the segment sum is positive and its exp could
//    overflow, so there the exponent is -inf before exp is taken (exp gives
//    exactly 0, as the plain version's -inf-filled segment sums do); a
//    select on the exponent, not a branch around exp, keeps the tile's
//    products in one basic block;
//  * the ragged tail needs no host padding: rows t >= S load as dt = 0,
//    x = B = C = 0 (exact, as the reference's zero padding is), and a
//    chunk's tile walk stops at its last valid row.
//
// dA_cum is the chunk's inclusive prefix sum of dt * A, taken by one thread
// in sequence as the plain version's cumsum takes it: the decays
// exp(cum_i - cum_j) subtract two sums of up to a chunk of terms, so a sum in
// another order would move them by an ulp of |cum| (~1e-4 relative at chunk
// 256), far more than the products' own rounding.
//
// Layout (the JAX package's): x (B, S, H, P) and B, C (B, S, G, N) in fp32 or
// bf16 (B and C in x's dtype), dt (B, S, H) fp32 after softplus, A (H,) fp32;
// head h reads group h / (H / G). Out: y (B, S, H, P) in x's dtype and the
// final state (B, H, P, N) fp32.
//
// Two kernels, one per dtype.
//
// bf16 (`ssd_scan_kernel_mma`, the serving path): 8 warps; row tiles of 128,
// one 16-row strip per warp; a chunk that 128 does not divide ends in a
// masked tile. The B and C tiles stay bf16 in shared memory, in a two-slot
// ring filled by cp.async while the previous stage is consumed; each warp
// holds its strip's C fragments in registers across the column walk. The
// state update rides on the last row tile's walk, which stages every column
// tile once: at chunk 256 a chunk is three stages, each one barrier. Warp 0
// fetches the next chunk's dt at the first stage and takes its prefix sum
// in the last, where it has the least work, so that only the first chunk
// waits for one. All
// four products run on the tensor cores (mma.sync m16n8k16 bf16, fp32
// accumulators):
//   - C Bᵀ has two bf16 operands: exact, one product;
//   - S (dt x): both fp32, each split into hi = bf16(v) and lo = bf16(v - hi);
//     three products hi·hi + hi·lo + lo·hi;
//   - C hᵀ and the state update (dt x decay)ᵀ B: one bf16 operand, the other
//     split; two products.
// A split operand keeps ~16 bits (~2^-16 relative), against TF32's 10, so
// the fp32 state holds atol = rtol = 1e-3 of the plain version. Each warp
// owns 16 columns of the state (N = 128) in its accumulators across chunks;
// a hi/lo bf16 copy in shared memory feeds C hᵀ.
//
// fp32 (`ssd_scan_kernel`): every product is an fp32 FMA on the CUDA cores,
// so that the fp32 checks hold at 1e-4 (TF32 keeps ~1e-3). 256 threads as a
// 16 x 16 grid, sub-tiles of 64, 32 or 16 rows (the largest that divides the
// chunk); inputs widened to fp32 as they are stored to shared memory.
//
// What bounds it on the card: at the serving shapes (S <= 1024, H = 32,
// P = 64, N = 128) the function moves ~10 MB and needs ~3 GFLOP, so on an
// H100 SXM (3.35 TB/s, 989 bf16 TFLOP/s at 700 W) the bound is bytes, a few
// microseconds. What still keeps the bf16 kernel above it: 128 blocks of 8
// warps leave each SM one block (~200 KB of shared memory at chunk 256), so
// the tensor cores wait on the latency of mma.sync chains and of the
// per-stage barriers (the chunk axis stays sequential); the causal diagonal
// tile leaves warps idle; the exps of the decays (one per score); mma.sync
// rather than wgmma; the split products (3 and 2 where one bf16 product
// would do for bf16 operands); and every P-block repeats the C Bᵀ scores and
// their exps.
#include "mma_common.cuh"

namespace {

constexpr int PT = 16;          // P columns per block (both kernels)

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }
constexpr int MAX_P = 64;
constexpr int MAX_N = 128;
constexpr int MAX_CHUNK = 1024;

// ---------------------------------------------------------------------------
// fp32: FMA products on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int NT = 256;         // threads per block: a 16 x 16 grid
constexpr int MAX_T = 64;       // rows per sub-tile

// floats of dynamic shared memory for one launch
__host__ __device__ constexpr int smem_floats(int T, int N, int L) {
  return PT * (N + 1)       // sH: this block's rows of the state
         + 2 * T * (N + 1)  // sC, sB: one row tile of C, one column tile of B
         + T * PT           // sX: one column tile of dt * x (times a decay)
         + T * (T + 1)      // sS: one T x T score tile
         + 2 * L;           // sDt, sCum: the chunk's dt and its dA prefix sum
}
constexpr size_t MAX_SMEM = sizeof(float) * smem_floats(MAX_T, MAX_N, MAX_CHUNK);

// rows [t0, t0 + T) of a (S, row_stride) matrix, `cols` wide, into shared
// memory with leading dimension ld; rows at or past `valid` load as zero
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          long row_stride, int t0, int valid,
                                          int T, int cols) {
  for (int i = threadIdx.x; i < T * cols; i += NT) {
    const int r = i / cols, c = i % cols;
    dst[r * ld + c] = r < valid ? src[(long)(t0 + r) * row_stride + c] : 0.f;
  }
}

template <int T>
__global__ void __launch_bounds__(NT)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, float* __restrict__ y,
                float* __restrict__ h_out, int S, int H, int G, int P, int N,
                int L) {
  constexpr int RT = T / 16;           // rows per thread in S and y tiles
  const int LDN = N + 1;               // odd: 16 rows at one column hit 16 banks
  constexpr int LDS = T + 1;
  const int nb = N / 16;

  extern __shared__ float smem[];
  float* sH = smem;
  float* sC = sH + PT * LDN;
  float* sB = sC + T * LDN;
  float* sX = sB + T * LDN;
  float* sS = sX + T * PT;
  float* sDt = sS + T * LDS;
  float* sCum = sDt + L;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int np = P / PT;
  const int p0 = (blockIdx.x % np) * PT;
  const int b = blockIdx.x / np / H, h = blockIdx.x / np % H;
  const int g = h / (H / G);
  const float a = A[h];
  const long x_row = (long)H * P;      // between consecutive positions
  const long bc_row = (long)G * N;
  const float* xb = x + (long)b * S * x_row + (long)h * P + p0;
  const float* dtb = dt + (long)b * S * H + h;
  const float* Bb = Bm + (long)b * S * bc_row + (long)g * N;
  const float* Cb = Cm + (long)b * S * bc_row + (long)g * N;
  float* yb = y + (long)b * S * x_row + (long)h * P + p0;

  for (int i = tid; i < PT * LDN; i += NT) sH[i] = 0.f;

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
      float acc[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[r] = 0.f;

      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * T;
        __syncthreads();               // sS, sB, sX (and sC, sCum) are free
        if (jt == 0) load_tile(sC, LDN, Cb, bc_row, t0 + i0, Lc - i0, T, N);
        load_tile(sB, LDN, Bb, bc_row, t0 + j0, Lc - j0, T, N);
        for (int i = tid; i < T * PT; i += NT) {
          const int r = i / PT, c = i % PT;
          sX[i] = r < Lc - j0 ? xb[(long)(t0 + j0 + r) * x_row + c] * sDt[j0 + r] : 0.f;
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
                s[r][c] * expf(gi >= gj ? sCum[gi] - sCum[gj] : neg_inf());
          }
        __syncthreads();

        // y_i += S_ij (dt x)_j: rows ty + 16 r, column tx
        for (int k = 0; k < T; ++k) {
          const float xv = sX[k * PT + tx];
#pragma unroll
          for (int r = 0; r < RT; ++r) acc[r] += sS[(ty + 16 * r) * LDS + k] * xv;
        }
      }

      // y_i += exp(cum_i) (C_i hᵀ), from the state that entered the chunk
      float off[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) off[r] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float hv = sH[tx * LDN + n];
#pragma unroll
        for (int r = 0; r < RT; ++r) off[r] += sC[(ty + 16 * r) * LDN + n] * hv;
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int li = i0 + ty + 16 * r;
        if (li < Lc) yb[(long)(t0 + li) * x_row + tx] = acc[r] + expf(sCum[li]) * off[r];
      }
    }

    // h <- h exp(cum_last) + ((dt x) exp(cum_last - cum))ᵀ B; each thread
    // owns row ty and columns tx + 16 c of h
    const float last = sCum[Lc - 1];
    float hacc[8];
    const float hdecay = expf(last);
#pragma unroll
    for (int c = 0; c < 8; ++c) hacc[c] = c < nb ? sH[ty * LDN + tx + 16 * c] * hdecay : 0.f;
    for (int jt = 0; jt < nT; ++jt) {
      const int j0 = jt * T;
      __syncthreads();                 // y's reads of sB, sX, sC, sH are done
      load_tile(sB, LDN, Bb, bc_row, t0 + j0, Lc - j0, T, N);
      for (int i = tid; i < T * PT; i += NT) {
        const int r = i / PT, c = i % PT;
        const int l = j0 + r;
        sX[i] = r < Lc - j0 ? xb[(long)(t0 + l) * x_row + c] * sDt[l] * expf(last - sCum[l])
                            : 0.f;
      }
      __syncthreads();
      for (int l = 0; l < T; ++l) {
        const float xr = sX[l * PT + ty];
#pragma unroll
        for (int c = 0; c < 8; ++c)
          if (c < nb) hacc[c] += xr * sB[l * LDN + tx + 16 * c];
      }
    }
    __syncthreads();                   // every thread has read its old h
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (c < nb) sH[ty * LDN + tx + 16 * c] = hacc[c];
  }

  __syncthreads();
  float* hb = h_out + (((long)b * H + h) * P + p0) * N;
  for (int i = tid; i < PT * N; i += NT) hb[i] = sH[(i / N) * LDN + i % N];
}

// ---------------------------------------------------------------------------
// bf16: tensor-core products (mma.sync), cp.async ring, ldmatrix fragments
// ---------------------------------------------------------------------------

constexpr int SW = 8;             // warps per block
constexpr int SNT = SW * 32;
constexpr int ST = 16 * SW;       // rows per tile: one 16-row strip per warp
constexpr int LDX = PT + 8;       // bf16 row stride of the dt x tiles (48 bytes)
static_assert(MAX_N <= 16 * SW, "each warp owns one 16-column pair of the state");

// 4 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0));
}

// bytes of dynamic shared memory for one launch, N padded to NPAD: a
// two-slot ring of (B tile, C tile, dt x hi/lo, dt x decay hi/lo), the
// state's hi/lo copy, and dt and cum of this chunk and the next
__host__ __device__ constexpr int mma_smem_bytes(int NPAD, int L) {
  return 2 * 2 * (2 * ST * (NPAD + 8) + 4 * ST * LDX) + 2 * 2 * PT * (NPAD + 8)
         + 2 * 2 * 4 * ((L + ST - 1) / ST * ST);
}
constexpr size_t MAX_MMA_SMEM = mma_smem_bytes(MAX_N, MAX_CHUNK);

// NK 16-deep k-steps over N, zero-padded to NPAD = 16 NK columns: every
// product loop has a compile-time trip count and no guard inside, so that
// ptxas can interleave its fragment loads and mma.sync
template <int NK>
__global__ void __launch_bounds__(SNT)
ssd_scan_kernel_mma(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
                    const __nv_bfloat16* __restrict__ Cm, __nv_bfloat16* __restrict__ y,
                    float* __restrict__ h_out, int S, int H, int G, int P, int N, int L) {
  constexpr int NPAD = 16 * NK;
  constexpr int LDN = NPAD + 8;     // bf16 row stride: an odd count of 16-byte units
  constexpr int CHN = NPAD / 8;     // 16-byte chunks per row of B / C
  const int Lp = (L + ST - 1) / ST * ST;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  constexpr int slot_elems = 2 * ST * LDN + 4 * ST * LDX;
  __nv_bfloat16* sHh = ring + 2 * slot_elems;           // [PT][LDN]
  __nv_bfloat16* sHl = sHh + PT * LDN;
  // dt and its prefix sum, [2][Lp]: chunk c in buffer c & 1
  float* sDt2 = reinterpret_cast<float*>(sHl + PT * LDN);
  float* sCum2 = sDt2 + 2 * Lp;
  // slot s & 1: B_j, C_i, (dt x)_j hi and lo, (dt x decay)_j hi and lo
  auto slot_B = [&](int s) { return ring + (s & 1) * slot_elems; };
  auto slot_C = [&](int s) { return slot_B(s) + ST * LDN; };
  auto slot_X = [&](int s, int k) { return slot_C(s) + ST * LDN + k * ST * LDX; };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int np = P / PT;
  const int p0 = (blockIdx.x % np) * PT;
  const int b = blockIdx.x / np / H, h = blockIdx.x / np % H;
  const int grp = h / (H / G);
  const float a = A[h];
  const long x_row = (long)H * P;      // between consecutive positions
  const long bc_row = (long)G * N;
  const __nv_bfloat16* xb = x + (long)b * S * x_row + (long)h * P + p0;
  const float* dtb = dt + (long)b * S * H + h;
  const __nv_bfloat16* Bb = Bm + (long)b * S * bc_row + (long)grp * N;
  const __nv_bfloat16* Cb = Cm + (long)b * S * bc_row + (long)grp * N;
  __nv_bfloat16* yb = y + (long)b * S * x_row + (long)h * P + p0;

  for (int i = tid; i < 2 * PT * LDN; i += SNT) sHh[i] = __float2bfloat16(0.f);
  // this warp's 16 columns of the state (16 x N): pair `warp` of N
  const bool owns = warp < N / 16;
  float hs[2][4] = {};

  // warp 0 fetches the dt of the chunk at tn into buffer nb with cp.async
  // (rows past the chunk or past S are 0) ...
  auto fetch_dt = [&](int tn, int nb) {
    const int Ln = min(L, S - tn), rows = (Ln + ST - 1) / ST * ST;
    for (int l = lane; l < rows; l += 32) {
      const bool ok = l < Ln;
      cp_async4(sDt2 + nb * Lp + l, dtb + (long)(tn + (ok ? l : 0)) * H, ok);
    }
    cp_async_commit();
  };
  // ... and its lane 0 then takes the inclusive prefix sum of dt * A in
  // order (the plain version's cumsum, bit for bit: no fused multiply-add,
  // same sequence)
  auto prefix_sum = [&](int tn, int nb) {
    cp_async_wait_all();
    __syncwarp();
    if (lane == 0) {
      const int rows = (min(L, S - tn) + ST - 1) / ST * ST;
      const float* d = sDt2 + nb * Lp;
      float* c = sCum2 + nb * Lp;
      float cum = 0.f;
      for (int l = 0; l < rows; l += 8) {
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = d[l + u];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          cum = __fadd_rn(cum, __fmul_rn(v[u], a));
          c[l + u] = cum;
        }
      }
    }
  };
  if (warp == 0) {
    fetch_dt(0, 0);
    prefix_sum(0, 0);
  }
  __syncthreads();

  for (int t0 = 0, cb = 0; t0 < S; t0 += L, cb ^= 1) {
    const float* sDt = sDt2 + cb * Lp;
    const float* sCum = sCum2 + cb * Lp;
    const bool next = t0 + L < S;      // the next chunk's dt and prefix sum
                                       // are made while this chunk runs
    const int Lc = min(L, S - t0);     // valid rows of this chunk
    const int nT = (Lc + ST - 1) / ST;
    const int n_st = nT * (nT + 1) / 2;  // stages (row tile it, column tile jt <= it)

    // stage s -> (it, jt)
    auto decode = [&](int s, int& it, int& jt) {
      it = 0;
      while ((it + 1) * (it + 2) / 2 <= s) ++it;
      jt = s - it * (it + 1) / 2;
    };
    // B_j (and C_i at a row tile's first stage) into the stage's slot;
    // rows past the chunk and columns past N are zero-filled
    auto issue = [&](int s) {
      int it, jt;
      decode(s, it, jt);
      const int j0 = jt * ST;
      __nv_bfloat16* dB = slot_B(s);
      __nv_bfloat16* dC = slot_C(s);
      for (int i = tid; i < ST * CHN; i += SNT) {
        const int r = i / CHN, c = (i % CHN) * 8;
        const bool okb = r < Lc - j0 && c < N;
        cp_async16(dB + r * LDN + c, okb ? Bb + (long)(t0 + j0 + r) * bc_row + c : Bb, okb);
        if (jt == 0) {
          const bool okc = r < Lc - it * ST && c < N;
          cp_async16(dC + r * LDN + c, okc ? Cb + (long)(t0 + it * ST + r) * bc_row + c : Cb,
                     okc);
        }
      }
      cp_async_commit();
    };
    // one 16-byte chunk of x per thread: row tid / 2, columns 8 (tid & 1)
    auto load_x = [&](int s) {
      int it, jt;
      decode(s, it, jt);
      const int r = tid >> 1;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < Lc - jt * ST)
        v = *reinterpret_cast<const uint4*>(xb + (long)(t0 + jt * ST + r) * x_row + (tid & 1) * 8);
      return v;
    };
    // dt x as hi/lo bf16; in the last row tile's walk, which also updates
    // the state, dt x exp(cum_last - cum) too
    auto store_x = [&](int s, uint4 v) {
      int it, jt;
      decode(s, it, jt);
      const int r = tid >> 1, l = jt * ST + r, o = r * LDX + (tid & 1) * 8;
      const uint32_t xv[4] = {v.x, v.y, v.z, v.w};
      float xf[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {    // a bf16 is the top half of an fp32
        xf[2 * e] = __uint_as_float(xv[e] << 16) * sDt[l];
        xf[2 * e + 1] = __uint_as_float(xv[e] & 0xffff0000u) * sDt[l];
      }
      for (int k = 0; k < (it == nT - 1 ? 2 : 1); ++k) {
        if (k == 1) {
          const float d = expf(sCum[Lc - 1] - sCum[l]);
#pragma unroll
          for (int e = 0; e < 8; ++e) xf[e] *= d;
        }
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_bf16(xf[2 * e], xf[2 * e + 1], hi[e], lo[e]);
        *reinterpret_cast<uint4*>(slot_X(s, 2 * k) + o) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(slot_X(s, 2 * k + 1) + o) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
    };

    issue(0);
    store_x(0, load_x(0));

    uint32_t cf[NK][4];                // this warp's strip of C_i, A fragments
    // its strip of y_i (P columns 0-7, 8-15), one sum per split product
    float yhh[2][4], ylh[2][4], yhl[2][4];
    for (int s = 0; s < n_st; ++s) {
      cp_async_wait_all();
      __syncthreads();                 // stage s is in; stage s - 1's slot is free
      uint4 xn;
      if (s + 1 < n_st) {
        issue(s + 1);
        xn = load_x(s + 1);
      }
      if (s == 0 && next && warp == 0) fetch_dt(t0 + L, cb ^ 1);
      int it, jt;
      decode(s, it, jt);
      const __nv_bfloat16* tB = slot_B(s);
      const __nv_bfloat16* tXh = slot_X(s, 0);
      const __nv_bfloat16* tXl = slot_X(s, 1);
      const int i0 = it * ST + 16 * warp;   // this warp's strip, rows of the chunk

      if (i0 < Lc) {
        // -- y_i += S_ij (dt x)_j for rows i0 + {g, g + 8}
        if (jt == 0) {
          const __nv_bfloat16* tC = slot_C(s);
#pragma unroll
          for (int ks = 0; ks < NK; ++ks)
            ldsm_x4(cf[ks], tC + (16 * warp + (lane & 15)) * LDN + ks * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) yhh[n][e] = ylh[n][e] = yhl[n][e] = 0.f;
        }
        // 64-column groups of the tile with a column at or left of the
        // diagonal for this strip; the mask zeroes the rest of a group
        const int ngroups = jt == it ? (warp >> 2) + 1 : ST / 64;
#pragma unroll
        for (int cg = 0; cg < ST / 64; ++cg) {
          if (cg < ngroups) {
            // S = C_i B_jᵀ on 64 columns (exact: bf16 operands, fp32 sums)
            float sc[8][4];
#pragma unroll
            for (int j = 0; j < 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
            for (int ks = 0; ks < NK; ++ks) {
#pragma unroll
              for (int c4 = 0; c4 < 4; ++c4) {
                uint32_t bf[4];
                ldsm_x4(bf, tB + (cg * 64 + c4 * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDN
                                + ks * 16 + ((lane >> 3) & 1) * 8);
                mma_bf16(sc[2 * c4], cf[ks], bf[0], bf[1]);
                mma_bf16(sc[2 * c4 + 1], cf[ks], bf[2], bf[3]);
              }
            }
            // decay and causal mask; then y += S (dt x)_j in three split products
#pragma unroll
            for (int c4 = 0; c4 < 4; ++c4) {
              uint32_t ah[4], al[4];
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const int j = 2 * c4 + half;
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int gi = i0 + g + 8 * (e >> 1);
                  const int gj = jt * ST + cg * 64 + 8 * j + 2 * tg + (e & 1);
                  sc[j][e] *= expf(gi >= gj ? sCum[gi] - sCum[gj] : neg_inf());
                }
                split_bf16(sc[j][0], sc[j][1], ah[2 * half], al[2 * half]);
                split_bf16(sc[j][2], sc[j][3], ah[2 * half + 1], al[2 * half + 1]);
              }
              uint32_t xh[4], xl[4];
              const int xo = (cg * 64 + c4 * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDX
                             + (lane >> 4) * 8;
              ldsm_x4_t(xh, tXh + xo);
              ldsm_x4_t(xl, tXl + xo);
              mma_bf16(yhh[0], ah, xh[0], xh[1]);
              mma_bf16(yhh[1], ah, xh[2], xh[3]);
              mma_bf16(ylh[0], al, xh[0], xh[1]);
              mma_bf16(ylh[1], al, xh[2], xh[3]);
              mma_bf16(yhl[0], ah, xl[0], xl[1]);
              mma_bf16(yhl[1], ah, xl[2], xl[3]);
            }
          }
        }
        if (jt == it) {
          // y_i += exp(cum_i) (C_i hᵀ) from the state that entered the chunk
          float oh[2][4] = {}, ol[2][4] = {};
#pragma unroll
          for (int ks = 0; ks < NK; ++ks) {
            uint32_t hh[4], hl[4];
            const int ho = ((lane & 7) + ((lane >> 4) << 3)) * LDN + ks * 16 + ((lane >> 3) & 1) * 8;
            ldsm_x4(hh, sHh + ho);
            ldsm_x4(hl, sHl + ho);
            mma_bf16(oh[0], cf[ks], hh[0], hh[1]);
            mma_bf16(oh[1], cf[ks], hh[2], hh[3]);
            mma_bf16(ol[0], cf[ks], hl[0], hl[1]);
            mma_bf16(ol[1], cf[ks], hl[2], hl[3]);
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int li = i0 + g + 8 * r;
            if (li < Lc) {
              const float e = expf(sCum[li]);
              __nv_bfloat16* yrow = yb + (long)(t0 + li) * x_row + 2 * tg;
              float v[2][2];
#pragma unroll
              for (int n = 0; n < 2; ++n)
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                  const int k = 2 * r + c;
                  v[n][c] = yhh[n][k] + ylh[n][k] + yhl[n][k] + e * (oh[n][k] + ol[n][k]);
                }
#pragma unroll
              for (int n = 0; n < 2; ++n)
                *reinterpret_cast<__nv_bfloat162*>(yrow + 8 * n) =
                    __floats2bfloat162_rn(v[n][0], v[n][1]);
            }
          }
        }
      }

      if (it == nT - 1 && owns) {
        // -- state: h <- h exp(cum_last) + (dt x decay)_jᵀ B_j on the last
        // row tile's walk, which stages every column tile j once (rows past
        // the chunk are zero)
        if (jt == 0) {
          const float hdecay = expf(sCum[Lc - 1]);
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) hs[n][e] *= hdecay;
        }
        const __nv_bfloat16* tDh = slot_X(s, 2);
        const __nv_bfloat16* tDl = slot_X(s, 3);
        float th[2][4] = {}, tl[2][4] = {};
#pragma unroll
        for (int ks = 0; ks < ST / 16; ++ks) {
          uint32_t ah[4], al[4], bf[4];  // (dt x decay)ᵀ: rows p, columns l
          const int xo = (ks * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDX + ((lane >> 3) & 1) * 8;
          ldsm_x4_t(ah, tDh + xo);
          ldsm_x4_t(al, tDl + xo);
          ldsm_x4_t(bf, tB + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDN
                           + warp * 16 + (lane >> 4) * 8);
          mma_bf16(th[0], ah, bf[0], bf[1]);
          mma_bf16(th[1], ah, bf[2], bf[3]);
          mma_bf16(tl[0], al, bf[0], bf[1]);
          mma_bf16(tl[1], al, bf[2], bf[3]);
        }
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) hs[n][e] += th[n][e] + tl[n][e];
      }
      if (s + 1 < n_st)
        store_x(s + 1, xn);
      else if (next && warp == 0)      // warp 0 has the least of the last stage
        prefix_sum(t0 + L, cb ^ 1);
    }

    // the new state's hi/lo copy for the next chunk's C hᵀ, once every warp
    // is done with this chunk's (and with the ring; the next chunk's dt and
    // cum are in)
    __syncthreads();
    if (owns) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int o = (g + 8 * r) * LDN + warp * 16 + n * 8 + 2 * tg;
          uint32_t hi, lo;
          split_bf16(hs[n][2 * r], hs[n][2 * r + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(sHh + o) = hi;
          *reinterpret_cast<uint32_t*>(sHl + o) = lo;
        }
    }
  }

  if (owns) {
    float* hb = h_out + (((long)b * H + h) * P + p0) * N;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(hb + (g + 8 * r) * N + warp * 16 + n * 8 + 2 * tg) =
            make_float2(hs[n][2 * r], hs[n][2 * r + 1]);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int T>
cudaError_t launch_f32(const void* x, const void* dt, const void* A, const void* Bm,
                       const void* Cm, void* y, void* h_out, int Bsz, int S, int H,
                       int G, int P, int N, int L, cudaStream_t stream) {
  static bool opted_in[64] = {};
  cudaError_t err = opt_in(ssd_scan_kernel<T>, MAX_SMEM, opted_in);
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(float) * smem_floats(T, N, L);
  ssd_scan_kernel<T><<<Bsz * H * (P / PT), NT, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<float*>(y), static_cast<float*>(h_out),
      S, H, G, P, N, L);
  return cudaGetLastError();
}

template <int NK>
cudaError_t launch_bf16(const void* x, const void* dt, const void* A, const void* Bm,
                        const void* Cm, void* y, void* h_out, int Bsz, int S, int H,
                        int G, int P, int N, int L, cudaStream_t stream) {
  static bool opted_in[64] = {};
  cudaError_t err = opt_in(ssd_scan_kernel_mma<NK>, MAX_MMA_SMEM, opted_in);
  if (err != cudaSuccess) return err;
  ssd_scan_kernel_mma<NK><<<Bsz * H * (P / PT), SNT, mma_smem_bytes(16 * NK, L), stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const __nv_bfloat16*>(Bm),
      static_cast<const __nv_bfloat16*>(Cm), static_cast<__nv_bfloat16*>(y),
      static_cast<float*>(h_out), S, H, G, P, N, L);
  return cudaGetLastError();
}

}  // namespace

// dtype of x, B, C and y: 0 = float32, 1 = bfloat16. Takes P and N multiples
// of 16 up to 64 and 128, a chunk L that is a multiple of 16 up to 1024, H a
// multiple of G, and (bf16) x, B and C 16-byte aligned. Returns the launch's
// cudaError_t.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, void* y, void* h_out,
                            int Bsz, int S, int H, int G, int P, int N, int L,
                            int dtype, void* stream) {
  if (Bsz <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 ||
      P % PT != 0 || P > MAX_P || N <= 0 || N % 16 != 0 || N > MAX_N ||
      L <= 0 || L % 16 != 0 || L > MAX_CHUNK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (L % 64 == 0) return (int)launch_f32<64>(x, dt, A, Bm, Cm, y, h_out, Bsz, S, H, G, P, N, L, s);
    if (L % 32 == 0) return (int)launch_f32<32>(x, dt, A, Bm, Cm, y, h_out, Bsz, S, H, G, P, N, L, s);
    return (int)launch_f32<16>(x, dt, A, Bm, Cm, y, h_out, Bsz, S, H, G, P, N, L, s);
  }
  if (dtype == 1) {              // N padded to 16, 32, 64 or 128 columns
    if (N <= 16) return (int)launch_bf16<1>(x, dt, A, Bm, Cm, y, h_out, Bsz, S, H, G, P, N, L, s);
    if (N <= 32) return (int)launch_bf16<2>(x, dt, A, Bm, Cm, y, h_out, Bsz, S, H, G, P, N, L, s);
    if (N <= 64) return (int)launch_bf16<4>(x, dt, A, Bm, Cm, y, h_out, Bsz, S, H, G, P, N, L, s);
    return (int)launch_bf16<8>(x, dt, A, Bm, Cm, y, h_out, Bsz, S, H, G, P, N, L, s);
  }
  return (int)cudaErrorInvalidValue;
}
