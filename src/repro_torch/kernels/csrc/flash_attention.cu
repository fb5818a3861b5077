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
// in q's dtype. Masks: k_pos < Sk for the ragged edge (no host-side padding),
// and k_pos <= q_pos when causal; the causal walk stops at the tile that
// holds the diagonal. A masked logit is -1e30 and the result is
// acc / max(l, 1e-30), as in the Pallas kernel.
//
// Two kernels, one per dtype.
//
// bf16 (`flash_fwd_kernel_mma`, the serving path): one block per (64-row q
// tile, batch * q-head) with two groups of MW = 4 warps (a 32-row tile gave
// twice the blocks but was slower at S = 384 and 512). Within a group each
// warp owns 16 q rows and keeps their Q fragments in registers for the whole
// k walk; group i walks k tiles i, i + 2, ..., so
// the causal last q tile's walk of S / 64 tiles is two walks of half its
// length, each with its own online-softmax state, merged at the end
// (m = max, l and acc rescaled by exp(m_i - m)). K and V stay bf16 in shared
// memory, in a two-slot ring of one 64-row K and V tile per group, filled by
// cp.async (16 bytes a thread; rows padded by 16 bytes so that ldmatrix is
// free of bank conflicts) while the previous tiles are consumed. QKᵀ runs on
// the tensor cores (mma.sync m16n8k16 bf16, fp32 accumulators); the scale
// multiplies the fp32 logits; the online softmax (m, l) runs on the
// accumulator fragments with quad shuffles. PV runs on mma.sync too. The
// Pallas body keeps the softmax weights P in fp32, so each weight is split
// into hi = bf16(p) and lo = bf16(p - hi) and both products go into the same
// fp32 accumulator: P is kept to ~2^-16 relative, and V (bf16) is exact.
// Fully masked 32-column halves of the diagonal tile are skipped.
//
// fp32 (`flash_fwd_kernel`): every product is an fp32 FMA on the CUDA cores,
// as in the Pallas body, so that the fp32 checks hold at 1e-5 (TF32 keeps
// ~1e-3). One block of 256 threads per (64-row q tile, batch * q-head);
// four threads share a q row, each owning 16 logits and D/4 output columns.
//
// What bounds it on the card: at the serving shapes (S <= 512, D = 128) the
// bytes are a few MB and the function needs well under a GFLOP, so on an
// H100 SXM (3.35 TB/s, 989 bf16 TFLOP/s at 700 W) the bound is bytes, a few
// microseconds. What still keeps the bf16 kernel above it: at one short
// sequence the grid is small (S = 384: 96 blocks of 8 warps on 132 SMs) and
// the last q tile walks three 64-row k tiles per group while the first walks
// one, so latency, not the tensor cores' rate, sets the time; mma.sync issues
// per warp where wgmma would feed the tensor cores from shared memory for
// four warps at once; the hi/lo split doubles PV; and each block reloads its
// (b, kv-head)'s K/V from L2.
//
// Head dims: 16, 32, 64, 128 and 192 (Nemotron-4-340B's). At D = 192 the
// bf16 kernel's shared memory is 2 x 200 x (64 + 2 * 2 * 2 * 64) = 230,400
// bytes of the 232,448 a block may opt in to (the row stride of 200 bf16 is
// 25 16-byte units, odd, so ldmatrix stays free of bank conflicts), and the
// fp32 kernel's 164,608. The bf16 kernel's registers are the risk there: a
// warp holds Q fragments for 12 k-steps (48 registers a thread) and a 16 x
// 192 fp32 accumulator (96) beside the logits (32), under 255 a thread at
// 256 threads a block; `-Xptxas -v` (the build's log) reports the count and
// any spill bytes, and PERF.md keeps them. One block per SM at this shared
// memory either way.
#include "mma_common.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// fp32: FMA products on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // k rows per tile
constexpr int NT = 256;       // threads per block: 4 per q row

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
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
  const float* qb = q + ((long)b * Sq * Hq + h) * D;
  const float* kb = k + ((long)b * Sk * Hkv + hk) * D;
  const float* vb = v + ((long)b * Sk * Hkv + hk) * D;
  float* ob = o + ((long)b * Sq * Hq + h) * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D;
    const int qp = q0 + r;
    sQ[r * LDQ + d] = qp < Sq ? qb[qp * q_stride + d] * scale : 0.f;
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
        kv = kb[kp * k_stride + d];
        vv = vb[kp * k_stride + d];
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
    for (int j = 0; j < NO; ++j) ob[q_pos * q_stride + c + 4 * j] = acc[j] / denom;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core products (mma.sync), cp.async ring, ldmatrix fragments
// ---------------------------------------------------------------------------

// q warps per block, 16 q rows each: flash_attention.py's BF16_Q_TILE is 16 MW
constexpr int MW = 4;
constexpr int KSPLIT = 2;         // warp groups: group i walks k tiles i, i + 2, ...
constexpr int MBQ = 16 * MW;      // q rows per block
constexpr int MBK = 64;           // k rows per tile
constexpr int MNT = 32 * MW * KSPLIT;  // threads per block

// bytes of dynamic shared memory: the Q tile and a two-slot ring of one K
// and one V tile per warp group (after the walk, the ring holds the groups'
// partial results for the merge)
template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (D + 8) * (MBQ + 2 * KSPLIT * 2 * MBK);
}

template <int D>
__global__ void __launch_bounds__(MNT)
flash_fwd_kernel_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     int Sq, int Sk, int Hq, int Hkv, float scale, int causal) {
  constexpr int LD = D + 8;          // row stride in bf16: an odd count of 16-byte units
  constexpr int KS = D / 16;         // k-steps of QKᵀ
  constexpr int CH = D / 8;          // 16-byte chunks per row
  constexpr int TILE = MBK * LD;     // bf16 of one K or V tile
  static_assert(MW * 32 * (D / 2 + 4) * sizeof(float) <=
                    2 * KSPLIT * 2 * TILE * sizeof(__nv_bfloat16),
                "the merge area fits in the ring");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ring = sQ + MBQ * LD;        // [slot][group][K, V][MBK][LD]
  auto tile_K = [&](int slot, int grp) { return ring + ((slot * KSPLIT + grp) * 2) * TILE; };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qw = warp % MW, grp = warp / MW;  // q strip, k-tile group
  const int g = lane >> 2, tg = lane & 3;
  const int q0 = blockIdx.x * MBQ;
  const int b = blockIdx.y / Hq;
  const int h = blockIdx.y % Hq;
  const int hk = h / (Hq / Hkv);
  const long q_stride = (long)Hq * D;
  const long k_stride = (long)Hkv * D;
  const __nv_bfloat16* qb = q + ((long)b * Sq * Hq + h) * D;
  const __nv_bfloat16* kb = k + ((long)b * Sk * Hkv + hk) * D;
  const __nv_bfloat16* vb = v + ((long)b * Sk * Hkv + hk) * D;
  __nv_bfloat16* ob = o + ((long)b * Sq * Hq + h) * D;

  int nk = (Sk + MBK - 1) / MBK;
  if (causal) nk = min(nk, (q0 + MBQ - 1) / MBK + 1);
  const int nsteps = (nk + KSPLIT - 1) / KSPLIT;  // step t: tile KSPLIT t + group

  // K and V tiles of step t, one per group, into slot t & 1
  auto load_kv = [&](int t) {
    for (int i = tid; i < KSPLIT * MBK * CH; i += MNT) {
      const int gi = i / (MBK * CH), r = i / CH % MBK, c = (i % CH) * 8;
      const int kt = KSPLIT * t + gi;
      if (kt >= nk) continue;
      const bool ok = kt * MBK + r < Sk;
      const long off = (long)(ok ? kt * MBK + r : 0) * k_stride + c;
      __nv_bfloat16* dk = tile_K(t & 1, gi);
      cp_async16(dk + r * LD + c, kb + off, ok);
      cp_async16(dk + TILE + r * LD + c, vb + off, ok);
    }
  };

  for (int i = tid; i < MBQ * CH; i += MNT) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = q0 + r < Sq;
    cp_async16(sQ + r * LD + c, qb + (long)(ok ? q0 + r : 0) * q_stride + c, ok);
  }
  load_kv(0);
  cp_async_commit();

  // this warp's q rows: q0 + 16 qw + g (fragment rows 0) and + 8 (rows 1)
  const int row0 = q0 + 16 * qw + g;
  const int last_row = q0 + 16 * qw + 15;
  uint32_t qf[KS][4];
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int t = 0; t < nsteps; ++t) {
    cp_async_wait_all();
    __syncthreads();           // step t is in; every warp is done with step t - 1
    if (t == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldsm_x4(qf[ks], sQ + (16 * qw + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
    }
    if (t + 1 < nsteps) {      // the slot step t - 1 used is free
      load_kv(t + 1);
      cp_async_commit();
    }
    const int kt = KSPLIT * t + grp;
    const int k0 = kt * MBK;
    if (kt >= nk) continue;
    // 16-column slices of this tile that hold an unmasked logit for this warp
    int ncol = min(MBK / 16, (Sk - k0 + 15) / 16);
    if (causal) ncol = last_row < k0 ? 0 : min(ncol, (last_row - k0) / 16 + 1);
    if (ncol <= 0) continue;   // (causal) the whole tile lies above this warp's rows
    const __nv_bfloat16* tK = tile_K(t & 1, grp);
    const __nv_bfloat16* tV = tK + TILE;
    // S = Q Kᵀ: 16 x MBK per warp, 8 columns per fragment, 32 columns per
    // guard (a guard around each mma would split the loop into blocks that
    // ptxas cannot interleave); the mask zeroes a half past ncol
    float s[MBK / 8][4];
#pragma unroll
    for (int j = 0; j < MBK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int c32 = 0; c32 < MBK / 32; ++c32) {
      if (2 * c32 < ncol) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
          for (int c16 = 2 * c32; c16 < 2 * c32 + 2; ++c16) {
            uint32_t kf[4];    // two 8-column fragments of Kᵀ
            ldsm_x4(kf, tK + (c16 * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD
                            + ks * 16 + ((lane >> 3) & 1) * 8);
            mma_bf16(s[2 * c16], qf[ks], kf[0], kf[1]);
            mma_bf16(s[2 * c16 + 1], qf[ks], kf[2], kf[3]);
          }
        }
      }
    }

    // scale, mask, online softmax on the fragments: element e of fragment j
    // is row row0 + 8 (e >> 1), column k0 + 8 j + 2 tg + (e & 1)
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < MBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k_pos = k0 + 8 * j + 2 * tg + (e & 1);
        const int q_pos = row0 + 8 * (e >> 1);
        const bool ok = k_pos < Sk && (!causal || k_pos <= q_pos);
        s[j][e] = ok ? s[j][e] * scale : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < MBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * corr[r] + sum[r];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= corr[0]; acc[j][1] *= corr[0];
      acc[j][2] *= corr[1]; acc[j][3] *= corr[1];
    }

    // acc += P V, P = hi + lo: two 8-column fragments of S make the A
    // fragment of one 16-deep k-step
#pragma unroll
    for (int c16 = 0; c16 < MBK / 16; ++c16) {
      if (c16 < ncol) {
        uint32_t ph[4], pl[4];
        split_bf16(s[2 * c16][0], s[2 * c16][1], ph[0], pl[0]);
        split_bf16(s[2 * c16][2], s[2 * c16][3], ph[1], pl[1]);
        split_bf16(s[2 * c16 + 1][0], s[2 * c16 + 1][1], ph[2], pl[2]);
        split_bf16(s[2 * c16 + 1][2], s[2 * c16 + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int d16 = 0; d16 < D / 16; ++d16) {
          uint32_t vf[4];      // two 8-column fragments of V
          ldsm_x4_t(vf, tV + (c16 * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD
                            + d16 * 16 + (lane >> 4) * 8);
          mma_bf16(acc[2 * d16], ph, vf[0], vf[1]);
          mma_bf16(acc[2 * d16 + 1], ph, vf[2], vf[3]);
          mma_bf16(acc[2 * d16], pl, vf[0], vf[1]);
          mma_bf16(acc[2 * d16 + 1], pl, vf[2], vf[3]);
        }
      }
    }
  }


  // merge the groups' (m, l, acc) when both had tiles: group 1 leaves its
  // partial result in the ring, element j of thread i at j * 32 MW + i, and
  // group 0 combines m = max(m0, m1), l = l0 e^(m0 - m) + l1 e^(m1 - m), and
  // acc likewise
  if (nk > 1) {
    float* part = reinterpret_cast<float*>(ring);
    const int pi = qw * 32 + lane;
    __syncthreads();           // every warp is done with the ring
    if (grp == 1) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[(4 * j + e) * (32 * MW) + pi] = acc[j][e];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        part[(D / 2 + r) * (32 * MW) + pi] = m[r];
        part[(D / 2 + 2 + r) * (32 * MW) + pi] = l[r];
      }
    }
    __syncthreads();
    if (grp == 0) {
      float c0[2], c1[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m1 = part[(D / 2 + r) * (32 * MW) + pi];
        const float l1 = part[(D / 2 + 2 + r) * (32 * MW) + pi];
        const float mm = fmaxf(m[r], m1);
        c0[r] = expf(m[r] - mm);
        c1[r] = expf(m1 - mm);
        l[r] = l[r] * c0[r] + l1 * c1[r];
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[j][e] = acc[j][e] * c0[e >> 1] + part[(4 * j + e) * (32 * MW) + pi] * c1[e >> 1];
    }
  }
  if (grp != 0) return;

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q_pos = row0 + 8 * r;
    if (q_pos < Sq) {
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      __nv_bfloat16* orow = ob + (long)q_pos * q_stride + 2 * tg;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B,
                       int Sq, int Sk, int Hq, int Hkv, float scale, int causal,
                       cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool opted_in[64] = {};
  cudaError_t err = opt_in(flash_fwd_kernel<D>, smem, opted_in);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, B * Hq);
  flash_fwd_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, Hq, Hkv, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                        int Sq, int Sk, int Hq, int Hkv, float scale, int causal,
                        cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  static bool opted_in[64] = {};
  cudaError_t err = opt_in(flash_fwd_kernel_mma<D>, smem, opted_in);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + MBQ - 1) / MBQ, B * Hq);
  flash_fwd_kernel_mma<D><<<grid, MNT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      Sq, Sk, Hq, Hkv, scale, causal);
  return cudaGetLastError();
}

#define FLASH_DISPATCH(fn)                                                                   \
  switch (D) {                                                                               \
    case 16: return fn<16>(q, k, v, o, B, Sq, Sk, Hq, Hkv, scale, causal, s);                \
    case 32: return fn<32>(q, k, v, o, B, Sq, Sk, Hq, Hkv, scale, causal, s);                \
    case 64: return fn<64>(q, k, v, o, B, Sq, Sk, Hq, Hkv, scale, causal, s);                \
    case 128: return fn<128>(q, k, v, o, B, Sq, Sk, Hq, Hkv, scale, causal, s);              \
    case 192: return fn<192>(q, k, v, o, B, Sq, Sk, Hq, Hkv, scale, causal, s);              \
    default: return cudaErrorInvalidValue;                                                   \
  }

cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                   int Sk, int Hq, int Hkv, int D, float scale, int causal, int dtype,
                   cudaStream_t s) {
  if (dtype == 0) FLASH_DISPATCH(launch_f32)
  if (dtype == 1) FLASH_DISPATCH(launch_bf16)
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v and o 16-byte aligned. Returns
// the launch's cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int Sq, int Sk, int Hq,
                                   int Hkv, int D, float scale, int causal,
                                   int dtype, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk <= 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  return (int)launch(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, scale, causal, dtype,
                     static_cast<cudaStream_t>(stream));
}
