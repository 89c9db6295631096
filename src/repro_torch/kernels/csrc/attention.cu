// Flash attention for Hopper (sm_90a): the port of the TPU kernel
// `_attn_kernel` / `flash_attention_pallas` in `src/repro/kernels/attention.py`.
//
// What it computes (the same as the TPU kernel, not carried over block by
// block): q (B, Hq, Lq, D), k/v (B, Hkv, Lkv, D) -> out (B, Hq, Lq, D) in the
// IO dtype, softmax(q k^T / sqrt(D)) v with an online softmax over KV blocks
// of b_kv rows:
//   * s = q.k^T * scale in fp32; causal: column c is masked for query row r
//     (global position q_offset + r) when c > q_offset + r; masked scores are
//     NEG_INF = -1e30, as on the TPU;
//   * m_new = max(m, rowmax s), p = exp(s - m_new), alpha = exp(m - m_new),
//     l = l*alpha + rowsum p, acc = acc*alpha + round(p) . v, where round(p)
//     casts p to the IO dtype before the product (the TPU kernel's
//     `p.astype(v.dtype)`); m, l and acc are fp32;
//   * out = acc / max(l, 1e-30).
// Nothing is padded: KV columns >= Lkv are masked by length here (the
// reference's ops layer padded KV and hid the padding behind a causal
// offset, which is exact only for Lq == 1).
//
// GQA-packed rows.  A CTA owns one (b, KV head) and b_q "packed" rows: packed
// row p in [0, group*Lq), group = Hq/Hkv, is query row p % Lq of query head
// hkv*group + p / Lq.  Those rows are contiguous in q and out, so the CTA
// reads and writes them as one (group*Lq, D) matrix; only the causal
// position (q_offset + p % Lq) needs the division.  The grid is
// (ceil(group*Lq / b_q), Hkv, B) and each K/V tile is read from device
// memory once per (b, KV head, row block): at decode (Lq = 1) the query
// heads of a group fill the rows of one tile (5 of 16 for qwen3-14b), where
// a CTA per query head would read the KV head group times.  A causal CTA
// stops at the KV block holding the diagonal of its largest query position
// (a CTA whose rows straddle two heads walks to Lq - 1: correct, the blocks
// past a row's diagonal add exp(-1e30 - m) = 0, only wasteful).
//
// bf16: tensor cores.  Each warp owns 16 packed rows and runs both products
// as mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32: Q.K^T from Q and K
// fragments loaded with ldmatrix, P.V with P converted to bf16 in registers
// from the S accumulator fragment (the FlashAttention-2 layout) and V
// through ldmatrix.trans.  Row max and row sum are quad shuffles; m, l and
// the 16 x D fp32 output accumulator stay in registers, so nothing but the
// Q, K and V tiles lives in shared memory.  K and V stream through a ring of
// `prefetch` stages filled by 16-byte cp.async copies (zero-filled past Lkv
// and past D); rows are padded by 16 bytes so the eight rows an ldmatrix
// phase reads hit distinct banks.  The head dim is a template bucket
// (64, 128 or 256; D up to it, the rest zero) so the accumulator is indexed
// at compile time; at 128 and below the Q fragments stay in registers.
// A CTA of fewer than 4 row tiles gives each tile cs = min(4 / (b_q/16),
// b_kv/16) warps, each taking a disjoint slice of b_kv/cs columns of every
// KV block with its own m, l and acc; the warps merge them once, after the
// last block, through the freed KV ring.  So a decode CTA still has 4 warps
// pulling K/V.  A split rounds p against its own slice's max instead of the
// block's, which moves each bf16 rounding of p by at most half an ulp of
// bf16 relative to p: well inside the bf16 tolerance of 2e-2 that the
// kernel is held to against its plain version and the fp32 oracle.
//
// fp32 (a checking dtype: every model and tune target runs bf16): the
// CUDA-core body of the first version, on the same packed rows.  256
// threads as a 16 x 16 grid; thread (ty, tx) owns rows ty + 16*i and score
// columns tx + 16*j; products are fmaf loops over shared memory, p through a
// shared fp32 tile, the accumulator in shared memory.  TF32 would change
// the numbers.
//
// What bounds it on this card: at a long causal prefill it does about
// group*D/2 FLOPs per byte of K/V per row block, far above the ~295 FLOP/B
// ridge, so it is bound by operations; at decode (Lq = 1) each KV element is
// used by the group's rows only, so it is bound by reading K and V once.
// What is left: wgmma (warpgroup products from shared-memory descriptors),
// TMA with mbarriers in place of the cp.async ring, and a split of a long
// cache across CTAs (with a combine pass) for decode at small B*Hkv, where
// today B*Hkv CTAs cannot fill 132 SMs.
//
// Built by kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound through the plain C entry point `attention_launch` with ctypes.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <type_traits>

#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace mma;

constexpr int kMaxSmem = 232448;  // dynamic shared memory opt-in limit
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;  // src-size 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most n commit groups are still in flight (n = stages - 1)
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n <= 0) {
    asm volatile("cp.async.wait_group 0;\n" ::);
  } else if (n == 1) {
    asm volatile("cp.async.wait_group 1;\n" ::);
  } else {
    asm volatile("cp.async.wait_group 2;\n" ::);
  }
}

// `rows` rows of D elements starting at global row r0 (of n) into shared
// memory with row stride ds, `cpr` 16-byte chunks a row; rows >= n and
// columns >= D are zero-filled.
template <typename T, int NTHREADS>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ src, int rows, int r0,
                                          int n, int D, int ds, int cpr) {
  constexpr int V = 16 / sizeof(T);
  for (int c = threadIdx.x; c < rows * cpr; c += NTHREADS) {
    const int r = c / cpr, dc = (c % cpr) * V;
    const bool ok = r0 + r < n && dc < D;
    cp_async16(dst + r * ds + dc, ok ? src + (size_t)(r0 + r) * D + dc : src, ok);
  }
}

// The largest (last) and smallest (first) query position among packed rows
// [p0, p0 + bq) of nrows: a CTA straddling two heads holds rows Lq-1 and 0.
__device__ __forceinline__ int2 position_range(int p0, int bq, int nrows, int Lq,
                                               int q_offset) {
  const int p1 = min(p0 + bq, nrows) - 1;
  if (p0 / Lq != p1 / Lq) return make_int2(q_offset, q_offset + Lq - 1);
  return make_int2(q_offset + p0 % Lq, q_offset + p1 % Lq);
}

// ---------------------------------------------------------------------------
// bf16: mma.sync tensor cores
// ---------------------------------------------------------------------------

template <int BQ, int BKV> struct MmaShape {
  static constexpr int kRowTiles = BQ / 16;
  // warps per row tile: 4 warps in all where the rows alone give fewer
  static constexpr int kSplit =
      kRowTiles >= 4 ? 1 : (4 / kRowTiles < BKV / 16 ? 4 / kRowTiles : BKV / 16);
  static constexpr int kWarps = kRowTiles * kSplit;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kCols = BKV / kSplit;  // KV columns of one warp's slice
};

template <int BQ, int BKV, int DM> size_t mma_smem_bytes(int stages) {
  using S = MmaShape<BQ, BKV>;
  const size_t row = (size_t)(DM + 8) * sizeof(bf16);
  const size_t ring = (size_t)stages * 2 * BKV * row;
  const size_t merge =
      S::kSplit > 1 ? (size_t)S::kWarps * 16 * (DM + 4 + 2) * sizeof(float) : 0;
  return (size_t)BQ * row + (ring > merge ? ring : merge);
}

// Fragment layout of m16n8k16 (lane = 4*g + t4): an A or C fragment holds
// rows g and g+8; C element e of n-tile j is (row g + 8*(e/2), column
// 8j + 2*t4 + e%2).  Scores are kept in the log2 domain (scale * log2 e
// folded in), so exp is exp2; NEG_INF keeps its meaning there.
template <int BQ, int BKV, int DM>
__global__ void __launch_bounds__((MmaShape<BQ, BKV>::kThreads), 1)
    attn_mma_kernel(const bf16* __restrict__ Q, const bf16* __restrict__ K,
                    const bf16* __restrict__ V, bf16* __restrict__ O, int Hq, int Hkv, int Lq,
                    int Lkv, int D, float scale_log2, int causal, int q_offset, int stages) {
  using S = MmaShape<BQ, BKV>;
  constexpr int kThreads = S::kThreads;
  constexpr int kNT = S::kCols / 8;  // score n-tiles of a warp's slice
  constexpr int kKD = DM / 16;       // k-steps of Q.K^T
  constexpr int kND = DM / 8;        // output n-tiles
  constexpr int kDS = DM + 8;        // shared row stride: 16 bytes of pad
  constexpr bool kQReg = DM <= 128;  // Q fragments held in registers
  constexpr int kStage = 2 * BKV * kDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* KVs = Qs + BQ * kDS;

  const int group = Hq / Hkv, nrows = group * Lq;
  const int p0 = blockIdx.x * BQ, hkv = blockIdx.y, b = blockIdx.z;
  const size_t qo = ((size_t)b * Hq + (size_t)hkv * group) * Lq * D;
  const size_t kvo = ((size_t)b * Hkv + hkv) * Lkv * D;
  const bf16* Qg = Q + qo;
  bf16* Og = O + qo;
  const bf16* Kg = K + kvo;
  const bf16* Vg = V + kvo;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rt = warp / S::kSplit, cw = warp % S::kSplit;
  const int g = lane >> 2, t4 = lane & 3;

  const int2 pos = position_range(p0, BQ, nrows, Lq, q_offset);
  int nkv = (Lkv + BKV - 1) / BKV;
  if (causal) nkv = min(nkv, pos.y / BKV + 1);
  const int pr = p0 + rt * 16 + g;  // this thread's packed rows pr, pr + 8
  const int pos0 = q_offset + pr % Lq, pos1 = q_offset + (pr + 8) % Lq;

  // the Q tile in a commit group of its own, then stages-1 KV blocks
  load_rows<bf16, kThreads>(Qs, Qg, BQ, p0, nrows, D, kDS, DM / 8);
  cp_async_commit();
  for (int s = 0; s < stages - 1; ++s) {
    if (s < nkv) {
      bf16* st = KVs + s * kStage;
      load_rows<bf16, kThreads>(st, Kg, BKV, s * BKV, Lkv, D, kDS, DM / 8);
      load_rows<bf16, kThreads>(st + BKV * kDS, Vg, BKV, s * BKV, Lkv, D, kDS, DM / 8);
    }
    cp_async_commit();
  }
  cp_async_wait(stages - 1);
  __syncthreads();

  const bf16* Qw = Qs + (rt * 16 + (lane & 15)) * kDS + (lane >> 4) * 8;
  uint32_t qf[kQReg ? kKD : 1][4];
  if constexpr (kQReg) {
#pragma unroll
    for (int kk = 0; kk < kKD; ++kk) ldsm_x4(qf[kk], Qw + kk * 16);
  }

  float acc[kND][4];
#pragma unroll
  for (int n = 0; n < kND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // l: this thread's columns

  // ldmatrix row addresses of this lane within the warp's slice
  const int k_row = cw * S::kCols + (lane & 7) + ((lane >> 4) << 3);
  const int k_col = ((lane >> 3) & 1) * 8;
  const int v_row = cw * S::kCols + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int v_col = (lane >> 4) * 8;

  for (int t = 0; t < nkv; ++t) {
    const int nt = t + stages - 1;
    if (nt < nkv) {
      bf16* st = KVs + (nt % stages) * kStage;
      load_rows<bf16, kThreads>(st, Kg, BKV, nt * BKV, Lkv, D, kDS, DM / 8);
      load_rows<bf16, kThreads>(st + BKV * kDS, Vg, BKV, nt * BKV, Lkv, D, kDS, DM / 8);
    }
    cp_async_commit();
    cp_async_wait(stages - 1);
    __syncthreads();

    const bf16* Ks = KVs + (t % stages) * kStage;
    const bf16* Vs = Ks + BKV * kDS;

    // s = q . k^T over this warp's kCols columns, fp32
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKD; ++kk) {
      uint32_t a[4];
      if constexpr (kQReg) {
        a[0] = qf[kk][0], a[1] = qf[kk][1], a[2] = qf[kk][2], a[3] = qf[kk][3];
      } else {
        ldsm_x4(a, Qw + kk * 16);
      }
#pragma unroll
      for (int jp = 0; jp < kNT / 2; ++jp) {
        uint32_t kb[4];
        ldsm_x4(kb, Ks + (k_row + jp * 16) * kDS + kk * 16 + k_col);
        mma_bf16(s[2 * jp], a, kb[0], kb[1]);
        mma_bf16(s[2 * jp + 1], a, kb[2], kb[3]);
      }
    }

    // scale (log2 domain), mask where the block reaches past Lkv or past
    // the CTA's smallest position, online softmax over the quad's row
    const int kv0 = t * BKV;
    const bool masked = kv0 + BKV > Lkv || (causal && kv0 + BKV - 1 > pos.x);
    const int c0 = kv0 + cw * S::kCols + 2 * t4;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = s[j][e] * scale_log2;
        if (masked) {
          const int col = c0 + 8 * j + (e & 1);
          if (col >= Lkv || (causal && col > (e < 2 ? pos0 : pos1))) v = kNegInf;
        }
        s[j][e] = v;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      s[j][0] = exp2f(s[j][0] - mn0);
      s[j][1] = exp2f(s[j][1] - mn0);
      s[j][2] = exp2f(s[j][2] - mn1);
      s[j][3] = exp2f(s[j][3] - mn1);
      ls0 += s[j][0] + s[j][1];
      ls1 += s[j][2] + s[j][3];
    }
    l0 = l0 * al0 + ls0;
    l1 = l1 * al1 + ls1;
#pragma unroll
    for (int n = 0; n < kND; ++n) {
      acc[n][0] *= al0;
      acc[n][1] *= al0;
      acc[n][2] *= al1;
      acc[n][3] *= al1;
    }

    // acc += round(p) . v: the S fragment of two n-tiles is the A fragment
    // of one k-step
#pragma unroll
    for (int kk = 0; kk < kNT / 2; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < kND / 2; ++dp) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, Vs + (v_row + kk * 16) * kDS + dp * 16 + v_col);
        mma_bf16(acc[2 * dp], a, vb[0], vb[1]);
        mma_bf16(acc[2 * dp + 1], a, vb[2], vb[3]);
      }
    }
    __syncthreads();  // the stage is refilled next
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }

  if constexpr (S::kSplit == 1) {
    // out = acc / max(l, 1e-30), straight from the fragment
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
    for (int n = 0; n < kND; ++n) {
      const int col = n * 8 + 2 * t4;
      if (col >= D) continue;
      if (pr < nrows)
        *reinterpret_cast<uint32_t*>(Og + (size_t)pr * D + col) =
            pack_bf16(acc[n][0] / d0, acc[n][1] / d0);
      if (pr + 8 < nrows)
        *reinterpret_cast<uint32_t*>(Og + (size_t)(pr + 8) * D + col) =
            pack_bf16(acc[n][2] / d1, acc[n][3] / d1);
    }
  } else {
    // merge the kSplit column slices of each row tile through the ring
    // (every copy has landed and every warp left the last block)
    constexpr int kAS = DM + 4;
    float* Ms = reinterpret_cast<float*>(KVs);  // [warp][16] m, then l
    float* Ls = Ms + S::kWarps * 16;
    float* As = Ls + S::kWarps * 16;  // [warp][16][kAS] weighted acc
    cp_async_wait(0);
    if (t4 == 0) {
      Ms[warp * 16 + g] = m0;
      Ms[warp * 16 + g + 8] = m1;
      Ls[warp * 16 + g] = l0;
      Ls[warp * 16 + g + 8] = l1;
    }
    __syncthreads();
    float mf0 = kNegInf, mf1 = kNegInf, lf0 = 0.f, lf1 = 0.f;
#pragma unroll
    for (int c = 0; c < S::kSplit; ++c) {
      mf0 = fmaxf(mf0, Ms[(rt * S::kSplit + c) * 16 + g]);
      mf1 = fmaxf(mf1, Ms[(rt * S::kSplit + c) * 16 + g + 8]);
    }
#pragma unroll
    for (int c = 0; c < S::kSplit; ++c) {
      const int w = (rt * S::kSplit + c) * 16;
      lf0 += Ls[w + g] * exp2f(Ms[w + g] - mf0);
      lf1 += Ls[w + g + 8] * exp2f(Ms[w + g + 8] - mf1);
    }
    const float w0 = exp2f(m0 - mf0) / fmaxf(lf0, 1e-30f);
    const float w1 = exp2f(m1 - mf1) / fmaxf(lf1, 1e-30f);
    float* Aw = As + warp * 16 * kAS + 2 * t4;
#pragma unroll
    for (int n = 0; n < kND; ++n) {
      *reinterpret_cast<float2*>(Aw + g * kAS + n * 8) =
          make_float2(acc[n][0] * w0, acc[n][1] * w0);
      *reinterpret_cast<float2*>(Aw + (g + 8) * kAS + n * 8) =
          make_float2(acc[n][2] * w1, acc[n][3] * w1);
    }
    __syncthreads();
    // sum the slices, 8 columns a thread, one 16-byte store each
    for (int e = threadIdx.x; e < BQ * (DM / 8); e += kThreads) {
      const int r = e / (DM / 8), col = (e % (DM / 8)) * 8;
      if (p0 + r >= nrows || col >= D) continue;
      float o[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < S::kSplit; ++c) {
        const float* src = As + (((r / 16) * S::kSplit + c) * 16 + r % 16) * kAS + col;
        const float4 x = *reinterpret_cast<const float4*>(src);
        const float4 y = *reinterpret_cast<const float4*>(src + 4);
        o[0] += x.x, o[1] += x.y, o[2] += x.z, o[3] += x.w;
        o[4] += y.x, o[5] += y.y, o[6] += y.z, o[7] += y.w;
      }
      uint4 u;
      u.x = pack_bf16(o[0], o[1]);
      u.y = pack_bf16(o[2], o[3]);
      u.z = pack_bf16(o[4], o[5]);
      u.w = pack_bf16(o[6], o[7]);
      *reinterpret_cast<uint4*>(Og + (size_t)(p0 + r) * D + col) = u;
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: the CUDA-core body
// ---------------------------------------------------------------------------

constexpr int kSimtThreads = 256;

size_t simt_smem_bytes(int bq, int bkv, int D, int stages) {
  const size_t row = (size_t)(D + 4) * sizeof(float);
  const size_t acc_row = (size_t)(((D + 31) / 32) * 32 + 16);
  return (size_t)(bq + 2 * stages * bkv) * row + (size_t)bq * (bkv + 4) * 4 +
         (size_t)bq * acc_row * 4;
}

__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  out[0] = f.x;
  out[1] = f.y;
  out[2] = f.z;
  out[3] = f.w;
}

template <int BQ, int BKV>
__global__ void __launch_bounds__(kSimtThreads)
    attn_simt_kernel(const float* __restrict__ Q, const float* __restrict__ K,
                     const float* __restrict__ V, float* __restrict__ O, int Hq, int Hkv, int Lq,
                     int Lkv, int D, float scale, int causal, int q_offset, int stages) {
  constexpr int TQ = BQ / 16, TK = BKV / 16;
  constexpr int VEC = 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ds = D + VEC;                        // Q/K/V row stride, 16 B pad
  constexpr int ps = BKV + 4;                    // P row stride (floats)
  const int as = ((D + 31) / 32) * 32 + 16;      // acc row stride (floats)
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* KVs = Qs + BQ * ds;
  float* Ps = KVs + (size_t)stages * 2 * BKV * ds;
  float* Acc = Ps + BQ * ps;

  const int group = Hq / Hkv, nrows = group * Lq;
  const int q0 = blockIdx.x * BQ, hkv = blockIdx.y, b = blockIdx.z;
  const size_t qo = ((size_t)b * Hq + (size_t)hkv * group) * Lq * D;
  const float* Qg = Q + qo;
  const float* Kg = K + ((size_t)b * Hkv + hkv) * Lkv * D;
  const float* Vg = V + ((size_t)b * Hkv + hkv) * Lkv * D;
  float* Og = O + qo;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  int nkv = (Lkv + BKV - 1) / BKV;
  if (causal) nkv = min(nkv, position_range(q0, BQ, nrows, Lq, q_offset).y / BKV + 1);

  for (int e = tid; e < BQ * as; e += kSimtThreads) Acc[e] = 0.f;
  float m[TQ], l[TQ], alpha[TQ];
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }

  // the Q tile joins the first commit group; stages-1 KV blocks in flight
  load_rows<float, kSimtThreads>(Qs, Qg, BQ, q0, nrows, D, ds, D / VEC);
  const int stage_elems = 2 * BKV * ds;
  for (int s = 0; s < stages - 1; ++s) {
    if (s < nkv) {
      float* st = KVs + s * stage_elems;
      load_rows<float, kSimtThreads>(st, Kg, BKV, s * BKV, Lkv, D, ds, D / VEC);
      load_rows<float, kSimtThreads>(st + BKV * ds, Vg, BKV, s * BKV, Lkv, D, ds, D / VEC);
    }
    cp_async_commit();
  }

  for (int t = 0; t < nkv; ++t) {
    const int nt = t + stages - 1;
    if (nt < nkv) {
      float* st = KVs + (nt % stages) * stage_elems;
      load_rows<float, kSimtThreads>(st, Kg, BKV, nt * BKV, Lkv, D, ds, D / VEC);
      load_rows<float, kSimtThreads>(st + BKV * ds, Vg, BKV, nt * BKV, Lkv, D, ds, D / VEC);
    }
    cp_async_commit();
    cp_async_wait(stages - 1);
    __syncthreads();

    const float* Ks = KVs + (t % stages) * stage_elems;
    const float* Vs = Ks + BKV * ds;
    const int kv0 = t * BKV;

    // s = q . k^T in fp32
    float s[TQ][TK];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < TK; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; d += VEC) {
      float kf[TK][VEC];
#pragma unroll
      for (int j = 0; j < TK; ++j) load4(Ks + (tx + 16 * j) * ds + d, kf[j]);
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        float qf[VEC];
        load4(Qs + (ty + 16 * i) * ds + d, qf);
#pragma unroll
        for (int j = 0; j < TK; ++j)
#pragma unroll
          for (int e = 0; e < VEC; ++e) s[i][j] = fmaf(qf[e], kf[j][e], s[i][j]);
      }
    }

    // scale, mask, online softmax; a row's 16 threads are one half-warp
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const int row = q_offset + (q0 + ty + 16 * i) % Lq;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        const int col = kv0 + tx + 16 * j;
        float v = s[i][j] * scale;
        if (col >= Lkv || (causal && col > row)) v = kNegInf;
        s[i][j] = v;
        mx = fmaxf(mx, v);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty + 16 * i) * ps + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha[i] + sum;
      m[i] = m_new;
    }
    __syncthreads();

    // acc = acc * alpha + p . v, four output columns at a time
    for (int c0 = tx; c0 < D; c0 += 64) {
      float pv[TQ][4];
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) pv[i][c] = 0.f;
      for (int j = 0; j < BKV; ++j) {
        float v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = c0 + 16 * c;
          v[c] = col < D ? Vs[j * ds + col] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < TQ; ++i) {
          const float p = Ps[(ty + 16 * i) * ps + j];
#pragma unroll
          for (int c = 0; c < 4; ++c) pv[i][c] = fmaf(p, v[c], pv[i][c]);
        }
      }
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = c0 + 16 * c;
          if (col < D) {
            float* a = Acc + (ty + 16 * i) * as + col;
            *a = *a * alpha[i] + pv[i][c];
          }
        }
    }
    __syncthreads();  // the stage and the P tile are refilled next
  }

  // out = acc / max(l, 1e-30); each thread reads only the acc it wrote
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= nrows) continue;
    const float den = fmaxf(l[i], 1e-30f);
    for (int col = tx; col < D; col += 16)
      Og[(size_t)r * D + col] = Acc[(ty + 16 * i) * as + col] / den;
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *Q, *K, *V;
  void* O;
  int B, Hq, Hkv, Lq, Lkv, D, causal, q_offset, stages;
  float scale;
  cudaStream_t stream;
};

template <typename T>
using KernelFn = void (*)(const T*, const T*, const T*, T*, int, int, int, int, int, float, int,
                          int, int);

template <typename T>
int launch_kernel(KernelFn<T> kernel, bool& opted_in, const Args& a, int bq, int threads,
                  size_t smem) {
  if (!opted_in) {  // one opt-in per instantiation
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  if (smem > (size_t)kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((a.Hq / a.Hkv * a.Lq + bq - 1) / bq, a.Hkv, a.B);
  kernel<<<grid, threads, smem, a.stream>>>(
      static_cast<const T*>(a.Q), static_cast<const T*>(a.K), static_cast<const T*>(a.V),
      static_cast<T*>(a.O), a.Hq, a.Hkv, a.Lq, a.Lkv, a.D, a.scale, a.causal, a.q_offset,
      a.stages);
  return static_cast<int>(cudaGetLastError());
}

template <int BQ, int BKV, int DM> int launch_mma(const Args& a) {
  static bool opted_in = false;
  Args m = a;
  m.scale = a.scale * kLog2e;
  return launch_kernel<bf16>(attn_mma_kernel<BQ, BKV, DM>, opted_in, m, BQ,
                             MmaShape<BQ, BKV>::kThreads, mma_smem_bytes<BQ, BKV, DM>(a.stages));
}

template <int BQ, int BKV> int launch_simt(const Args& a) {
  static bool opted_in = false;
  return launch_kernel<float>(attn_simt_kernel<BQ, BKV>, opted_in, a, BQ, kSimtThreads,
                       simt_smem_bytes(BQ, BKV, a.D, a.stages));
}

template <int N> using Int = std::integral_constant<int, N>;

// f(Int<n>) for a tile n of 16, 32, 64 or 128
template <typename F> int with_tile(int n, F&& f) {
  switch (n) {
    case 16: return f(Int<16>());
    case 32: return f(Int<32>());
    case 64: return f(Int<64>());
    case 128: return f(Int<128>());
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// f(Int<dm>) for the head-dim bucket dm of D
template <typename F> int with_head_dim(int D, F&& f) {
  if (D <= 64) return f(Int<64>());
  if (D <= 128) return f(Int<128>());
  if (D <= 256) return f(Int<256>());
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32.  D must be a multiple of 8 (at most 256 in
// bf16) and every pointer 16-byte aligned.  Returns cudaGetLastError()
// after the launch (0 = launched), or cudaErrorInvalidValue for arguments
// it does not take.
extern "C" int attention_launch(const void* Q, const void* K, const void* V, void* O, int B,
                                int Hq, int Hkv, int Lq, int Lkv, int D, int dtype, int b_q,
                                int b_kv, int causal, int q_offset, int prefetch, float scale,
                                void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || Lq <= 0 || Lkv <= 0 || D <= 0 || D % 8 ||
      prefetch < 1 || prefetch > 3 || B > 65535 || Hq > 65535 || (causal && q_offset < 0) ||
      (long long)(Hq / Hkv) * Lq > INT_MAX - 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t align = reinterpret_cast<uintptr_t>(Q) | reinterpret_cast<uintptr_t>(K) |
                          reinterpret_cast<uintptr_t>(V) | reinterpret_cast<uintptr_t>(O);
  if (align % 16) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{Q, K, V, O, B, Hq, Hkv, Lq, Lkv, D, causal, q_offset, prefetch, scale,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0)
    return with_tile(b_q, [&](auto bq) {
      return with_tile(b_kv, [&](auto bkv) {
        return with_head_dim(D, [&](auto dm) {
          return launch_mma<decltype(bq)::value, decltype(bkv)::value, decltype(dm)::value>(a);
        });
      });
    });
  if (dtype == 1)
    return with_tile(b_q, [&](auto bq) {
      return with_tile(b_kv, [&](auto bkv) {
        return launch_simt<decltype(bq)::value, decltype(bkv)::value>(a);
      });
    });
  return static_cast<int>(cudaErrorInvalidValue);
}
