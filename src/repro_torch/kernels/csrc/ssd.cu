// Mamba-2 SSD chunk scan for Hopper (sm_90a): the port of the TPU kernel
// `_ssd_kernel` / `ssd_scan_pallas` in `src/repro/kernels/ssd.py`.
//
// What it computes (the same as the TPU kernel, not carried over block by
// block): x (B, L, H, P), dt (B, L, H), a (H,) fp32, Bm/Cm (B, L, S)
// [ngroups = 1] -> y (B, L, H, P) in the IO dtype.  The sequence splits into
// chunks of `chunk` steps; per head, with cum = cumsum(dt * a) within the
// chunk (fp32):
//   * intra-chunk: y_i += sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j;
//     the exponent is formed only where j <= i (for j > i it is positive and
//     overflows), which is the TPU kernel's mask applied before the exp;
//   * inter-chunk: y_i += exp(cum_i) * C_i . state;
//   * the (P x S) fp32 state decays by exp(cum_last) and gains
//     sum_j exp(cum_last - cum_j) dt_j x_j B_j^T.
// A ragged L is handled by length: steps >= L load as zeros (dt = 0 makes a
// step the identity, exactly the reference's padding) and are never stored.
//
// Both bodies: one CTA per (b, block of b_heads heads).  It walks the
// chunks in order and keeps the fp32 state in shared memory across them:
// the loop inside the block takes the place of the TPU's sequential grid
// axis with the state in VMEM scratch (blocks of a CUDA grid run in no
// order).  x, B and C of a chunk stream through a ring of `prefetch`
// shared-memory stages filled by 16-byte cp.async copies (zero-filled past
// L), dt beside them.  P and S are runtime values, multiples of 8 (the
// launch and the wrapper reject any other).
//
// bf16: tensor cores (ssd_mma_kernel, 16 warps).  All four chunk products
// run as mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, per chunk
// between CTA barriers:
//   1. cum: one warp per head, a shuffle scan 32 steps at a time (its fp32
//      sum order differs from a sequential cumsum: within the bf16
//      tolerance), kept in the log2 domain so every exp is an exp2; then
//      the state weights wt_j = exp(cum_last - cum_j) dt_j;
//   2. y: a warp owns 16 rows i of one head and 32 columns p (16 where 32
//      would leave most warps idle).  The read-out C_i . state (K = S, C
//      through ldmatrix, the state's B fragments through ldmatrix from its
//      bf16 copy) is scaled by exp(cum_i); then, two 16-column slabs j <= i
//      at a time, the scores C . B^T (C and B through ldmatrix, K = S) go
//      to fp32 fragments, W = CB * exp(cum_i - cum_j) * dt_j where j <= i
//      and 0 elsewhere is packed to bf16 A fragments in registers (W never
//      goes through shared memory) and multiplied into x, read through
//      ldmatrix.trans;
//   3. the state update, a (P x S) product with K = chunk: a warp owns 16
//      rows p and 32 columns s of one head's state, loads them into its
//      accumulators and decays them by exp(cum_last), adds (wt . x)^T B
//      with x^T and B through ldmatrix.trans (wt scales the x fragment in
//      registers), and stores the fp32 state and its bf16 copy.
// It rounds to bf16 at three points beyond the IO: the score tile W, the
// weighted wt . x, and the copy of the state read at the read-out; every
// sum is fp32 and the carried state is never rounded.  A P or S that is a
// multiple of 8 but not of 16 is computed at 16: B's and C's pad columns
// are zero (K = S reads them), x columns and state rows past P are
// computed and never stored.  Stage and state rows are padded so the eight
// rows an ldmatrix phase reads (and a quarter-warp's 8-byte state
// accesses) start in distinct banks.  Where the padded layout and the
// state's copy do not fit, the launch takes the unpadded layout and the
// read-out packs the B fragments from the fp32 state, so the bf16 body
// fits wherever the first version did (dropping its fp32 score tile pays
// for that); core/space.py ssd_smem_bytes counts the same bytes.  dt (2
// bytes a head and step: too small for cp.async) is fetched into registers
// when its stage is refilled and stored after the chunk in hand is done.
//
// What bounds the bf16 body on this card: per chunk and head it does
// ~chunk^2 (P + S) + 4 chunk P S FLOPs on chunk (P + 2S/b_heads) loaded
// elements, a few microseconds of mma.sync, ldmatrix and exp2 for one SM;
// the chunks of a CTA run one after another behind four CTA barriers each,
// and at B = 1 only H / b_heads CTAs (64 for a mamba2-1.3b layer) share
// the 132 SMs.  So the serial chunk loop bounds it, not the products or
// the bytes: the longest warp of each phase (the last row tile's slabs)
// sets the pace.
//
// fp32 (a checking dtype: every model and tune target runs bf16): the
// CUDA-core body of the first version (ssd_kernel<float>, 256 threads).
// For each head, 16 rows at a time, a tile W = (C . B^T) * exp(cum_i -
// cum_j) * dt_j (fp32, j <= i) is formed in shared memory and multiplied
// into x as fmaf loops; cum is a sequential sum; the B and C rows are
// padded by 16 bytes so the 16-byte reads of a quarter-warp hit distinct
// banks.

// Built by kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound through the plain C entry point `ssd_launch` with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // dynamic shared memory opt-in limit
constexpr int kRowTile = 16;      // fp32 body: score rows held at once (SSD_ROW_TILE)
constexpr float kLog2e = 1.4426950408889634f;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

// N consecutive elements of T from shared memory (N * sizeof(T) bytes,
// aligned to that size or to 16 bytes), as floats
template <int N, typename T> __device__ __forceinline__ void load_f(const T* p, float* out);
template <> __device__ __forceinline__ void load_f<4, float>(const float* p, float* out) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  out[0] = f.x;
  out[1] = f.y;
  out[2] = f.z;
  out[3] = f.w;
}
template <> __device__ __forceinline__ void load_f<8, float>(const float* p, float* out) {
  load_f<4, float>(p, out);
  load_f<4, float>(p + 4, out + 4);
}

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

// Shared-memory layout, in elements of T for a stage and bytes overall.
struct Layout {
  int bs;             // B/C row stride (elements): S + 16 bytes
  size_t x_elems;     // chunk x bh x P
  size_t dt_elems;    // chunk x bh, rounded up to 16 bytes
  size_t stage_elems;
  size_t stage_bytes;
  size_t bytes;       // the whole CTA
};

template <typename T> __host__ __device__ Layout layout(int chunk, int bh, int P, int S,
                                                        int stages) {
  constexpr int V = 16 / sizeof(T);
  Layout g;
  g.bs = S + V;
  g.x_elems = (size_t)chunk * bh * P;
  g.dt_elems = ((size_t)chunk * bh + V - 1) / V * V;
  g.stage_elems = g.x_elems + g.dt_elems + (size_t)2 * chunk * g.bs;
  g.stage_bytes = g.stage_elems * sizeof(T);
  g.bytes = stages * g.stage_bytes + (size_t)bh * S * P * 4 +
            (size_t)kRowTile * (chunk + 4) * 4 + (size_t)2 * bh * chunk * 4;
  return g;
}

// One chunk's x, dt, B and C (steps t0 .. t0+chunk) into a stage; steps >= L
// load as zeros.
template <typename T>
__device__ __forceinline__ void load_stage(T* st, const Layout& g, const T* __restrict__ X,
                                           const T* __restrict__ DT, const T* __restrict__ Bm,
                                           const T* __restrict__ Cm, int b, int t0, int L,
                                           int H, int P, int S, int h0, int bh, int chunk) {
  constexpr int V = 16 / sizeof(T);
  T* xs = st;
  T* dts = st + g.x_elems;
  T* bsm = dts + g.dt_elems;
  T* csm = bsm + (size_t)chunk * g.bs;
  const int tid = threadIdx.x;
  const int xrow = bh * P, xcpr = xrow / V;
  for (int c = tid; c < chunk * xcpr; c += kThreads) {
    const int r = c / xcpr, e = (c % xcpr) * V;
    const bool ok = t0 + r < L;
    cp_async16(xs + (size_t)r * xrow + e,
               ok ? X + ((size_t)(b * L + t0 + r) * H + h0) * P + e : X, ok);
  }
  for (int e = tid; e < chunk * bh; e += kThreads) {
    const int r = e / bh, hh = e % bh;
    dts[e] = t0 + r < L ? DT[(size_t)(b * L + t0 + r) * H + h0 + hh] : from_f<T>(0.f);
  }
  const int scpr = S / V;
  for (int c = tid; c < chunk * scpr; c += kThreads) {
    const int r = c / scpr, e = (c % scpr) * V;
    const bool ok = t0 + r < L;
    const size_t off = (size_t)(b * L + t0 + r) * S + e;
    cp_async16(bsm + (size_t)r * g.bs + e, ok ? Bm + off : Bm, ok);
    cp_async16(csm + (size_t)r * g.bs + e, ok ? Cm + off : Cm, ok);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_kernel(const T* __restrict__ X, const T* __restrict__ DT, const float* __restrict__ A,
               const T* __restrict__ Bm, const T* __restrict__ Cm, T* __restrict__ Y, int L,
               int H, int P, int S, int chunk, int bh, int stages) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout g = layout<T>(chunk, bh, P, S, stages);
  T* stages_base = reinterpret_cast<T*>(smem_raw);
  float* state = reinterpret_cast<float*>(smem_raw + stages * g.stage_bytes);  // [bh][S][P]
  float* W = state + (size_t)bh * S * P;                 // [kRowTile][chunk + 4]
  float* cum = W + (size_t)kRowTile * (chunk + 4);       // [bh][chunk]
  float* wt = cum + (size_t)bh * chunk;                  // [bh][chunk]
  const int ws = chunk + 4;

  const int h0 = blockIdx.x * bh, b = blockIdx.y;
  const int tid = threadIdx.x;
  const int n_chunks = (L + chunk - 1) / chunk;

  for (int e = tid; e < bh * S * P; e += kThreads) state[e] = 0.f;

  for (int s = 0; s < stages - 1; ++s) {
    if (s < n_chunks)
      load_stage<T>(stages_base + s * g.stage_elems, g, X, DT, Bm, Cm, b, s * chunk, L, H, P, S,
                    h0, bh, chunk);
    cp_async_commit();
  }

  for (int t = 0; t < n_chunks; ++t) {
    const int nt = t + stages - 1;
    if (nt < n_chunks)
      load_stage<T>(stages_base + (nt % stages) * g.stage_elems, g, X, DT, Bm, Cm, b,
                    nt * chunk, L, H, P, S, h0, bh, chunk);
    cp_async_commit();
    cp_async_wait(stages - 1);
    __syncthreads();

    const T* xs = stages_base + (t % stages) * g.stage_elems;
    const T* dts = xs + g.x_elems;
    const T* bsm = dts + g.dt_elems;
    const T* csm = bsm + (size_t)chunk * g.bs;
    const int t0 = t * chunk;

    // per head: cum = cumsum(dt * a), in order, as the reference's cumsum
    if (tid < bh) {
      const float a = A[h0 + tid];
      float c = 0.f;
      for (int i = 0; i < chunk; ++i) {
        c += to_f<T>(dts[i * bh + tid]) * a;
        cum[tid * chunk + i] = c;
      }
    }
    __syncthreads();
    // the state-update weights exp(cum_last - cum_j) * dt_j
    for (int e = tid; e < bh * chunk; e += kThreads) {
      const int hh = e / chunk, j = e % chunk;
      wt[e] = expf(cum[hh * chunk + chunk - 1] - cum[e]) * to_f<T>(dts[j * bh + hh]);
    }

    for (int hh = 0; hh < bh; ++hh) {
      const float* ch = cum + hh * chunk;
      for (int i0 = 0; i0 < chunk; i0 += kRowTile) {
        // W[ii][j] = (C_i . B_j) * exp(cum_i - cum_j) * dt_j for j <= i
        const int jn = i0 + kRowTile;
        for (int e = tid; e < kRowTile * jn; e += kThreads) {
          const int ii = e / jn, j = e % jn, i = i0 + ii;
          if (j > i) continue;
          const T* crow = csm + (size_t)i * g.bs;
          const T* brow = bsm + (size_t)j * g.bs;
          float acc = 0.f;
          for (int s = 0; s < S; s += V) {
            float cf[V], bf[V];
            load_f<V, T>(crow + s, cf);
            load_f<V, T>(brow + s, bf);
#pragma unroll
            for (int k = 0; k < V; ++k) acc = fmaf(cf[k], bf[k], acc);
          }
          W[ii * ws + j] = acc * expf(ch[i] - ch[j]) * to_f<T>(dts[j * bh + hh]);
        }
        __syncthreads();

        // y rows i0 .. i0+16 of head hh: thread (ii, pg) owns 4 columns of p
        {
          const int ii = tid / 16, i = i0 + ii;
          const T* crow = csm + (size_t)i * g.bs;
          const float* st = state + (size_t)hh * S * P;
          for (int p0 = (tid % 16) * 4; p0 < P; p0 += 64) {
            float yi[4] = {0.f, 0.f, 0.f, 0.f}, ye[4] = {0.f, 0.f, 0.f, 0.f};
            for (int j = 0; j <= i; ++j) {
              const float w = W[ii * ws + j];
              float xv[4];
              load_f<4, T>(xs + ((size_t)j * bh + hh) * P + p0, xv);
#pragma unroll
              for (int k = 0; k < 4; ++k) yi[k] = fmaf(w, xv[k], yi[k]);
            }
            for (int s = 0; s < S; ++s) {
              const float c = to_f<T>(crow[s]);
              float sv[4];
              load_f<4, float>(st + (size_t)s * P + p0, sv);
#pragma unroll
              for (int k = 0; k < 4; ++k) ye[k] = fmaf(c, sv[k], ye[k]);
            }
            if (t0 + i < L) {
              const float e = expf(ch[i]);
              T* yrow = Y + ((size_t)(b * L + t0 + i) * H + h0 + hh) * P + p0;
#pragma unroll
              for (int k = 0; k < 4; ++k) yrow[k] = from_f<T>(yi[k] + ye[k] * e);
            }
          }
        }
        __syncthreads();  // W is refilled by the next row tile
      }
    }

    // state = state * exp(cum_last) + sum_j wt_j x_j B_j^T; thread (sg, pg)
    // owns 4 state rows (s) x 8 columns (p) per 128 x 64 tile
    for (int hh = 0; hh < bh; ++hh) {
      const float decay = expf(cum[hh * chunk + chunk - 1]);
      float* st = state + (size_t)hh * S * P;
      const float* w = wt + hh * chunk;
      for (int s0 = (tid / 8) * 4; s0 < S; s0 += 128) {
        for (int p0 = (tid % 8) * 8; p0 < P; p0 += 64) {
          float acc[4][8];
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int q = 0; q < 8; ++q) acc[k][q] = 0.f;
          for (int j = 0; j < chunk; ++j) {
            const float wj = w[j];
            float u[8], bv[4];
            load_f<8, T>(xs + ((size_t)j * bh + hh) * P + p0, u);
            load_f<4, T>(bsm + (size_t)j * g.bs + s0, bv);
#pragma unroll
            for (int q = 0; q < 8; ++q) u[q] *= wj;
#pragma unroll
            for (int k = 0; k < 4; ++k)
#pragma unroll
              for (int q = 0; q < 8; ++q) acc[k][q] = fmaf(bv[k], u[q], acc[k][q]);
          }
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int q = 0; q < 8; ++q) {
              float* sp = st + (size_t)(s0 + k) * P + p0 + q;
              *sp = *sp * decay + acc[k][q];
            }
        }
      }
    }
    __syncthreads();  // the stage is refilled and the state read next chunk
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 512;  // 16 warps
constexpr int kMaxSq = 2;         // 16-column groups of s in a state-update unit

// Shared-memory layout of the bf16 body, in bf16 elements for a stage and
// bytes overall: `stages` stages of x (chunk rows of bh * P, pitch xp), dt
// (chunk * bh, rounded up to 16 bytes), B and C (chunk rows of S, pitch
// S + 8: where S is not a multiple of 16 the pad is the zero columns up to
// S16); then the fp32 state [bh][P][sp], with `pad` its bf16 copy
// [bh][P16][S16 + 8], and, [bh][chunk] each, cum (log2 domain) and the
// state weights wt.  With `pad` the x pitch is an odd number of 16-byte
// units and the state pitch S16 + 8 floats (8-byte accesses of 4 rows g
// and 4 lanes t4 hit distinct banks), and the read-out takes the state's
// B fragments from the copy with ldmatrix (the copy's pad rows and
// columns stay zero); without, it packs them from the fp32 state.  The
// launch takes the padded layout where it fits, so the bf16 body fits
// wherever the first version's did (core/space.py ssd_smem_bytes counts
// the same bytes).
struct MmaLayout {
  int xp, bp, sp, cp;  // pitches: x, B/C, the state, its copy (0: none)
  size_t x_elems, dt_elems, stage_elems, stage_bytes, state_floats, copy_elems, bytes;
};

__host__ __device__ MmaLayout mma_layout(int chunk, int bh, int P, int S, int stages, bool pad) {
  MmaLayout g;
  g.xp = pad ? mma::mma_pitch(bh * P) : bh * P;
  g.bp = S + 8;
  g.sp = pad ? (S + 15) / 16 * 16 + 8 : S;
  g.x_elems = (size_t)chunk * g.xp;
  g.dt_elems = ((size_t)chunk * bh + 7) / 8 * 8;
  g.stage_elems = g.x_elems + g.dt_elems + (size_t)2 * chunk * g.bp;
  g.stage_bytes = g.stage_elems * sizeof(bf16);
  g.state_floats = (size_t)bh * P * g.sp;
  g.cp = pad ? (S + 15) / 16 * 16 + 8 : 0;
  g.copy_elems = (size_t)bh * ((P + 15) / 16 * 16) * g.cp;
  g.bytes = stages * g.stage_bytes + g.state_floats * 4 + g.copy_elems * sizeof(bf16) +
            (size_t)2 * bh * chunk * 4;
  return g;
}

// This thread's walk over a grid of rows of `pieces` 16-byte pieces,
// kMmaThreads pieces at a time: the divisions are made once per kernel, not
// once per piece and chunk.
struct Walk {
  int r, e, dr, de, pieces;  // row, piece; the step in rows and pieces
  __device__ explicit Walk(int n)
      : r(threadIdx.x / n),
        e(threadIdx.x % n),
        dr(kMmaThreads / n),
        de(kMmaThreads % n),
        pieces(n) {}
  __device__ void next() {
    r += dr;
    e += de;
    if (e >= pieces) e -= pieces, ++r;
  }
};

// One chunk's x, B and C (steps t0 .. t0+chunk) into a bf16 stage by
// cp.async; steps >= L load as zeros.  xw walks x's rows of bh * P / 8
// pieces, sw B's and C's of S / 8.
__device__ __forceinline__ void load_stage_mma(bf16* st, const MmaLayout& g, Walk xw, Walk sw,
                                               const bf16* __restrict__ X,
                                               const bf16* __restrict__ Bm,
                                               const bf16* __restrict__ Cm, int b, int t0, int L,
                                               int H, int P, int S, int h0, int chunk) {
  bf16* xs = st;
  bf16* bsm = st + g.x_elems + g.dt_elems;
  bf16* csm = bsm + (size_t)chunk * g.bp;
  for (; xw.r < chunk; xw.next()) {
    const bool ok = t0 + xw.r < L;
    cp_async16(xs + (size_t)xw.r * g.xp + xw.e * 8,
               ok ? X + ((size_t)(b * L + t0 + xw.r) * H + h0) * P + xw.e * 8 : X, ok);
  }
  for (; sw.r < chunk; sw.next()) {
    const bool ok = t0 + sw.r < L;
    const size_t off = (size_t)(b * L + t0 + sw.r) * S + sw.e * 8;
    cp_async16(bsm + (size_t)sw.r * g.bp + sw.e * 8, ok ? Bm + off : Bm, ok);
    cp_async16(csm + (size_t)sw.r * g.bp + sw.e * 8, ok ? Cm + off : Cm, ok);
  }
}

// A chunk's dt (chunk x bh elements, at most 256 x 8) has no cp.async (2
// bytes a head and step), so it comes through registers: fetch_dt issues
// the loads and store_dt, called after the chunk in hand is computed,
// writes them to the stage (steps >= L as zeros).
constexpr int kDtPerThread = 256 * 8 / kMmaThreads;

__device__ __forceinline__ void fetch_dt(bf16 (&v)[kDtPerThread], const bf16* __restrict__ DT,
                                         int b, int t0, int L, int H, int h0, int bh, int chunk) {
#pragma unroll
  for (int k = 0; k < kDtPerThread; ++k) {
    const int e = threadIdx.x + k * kMmaThreads, r = e / bh;
    v[k] = e < chunk * bh && t0 + r < L ? DT[(size_t)(b * L + t0 + r) * H + h0 + e % bh]
                                         : __float2bfloat16_rn(0.f);
  }
}

__device__ __forceinline__ void store_dt(bf16* dts, const bf16 (&v)[kDtPerThread], int n) {
#pragma unroll
  for (int k = 0; k < kDtPerThread; ++k)
    if (threadIdx.x + k * kMmaThreads < n) dts[threadIdx.x + k * kMmaThreads] = v[k];
}

// a bf16x2 register times (lo, hi), rounded back to bf16x2
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t r, float lo, float hi) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
  return mma::pack_bf16(f.x * lo, f.y * hi);
}

// a B fragment register: state row[s], row[s + 1] rounded to bf16 (0 where
// the pair lies past P or S)
__device__ __forceinline__ uint32_t state_pair(const float* row, int s, bool ok) {
  if (!ok) return 0u;
  const float2 v = *reinterpret_cast<const float2*>(row + s);
  return mma::pack_bf16(v.x, v.y);
}

// Fragment layout of m16n8k16 (lane = 4*g + t4): an A fragment holds rows g
// and g+8; C element e of n-tile j is (row g + 8*(e/2), column
// 8j + 2*t4 + e%2).
__global__ void __launch_bounds__(kMmaThreads, 1)
    ssd_mma_kernel(const bf16* __restrict__ X, const bf16* __restrict__ DT,
                   const float* __restrict__ A, const bf16* __restrict__ Bm,
                   const bf16* __restrict__ Cm, bf16* __restrict__ Y, int L, int H, int P, int S,
                   int chunk, int bh, int stages, int pad) {
  using namespace mma;
  constexpr int kWarps = kMmaThreads / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const MmaLayout g = mma_layout(chunk, bh, P, S, stages, pad);
  bf16* stages_base = reinterpret_cast<bf16*>(smem_raw);
  float* state = reinterpret_cast<float*>(smem_raw + stages * g.stage_bytes);  // [bh][P][sp]
  bf16* scopy = reinterpret_cast<bf16*>(state + g.state_floats);  // [bh][P16][cp]
  float* cl = reinterpret_cast<float*>(scopy + g.copy_elems);      // [bh][chunk]: cum * log2(e)
  float* wt = cl + (size_t)bh * chunk;                             // [bh][chunk]

  const int h0 = blockIdx.x * bh, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t4 = lane & 3;
  const int n_chunks = (L + chunk - 1) / chunk;
  const int n_it = chunk / 16, n_pq = (P + 15) / 16, n_sq = (S + 15) / 16;
  // warp units of y: (head, 16 rows, yq groups of 16 columns p), yq = 2
  // unless that leaves more than half the warps idle (each unit recomputes
  // its rows' C . B^T, so narrower units cost more products in all); of the
  // state update: (head, 16 rows p, sq groups of 16 columns s), sq =
  // kMaxSq halved while warps would idle
  const int yq = 2 * bh * n_it * ((n_pq + 1) / 2) >= kWarps ? 2 : 1;
  const int yn = (n_pq + yq - 1) / yq;
  int sq = kMaxSq;
  while (sq > 1 && bh * n_pq * ((n_sq + sq - 1) / sq) < kWarps) sq /= 2;
  const int sn = (n_sq + sq - 1) / sq;

  // ldmatrix row addresses of this lane: C rows as the A operand; B rows as
  // the col-major B operand of C . B^T; [k][n] rows read transposed (x and
  // B as the B operand, x^T as the A operand)
  const int c_row = lane & 15, c_col = (lane >> 4) * 8;
  const int k_row = (lane & 7) + ((lane >> 4) << 3), k_col = ((lane >> 3) & 1) * 8;
  const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8, v_col = (lane >> 4) * 8;
  const int a_row = (lane & 7) + ((lane >> 4) & 1) * 8, a_col = ((lane >> 3) & 1) * 8;

  // zero the stages (their pad columns stay zero), the state and its copy
  // before any cp.async lands
  {
    uint4* z = reinterpret_cast<uint4*>(smem_raw);
    const size_t n = (stages * g.stage_bytes + g.state_floats * 4 + g.copy_elems * 2) / 16;
    for (size_t e = tid; e < n; e += kMmaThreads) z[e] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  const Walk xw(bh * P / 8), sw(S / 8);
  bf16 dtv[kDtPerThread];
  for (int s = 0; s < stages - 1; ++s) {
    if (s < n_chunks) {
      bf16* st = stages_base + s * g.stage_elems;
      load_stage_mma(st, g, xw, sw, X, Bm, Cm, b, s * chunk, L, H, P, S, h0, chunk);
      fetch_dt(dtv, DT, b, s * chunk, L, H, h0, bh, chunk);
      store_dt(st + g.x_elems, dtv, chunk * bh);
    }
    cp_async_commit();
  }

  for (int t = 0; t < n_chunks; ++t) {
    const int nt = t + stages - 1;
    bf16* refill = nt < n_chunks ? stages_base + (nt % stages) * g.stage_elems : nullptr;
    if (refill) {
      load_stage_mma(refill, g, xw, sw, X, Bm, Cm, b, nt * chunk, L, H, P, S, h0, chunk);
      fetch_dt(dtv, DT, b, nt * chunk, L, H, h0, bh, chunk);
      if (stages == 1) store_dt(refill + g.x_elems, dtv, chunk * bh);  // the chunk in hand
    }
    cp_async_commit();
    cp_async_wait(stages - 1);
    __syncthreads();

    const bf16* xs = stages_base + (t % stages) * g.stage_elems;
    const bf16* dts = xs + g.x_elems;
    const bf16* bsm = dts + g.dt_elems;
    const bf16* csm = bsm + (size_t)chunk * g.bp;
    const int t0 = t * chunk;

    // 1. per head (one warp each): cum by a shuffle scan of 32 steps at a
    // time, in the log2 domain; then wt_j = exp(cum_last - cum_j) dt_j
    for (int hh = warp; hh < bh; hh += kWarps) {
      const float a = A[h0 + hh] * kLog2e;
      float* ch = cl + hh * chunk;
      float carry = 0.f;
      for (int i0 = 0; i0 < chunk; i0 += 32) {
        const int i = i0 + lane;
        float v = i < chunk ? __bfloat162float(dts[i * bh + hh]) * a : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, off);
          if (lane >= off) v += u;
        }
        v += carry;
        if (i < chunk) ch[i] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
      __syncwarp();
      for (int i = lane; i < chunk; i += 32)
        wt[hh * chunk + i] = exp2f(carry - ch[i]) * __bfloat162float(dts[i * bh + hh]);
    }
    __syncthreads();

    // 2. y: per warp unit, the read-out exp(cum_i) C_i . state, then the
    // intra-chunk W . x over the 16-column slabs j <= i
    for (int u = warp; u < bh * n_it * yn; u += kWarps) {
      const int q0 = (u % yn) * yq, it = (u / yn) % n_it, hh = u / (yn * n_it);
      const int nq = min(yq, n_pq - q0);
      const float* ch = cl + hh * chunk;
      const float* st = state + (size_t)hh * P * g.sp;
      const int i0 = it * 16 + gq;  // this thread's rows i0, i0 + 8
      const float ci0 = ch[i0], ci1 = ch[i0 + 8];
      const bf16* crow = csm + (size_t)(it * 16 + c_row) * g.bp + c_col;
      float acc[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

      // read-out: C_i . state with K = S; the state's B fragments come
      // from its bf16 copy, or are packed from the fp32 state
      const bf16* srow = scopy + ((size_t)hh * n_pq * 16 + q0 * 16 + k_row) * g.cp + k_col;
      for (int kk = 0; kk < n_sq * 16; kk += 16) {
        uint32_t a[4];
        ldsm_x4(a, crow + kk);
        if (g.cp) {
#pragma unroll
          for (int dq = 0; dq < 2; ++dq) {
            if (dq < nq) {
              uint32_t kb[4];
              ldsm_x4(kb, srow + (size_t)dq * 16 * g.cp + kk);
              mma_bf16(acc[2 * dq], a, kb[0], kb[1]);
              mma_bf16(acc[2 * dq + 1], a, kb[2], kb[3]);
            }
          }
          continue;
        }
        const int s = kk + 2 * t4;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          if (n < 2 * nq) {
            const int p = q0 * 16 + n * 8 + gq;
            const float* row = st + (size_t)p * g.sp;
            mma_bf16(acc[n], a, state_pair(row, s, p < P && s < S),
                     state_pair(row, s + 8, p < P && s + 8 < S));
          }
        }
      }
      const float e0 = exp2f(ci0), e1 = exp2f(ci1);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        acc[n][0] *= e0;
        acc[n][1] *= e0;
        acc[n][2] *= e1;
        acc[n][3] *= e1;
      }

      // two 16-column slabs j <= i at a time: their C . B^T share the C
      // fragments and run as four independent accumulator chains
      for (int jt = 0; jt <= it; jt += 2) {
        const int n_slab = jt < it ? 2 : 1;
        // CB = C . B^T for rows i, columns j of the slabs (K = S), fp32
        float cb[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n) cb[n][0] = cb[n][1] = cb[n][2] = cb[n][3] = 0.f;
        const bf16* brow = bsm + (size_t)(jt * 16 + k_row) * g.bp + k_col;
        for (int kk = 0; kk < n_sq * 16; kk += 16) {
          uint32_t a[4], kb[4];
          ldsm_x4(a, crow + kk);
          ldsm_x4(kb, brow + kk);
          mma_bf16(cb[0], a, kb[0], kb[1]);
          mma_bf16(cb[1], a, kb[2], kb[3]);
          if (n_slab == 2) {
            ldsm_x4(kb, brow + (size_t)16 * g.bp + kk);
            mma_bf16(cb[2], a, kb[0], kb[1]);
            mma_bf16(cb[3], a, kb[2], kb[3]);
          }
        }
#pragma unroll
        for (int sl = 0; sl < 2; ++sl) {
          if (sl >= n_slab) break;
          // W = CB exp(cum_i - cum_j) dt_j, the exponent masked to -inf
          // where j > i; a slab's two n-tiles are the A fragment of one
          // k-step
          uint32_t w[4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float* c4 = cb[2 * sl + h];
            const int j = (jt + sl) * 16 + h * 8 + 2 * t4;
            const float cj0 = ch[j], cj1 = ch[j + 1];
            const float d0 = __bfloat162float(dts[j * bh + hh]);
            const float d1 = __bfloat162float(dts[(j + 1) * bh + hh]);
            const float w00 = c4[0] * exp2f(j <= i0 ? ci0 - cj0 : -INFINITY) * d0;
            const float w01 = c4[1] * exp2f(j + 1 <= i0 ? ci0 - cj1 : -INFINITY) * d1;
            const float w10 = c4[2] * exp2f(j <= i0 + 8 ? ci1 - cj0 : -INFINITY) * d0;
            const float w11 = c4[3] * exp2f(j + 1 <= i0 + 8 ? ci1 - cj1 : -INFINITY) * d1;
            w[2 * h] = pack_bf16(w00, w01);
            w[2 * h + 1] = pack_bf16(w10, w11);
          }
          const bf16* xrow =
              xs + (size_t)((jt + sl) * 16 + v_row) * g.xp + hh * P + q0 * 16 + v_col;
#pragma unroll
          for (int dq = 0; dq < 2; ++dq) {
            if (dq < nq) {
              uint32_t vb[4];
              ldsm_x4_trans(vb, xrow + dq * 16);
              mma_bf16(acc[2 * dq], w, vb[0], vb[1]);
              mma_bf16(acc[2 * dq + 1], w, vb[2], vb[3]);
            }
          }
        }
      }

      // y rows i0, i0 + 8 where the step is < L, columns p < P
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int p = q0 * 16 + n * 8 + 2 * t4;
        if (n >= 2 * nq || p >= P) continue;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = i0 + 8 * rr;
          if (t0 + i < L)
            *reinterpret_cast<uint32_t*>(Y + ((size_t)(b * L + t0 + i) * H + h0 + hh) * P + p) =
                pack_bf16(acc[n][2 * rr], acc[n][2 * rr + 1]);
        }
      }
    }
    __syncthreads();  // every read-out has read the state

    // 3. state = state * exp(cum_last) + (wt . x)^T B: per warp unit, 16
    // rows p and sq groups of 16 columns s of one head's state
    for (int u = warp; u < bh * n_pq * sn; u += kWarps) {
      const int r0 = (u % sn) * sq, mt = (u / sn) % n_pq, hh = u / (sn * n_pq);
      const int nr = min(sq, n_sq - r0);
      const float* w = wt + hh * chunk;
      float* st = state + (size_t)hh * P * g.sp;
      const float decay = exp2f(cl[hh * chunk + chunk - 1]);
      const int p0 = mt * 16 + gq;  // this thread's rows p0, p0 + 8
      float acc[2 * kMaxSq][4];
#pragma unroll
      for (int n = 0; n < 2 * kMaxSq; ++n) {
        const int s = r0 * 16 + n * 8 + 2 * t4;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int p = p0 + 8 * rr;
          float2 v = make_float2(0.f, 0.f);
          if (n < 2 * nr && p < P && s < S)
            v = *reinterpret_cast<const float2*>(st + (size_t)p * g.sp + s);
          acc[n][2 * rr] = v.x * decay;
          acc[n][2 * rr + 1] = v.y * decay;
        }
      }
      const bf16* xa = xs + (size_t)a_row * g.xp + hh * P + mt * 16 + a_col;
      const bf16* bb = bsm + (size_t)v_row * g.bp + r0 * 16 + v_col;
      for (int kt = 0; kt < chunk; kt += 16) {
        uint32_t a[4];
        ldsm_x4_trans(a, xa + (size_t)kt * g.xp);
        const int j = kt + 2 * t4;
        a[0] = scale_bf16x2(a[0], w[j], w[j + 1]);
        a[1] = scale_bf16x2(a[1], w[j], w[j + 1]);
        a[2] = scale_bf16x2(a[2], w[j + 8], w[j + 9]);
        a[3] = scale_bf16x2(a[3], w[j + 8], w[j + 9]);
#pragma unroll
        for (int d = 0; d < kMaxSq; ++d) {
          if (d < nr) {
            uint32_t vb[4];
            ldsm_x4_trans(vb, bb + (size_t)kt * g.bp + d * 16);
            mma_bf16(acc[2 * d], a, vb[0], vb[1]);
            mma_bf16(acc[2 * d + 1], a, vb[2], vb[3]);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < 2 * kMaxSq; ++n) {
        const int s = r0 * 16 + n * 8 + 2 * t4;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int p = p0 + 8 * rr;
          if (n < 2 * nr && p < P && s < S) {
            *reinterpret_cast<float2*>(st + (size_t)p * g.sp + s) =
                make_float2(acc[n][2 * rr], acc[n][2 * rr + 1]);
            if (g.cp)
              *reinterpret_cast<uint32_t*>(scopy + ((size_t)hh * n_pq * 16 + p) * g.cp + s) =
                  pack_bf16(acc[n][2 * rr], acc[n][2 * rr + 1]);
          }
        }
      }
    }
    // the next chunk's dt, fetched before this chunk's products, into its
    // stage (consumed in an earlier iteration)
    if (refill && stages > 1) store_dt(refill + g.x_elems, dtv, chunk * bh);
    __syncthreads();  // the stage is refilled, cum and wt rewritten, the state read next chunk
  }
}

int launch_mma(const void* X, const void* DT, const void* A, const void* Bm, const void* Cm,
               void* Y, int B, int L, int H, int P, int S, int chunk, int bh, int stages,
               cudaStream_t stream) {
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(ssd_mma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const bool pad = mma_layout(chunk, bh, P, S, stages, true).bytes <= (size_t)kMaxSmem;
  const size_t smem = mma_layout(chunk, bh, P, S, stages, pad).bytes;
  if (smem > (size_t)kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(H / bh, B);
  ssd_mma_kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(X), static_cast<const bf16*>(DT), static_cast<const float*>(A),
      static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm), static_cast<bf16*>(Y), L, H, P,
      S, chunk, bh, stages, pad);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// fp32: the CUDA-core body's launch
// ---------------------------------------------------------------------------

template <typename T>
int launch(const void* X, const void* DT, const void* A, const void* Bm, const void* Cm, void* Y,
           int B, int L, int H, int P, int S, int chunk, int bh, int stages,
           cudaStream_t stream) {
  auto kernel = ssd_kernel<T>;
  static bool opted_in = false;  // one opt-in per instantiation
  if (!opted_in) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const size_t smem = layout<T>(chunk, bh, P, S, stages).bytes;
  if (smem > (size_t)kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(H / bh, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(X), static_cast<const T*>(DT), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<T*>(Y), L, H, P, S,
      chunk, bh, stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32 (x, dt, Bm, Cm and y; a is always fp32).  P and
// S must be multiples of 8, chunk a multiple of 16, b_heads a divisor of H,
// every pointer 16-byte aligned.  Returns cudaGetLastError() after the
// launch (0 = launched), or cudaErrorInvalidValue for arguments it does not
// take.
extern "C" int ssd_launch(const void* X, const void* DT, const void* A, const void* Bm,
                          const void* Cm, void* Y, int B, int L, int H, int P, int S, int dtype,
                          int chunk, int b_heads, int prefetch, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || P <= 0 || S <= 0 || P % 8 || S % 8 || chunk <= 0 ||
      chunk % kRowTile || b_heads <= 0 || H % b_heads || prefetch < 1 || prefetch > 3 ||
      B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t align = reinterpret_cast<uintptr_t>(X) | reinterpret_cast<uintptr_t>(Bm) |
                          reinterpret_cast<uintptr_t>(Cm) | reinterpret_cast<uintptr_t>(Y);
  if (align % 16) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_mma(X, DT, A, Bm, Cm, Y, B, L, H, P, S, chunk, b_heads, prefetch, s);
  if (dtype == 1)
    return launch<float>(X, DT, A, Bm, Cm, Y, B, L, H, P, S, chunk, b_heads, prefetch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
