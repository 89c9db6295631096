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
// Design: one CTA of 256 threads per (b, block of b_heads heads).  It walks
// the chunks in order and keeps the state in shared memory across them:
// the loop inside the block takes the place of the TPU's sequential grid
// axis with the state in VMEM scratch (blocks of a CUDA grid run in no
// order).  x, dt, B and C of a chunk stream through a ring of `prefetch`
// shared-memory stages filled by 16-byte cp.async copies (zero-filled past
// L).  The chunk x chunk scores are never held whole: for each head, 16
// rows at a time, a tile W = (C . B^T) * exp(cum_i - cum_j) * dt_j (fp32,
// j <= i) is formed in shared memory and multiplied into x; the B and C
// rows are padded by 16 bytes so the 16-byte reads of a quarter-warp hit
// distinct banks.  P and S are runtime values, multiples of 8 (the launch
// and the wrapper reject any other).
//
// What bounds it on this card: per chunk and head it does ~chunk^2 (P + S)
// + 4 chunk P S FLOPs on chunk (P + 2S/b_heads) loaded elements, bound by
// operations at chunk >= 64.  This first version runs them as CUDA-core
// FMAs from shared memory (no tensor cores): right, not fast; at B = 1 and
// 64 heads it also fills only 64 / b_heads of the 132 SMs.
//
// Built by kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound through the plain C entry point `ssd_launch` with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // dynamic shared memory opt-in limit
constexpr int kRowTile = 16;      // score rows held at once (SSD_ROW_TILE)

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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
template <> __device__ __forceinline__ void load_f<4, __nv_bfloat16>(const __nv_bfloat16* p,
                                                                     float* out) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
template <> __device__ __forceinline__ void load_f<8, __nv_bfloat16>(const __nv_bfloat16* p,
                                                                     float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
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
    return launch<__nv_bfloat16>(X, DT, A, Bm, Cm, Y, B, L, H, P, S, chunk, b_heads, prefetch, s);
  if (dtype == 1)
    return launch<float>(X, DT, A, Bm, Cm, Y, B, L, H, P, S, chunk, b_heads, prefetch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
