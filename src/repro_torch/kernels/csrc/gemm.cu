// Parameterised GEMM for Hopper (sm_90a): the port of the TPU kernel
// `_gemm_kernel` / `matmul_pallas` in `src/repro/kernels/matmul.py`.
//
// What it computes (the same as the TPU kernel, not carried over block by
// block): A (M, K) @ B (K, N) -> (k_split, M, N) partials in the IO dtype.
//   * one CTA per (bm, bn) output tile and per split s (grid z = k_split);
//     `order` picks the raster: 0 walks n fastest, 1 walks m fastest;
//   * split s covers K-range [s*kps*bk, (s+1)*kps*bk) of K padded to a
//     multiple of bk*k_split, exactly as the TPU grid does, so bf16 partials
//     round at the same places; the CTA masks the ragged M/N/K edges itself
//     (out-of-range elements load as zero) instead of relying on padding;
//   * acc32=1: fp32 accumulator, one cast of the partial at the end;
//     acc32=0: each sub-dot of bk/k_unroll K-elements is summed in fp32,
//     rounded to the IO dtype, added to the running sum, and the sum is
//     rounded again -- what `acc + jnp.dot(..., preferred_element_type=bf16)`
//     does on the TPU;
//   * fp32 IO is full fp32 FMA (no TF32).
//
// Design: 256 threads as a 16 x 16 grid; each thread owns (bm/16) x (bn/16)
// outputs in registers (strided by 16 so a warp reads consecutive B columns
// from shared memory).  A and B tiles stream through a ring of `prefetch`
// shared-memory stages filled with 16-byte cp.async copies (zero-filled past
// the edges); rows that are not 16-byte aligned fall back to element loads.
//
// What bounds it on this card: at the shapes of the serving path (M = 4 or
// 32 rows against 576/1536-wide weights) the GEMMs do 2*M FLOPs per weight
// element, far below the ~295 FLOP/byte ridge of an H100 in bf16, so the
// kernel is bound by reading B.  Per decode tick the 210 projections of
// SmolLM-135M read ~106 M bf16 weights, ~212 MB, about 63 us at 3.35 TB/s on
// an H100 SXM (reckoned from the shapes, not measured).  This first version
// does its arithmetic as CUDA-core FMAs from shared memory; tensor cores
// (mma.sync / wgmma) and TMA are later work.
//
// Built by kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound through the plain C entry point `gemm_launch` with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // dynamic shared memory opt-in limit

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

// round a float to the IO dtype and back
template <typename T> __device__ __forceinline__ float round_io(float x) {
  return to_f<T>(from_f<T>(x));
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

// Load the (BM x bk) tile of A at (m0, k0) and the (bk x BN) tile of B at
// (k0, n0) into one shared-memory stage; elements outside M/N/K are zero.
template <typename T, int BM, int BN>
__device__ __forceinline__ void load_stage(T* As, T* Bs, const T* __restrict__ A,
                                           const T* __restrict__ B, int M, int N, int K,
                                           int m0, int n0, int k0, int bk, bool vec_a,
                                           bool vec_b) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte copy
  const int tid = threadIdx.x;
  if (vec_a) {
    // K % V == 0 and k0 % V == 0: each chunk is wholly inside or outside
    const int cpr = bk / V;
    for (int c = tid; c < BM * cpr; c += kThreads) {
      const int r = c / cpr, kc = (c % cpr) * V;
      const int gr = m0 + r, gk = k0 + kc;
      const bool ok = gr < M && gk < K;
      cp_async16(As + r * bk + kc, ok ? A + (size_t)gr * K + gk : A, ok);
    }
  } else {
    for (int e = tid; e < BM * bk; e += kThreads) {
      const int r = e / bk, kk = e % bk;
      const int gr = m0 + r, gk = k0 + kk;
      As[e] = (gr < M && gk < K) ? A[(size_t)gr * K + gk] : from_f<T>(0.f);
    }
  }
  if (vec_b) {
    constexpr int cpr = BN / V;
    for (int c = tid; c < bk * cpr; c += kThreads) {
      const int r = c / cpr, nc = (c % cpr) * V;
      const int gk = k0 + r, gn = n0 + nc;
      const bool ok = gk < K && gn < N;
      cp_async16(Bs + r * BN + nc, ok ? B + (size_t)gk * N + gn : B, ok);
    }
  } else {
    for (int e = tid; e < bk * BN; e += kThreads) {
      const int r = e / BN, nn = e % BN;
      const int gk = k0 + r, gn = n0 + nn;
      Bs[e] = (gk < K && gn < N) ? B[(size_t)gk * N + gn] : from_f<T>(0.f);
    }
  }
}

template <typename T, int BM, int BN, bool ACC32>
__global__ void __launch_bounds__(kThreads)
    gemm_kernel(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ C, int M,
                int N, int K, int bk, int kps, int k_unroll, int stages, int order, int vec_a,
                int vec_b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  constexpr int TM = BM / 16, TN = BN / 16;
  const int stage_elems = (BM + BN) * bk;

  const int gm = (M + BM - 1) / BM, gn = (N + BN - 1) / BN;
  const int tile = blockIdx.x;
  int tm, tn;
  if (order == 0) {
    tm = tile / gn;
    tn = tile % gn;
  } else {
    tn = tile / gm;
    tm = tile % gm;
  }
  const int m0 = tm * BM, n0 = tn * BN;
  const int split = blockIdx.z;
  const int kbase = split * kps * bk;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // prologue: stages-1 tiles in flight
  for (int s = 0; s < stages - 1; ++s) {
    if (s < kps) {
      T* st = smem + s * stage_elems;
      load_stage<T, BM, BN>(st, st + BM * bk, A, B, M, N, K, m0, n0, kbase + s * bk, bk,
                            vec_a, vec_b);
    }
    cp_async_commit();
  }

  const int sub_len = bk / k_unroll;
  for (int t = 0; t < kps; ++t) {
    const int nt = t + stages - 1;
    if (nt < kps) {
      T* st = smem + (nt % stages) * stage_elems;
      load_stage<T, BM, BN>(st, st + BM * bk, A, B, M, N, K, m0, n0, kbase + nt * bk, bk,
                            vec_a, vec_b);
    }
    cp_async_commit();
    cp_async_wait(stages - 1);
    __syncthreads();

    const T* As = smem + (t % stages) * stage_elems;
    const T* Bs = As + BM * bk;
    for (int u = 0; u < k_unroll; ++u) {
      float sub[TM][TN];
      if constexpr (!ACC32) {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) sub[i][j] = 0.f;
      }
#pragma unroll 4
      for (int kk = u * sub_len; kk < (u + 1) * sub_len; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = to_f<T>(As[(ty + 16 * i) * bk + kk]);
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = to_f<T>(Bs[kk * BN + tx + 16 * j]);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            if constexpr (ACC32) {
              acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
            } else {
              sub[i][j] = fmaf(a[i], b[j], sub[i][j]);
            }
          }
      }
      if constexpr (!ACC32) {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = round_io<T>(acc[i][j] + round_io<T>(sub[i][j]));
      }
    }
    __syncthreads();  // the stage is refilled by a later iteration
  }

  T* Cs = C + (size_t)split * M * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c < N) Cs[(size_t)r * N + c] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T, int BM, int BN, bool ACC32>
int launch(const void* A, const void* B, void* C, int M, int N, int K, int bk, int k_split,
           int k_unroll, int order, int prefetch, cudaStream_t stream) {
  auto kernel = gemm_kernel<T, BM, BN, ACC32>;
  static bool opted_in = false;  // one opt-in per instantiation
  if (!opted_in) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const size_t smem = (size_t)prefetch * (BM + BN) * bk * sizeof(T);
  if (smem > (size_t)kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const long long chunk = (long long)bk * k_split;
  const int kps = static_cast<int>((K + chunk - 1) / chunk);
  const int gm = (M + BM - 1) / BM, gn = (N + BN - 1) / BN;
  constexpr int V = 16 / sizeof(T);
  const int vec_a = (K % V == 0) && (reinterpret_cast<uintptr_t>(A) % 16 == 0);
  const int vec_b = (N % V == 0) && (reinterpret_cast<uintptr_t>(B) % 16 == 0);
  dim3 grid(gm * gn, 1, k_split);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(A), static_cast<const T*>(B),
                                           static_cast<T*>(C), M, N, K, bk, kps, k_unroll,
                                           prefetch, order, vec_a, vec_b);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BM, bool ACC32>
int launch_bn(int bn, const void* A, const void* B, void* C, int M, int N, int K, int bk,
              int k_split, int k_unroll, int order, int prefetch, cudaStream_t stream) {
  switch (bn) {
    case 32:
      return launch<T, BM, 32, ACC32>(A, B, C, M, N, K, bk, k_split, k_unroll, order, prefetch,
                                      stream);
    case 64:
      return launch<T, BM, 64, ACC32>(A, B, C, M, N, K, bk, k_split, k_unroll, order, prefetch,
                                      stream);
    case 128:
      return launch<T, BM, 128, ACC32>(A, B, C, M, N, K, bk, k_split, k_unroll, order,
                                       prefetch, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, bool ACC32>
int launch_bm(int bm, int bn, const void* A, const void* B, void* C, int M, int N, int K,
              int bk, int k_split, int k_unroll, int order, int prefetch, cudaStream_t stream) {
  switch (bm) {
    case 16:
      return launch_bn<T, 16, ACC32>(bn, A, B, C, M, N, K, bk, k_split, k_unroll, order,
                                     prefetch, stream);
    case 32:
      return launch_bn<T, 32, ACC32>(bn, A, B, C, M, N, K, bk, k_split, k_unroll, order,
                                     prefetch, stream);
    case 64:
      return launch_bn<T, 64, ACC32>(bn, A, B, C, M, N, K, bk, k_split, k_unroll, order,
                                     prefetch, stream);
    case 128:
      return launch_bn<T, 128, ACC32>(bn, A, B, C, M, N, K, bk, k_split, k_unroll, order,
                                      prefetch, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32.  Returns cudaGetLastError() after the launch
// (0 = launched), or cudaErrorInvalidValue for a config it does not build.
extern "C" int gemm_launch(const void* A, const void* B, void* C, int M, int N, int K,
                           int dtype, int bm, int bn, int bk, int k_split, int k_unroll,
                           int acc32, int order, int prefetch, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bk <= 0 || k_split <= 0 || k_unroll <= 0 ||
      bk % k_unroll || prefetch < 1 || prefetch > 3 || k_split > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (acc32)
      return launch_bm<__nv_bfloat16, true>(bm, bn, A, B, C, M, N, K, bk, k_split, k_unroll,
                                            order, prefetch, s);
    return launch_bm<__nv_bfloat16, false>(bm, bn, A, B, C, M, N, K, bk, k_split, k_unroll,
                                           order, prefetch, s);
  }
  if (dtype == 1 && acc32)
    return launch_bm<float, true>(bm, bn, A, B, C, M, N, K, bk, k_split, k_unroll, order,
                                  prefetch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
