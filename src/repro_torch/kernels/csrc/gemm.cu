// Parameterised GEMM for Hopper (sm_90a): the port of the TPU kernel
// `_gemm_kernel` / `matmul_pallas` in `src/repro/kernels/matmul.py`, and
// the one-pass reduction of its split-K partials.
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
// `splitk_reduce_kernel` then sums the k_split partials in fp32, in split
// order, and rounds once to the IO dtype: the reference's
// `parts.sum(axis=0)` in `repro/kernels/ops.py`, one launch where the
// PyTorch expression `parts.float().sum(0).to(dtype)` took three.
//
// Staging (both bodies): the A (bm x bk, K fastest) and B (bk x bn, N
// fastest) tiles stream through a ring of `prefetch` shared-memory stages
// filled with 16-byte cp.async copies (zero-filled past the edges); rows
// that are not 16-byte aligned (K or N not a multiple of 8 bf16 / 4 fp32
// elements) fall back to element loads.
//
// bf16: tensor cores.  A GEMM is conv.cu's window product at R = S = 1, so
// the two share mma.cuh's MmaTile / window_dot: the CTA's warps are sized
// to its tile, each warp owning a (16 or 32) x (32 or 64) block of m16n8
// fragments (1 warp at 16 x 32, 8 at 128 x 128), A through ldmatrix.x4 as
// the row-major operand and B through ldmatrix.x4.trans as the col-major
// one of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32.  Stage rows
// are padded to an odd number of 16-byte units (mma_pitch), so the eight
// rows one ldmatrix phase reads fall in distinct banks.  A warp runs every
// k-step of a sub-dot (K is never split across the warps of a CTA), so
// with acc32=0 a second fp32 fragment holds the whole sub-dot before it is
// rounded to bf16 and added into the running sum, itself rounded again --
// all in registers.  The partials go out as bf16 pairs.
//
// fp32 (a checking dtype: every tune target and the serving path run
// bf16): the CUDA-core body of the first version, 256 threads as a 16 x 16
// grid, each thread owning (bm/16) x (bn/16) outputs, FMAs from unpadded
// stage rows.  TF32 would change its numbers.
//
// What bounds it on this card: at the shapes of the serving path (M = 4 or
// 32 rows against 576/1536-wide weights) the GEMMs do 2*M FLOPs per weight
// element, far below the ~295 FLOP/byte ridge of an H100 in bf16; a call
// reads 0.07-0.53 MB of weights (0.07-0.53 us at 3.35 TB/s), so launch and
// DRAM latency set its floor, and the tuned configs split K 8 ways to put
// more CTAs on the 132 SMs -- which is why the split reduction is a single
// pass.  At M = 4 the tensor cores run mostly on zero rows of the 16-row
// A fragment; that costs products, not bytes.  Table 4's large shapes
// (LINPACK 2048^3) are bound by operations, where mma.sync is a step
// towards wgmma and TMA (not used here).
//
// Built by kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound through the plain C entry points `gemm_launch` and
// `splitk_reduce_launch` with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using namespace mma;

constexpr int kSimtThreads = 256;  // the fp32 body's 16 x 16 thread grid
constexpr int kMaxSmem = 232448;   // dynamic shared memory opt-in limit

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

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ bf16 zero<bf16>() { return __float2bfloat16_rn(0.f); }

// Load the (BM x bk) tile of A at (m0, k0), rows of pitch pa, and the
// (bk x BN) tile of B at (k0, n0), rows of pitch pb, into one shared-memory
// stage; elements outside M/N/K are zero.  bk is a power of 2, so a copy's
// row and column in the A tile are a shift and a mask.
template <typename T, int BM, int BN, int NTHREADS>
__device__ __forceinline__ void load_stage(T* As, T* Bs, const T* __restrict__ A,
                                           const T* __restrict__ B, int M, int N, int K,
                                           int m0, int n0, int k0, int bk, int pa, int pb,
                                           bool vec_a, bool vec_b) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte copy
  const int tid = threadIdx.x;
  if (vec_a) {
    // K % V == 0 and k0 % V == 0: each chunk is wholly inside or outside
    const int lg = __ffs(bk / V) - 1;  // log2 of the 16-byte chunks a row
    for (int c = tid; c < (BM << lg); c += NTHREADS) {
      const int r = c >> lg, kc = (c & ((1 << lg) - 1)) * V;
      const int gr = m0 + r, gk = k0 + kc;
      const bool ok = gr < M && gk < K;
      cp_async16(As + r * pa + kc, ok ? A + (size_t)gr * K + gk : A, ok);
    }
  } else {
    const int lg = __ffs(bk) - 1;
    for (int e = tid; e < (BM << lg); e += NTHREADS) {
      const int r = e >> lg, kk = e & (bk - 1);
      const int gr = m0 + r, gk = k0 + kk;
      As[r * pa + kk] = (gr < M && gk < K) ? A[(size_t)gr * K + gk] : zero<T>();
    }
  }
  if (vec_b) {
    constexpr int cpr = BN / V;
    for (int c = tid; c < bk * cpr; c += NTHREADS) {
      const int r = c / cpr, nc = (c % cpr) * V;
      const int gk = k0 + r, gn = n0 + nc;
      const bool ok = gk < K && gn < N;
      cp_async16(Bs + r * pb + nc, ok ? B + (size_t)gk * N + gn : B, ok);
    }
  } else {
    for (int e = tid; e < bk * BN; e += NTHREADS) {
      const int r = e / BN, nn = e % BN;
      const int gk = k0 + r, gn = n0 + nn;
      Bs[r * pb + nn] = (gk < K && gn < N) ? B[(size_t)gk * N + gn] : zero<T>();
    }
  }
}

// (tile row, tile column) of this CTA under the `order` raster
__device__ __forceinline__ int2 tile_of(int BM, int BN, int M, int N, int order) {
  const int gm = (M + BM - 1) / BM, gn = (N + BN - 1) / BN;
  const int tile = blockIdx.x;
  if (order == 0) return make_int2(tile / gn, tile % gn);
  return make_int2(tile % gm, tile / gm);
}

struct Problem {
  int M, N, K;
  int bk, kps, k_unroll;  // stage depth, stages per split, sub-dots a stage
  int vec_a, vec_b;       // 16-byte copies possible for A / B rows
};

// ---------------------------------------------------------------------------
// bf16: mma.sync tensor cores
// ---------------------------------------------------------------------------

// One CTA per SM in the launch bounds, as in conv.cu: without it ptxas may
// cap the registers of the larger tiles and spill.
template <int BM, int BN, bool ACC32>
__global__ void __launch_bounds__(MmaTile<BM, BN>::kThreads, 1)
    gemm_mma_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                    bf16* __restrict__ C, Problem pb, int stages, int order) {
  using Tl = MmaTile<BM, BN>;
  constexpr int kThreads = Tl::kThreads, MT = Tl::kMT, NT = Tl::kNT, PB = Tl::kPF;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int bk = pb.bk, pa = mma_pitch(bk);
  const int stage_elems = BM * pa + bk * PB;

  const int2 tl = tile_of(BM, BN, pb.M, pb.N, order);
  const int m0 = tl.x * BM, n0 = tl.y * BN;
  const int split = blockIdx.z;
  const int kbase = split * pb.kps * bk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm0 = (warp / Tl::kWarpsN) * Tl::kWM, wn0 = (warp % Tl::kWarpsN) * Tl::kWN;
  const int g = lane >> 2, t4 = lane & 3;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  // prologue: stages-1 tiles in flight
  for (int s = 0; s < stages - 1; ++s) {
    if (s < pb.kps) {
      bf16* st = smem + s * stage_elems;
      load_stage<bf16, BM, BN, kThreads>(st, st + BM * pa, A, B, pb.M, pb.N, pb.K, m0, n0,
                                         kbase + s * bk, bk, pa, PB, pb.vec_a, pb.vec_b);
    }
    cp_async_commit();
  }

  const int sub_len = bk / pb.k_unroll;  // a whole number of k16 steps
  for (int t = 0; t < pb.kps; ++t) {
    const int nt = t + stages - 1;
    if (nt < pb.kps) {
      bf16* st = smem + (nt % stages) * stage_elems;
      load_stage<bf16, BM, BN, kThreads>(st, st + BM * pa, A, B, pb.M, pb.N, pb.K, m0, n0,
                                         kbase + nt * bk, bk, pa, PB, pb.vec_a, pb.vec_b);
    }
    cp_async_commit();
    cp_async_wait(stages - 1);
    __syncthreads();

    const bf16* As = smem + (t % stages) * stage_elems;
    const bf16* Bs = As + BM * pa;
    if constexpr (ACC32) {
      window_dot<MT, NT>(acc, As, Bs, bk, pa, PB, wm0, wn0, lane);
    } else {
      for (int u = 0; u < pb.k_unroll; ++u) {
        float sub[MT][NT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) sub[i][j][e] = 0.f;
        window_dot<MT, NT>(sub, As + u * sub_len, Bs + u * sub_len * PB, sub_len, pa, PB, wm0,
                           wn0, lane);
        // the sub-dot is complete in fp32: round it, add, round again
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][j][e] = __bfloat162float(__float2bfloat16_rn(
                  acc[i][j][e] + __bfloat162float(__float2bfloat16_rn(sub[i][j][e]))));
      }
    }
    __syncthreads();  // the stage is refilled by a later iteration
  }

  // epilogue: two adjacent columns a store where N keeps them 4-byte aligned
  bf16* Cs = C + (size_t)split * pb.M * pb.N;
  const bool pairs = (pb.N % 2) == 0;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm0 + 16 * i + g + 8 * h;
      if (m >= pb.M) continue;
      bf16* crow = Cs + (size_t)m * pb.N;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + wn0 + 8 * j + 2 * t4;
        const float lo = acc[i][j][2 * h], hi = acc[i][j][2 * h + 1];
        if (pairs && n + 1 < pb.N) {
          *reinterpret_cast<uint32_t*>(crow + n) = pack_bf16(lo, hi);
        } else {
          if (n < pb.N) crow[n] = __float2bfloat16_rn(lo);
          if (n + 1 < pb.N) crow[n + 1] = __float2bfloat16_rn(hi);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: the CUDA-core body
// ---------------------------------------------------------------------------

template <int BM, int BN>
__global__ void __launch_bounds__(kSimtThreads)
    gemm_simt_kernel(const float* __restrict__ A, const float* __restrict__ B,
                     float* __restrict__ C, Problem pb, int stages, int order) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  constexpr int TM = BM / 16, TN = BN / 16;
  const int bk = pb.bk;
  const int stage_elems = (BM + BN) * bk;

  const int2 tl = tile_of(BM, BN, pb.M, pb.N, order);
  const int m0 = tl.x * BM, n0 = tl.y * BN;
  const int split = blockIdx.z;
  const int kbase = split * pb.kps * bk;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // prologue: stages-1 tiles in flight
  for (int s = 0; s < stages - 1; ++s) {
    if (s < pb.kps) {
      float* st = smem + s * stage_elems;
      load_stage<float, BM, BN, kSimtThreads>(st, st + BM * bk, A, B, pb.M, pb.N, pb.K, m0, n0,
                                              kbase + s * bk, bk, bk, BN, pb.vec_a, pb.vec_b);
    }
    cp_async_commit();
  }

  for (int t = 0; t < pb.kps; ++t) {
    const int nt = t + stages - 1;
    if (nt < pb.kps) {
      float* st = smem + (nt % stages) * stage_elems;
      load_stage<float, BM, BN, kSimtThreads>(st, st + BM * bk, A, B, pb.M, pb.N, pb.K, m0, n0,
                                              kbase + nt * bk, bk, bk, BN, pb.vec_a, pb.vec_b);
    }
    cp_async_commit();
    cp_async_wait(stages - 1);
    __syncthreads();

    const float* As = smem + (t % stages) * stage_elems;
    const float* Bs = As + BM * bk;
#pragma unroll 4
    for (int kk = 0; kk < bk; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[(ty + 16 * i) * bk + kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk * BN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // the stage is refilled by a later iteration
  }

  float* Cs = C + (size_t)split * pb.M * pb.N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= pb.M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c < pb.N) Cs[(size_t)r * pb.N + c] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// the split-K reduction
// ---------------------------------------------------------------------------

constexpr int kReduceThreads = 256;

// acc[0..V) += the V elements at p (16 bytes where V > 1)
template <int V> __device__ __forceinline__ void add_vec(float* acc, const bf16* p) {
  if constexpr (V == 1) {
    acc[0] += __bfloat162float(*p);
  } else {
    static_assert(V == 8, "16 bytes of bf16");
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      acc[2 * j] += f.x;
      acc[2 * j + 1] += f.y;
    }
  }
}

template <int V> __device__ __forceinline__ void add_vec(float* acc, const float* p) {
  if constexpr (V == 1) {
    acc[0] += *p;
  } else {
    static_assert(V == 4, "16 bytes of fp32");
    const float4 v = *reinterpret_cast<const float4*>(p);
    acc[0] += v.x;
    acc[1] += v.y;
    acc[2] += v.z;
    acc[3] += v.w;
  }
}

template <int V> __device__ __forceinline__ void store_vec(bf16* p, const float* acc) {
  if constexpr (V == 1) {
    *p = __float2bfloat16_rn(acc[0]);
  } else {
    uint4 v;
    v.x = pack_bf16(acc[0], acc[1]);
    v.y = pack_bf16(acc[2], acc[3]);
    v.z = pack_bf16(acc[4], acc[5]);
    v.w = pack_bf16(acc[6], acc[7]);
    *reinterpret_cast<uint4*>(p) = v;
  }
}

template <int V> __device__ __forceinline__ void store_vec(float* p, const float* acc) {
  if constexpr (V == 1) {
    *p = acc[0];
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
}

// out[i] = the IO-dtype rounding of sum_s parts[s][i], the sum in fp32 in
// split order; a thread owns V consecutive elements (16 bytes where the
// partials' length keeps every split's rows 16-byte aligned).
template <typename T, int V>
__global__ void __launch_bounds__(kReduceThreads)
    splitk_reduce_kernel(const T* __restrict__ parts, T* __restrict__ out, long long n,
                         int k_split) {
  const long long i = ((long long)blockIdx.x * kReduceThreads + threadIdx.x) * V;
  if (i >= n) return;
  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;
  for (int s = 0; s < k_split; ++s) add_vec<V>(acc, parts + (size_t)s * n + i);
  store_vec<V>(out + i, acc);
}

template <typename T, int V>
int reduce(const void* parts, void* out, long long n, int k_split, cudaStream_t stream) {
  const long long blocks = (n / V + kReduceThreads - 1) / kReduceThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  splitk_reduce_kernel<T, V><<<static_cast<unsigned>(blocks), kReduceThreads, 0, stream>>>(
      static_cast<const T*>(parts), static_cast<T*>(out), n, k_split);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, int BM, int BN, bool ACC32>
int launch(const void* A, const void* B, void* C, const Problem& pb, int k_split, int order,
           int prefetch, cudaStream_t stream) {
  constexpr bool kMma = std::is_same<T, bf16>::value;
  // bf16 rows are padded for ldmatrix; fp32 rows are not
  const int pa = kMma ? mma_pitch(pb.bk) : pb.bk;
  const int pbn = kMma ? MmaTile<BM, BN>::kPF : BN;
  const int threads = kMma ? MmaTile<BM, BN>::kThreads : kSimtThreads;
  const size_t smem = (size_t)prefetch * (BM * pa + pb.bk * pbn) * sizeof(T);
  if (smem > (size_t)kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const long long gm = (pb.M + BM - 1) / BM, gn = (pb.N + BN - 1) / BN;
  if (gm * gn > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(gm * gn), 1, k_split);
  static bool opted_in = false;  // one opt-in per instantiation
  if constexpr (kMma) {
    auto kernel = gemm_mma_kernel<BM, BN, ACC32>;
    if (!opted_in) {
      cudaError_t e =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (e != cudaSuccess) return static_cast<int>(e);
      opted_in = true;
    }
    kernel<<<grid, threads, smem, stream>>>(static_cast<const bf16*>(A),
                                            static_cast<const bf16*>(B), static_cast<bf16*>(C),
                                            pb, prefetch, order);
  } else {
    static_assert(ACC32, "fp32 IO accumulates in fp32");
    auto kernel = gemm_simt_kernel<BM, BN>;
    if (!opted_in) {
      cudaError_t e =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (e != cudaSuccess) return static_cast<int>(e);
      opted_in = true;
    }
    kernel<<<grid, threads, smem, stream>>>(static_cast<const float*>(A),
                                            static_cast<const float*>(B),
                                            static_cast<float*>(C), pb, prefetch, order);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BM, bool ACC32>
int launch_bn(int bn, const void* A, const void* B, void* C, const Problem& pb, int k_split,
              int order, int prefetch, cudaStream_t stream) {
  switch (bn) {
    case 32:
      return launch<T, BM, 32, ACC32>(A, B, C, pb, k_split, order, prefetch, stream);
    case 64:
      return launch<T, BM, 64, ACC32>(A, B, C, pb, k_split, order, prefetch, stream);
    case 128:
      return launch<T, BM, 128, ACC32>(A, B, C, pb, k_split, order, prefetch, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, bool ACC32>
int launch_bm(int bm, int bn, const void* A, const void* B, void* C, const Problem& pb,
              int k_split, int order, int prefetch, cudaStream_t stream) {
  switch (bm) {
    case 16:
      return launch_bn<T, 16, ACC32>(bn, A, B, C, pb, k_split, order, prefetch, stream);
    case 32:
      return launch_bn<T, 32, ACC32>(bn, A, B, C, pb, k_split, order, prefetch, stream);
    case 64:
      return launch_bn<T, 64, ACC32>(bn, A, B, C, pb, k_split, order, prefetch, stream);
    case 128:
      return launch_bn<T, 128, ACC32>(bn, A, B, C, pb, k_split, order, prefetch, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32.  Returns cudaGetLastError() after the launch
// (0 = launched), or cudaErrorInvalidValue for a config it does not build.
// bk is a power of 2 from 16 up, bk / k_unroll a multiple of 16.
extern "C" int gemm_launch(const void* A, const void* B, void* C, int M, int N, int K,
                           int dtype, int bm, int bn, int bk, int k_split, int k_unroll,
                           int acc32, int order, int prefetch, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bk < 16 || (bk & (bk - 1)) || k_split <= 0 ||
      k_unroll <= 0 || (bk / k_unroll) % 16 || bk % k_unroll || prefetch < 1 || prefetch > 3 ||
      k_split > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Problem pb;
  pb.M = M;
  pb.N = N;
  pb.K = K;
  pb.bk = bk;
  const long long chunk = (long long)bk * k_split;
  pb.kps = static_cast<int>((K + chunk - 1) / chunk);
  pb.k_unroll = k_unroll;
  const int V = dtype == 0 ? 8 : 4;
  pb.vec_a = (K % V == 0) && (reinterpret_cast<uintptr_t>(A) % 16 == 0);
  pb.vec_b = (N % V == 0) && (reinterpret_cast<uintptr_t>(B) % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (acc32) return launch_bm<bf16, true>(bm, bn, A, B, C, pb, k_split, order, prefetch, s);
    return launch_bm<bf16, false>(bm, bn, A, B, C, pb, k_split, order, prefetch, s);
  }
  // fp32 sums in fp32 throughout, so k_unroll (where the sum would round)
  // does not change its arithmetic
  if (dtype == 1 && acc32)
    return launch_bm<float, true>(bm, bn, A, B, C, pb, k_split, order, prefetch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// (k_split, M, N) partials -> (M, N): summed in fp32 in split order and
// rounded once to the IO dtype (0 = bf16, 1 = fp32).  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue.
extern "C" int splitk_reduce_launch(const void* parts, void* out, int k_split, int M, int N,
                                    int dtype, void* stream) {
  if (k_split <= 0 || M <= 0 || N <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = (long long)M * N;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int V = dtype == 0 ? 8 : 4;
  const bool vec = n % V == 0 && reinterpret_cast<uintptr_t>(parts) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (dtype == 0)
    return vec ? reduce<bf16, 8>(parts, out, n, k_split, s)
               : reduce<bf16, 1>(parts, out, n, k_split, s);
  return vec ? reduce<float, 4>(parts, out, n, k_split, s)
             : reduce<float, 1>(parts, out, n, k_split, s);
}
