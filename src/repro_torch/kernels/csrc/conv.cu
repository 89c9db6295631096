// SAME, stride-1 implicit-GEMM convolution for Hopper (sm_90a): the port of
// the TPU kernel `_conv_kernel` / `conv2d_pallas` in
// `src/repro/kernels/conv.py`.
//
// What it computes (the same as the TPU kernel, not carried over block by
// block): I (N, H, W, C) NHWC conv F (R, S, C, K) RSCK, SAME padding (XLA's
// rule: an even filter pads one more row/column after than before), stride
// 1 -> (c_split, N, H, W, K) partials in the IO dtype.
//   * implicit GEMM: the output is an (N*H*W) x K matrix; one CTA per
//     (b_npq, b_k) tile of it and per split s (grid z = c_split); `order`
//     picks the raster: 0 walks k fastest, 1 walks npq fastest;
//   * split s reduces channels [s*cps*b_c, (s+1)*cps*b_c) of C padded to a
//     multiple of b_c*c_split, exactly as the TPU grid does, so bf16
//     partials round at the same places;
//   * the reduction walks C in b_c slabs and, within a slab, the R x S
//     filter offsets (r slower than s); each (r, s) window's input tile is
//     gathered through the shift (p + r - pad_top, q + s - pad_left), with
//     zero-fill for the SAME halo and for ragged C / K / N*H*W -- the kernel
//     masks every edge itself, nothing is padded in memory;
//   * acc32=1: fp32 accumulator, one cast of the partial at the end;
//     acc32=0: each window's b_c-deep sub-dot is summed in fp32, rounded to
//     the IO dtype, added to the running sum, and the sum is rounded again
//     -- what `acc + jnp.dot(..., preferred_element_type=bf16)` does on the
//     TPU;
//   * fp32 IO is full fp32 FMA (no TF32).
//
// Why not the TPU's design: the TPU kernel keeps the whole padded
// (H+R-1, W+S-1, b_c) image slab in VMEM and slices shifted windows out of
// it.  At the paper's Table 5 sizes that slab is megabytes; a CTA has at
// most 227 KB of shared memory.  So each CTA stages only what its output
// tile needs for `rs_unroll` windows at a time.
//
// Design: 256 threads as a 16 x 16 grid; each thread owns (b_npq/16) x
// (b_k/16) outputs in registers, as in gemm.cu.  A shared-memory stage holds
// `rs_unroll` windows, each a (b_npq x b_c) input tile and a (b_c x b_k)
// filter tile; stages stream through a ring of `prefetch` buffers filled
// with 16-byte cp.async copies (zero-filled past the edges).  Input rows of
// a channel count that is not a multiple of 16 bytes (C=1 in Conv1 of
// DeepBench) and filter rows of such a K (K=174, K=87) fall back to element
// loads.  The tile's (n, p, q) coordinates are decoded once into a row
// table in shared memory.
//
// What bounds it on this card: the Table 5 convolutions do 2*C*R*S FLOPs
// per output and reuse every input element R*S*K times, so at full size
// they sit far above the ~295 FLOP/byte ridge of an H100 in bf16: they are
// bound by operations.  This first version does its arithmetic as CUDA-core
// FMAs from shared memory (at most 67 TFLOP/s of fp32 FMA on an H100 SXM,
// against 989 TFLOP/s of bf16 tensor cores); mma.sync / wgmma and a TMA
// im2col tensor map are later work.
//
// Built by kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound through the plain C entry point `conv_launch` with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // dynamic shared memory opt-in limit
constexpr int kNoRow = -(1 << 28);  // row-table marker: past N*H*W

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

struct Problem {
  int N, H, W, C, K, R, S;
  int pt, pl;          // SAME padding before the first row / column
  int npq;             // N * H * W output pixels
  int bc, ru;          // b_c, rs_unroll
  int cps, groups;     // C slabs per split, ceil(R*S / ru) window groups
  int vec_i, vec_f;    // 16-byte copies possible for input / filter rows
};

// Load stage `t` (C slab t / groups, window group t % groups) of this CTA:
// for each of the group's windows, the (BM x bc) input tile and the
// (bc x BN) filter tile.  Out-of-range elements are zero.
template <typename T, int BM, int BN>
__device__ __forceinline__ void load_stage(T* st, const T* __restrict__ I,
                                           const T* __restrict__ F, const Problem& pb,
                                           const int* rn, const int* rp, const int* rq, int n0,
                                           int cbase, int t) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte copy
  const int tid = threadIdx.x;
  const int bc = pb.bc;
  const int c0 = cbase + (t / pb.groups) * bc;
  const int rs0 = (t % pb.groups) * pb.ru;
  const int win_elems = BM * bc + bc * BN;
  for (int u = 0; u < pb.ru; ++u) {
    const int rs = rs0 + u;
    if (rs >= pb.R * pb.S) break;  // the compute loop stops there too
    const int r = rs / pb.S, s = rs % pb.S;
    T* As = st + u * win_elems;
    T* Bs = As + BM * bc;
    // input tile: output pixel (n, p, q) reads input pixel
    // (n, p + r - pt, q + s - pl), channels [c0, c0 + bc)
    if (pb.vec_i) {
      const int cpr = bc / V;
      for (int c = tid; c < BM * cpr; c += kThreads) {
        const int row = c / cpr, cc = (c % cpr) * V;
        const int ip = rp[row] + r - pb.pt, iq = rq[row] + s - pb.pl;
        const int gc = c0 + cc;
        const bool ok = ip >= 0 && ip < pb.H && iq >= 0 && iq < pb.W && gc < pb.C;
        const T* src = ok ? I + (((size_t)rn[row] * pb.H + ip) * pb.W + iq) * pb.C + gc : I;
        cp_async16(As + row * bc + cc, src, ok);
      }
    } else {
      for (int e = tid; e < BM * bc; e += kThreads) {
        const int row = e / bc, cc = e % bc;
        const int ip = rp[row] + r - pb.pt, iq = rq[row] + s - pb.pl;
        const int gc = c0 + cc;
        const bool ok = ip >= 0 && ip < pb.H && iq >= 0 && iq < pb.W && gc < pb.C;
        As[e] = ok ? I[(((size_t)rn[row] * pb.H + ip) * pb.W + iq) * pb.C + gc] : from_f<T>(0.f);
      }
    }
    // filter tile: F[r, s, c0 + kk, n0 + nn]
    const T* Frs = F + (size_t)rs * pb.C * pb.K;
    if (pb.vec_f) {
      constexpr int cpr = BN / V;
      for (int c = tid; c < bc * cpr; c += kThreads) {
        const int kk = c / cpr, nc = (c % cpr) * V;
        const int gc = c0 + kk, gk = n0 + nc;
        const bool ok = gc < pb.C && gk < pb.K;
        cp_async16(Bs + kk * BN + nc, ok ? Frs + (size_t)gc * pb.K + gk : F, ok);
      }
    } else {
      for (int e = tid; e < bc * BN; e += kThreads) {
        const int kk = e / BN, nn = e % BN;
        const int gc = c0 + kk, gk = n0 + nn;
        Bs[e] = (gc < pb.C && gk < pb.K) ? Frs[(size_t)gc * pb.K + gk] : from_f<T>(0.f);
      }
    }
  }
}

template <typename T, int BM, int BN, bool ACC32>
__global__ void __launch_bounds__(kThreads)
    conv_kernel(const T* __restrict__ I, const T* __restrict__ F, T* __restrict__ O, Problem pb,
                int stages, int order) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  constexpr int TM = BM / 16, TN = BN / 16;
  const int stage_elems = pb.ru * (BM * pb.bc + pb.bc * BN);
  int* rn = reinterpret_cast<int*>(smem + (size_t)stages * stage_elems);
  int* rp = rn + BM;
  int* rq = rp + BM;

  const int gm = (pb.npq + BM - 1) / BM, gn = (pb.K + BN - 1) / BN;
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
  const int cbase = split * pb.cps * pb.bc;
  const int n_tiles = pb.cps * pb.groups;  // stages this split walks
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  // decode the tile's output pixels once; rows past N*H*W never match a
  // valid input pixel, so they load zeros
  for (int row = threadIdx.x; row < BM; row += kThreads) {
    const int m = m0 + row;
    if (m < pb.npq) {
      rq[row] = m % pb.W;
      const int nh = m / pb.W;
      rp[row] = nh % pb.H;
      rn[row] = nh / pb.H;
    } else {
      rn[row] = 0;
      rp[row] = kNoRow;
      rq[row] = 0;
    }
  }
  __syncthreads();

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // prologue: stages-1 tiles in flight
  for (int s = 0; s < stages - 1; ++s) {
    if (s < n_tiles) load_stage<T, BM, BN>(smem + s * stage_elems, I, F, pb, rn, rp, rq, n0, cbase, s);
    cp_async_commit();
  }

  const int rs_total = pb.R * pb.S;
  const int bc = pb.bc;
  for (int t = 0; t < n_tiles; ++t) {
    const int nt = t + stages - 1;
    if (nt < n_tiles)
      load_stage<T, BM, BN>(smem + (nt % stages) * stage_elems, I, F, pb, rn, rp, rq, n0, cbase, nt);
    cp_async_commit();
    cp_async_wait(stages - 1);
    __syncthreads();

    const T* st = smem + (t % stages) * stage_elems;
    const int rs0 = (t % pb.groups) * pb.ru;
    for (int u = 0; u < pb.ru && rs0 + u < rs_total; ++u) {
      const T* As = st + u * (BM * bc + bc * BN);
      const T* Bs = As + BM * bc;
      float sub[TM][TN];
      if constexpr (!ACC32) {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) sub[i][j] = 0.f;
      }
#pragma unroll 4
      for (int kk = 0; kk < bc; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = to_f<T>(As[(ty + 16 * i) * bc + kk]);
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

  T* Os = O + (size_t)split * pb.npq * pb.K;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= pb.npq) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int k = n0 + tx + 16 * j;
      if (k < pb.K) Os[(size_t)m * pb.K + k] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T, int BM, int BN, bool ACC32>
int launch(const void* I, const void* F, void* O, const Problem& pb, int c_split, int order,
           int prefetch, cudaStream_t stream) {
  auto kernel = conv_kernel<T, BM, BN, ACC32>;
  static bool opted_in = false;  // one opt-in per instantiation
  if (!opted_in) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const size_t smem = (size_t)prefetch * pb.ru * (BM * pb.bc + pb.bc * BN) * sizeof(T) +
                      3 * BM * sizeof(int);
  if (smem > (size_t)kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const long long gm = (pb.npq + BM - 1) / BM, gn = (pb.K + BN - 1) / BN;
  if (gm * gn > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(gm * gn), 1, c_split);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(I), static_cast<const T*>(F),
                                           static_cast<T*>(O), pb, prefetch, order);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BM, bool ACC32>
int launch_bn(int bn, const void* I, const void* F, void* O, const Problem& pb, int c_split,
              int order, int prefetch, cudaStream_t stream) {
  switch (bn) {
    case 16:
      return launch<T, BM, 16, ACC32>(I, F, O, pb, c_split, order, prefetch, stream);
    case 32:
      return launch<T, BM, 32, ACC32>(I, F, O, pb, c_split, order, prefetch, stream);
    case 64:
      return launch<T, BM, 64, ACC32>(I, F, O, pb, c_split, order, prefetch, stream);
    case 128:
      return launch<T, BM, 128, ACC32>(I, F, O, pb, c_split, order, prefetch, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, bool ACC32>
int launch_bm(int bm, int bn, const void* I, const void* F, void* O, const Problem& pb,
              int c_split, int order, int prefetch, cudaStream_t stream) {
  switch (bm) {
    case 16:
      return launch_bn<T, 16, ACC32>(bn, I, F, O, pb, c_split, order, prefetch, stream);
    case 32:
      return launch_bn<T, 32, ACC32>(bn, I, F, O, pb, c_split, order, prefetch, stream);
    case 64:
      return launch_bn<T, 64, ACC32>(bn, I, F, O, pb, c_split, order, prefetch, stream);
    case 128:
      return launch_bn<T, 128, ACC32>(bn, I, F, O, pb, c_split, order, prefetch, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32.  Returns cudaGetLastError() after the launch
// (0 = launched), or cudaErrorInvalidValue for a config it does not build.
extern "C" int conv_launch(const void* I, const void* F, void* O, int N, int H, int W, int C,
                           int K, int R, int S, int dtype, int b_npq, int b_k, int b_c,
                           int rs_unroll, int c_split, int acc32, int order, int prefetch,
                           void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || K <= 0 || R <= 0 || S <= 0 || b_c <= 0 ||
      b_c % 8 || rs_unroll <= 0 || c_split <= 0 || c_split > 65535 || prefetch < 1 ||
      prefetch > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long npq = (long long)N * H * W;
  if (npq > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  Problem pb;
  pb.N = N;
  pb.H = H;
  pb.W = W;
  pb.C = C;
  pb.K = K;
  pb.R = R;
  pb.S = S;
  pb.pt = (R - 1) / 2;
  pb.pl = (S - 1) / 2;
  pb.npq = static_cast<int>(npq);
  pb.bc = b_c;
  pb.ru = rs_unroll;
  const long long chunk = (long long)b_c * c_split;
  pb.cps = static_cast<int>((C + chunk - 1) / chunk);
  pb.groups = (R * S + rs_unroll - 1) / rs_unroll;
  const int V = dtype == 0 ? 8 : 4;
  pb.vec_i = (C % V == 0) && (reinterpret_cast<uintptr_t>(I) % 16 == 0);
  pb.vec_f = (K % V == 0) && (reinterpret_cast<uintptr_t>(F) % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (acc32)
      return launch_bm<__nv_bfloat16, true>(b_npq, b_k, I, F, O, pb, c_split, order, prefetch, s);
    return launch_bm<__nv_bfloat16, false>(b_npq, b_k, I, F, O, pb, c_split, order, prefetch, s);
  }
  if (dtype == 1 && acc32)
    return launch_bm<float, true>(b_npq, b_k, I, F, O, pb, c_split, order, prefetch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
