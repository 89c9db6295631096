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
// Staging (both bodies): a shared-memory stage holds `rs_unroll` windows,
// each a (b_npq x b_c) input tile (channels fastest) and a (b_c x b_k)
// filter tile (output channels fastest); stages stream through a ring of
// `prefetch` buffers filled with 16-byte cp.async copies (zero-filled past
// the edges).  Input rows of a channel count that is not a multiple of 16
// bytes (C=1 in Conv1 of DeepBench) and filter rows of such a K (K=174,
// K=87) fall back to element loads.  The tile's output pixels are decoded
// once into a row table in shared memory: p, q and the offset m*C of pixel
// m itself, which a window's shift (dr, ds) moves by (dr*W + ds)*C.
//
// bf16: tensor cores.  The CTA's warps are sized to its tile: each warp
// owns a (16 or 32) x (16, 32 or 64) block of the output (1 warp for a
// 16 x 16 tile, 8 for 128 x 128) and runs the window's sub-dot as
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, the input tile as
// the row-major A through ldmatrix.x4 and the filter tile as the col-major
// B through ldmatrix.x4.trans.  A slab of b_c = 8 channels is one
// m16n8k8 product (ldmatrix.x2 / .x2.trans): no zero-filled half k-step.
// Stage rows are padded to an odd number of 16-byte units, so the eight
// rows one ldmatrix phase reads hit distinct banks.  The fp32 accumulator
// fragments stay in registers; with acc32=0 a second fragment of the same
// positions takes each window's sub-dot (complete in fp32 once the window's
// k-steps are done), which is rounded to bf16 and added into the running
// sum, itself rounded again -- all in registers.
//
// fp32 (a checking dtype: every tune target runs bf16): the CUDA-core body
// of the first version, 256 threads as a 16 x 16 grid, each thread owning
// (b_npq/16) x (b_k/16) outputs, FMAs from unpadded stage rows.  TF32 would
// change its numbers.
//
// What bounds it on this card: the Table 5 convolutions do 2*C*R*S FLOPs
// per output and reuse every input element R*S*K times, so at full size
// they sit far above the ~295 FLOP/byte ridge of an H100 in bf16: they are
// bound by operations, which the mma.sync body brings onto the tensor
// cores.  What is left: wgmma (warpgroup products from shared-memory
// descriptors) and a TMA im2col tensor map in place of the cp.async
// gathers.  A C=1 input (Conv1) fills one channel of each 8-deep k-step.
//
// Built by kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound through the plain C entry point `conv_launch` with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using namespace mma;

constexpr int kSimtThreads = 256;   // the fp32 body's 16 x 16 thread grid
constexpr int kMaxSmem = 232448;    // dynamic shared memory opt-in limit
constexpr int kNoRow = -(1 << 28);  // row-table marker: past N*H*W

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

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
// for each of the group's windows, the (BM x bc) input tile (rows of pitch
// pa) and the (bc x BN) filter tile (rows of pitch pf).  Out-of-range
// elements are zero.  bc is a power of 2, so a copy's row and column are
// shifts and masks, and the row table holds each output pixel's p, q and
// m*C (no division per copy).
template <typename T, int BM, int BN, int NTHREADS>
__device__ __forceinline__ void load_stage(T* st, const T* __restrict__ I,
                                           const T* __restrict__ F, const Problem& pb,
                                           const long long* rb, const int* rp, const int* rq,
                                           int n0, int cbase, int t, int pa, int pf) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte copy
  const int tid = threadIdx.x;
  const int bc = pb.bc;
  const int c0 = cbase + (t / pb.groups) * bc;
  const int rs0 = (t % pb.groups) * pb.ru;
  const int win_elems = BM * pa + bc * pf;
  for (int u = 0; u < pb.ru; ++u) {
    const int rs = rs0 + u;
    if (rs >= pb.R * pb.S) break;  // the compute loop stops there too
    const int dr = rs / pb.S - pb.pt, ds = rs % pb.S - pb.pl;  // the window's shift
    // output pixel m = (n, p, q) reads input pixel (n, p + dr, q + ds), which
    // lies (dr*W + ds)*C elements past m*C
    const long long shift = ((long long)dr * pb.W + ds) * pb.C + c0;
    T* As = st + u * win_elems;
    T* Bs = As + BM * pa;
    // input tile: output pixel (n, p, q) reads input pixel
    // (n, p + r - pt, q + s - pl), channels [c0, c0 + bc)
    if (pb.vec_i) {
      const int lg = __ffs(bc / V) - 1;  // log2 of the 16-byte chunks a row
      for (int c = tid; c < (BM << lg); c += NTHREADS) {
        const int row = c >> lg, cc = (c & ((1 << lg) - 1)) * V;
        const int ip = rp[row] + dr, iq = rq[row] + ds;
        const bool ok = (unsigned)ip < (unsigned)pb.H && (unsigned)iq < (unsigned)pb.W &&
                        c0 + cc < pb.C;
        cp_async16(As + row * pa + cc, ok ? I + rb[row] + shift + cc : I, ok);
      }
    } else {
      const int lgc = __ffs(bc) - 1;
      for (int e = tid; e < (BM << lgc); e += NTHREADS) {
        const int row = e >> lgc, cc = e & (bc - 1);
        const int ip = rp[row] + dr, iq = rq[row] + ds;
        const bool ok = (unsigned)ip < (unsigned)pb.H && (unsigned)iq < (unsigned)pb.W &&
                        c0 + cc < pb.C;
        As[row * pa + cc] = ok ? I[rb[row] + shift + cc] : from_f<T>(0.f);
      }
    }
    // filter tile: F[r, s, c0 + kk, n0 + nn]
    const T* Frs = F + (size_t)rs * pb.C * pb.K;
    if (pb.vec_f) {
      constexpr int cpr = BN / V;
      for (int c = tid; c < bc * cpr; c += NTHREADS) {
        const int kk = c / cpr, nc = (c % cpr) * V;
        const int gc = c0 + kk, gk = n0 + nc;
        const bool ok = gc < pb.C && gk < pb.K;
        cp_async16(Bs + kk * pf + nc, ok ? Frs + (size_t)gc * pb.K + gk : F, ok);
      }
    } else {
      for (int e = tid; e < bc * BN; e += NTHREADS) {
        const int kk = e / BN, nn = e % BN;
        const int gc = c0 + kk, gk = n0 + nn;
        Bs[kk * pf + nn] = (gc < pb.C && gk < pb.K) ? Frs[(size_t)gc * pb.K + gk] : from_f<T>(0.f);
      }
    }
  }
}

// Decode the tile's output pixels once; rows past N*H*W never match a
// valid input pixel, so they load zeros.
template <int BM, int NTHREADS>
__device__ __forceinline__ void fill_row_table(long long* rb, int* rp, int* rq, int m0,
                                               const Problem& pb) {
  for (int row = threadIdx.x; row < BM; row += NTHREADS) {
    const int m = m0 + row;
    if (m < pb.npq) {
      rq[row] = m % pb.W;
      rp[row] = (m / pb.W) % pb.H;
      rb[row] = (long long)m * pb.C;
    } else {
      rb[row] = 0;
      rp[row] = kNoRow;
      rq[row] = 0;
    }
  }
}

// (tile row, tile column) of this CTA under the `order` raster
__device__ __forceinline__ int2 tile_of(int BM, int BN, const Problem& pb, int order) {
  const int gm = (pb.npq + BM - 1) / BM, gn = (pb.K + BN - 1) / BN;
  const int tile = blockIdx.x;
  if (order == 0) return make_int2(tile / gn, tile % gn);
  return make_int2(tile % gm, tile / gm);
}

// ---------------------------------------------------------------------------
// bf16: mma.sync tensor cores
// ---------------------------------------------------------------------------

// One CTA per SM in the launch bounds: without it ptxas capped some
// instantiations at 64 registers and spilled.
template <int BM, int BN, bool ACC32>
__global__ void __launch_bounds__(MmaTile<BM, BN>::kThreads, 1)
    conv_mma_kernel(const bf16* __restrict__ I, const bf16* __restrict__ F,
                    bf16* __restrict__ O, Problem pb, int stages, int order) {
  using Tl = MmaTile<BM, BN>;
  constexpr int kThreads = Tl::kThreads, MT = Tl::kMT, NT = Tl::kNT, PF = Tl::kPF;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int bc = pb.bc, pa = mma_pitch(bc);
  const int win = BM * pa + bc * PF;
  const int stage_elems = pb.ru * win;
  long long* rb = reinterpret_cast<long long*>(smem + (size_t)stages * stage_elems);
  int* rp = reinterpret_cast<int*>(rb + BM);
  int* rq = rp + BM;

  const int2 tl = tile_of(BM, BN, pb, order);
  const int m0 = tl.x * BM, n0 = tl.y * BN;
  const int split = blockIdx.z;
  const int cbase = split * pb.cps * pb.bc;
  const int n_tiles = pb.cps * pb.groups;  // stages this split walks
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm0 = (warp / Tl::kWarpsN) * Tl::kWM, wn0 = (warp % Tl::kWarpsN) * Tl::kWN;
  const int g = lane >> 2, t4 = lane & 3;

  fill_row_table<BM, kThreads>(rb, rp, rq, m0, pb);
  __syncthreads();

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  // prologue: stages-1 tiles in flight
  for (int s = 0; s < stages - 1; ++s) {
    if (s < n_tiles)
      load_stage<bf16, BM, BN, kThreads>(smem + s * stage_elems, I, F, pb, rb, rp, rq, n0, cbase,
                                         s, pa, PF);
    cp_async_commit();
  }

  const int rs_total = pb.R * pb.S;
  for (int t = 0; t < n_tiles; ++t) {
    const int nt = t + stages - 1;
    if (nt < n_tiles)
      load_stage<bf16, BM, BN, kThreads>(smem + (nt % stages) * stage_elems, I, F, pb, rb, rp, rq,
                                         n0, cbase, nt, pa, PF);
    cp_async_commit();
    cp_async_wait(stages - 1);
    __syncthreads();

    const bf16* st = smem + (t % stages) * stage_elems;
    const int rs0 = (t % pb.groups) * pb.ru;
    for (int u = 0; u < pb.ru && rs0 + u < rs_total; ++u) {
      const bf16* As = st + u * win;
      const bf16* Bs = As + BM * pa;
      if constexpr (ACC32) {
        window_dot<MT, NT>(acc, As, Bs, bc, pa, PF, wm0, wn0, lane);
      } else {
        float sub[MT][NT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) sub[i][j][0] = sub[i][j][1] = sub[i][j][2] = sub[i][j][3] = 0.f;
        window_dot<MT, NT>(sub, As, Bs, bc, pa, PF, wm0, wn0, lane);
        // the window's fp32 sub-dot is complete: round it, add, round again
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][j][e] = round_io<bf16>(acc[i][j][e] + round_io<bf16>(sub[i][j][e]));
      }
    }
    __syncthreads();  // the stage is refilled by a later iteration
  }

  // epilogue: two adjacent columns a store where K keeps them 4-byte aligned
  bf16* Os = O + (size_t)split * pb.npq * pb.K;
  const bool pairs = (pb.K % 2) == 0;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm0 + 16 * i + g + 8 * h;
      if (m >= pb.npq) continue;
      bf16* orow = Os + (size_t)m * pb.K;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int k = n0 + wn0 + 8 * j + 2 * t4;
        const float lo = acc[i][j][2 * h], hi = acc[i][j][2 * h + 1];
        if (pairs && k + 1 < pb.K) {
          *reinterpret_cast<uint32_t*>(orow + k) = pack_bf16(lo, hi);
        } else {
          if (k < pb.K) orow[k] = __float2bfloat16_rn(lo);
          if (k + 1 < pb.K) orow[k + 1] = __float2bfloat16_rn(hi);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: the CUDA-core body
// ---------------------------------------------------------------------------

template <typename T, int BM, int BN, bool ACC32>
__global__ void __launch_bounds__(kSimtThreads, 1)
    conv_kernel(const T* __restrict__ I, const T* __restrict__ F, T* __restrict__ O, Problem pb,
                int stages, int order) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  constexpr int TM = BM / 16, TN = BN / 16;
  const int stage_elems = pb.ru * (BM * pb.bc + pb.bc * BN);
  long long* rb = reinterpret_cast<long long*>(smem + (size_t)stages * stage_elems);
  int* rp = reinterpret_cast<int*>(rb + BM);
  int* rq = rp + BM;

  const int2 tl = tile_of(BM, BN, pb, order);
  const int m0 = tl.x * BM, n0 = tl.y * BN;
  const int split = blockIdx.z;
  const int cbase = split * pb.cps * pb.bc;
  const int n_tiles = pb.cps * pb.groups;  // stages this split walks
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  fill_row_table<BM, kSimtThreads>(rb, rp, rq, m0, pb);
  __syncthreads();

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // prologue: stages-1 tiles in flight
  for (int s = 0; s < stages - 1; ++s) {
    if (s < n_tiles)
      load_stage<T, BM, BN, kSimtThreads>(smem + s * stage_elems, I, F, pb, rb, rp, rq, n0, cbase,
                                          s, pb.bc, BN);
    cp_async_commit();
  }

  const int rs_total = pb.R * pb.S;
  const int bc = pb.bc;
  for (int t = 0; t < n_tiles; ++t) {
    const int nt = t + stages - 1;
    if (nt < n_tiles)
      load_stage<T, BM, BN, kSimtThreads>(smem + (nt % stages) * stage_elems, I, F, pb, rb, rp,
                                          rq, n0, cbase, nt, pb.bc, BN);
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

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, int BM, int BN, bool ACC32>
int launch(const void* I, const void* F, void* O, const Problem& pb, int c_split, int order,
           int prefetch, cudaStream_t stream) {
  constexpr bool kMma = std::is_same<T, bf16>::value;
  // bf16 rows are padded for ldmatrix; fp32 rows are not
  const int pa = kMma ? mma_pitch(pb.bc) : pb.bc;
  const int pf = kMma ? MmaTile<BM, BN>::kPF : BN;
  const int threads = kMma ? MmaTile<BM, BN>::kThreads : kSimtThreads;
  const size_t smem = (size_t)prefetch * pb.ru * (BM * pa + pb.bc * pf) * sizeof(T) +
                      BM * (sizeof(long long) + 2 * sizeof(int));
  if (smem > (size_t)kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const long long gm = (pb.npq + BM - 1) / BM, gn = (pb.K + BN - 1) / BN;
  if (gm * gn > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(gm * gn), 1, c_split);
  static bool opted_in = false;  // one opt-in per instantiation
  if constexpr (kMma) {
    auto kernel = conv_mma_kernel<BM, BN, ACC32>;
    if (!opted_in) {
      cudaError_t e =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (e != cudaSuccess) return static_cast<int>(e);
      opted_in = true;
    }
    kernel<<<grid, threads, smem, stream>>>(static_cast<const bf16*>(I),
                                            static_cast<const bf16*>(F), static_cast<bf16*>(O),
                                            pb, prefetch, order);
  } else {
    auto kernel = conv_kernel<T, BM, BN, ACC32>;
    if (!opted_in) {
      cudaError_t e =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (e != cudaSuccess) return static_cast<int>(e);
      opted_in = true;
    }
    kernel<<<grid, threads, smem, stream>>>(static_cast<const T*>(I), static_cast<const T*>(F),
                                            static_cast<T*>(O), pb, prefetch, order);
  }
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
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || K <= 0 || R <= 0 || S <= 0 || b_c < 8 ||
      (b_c & (b_c - 1)) || rs_unroll <= 0 || c_split <= 0 || c_split > 65535 || prefetch < 1 ||
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
    if (acc32) return launch_bm<bf16, true>(b_npq, b_k, I, F, O, pb, c_split, order, prefetch, s);
    return launch_bm<bf16, false>(b_npq, b_k, I, F, O, pb, c_split, order, prefetch, s);
  }
  if (dtype == 1 && acc32)
    return launch_bm<float, true>(b_npq, b_k, I, F, O, pb, c_split, order, prefetch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
