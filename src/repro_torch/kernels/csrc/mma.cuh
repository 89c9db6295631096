// Warp-level tensor-core helpers for sm_90a, shared by the kernels that
// run their bf16 products on mma.sync (attention.cu, conv.cu, gemm.cu):
// ldmatrix loads of 8x8 bf16 tiles from shared memory, the m16n8k16 and
// m16n8k8 bf16 products with fp32 accumulators, a bf16 pair pack, and the
// warp-tiled block product of conv.cu and gemm.cu (MmaTile, mma_pitch,
// window_dot).
//
// Fragment layout of m16n8k16 (lane = 4*g + t4): an A or C fragment holds
// rows g and g+8; C element e of n-tile j is (row g + 8*(e/2), column
// 8j + 2*t4 + e%2).
//
// kernels/_build.py hashes this header with every source, so editing it
// rebuilds every library.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x2(uint32_t* r, const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t* r, const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c (16 x 8, fp32) += a (16 x 8, bf16, row) . b (8 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16_k8(float* c, const uint32_t* a, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Row pitch, in bf16 elements, of a bf16 stage row of n elements: an odd
// number of 16-byte units (n + 8 where n / 8 is even), so the eight rows an
// ldmatrix phase reads start in eight distinct bank groups.
__host__ __device__ constexpr int mma_pitch(int n) { return (n / 8) % 2 ? n : n + 8; }

// Warps sized to the CTA tile (BM, BN in 16..128): a warp owns kWM x kWN
// outputs, kMT x kNT m16n8 fragments (1 warp at 16 x 16 or 16 x 32, 8 at
// 128 x 128).
template <int BM, int BN> struct MmaTile {
  static constexpr int kWM = BM < 32 ? BM : 32;
  static constexpr int kWarpsM = BM / kWM;          // 1, 1, 2, 4
  static constexpr int kWarpsN = BN < 64 ? 1 : 2;
  static constexpr int kWN = BN / kWarpsN;          // 16, 32, 32, 64
  static constexpr int kThreads = 32 * kWarpsM * kWarpsN;
  static constexpr int kMT = kWM / 16;
  static constexpr int kNT = kWN / 8;
  static constexpr int kPF = mma_pitch(BN);        // B (filter) tile row pitch
};

// c += this warp's block of one sub-dot of depth bc (a multiple of 16, or
// 8): As (rows of pitch pa) is the (BM x bc) row-major operand, read
// through ldmatrix; Bs (rows of pitch pf) the (bc x BN) operand stored N
// fastest, read as the col-major operand through ldmatrix.trans; the
// warp's block starts at row wm0, column wn0.  In conv.cu a sub-dot is one
// (r, s) window's input and filter tiles; a GEMM is that window product at
// R = S = 1, its sub-dot bk / k_unroll elements of K.  Fragment layout of
// m16n8k16 (lane = 4*g + t4): an A fragment holds rows g and g+8; C
// element e of n-tile j is (row g + 8*(e/2), column 8j + 2*t4 + e%2).
template <int MT, int NT>
__device__ __forceinline__ void window_dot(float (&c)[MT][NT][4], const __nv_bfloat16* As,
                                           const __nv_bfloat16* Bs, int bc, int pa, int pf,
                                           int wm0, int wn0, int lane) {
  if (bc == 8) {  // one m16n8k8 step
    uint32_t a[MT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) ldsm_x2(a[i], As + (wm0 + 16 * i + (lane & 15)) * pa);
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      uint32_t b[2];
      ldsm_x2_trans(b, Bs + (lane & 7) * pf + wn0 + 16 * jp + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma_bf16_k8(c[i][2 * jp], a[i], b[0]);
        mma_bf16_k8(c[i][2 * jp + 1], a[i], b[1]);
      }
    }
    return;
  }
  const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8, b_col = (lane >> 4) * 8;
  for (int kk = 0; kk < bc; kk += 16) {
    uint32_t a[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
      ldsm_x4(a[i], As + (wm0 + 16 * i + (lane & 15)) * pa + kk + (lane >> 4) * 8);
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      uint32_t b[4];
      ldsm_x4_trans(b, Bs + (kk + b_row) * pf + wn0 + 16 * jp + b_col);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma_bf16(c[i][2 * jp], a[i], b[0], b[1]);
        mma_bf16(c[i][2 * jp + 1], a[i], b[2], b[3]);
      }
    }
  }
}

}  // namespace mma
