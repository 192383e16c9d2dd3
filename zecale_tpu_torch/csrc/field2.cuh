// Fq2 = Fq[u] / (u^2 - nr) over the BLS12-377 base field (12 limbs), nr =
// -5: the coordinate field of BLS12-377 G2.  An element is c0 | c1, 2 x 12
// little-endian 32-bit Montgomery limbs (R = 2^384, the JAX package's R),
// canonical in both coefficients.  The plain PyTorch twin is
// ff/fp2_torch.py; host_check.cpp builds this header with g++ for the
// tests.
//
// Ports ff/fp2_jax.py:Fp2TPU and ec/msm8.py:Fp28TPU (Karatsuba: three Fq
// products).  The non-residue multiply is -(4x + x) through fp_mul_small,
// never a multiply by a negative limb (the trap of ff/fp8q.py:496-501).
#pragma once
#include "field.cuh"

struct Fq2 {
  static constexpr int NB = 12;      // limbs of the base field
  static constexpr int W = 2 * NB;   // words per element
  static constexpr int kNr = -5;     // u^2
  using Params = FieldParams<NB>;
  // b3 of the D-twist y^2 = x^3 + 1/u: (0, -3/5), Montgomery limbs
  struct B3 {
    uint32_t c[W];
  };

  static constexpr int ROW = W;      // words of a coordinate in memory
  static constexpr bool kUniform = false;  // see field_fast.cuh Lanes
  ZT_HD static void copy(uint32_t* r, const uint32_t* a) {
    fp_copy<W>(r, a);
  }
  // coordinate k of a row of coordinates
  ZT_HD static void load(uint32_t* r, const uint32_t* row, int k) {
    fp_copy<W>(r, row + k * W);
  }
  ZT_HD static void store(uint32_t* row, const uint32_t* a, int k) {
    fp_copy<W>(row + k * W, a);
  }
  ZT_HD static void zero(uint32_t* r) {
#pragma unroll
    for (int i = 0; i < W; ++i) r[i] = 0;
  }
  ZT_HD static void one(uint32_t* r, const Params& F) {
    fp_copy<NB>(r, F.one);
#pragma unroll
    for (int i = NB; i < W; ++i) r[i] = 0;
  }
  ZT_HD static bool is_zero(const uint32_t* a) { return fp_is_zero<W>(a); }
  ZT_HD static void add(uint32_t* r, const uint32_t* a, const uint32_t* b,
                        const Params& F) {
    fp_add<NB>(r, a, b, F);
    fp_add<NB>(r + NB, a + NB, b + NB, F);
  }
  ZT_HD static void sub(uint32_t* r, const uint32_t* a, const uint32_t* b,
                        const Params& F) {
    fp_sub<NB>(r, a, b, F);
    fp_sub<NB>(r + NB, a + NB, b + NB, F);
  }
  ZT_HD static void neg(uint32_t* r, const uint32_t* a, const Params& F) {
    fp_neg<NB>(r, a, F);
    fp_neg<NB>(r + NB, a + NB, F);
  }
  // r = nr * a for a base-field element a
  ZT_HD static void mul_nr(uint32_t* r, const uint32_t* a, const Params& F) {
    fp_mul_small<NB>(r, a, kNr, F);
  }
  // Karatsuba: c1 = (a0 + a1)(b0 + b1) - a0 b0 - a1 b1, c0 = a0 b0 +
  // nr a1 b1.  r may alias a or b: it is written after the last read.
  //
  // On the device this is a call, not inlined: with ~40 products inlined
  // into one thread's group law, cicc (CUDA 12.8) segfaults on the
  // projective Fq2 bucket reduce, and ptxas spills 1.1 KB a thread in the
  // Fq2 proj_add kernel (116 B as a call).  As a call, the three base
  // products of one Fq2 product stay inlined and the group law stays small.
#ifdef __CUDACC__
  __host__ __device__ __noinline__
#else
  inline
#endif
  static void mul(uint32_t* r, const uint32_t* a, const uint32_t* b,
                  const Params& F) {
    uint32_t t0[NB], t1[NB], s[NB], u[NB];
    fp_mul<NB>(t0, a, b, F);
    fp_mul<NB>(t1, a + NB, b + NB, F);
    fp_add<NB>(s, a, a + NB, F);
    fp_add<NB>(u, b, b + NB, F);
    fp_mul<NB>(s, s, u, F);
    fp_sub<NB>(s, s, t0, F);
    fp_sub<NB>(r + NB, s, t1, F);
    mul_nr(t1, t1, F);
    fp_add<NB>(r, t0, t1, F);
  }
  ZT_HD static void mul_b3(uint32_t* r, const uint32_t* a, const B3& b3,
                           const Params& F) {
    mul(r, a, b3.c, F);
  }
};
