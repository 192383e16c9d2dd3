// Montgomery arithmetic over N little-endian 32-bit limbs (R = 2^(32N)),
// as __host__ __device__ inline functions: nvcc builds them into the
// kernels, g++ into a small CPU library the tests hold against the plain
// PyTorch version (ff/fp_torch.py).  Fq<N> at the end wraps them as the
// field type that the group law (curve.cuh) is written over; field2.cuh
// has the other one, Fq2.  Every function takes and returns
// canonical values in [0, p); p < 2^(32N - 1) for every field used here
// (BLS12-377 Fq and BW6-761 Fr at N = 12, BW6-761 Fq at N = 24).
#pragma once
#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#define ZT_HD __host__ __device__ __forceinline__
#else
#define ZT_HD inline
#endif

template <int N>
struct FieldParams {
  uint32_t p[N];
  uint32_t one[N];  // R mod p: Montgomery form of 1
  uint32_t pinv;    // -p^-1 mod 2^32
};

template <int N>
ZT_HD void fp_copy(uint32_t* r, const uint32_t* a) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = a[i];
}

template <int N>
ZT_HD bool fp_is_zero(const uint32_t* a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) acc |= a[i];
  return acc == 0;
}

// a >= b
template <int N>
ZT_HD bool fp_geq(const uint32_t* a, const uint32_t* b) {
  for (int i = N - 1; i >= 0; --i)
    if (a[i] != b[i]) return a[i] > b[i];
  return true;
}

// r = a - b, returns the borrow out
template <int N>
ZT_HD uint32_t fp_sub_raw(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t br = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t d = (uint64_t)a[i] - b[i] - br;
    r[i] = (uint32_t)d;
    br = (uint32_t)(d >> 63);
  }
  return br;
}

// r = a + b, returns the carry out
template <int N>
ZT_HD uint32_t fp_add_raw(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t s = (uint64_t)a[i] + b[i] + c;
    r[i] = (uint32_t)s;
    c = s >> 32;
  }
  return (uint32_t)c;
}

template <int N>
ZT_HD void fp_add(uint32_t* r, const uint32_t* a, const uint32_t* b,
                  const FieldParams<N>& F) {
  uint32_t c = fp_add_raw<N>(r, a, b);
  if (c || fp_geq<N>(r, F.p)) fp_sub_raw<N>(r, r, F.p);
}

template <int N>
ZT_HD void fp_sub(uint32_t* r, const uint32_t* a, const uint32_t* b,
                  const FieldParams<N>& F) {
  if (fp_sub_raw<N>(r, a, b)) fp_add_raw<N>(r, r, F.p);
}

template <int N>
ZT_HD void fp_neg(uint32_t* r, const uint32_t* a, const FieldParams<N>& F) {
  if (fp_is_zero<N>(a)) {
#pragma unroll
    for (int i = 0; i < N; ++i) r[i] = 0;
  } else {
    fp_sub_raw<N>(r, F.p, a);
  }
}

// CIOS Montgomery product r = a*b/R mod p.  The outer loop stays rolled:
// unrolled at N = 24 inside the group law it multiplies the code size
// (and the nvcc time) by 24 for little gain in a register-bound kernel.
// r may alias a or b: it is written only after the last read.
template <int N>
ZT_HD void fp_mul(uint32_t* r, const uint32_t* a, const uint32_t* b,
                  const FieldParams<N>& F) {
  uint32_t t[N + 2];
#pragma unroll
  for (int i = 0; i < N + 2; ++i) t[i] = 0;
#pragma unroll 1
  for (int i = 0; i < N; ++i) {
    const uint64_t bi = b[i];
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      uint64_t s = (uint64_t)a[j] * bi + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[N] + c;
    t[N] = (uint32_t)s;
    t[N + 1] = (uint32_t)(s >> 32);
    const uint64_t m = (uint32_t)(t[0] * F.pinv);
    s = m * F.p[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < N; ++j) {
      s = m * F.p[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[N] + c;
    t[N - 1] = (uint32_t)s;
    t[N] = t[N + 1] + (uint32_t)(s >> 32);
  }
  if (t[N] || fp_geq<N>(t, F.p)) fp_sub_raw<N>(t, t, F.p);
  fp_copy<N>(r, t);
}

// r = k*a for a small integer k (b3 = 3, -3 or 12, the Fq2 non-residue
// -5): double-and-add, then a field negation for k < 0 -- never a multiply
// by a negative limb.
template <int N>
ZT_HD void fp_mul_small(uint32_t* r, const uint32_t* a, int k,
                        const FieldParams<N>& F) {
  uint32_t base[N], acc[N];
  fp_copy<N>(base, a);
  fp_copy<N>(acc, a);
  unsigned mag = k < 0 ? (unsigned)(-k) : (unsigned)k;
  int top = 31;
  while (top > 0 && !((mag >> top) & 1u)) --top;
  for (int bit = top - 1; bit >= 0; --bit) {
    fp_add<N>(acc, acc, acc, F);
    if ((mag >> bit) & 1u) fp_add<N>(acc, acc, base, F);
  }
  if (k < 0)
    fp_neg<N>(r, acc, F);
  else
    fp_copy<N>(r, acc);
}

// The prime field as a type for the group law: an element is W = N words,
// and b3 = 3b of the curve equation is a small signed integer (3 for
// BLS12-377 G1, -3 for BW6-761 G1, 12 for BW6-761 G2).
template <int N>
struct Fq {
  static constexpr int NB = N;  // limbs of the base prime field
  static constexpr int W = N;   // words per element
  using Params = FieldParams<N>;
  using B3 = int;

  static constexpr int ROW = N;  // words of a coordinate in memory
  static constexpr bool kUniform = false;  // see field_fast.cuh Lanes
  ZT_HD static void copy(uint32_t* r, const uint32_t* a) { fp_copy<N>(r, a); }
  // coordinate k of a row of coordinates
  ZT_HD static void load(uint32_t* r, const uint32_t* row, int k) {
    fp_copy<N>(r, row + k * N);
  }
  ZT_HD static void store(uint32_t* row, const uint32_t* a, int k) {
    fp_copy<N>(row + k * N, a);
  }
  ZT_HD static void zero(uint32_t* r) {
#pragma unroll
    for (int i = 0; i < N; ++i) r[i] = 0;
  }
  ZT_HD static void one(uint32_t* r, const Params& F) { fp_copy<N>(r, F.one); }
  ZT_HD static bool is_zero(const uint32_t* a) { return fp_is_zero<N>(a); }
  ZT_HD static void add(uint32_t* r, const uint32_t* a, const uint32_t* b,
                        const Params& F) {
    fp_add<N>(r, a, b, F);
  }
  ZT_HD static void sub(uint32_t* r, const uint32_t* a, const uint32_t* b,
                        const Params& F) {
    fp_sub<N>(r, a, b, F);
  }
  ZT_HD static void neg(uint32_t* r, const uint32_t* a, const Params& F) {
    fp_neg<N>(r, a, F);
  }
  ZT_HD static void mul(uint32_t* r, const uint32_t* a, const uint32_t* b,
                        const Params& F) {
    fp_mul<N>(r, a, b, F);
  }
  ZT_HD static void mul_b3(uint32_t* r, const uint32_t* a, B3 b3,
                           const Params& F) {
    fp_mul_small<N>(r, a, b3, F);
  }
};
