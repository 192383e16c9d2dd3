// The Montgomery field core of every kernel, all in fast_kernels.cu (K1
// bucket_reduce, K2 proj_add, K3 proj_dbl_chain, K4 jac_add, K5
// jac_dbl_chain, K6 aff_add): FqF<M, TPI, Uniform> over a modulus M fixed
// at compile time, and Fq2F<TPI, Uniform> over it.  field.cuh's Fq<N> and
// field2.cuh's Fq2 are left to the CPU tests of the older field code.
//
//   * The moduli are compile-time constants (Bls377Fq, Bw6Fq below): every
//     limb of p is an immediate of the instruction that uses it, and no
//     launcher passes p, R mod p or -p^-1.
//   * The carries run on PTX carry chains (add.cc / addc / mad.lo.cc /
//     madc.hi.cc, sub.cc / subc).  The product splits the partial products
//     of the even and of the odd limbs of a into two accumulators, so that
//     each chain's lo and hi halves tile disjoint words and the two chains
//     are independent (the scheme of sppark's mont_t).  Under g++ every
//     instruction is its portable 64-bit equivalent with the carry flag
//     held in a Carry object, so the CPU tests run the same instruction
//     sequence, chain for chain.
//   * No runtime-indexed array: every loop over limbs is unrolled, the
//     compare and the conditional subtraction take the borrow of t - p and
//     select, and a lane's slice of a constant is picked by selects.
//   * TPI threads per point (1, 2, 4 or 8; a group of TPI neighbouring
//     lanes of a warp).  Lane l holds limbs [l L, (l + 1) L), L = N / TPI,
//     of every element.  In the product each CIOS step broadcasts b_i and
//     m by a shuffle and every lane runs L multiply-adds against a and
//     against p into a window of its own (each product's lo and hi halves
//     side by side, which ptxas pairs); the words a lane carries above
//     its slice stay there, and every L steps each lane takes the next
//     lane's low words in one batch of shuffles, off the dependent path;
//     the last carries between lanes are resolved once, after the last
//     step (the design of NVIDIA Labs' CGBN).  Sums, differences and
//     compares carry between lanes through __ballot_sync masks: each lane
//     reports whether it generates a carry and whether it would propagate
//     one, and one integer add on the masks resolves every lane's
//     carry-in.  is_zero is a vote of the group, so all lanes of a group
//     take the same branch of the group law.  With Uniform, shuffles and
//     votes name the whole warp (plain SHFL and VOTE; the group's mask
//     costs a convergence region each), and any / all vote across it.
//   * Products side by side (mul_side_by_side, at the end): the 32 / TPI
//     groups of a warp that all hold one point each compute one of the
//     independent products of a step of the group law, and whole-warp
//     shuffles hand every result to every group.
//   * Under g++, host_check.cpp runs the lanes of a warp (one group, or
//     all 32 lanes for products side by side) as coroutines of one thread
//     that exchange words in the order a warp's shuffles and ballots would.
//
// Every function takes and returns canonical values in [0, p); p < 2^(32N
// - 6) in both fields, so sums never leave N words.
#pragma once
#include <stddef.h>
#include <stdint.h>

#include "field.cuh"

// ---------------------------------------------------------------------------
// The moduli: p, R mod p (R = 2^(32N)) and -p^-1 mod 2^32, little-endian
// 32-bit limbs.  A limb is read through a constexpr function so that device
// code may use it; with a constant index it folds to an immediate.

struct Bls377Fq {  // BLS12-377 base field, 377 bits
  static constexpr int N = 12;
  static constexpr uint32_t kPinv = 0xffffffffu;
  ZT_HD static constexpr uint32_t p(int i) {
    constexpr uint32_t v[N] = {
        0x00000001u, 0x8508c000u, 0x30000000u, 0x170b5d44u,
        0xba094800u, 0x1ef3622fu, 0x00f5138fu, 0x1a22d9f3u,
        0x6ca1493bu, 0xc63b05c0u, 0x17c510eau, 0x01ae3a46u};
    return v[i];
  }
  ZT_HD static constexpr uint32_t one(int i) {
    constexpr uint32_t v[N] = {
        0xffffff68u, 0x02cdffffu, 0x7fffffb1u, 0x51409f83u,
        0x8a7d3ff2u, 0x9f7db3a9u, 0x6e7c6305u, 0x7b4e97b7u,
        0x803c84e8u, 0x4cf495bfu, 0xe2fdf49au, 0x008d6661u};
    return v[i];
  }
};

struct Bw6Fq {  // BW6-761 base field, 761 bits
  static constexpr int N = 24;
  static constexpr uint32_t kPinv = 0x8fa798ddu;
  ZT_HD static constexpr uint32_t p(int i) {
    constexpr uint32_t v[N] = {
        0x0000008bu, 0xf49d0000u, 0x70000082u, 0xe6913e68u,
        0xeaf0a437u, 0x160cf8aeu, 0x5667a8f8u, 0x98a116c2u,
        0x73ebff2eu, 0x71dcd3dcu, 0x12f9fd90u, 0x8689c8edu,
        0x25b42304u, 0x03cebaffu, 0xe584e919u, 0x707ba638u,
        0x8087be41u, 0x528275efu, 0x81d14688u, 0xb926186au,
        0x04faff3eu, 0xd187c940u, 0xfb83ce0au, 0x0122e824u};
    return v[i];
  }
  ZT_HD static constexpr uint32_t one(int i) {
    constexpr uint32_t v[N] = {
        0xffff85d5u, 0x0202ffffu, 0x8fff8ce7u, 0x5a582635u,
        0x827faadeu, 0x9e996e43u, 0x0ee47df4u, 0xda6aff32u,
        0x1d94b80bu, 0xece9cb3eu, 0x5248240bu, 0xc0e667a2u,
        0xdcad3905u, 0xa74da5bfu, 0x462f2103u, 0x2352e7feu,
        0x08b1c87cu, 0x7b565880u, 0xe711022fu, 0x45848a63u,
        0x9f65a9dfu, 0xd7a81ebbu, 0xf127e87du, 0x0051f77eu};
    return v[i];
  }
};

// ---------------------------------------------------------------------------
// Carry-chain instructions.  On the device each is one PTX instruction and
// the flag is the hardware's CC.CF (ptxas renames it, so independent
// chains interleave); Carry is then empty of meaning.  On the host each is
// its 64-bit equivalent on c.cf.  A chain must not be interrupted by other
// carry-setting code: every function below keeps its chains contiguous.

struct Carry {
  uint32_t cf = 0;
};

#if defined(__CUDA_ARCH__)
#define ZT_CC1(op, r, a, b) \
  asm volatile(op " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b))
#define ZT_CC2(op, r, a, b, d) \
  asm volatile(op " %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(d))
#endif

ZT_HD uint32_t add_cc(Carry& c, uint32_t a, uint32_t b) {
  uint32_t r;
#if defined(__CUDA_ARCH__)
  ZT_CC1("add.cc.u32", r, a, b);
#else
  const uint64_t s = (uint64_t)a + b;
  r = (uint32_t)s;
  c.cf = (uint32_t)(s >> 32);
#endif
  return r;
}

ZT_HD uint32_t addc_cc(Carry& c, uint32_t a, uint32_t b) {
  uint32_t r;
#if defined(__CUDA_ARCH__)
  ZT_CC1("addc.cc.u32", r, a, b);
#else
  const uint64_t s = (uint64_t)a + b + c.cf;
  r = (uint32_t)s;
  c.cf = (uint32_t)(s >> 32);
#endif
  return r;
}

// reads the flag, leaves it
ZT_HD uint32_t addc(Carry& c, uint32_t a, uint32_t b) {
  uint32_t r;
#if defined(__CUDA_ARCH__)
  ZT_CC1("addc.u32", r, a, b);
#else
  r = a + b + c.cf;
#endif
  return r;
}

// the flag is the borrow
ZT_HD uint32_t sub_cc(Carry& c, uint32_t a, uint32_t b) {
  uint32_t r;
#if defined(__CUDA_ARCH__)
  ZT_CC1("sub.cc.u32", r, a, b);
#else
  r = a - b;
  c.cf = a < b;
#endif
  return r;
}

ZT_HD uint32_t subc_cc(Carry& c, uint32_t a, uint32_t b) {
  uint32_t r;
#if defined(__CUDA_ARCH__)
  ZT_CC1("subc.cc.u32", r, a, b);
#else
  const uint64_t bb = (uint64_t)b + c.cf;
  r = (uint32_t)((uint64_t)a - bb);
  c.cf = (uint64_t)a < bb;
#endif
  return r;
}

ZT_HD uint32_t subc(Carry& c, uint32_t a, uint32_t b) {
  uint32_t r;
#if defined(__CUDA_ARCH__)
  ZT_CC1("subc.u32", r, a, b);
#else
  r = a - b - c.cf;
#endif
  return r;
}

// lo(a b) + d, sets the flag
ZT_HD uint32_t mad_lo_cc(Carry& c, uint32_t a, uint32_t b, uint32_t d) {
  uint32_t r;
#if defined(__CUDA_ARCH__)
  ZT_CC2("mad.lo.cc.u32", r, a, b, d);
#else
  const uint64_t s = (uint64_t)(uint32_t)(a * b) + d;
  r = (uint32_t)s;
  c.cf = (uint32_t)(s >> 32);
#endif
  return r;
}

ZT_HD uint32_t madc_lo_cc(Carry& c, uint32_t a, uint32_t b, uint32_t d) {
  uint32_t r;
#if defined(__CUDA_ARCH__)
  ZT_CC2("madc.lo.cc.u32", r, a, b, d);
#else
  const uint64_t s = (uint64_t)(uint32_t)(a * b) + d + c.cf;
  r = (uint32_t)s;
  c.cf = (uint32_t)(s >> 32);
#endif
  return r;
}

ZT_HD uint32_t mad_hi_cc(Carry& c, uint32_t a, uint32_t b, uint32_t d) {
  uint32_t r;
#if defined(__CUDA_ARCH__)
  ZT_CC2("mad.hi.cc.u32", r, a, b, d);
#else
  const uint64_t s = (((uint64_t)a * b) >> 32) + d;
  r = (uint32_t)s;
  c.cf = (uint32_t)(s >> 32);
#endif
  return r;
}

ZT_HD uint32_t madc_hi_cc(Carry& c, uint32_t a, uint32_t b, uint32_t d) {
  uint32_t r;
#if defined(__CUDA_ARCH__)
  ZT_CC2("madc.hi.cc.u32", r, a, b, d);
#else
  const uint64_t s = (((uint64_t)a * b) >> 32) + d + c.cf;
  r = (uint32_t)s;
  c.cf = (uint32_t)(s >> 32);
#endif
  return r;
}

// reads the flag, leaves it
ZT_HD uint32_t madc_hi(Carry& c, uint32_t a, uint32_t b, uint32_t d) {
  uint32_t r;
#if defined(__CUDA_ARCH__)
  ZT_CC2("madc.hi.u32", r, a, b, d);
#else
  r = (uint32_t)((((uint64_t)a * b) >> 32) + d + c.cf);
#endif
  return r;
}

ZT_HD uint32_t mul_hi(uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
  return __umulhi(a, b);
#else
  return (uint32_t)(((uint64_t)a * b) >> 32);
#endif
}

// ---------------------------------------------------------------------------
// The lanes of a group of TPI threads.  On the device: the TPI neighbouring
// lanes of a warp (TPI divides 32, the block size is a multiple of 32).
// Under g++: host_check.cpp runs the ``width`` lanes of an emulated warp
// (one group, or 32 lanes) and installs zt_lane_emu: ``lane`` is this
// lane's index in the warp, and exchange() deposits its word and returns
// every lane's word of the same call; ``site``, the code address the
// exchange was made from, lets it check that the lanes run in step.  Under
// nvcc's host pass these paths are never taken.

#if !defined(__CUDACC__)
struct ZtLaneEmu {
  int lane = 0;
  int width = 1;
  void* ctx = nullptr;
  void (*exchange)(void* ctx, int lane, uint32_t v, uint32_t* all,
                   const void* site) = nullptr;
};
inline thread_local ZtLaneEmu zt_lane_emu;
#endif

// Uniform: every thread of the warp runs the same code path to the same
// shuffles and votes, and none has left (the caller's promise).  Then
// they name the whole warp and compile to plain SHFL / VOTE; otherwise
// they name the group, a mask ptxas cannot see is converged, and each
// takes a convergence region (BSSY, WARPSYNC.COLLECTIVE).
template <int TPI, bool Uniform = false>
struct Lanes {
  static_assert(TPI == 1 || TPI == 2 || TPI == 4 || TPI == 8, "TPI");
  static constexpr int kTpi = TPI;
  static constexpr uint32_t kBits = (1u << TPI) - 1;

  ZT_HD static int lane() {
    if constexpr (TPI == 1) return 0;
#if defined(__CUDA_ARCH__)
    return threadIdx.x & (TPI - 1);
#elif defined(__CUDACC__)
    return 0;
#else
    return zt_lane_emu.lane & (TPI - 1);
#endif
  }

  // this group's index in the warp
  ZT_HD static int group() {
#if defined(__CUDA_ARCH__)
    return (threadIdx.x & 31) / TPI;
#elif defined(__CUDACC__)
    return 0;
#else
    return zt_lane_emu.lane / TPI;
#endif
  }

#if defined(__CUDA_ARCH__)
  __device__ __forceinline__ static int base() {
    return threadIdx.x & 31 & ~(TPI - 1);
  }
  __device__ __forceinline__ static uint32_t mask() {
    return Uniform ? 0xffffffffu : kBits << base();
  }
#elif !defined(__CUDACC__)
  // out[i]: the word of lane i of the emulated warp, for i < width
  __attribute__((noinline)) static void exchange(uint32_t v, uint32_t* out) {
    zt_lane_emu.exchange(zt_lane_emu.ctx, zt_lane_emu.lane, v, out,
                         __builtin_return_address(0));
  }
  static int base() { return zt_lane_emu.lane & ~(TPI - 1); }
#endif

  // the word of lane src of the group
  ZT_HD static uint32_t shfl(uint32_t v, int src) {
    if constexpr (TPI == 1) return v;
#if defined(__CUDA_ARCH__)
    return __shfl_sync(mask(), v, src, TPI);
#elif defined(__CUDACC__)
    return v;
#else
    uint32_t w[32];
    exchange(v, w);
    return w[base() + src];
#endif
  }

  // the word of lane src of the warp (Uniform): from one group to another
  ZT_HD static uint32_t shfl_warp(uint32_t v, int src) {
    static_assert(Uniform, "a whole-warp shuffle needs the whole warp");
#if defined(__CUDA_ARCH__)
    return __shfl_sync(0xffffffffu, v, src);
#elif defined(__CUDACC__)
    return v;
#else
    uint32_t w[32];
    exchange(v, w);
    return w[src];
#endif
  }

  // the word of lane + 1; 0 on the top lane
  ZT_HD static uint32_t from_above(uint32_t v) {
    if constexpr (TPI == 1) return 0;
#if defined(__CUDA_ARCH__)
    const uint32_t w = __shfl_down_sync(mask(), v, 1, TPI);
    return lane() == TPI - 1 ? 0u : w;
#elif defined(__CUDACC__)
    return v;
#else
    uint32_t w[32];
    exchange(v, w);
    return lane() == TPI - 1 ? 0u : w[base() + lane() + 1];
#endif
  }

  // the word of lane - 1; 0 on lane 0
  ZT_HD static uint32_t from_below(uint32_t v) {
    if constexpr (TPI == 1) return 0;
#if defined(__CUDA_ARCH__)
    const uint32_t w = __shfl_up_sync(mask(), v, 1, TPI);
    return lane() == 0 ? 0u : w;
#elif defined(__CUDACC__)
    return v;
#else
    uint32_t w[32];
    exchange(v, w);
    return lane() == 0 ? 0u : w[base() + lane() - 1];
#endif
  }

  // bit l set where lane l's flag is set
  ZT_HD static uint32_t ballot(bool f) {
    if constexpr (TPI == 1) return f;
#if defined(__CUDA_ARCH__)
    return (__ballot_sync(mask(), f) >> base()) & kBits;
#elif defined(__CUDACC__)
    return f;
#else
    uint32_t w[32], bits = 0;
    exchange(f, w);
    for (int i = 0; i < TPI; ++i) bits |= (w[base() + i] != 0) << i;
    return bits;
#endif
  }

  // A vote of the warp (Uniform) or of the group: does any / every
  // thread's flag hold?  With one thread and no warp, its own flag.
  ZT_HD static bool any(bool f) {
    if constexpr (TPI == 1 && !Uniform) return f;
#if defined(__CUDA_ARCH__)
    if constexpr (Uniform) return __any_sync(0xffffffffu, f);
#elif !defined(__CUDACC__)
    if constexpr (Uniform) return warp_votes(f) != 0;
#endif
    return ballot(f) != 0;
  }
  ZT_HD static bool all(bool f) {
    if constexpr (TPI == 1 && !Uniform) return f;
#if defined(__CUDA_ARCH__)
    if constexpr (Uniform) return __all_sync(0xffffffffu, f);
#elif !defined(__CUDACC__)
    if constexpr (Uniform) return warp_votes(f) == zt_lane_emu.width;
#endif
    return ballot(f) == kBits;
  }
  // the largest v of the warp (Uniform): one trip count for a warp whose
  // groups loop over runs of different lengths (the bucket reduce)
  ZT_HD static uint32_t warp_max(uint32_t v) {
    static_assert(Uniform, "a warp-wide reduction needs the whole warp");
#if defined(__CUDA_ARCH__)
    return __reduce_max_sync(0xffffffffu, v);
#elif defined(__CUDACC__)
    return v;
#else
    uint32_t w[32];
    exchange(v, w);
    for (int i = 0; i < zt_lane_emu.width; ++i) v = w[i] > v ? w[i] : v;
    return v;
#endif
  }
#if !defined(__CUDACC__)
  // the number of lanes of the emulated warp whose flag holds
  static int warp_votes(bool f) {
    uint32_t w[32];
    exchange(f, w);
    int n = 0;
    for (int i = 0; i < zt_lane_emu.width; ++i) n += w[i] != 0;
    return n;
  }
#endif

  // Carries between lanes.  Each lane has added (or subtracted) its slice
  // and reports gen (a carry or borrow left its top word) and prop (its
  // slice would pass an incoming one on: all ones for a sum, all zeros for
  // a difference; never both).  In S = (P | G) + G a generating lane's bit
  // overflows into the next and runs through every propagating one, so the
  // carry into lane l is bit l of S ^ P and the carry out of the group is
  // bit TPI of S.  Returns the carry into this lane.
  ZT_HD static uint32_t resolve(bool gen, bool prop, uint32_t& out) {
    const uint32_t G = ballot(gen), P = ballot(prop);
    const uint32_t S = (P | G) + G;
    out = (S >> TPI) & 1u;
    return ((S ^ P) >> lane()) & 1u;
  }
};

// Word sources for lane_slice: the limbs of p and of R mod p, or an
// array (a kernel argument).
template <class M>
struct PLimbs {
  ZT_HD uint32_t operator()(int i) const { return M::p(i); }
};
template <class M>
struct OneLimbs {
  ZT_HD uint32_t operator()(int i) const { return M::one(i); }
};
struct Words {
  const uint32_t* w;
  ZT_HD uint32_t operator()(int i) const { return w[i]; }
};

// out[j] = v(lane L + j) for this lane, by selects (no runtime index)
template <class Lane, int L, class Src>
ZT_HD void lane_slice(uint32_t* out, const Src& v) {
  const int l = Lane::lane();
#pragma unroll
  for (int j = 0; j < L; ++j) {
    uint32_t w = v(j);
#pragma unroll
    for (int k = 1; k < Lane::kTpi; ++k) w = l == k ? v(k * L + j) : w;
    out[j] = w;
  }
}

// ---------------------------------------------------------------------------
// One thread per element (TPI = 1): the CIOS product on two accumulators.
// A (words at 0..N-1) and B (words at 1..N) hold T = A + 2^32 B.  A step
// adds a bi (even limbs of a into A, odd limbs into B: in each chain the lo
// and hi halves of neighbouring products tile disjoint words), then m p
// with m = A[0] (-p^-1) the same way, which zeroes A[0].  The shift by one
// word is a renaming: the next step's A is this B, plus A[1] at its word 0,
// and its B is A[2..N-1], rebuilt inside the next a bi chain.  Every
// partial sum stays below 2^(32(N+1)), so a carry out of word N is 0.

template <class M>
ZT_HD void mad_redc_step(uint32_t* A, uint32_t* B, const uint32_t* a,
                         uint32_t bi, bool first) {
  constexpr int N = M::N;
  Carry c;
  if (first) {
#pragma unroll
    for (int j = 0; j < N; j += 2) {
      A[j] = a[j] * bi;
      A[j + 1] = mul_hi(a[j], bi);
      B[j] = a[j + 1] * bi;
      B[j + 1] = mul_hi(a[j + 1], bi);
    }
  } else {
    // A <- B_prev + A_prev[1]; its carry enters B at word 1 (B[0])
    A[0] = add_cc(c, A[0], B[1]);
    // B <- A_prev >> 64 + (odd limbs of a) bi
#pragma unroll
    for (int j = 0; j < N - 2; j += 2) {
      B[j] = madc_lo_cc(c, a[j + 1], bi, B[j + 2]);
      B[j + 1] = madc_hi_cc(c, a[j + 1], bi, B[j + 3]);
    }
    B[N - 2] = madc_lo_cc(c, a[N - 1], bi, 0);
    B[N - 1] = madc_hi(c, a[N - 1], bi, 0);
    // A += (even limbs of a) bi; the carry out of word N-1 enters B[N-1]
    A[0] = mad_lo_cc(c, a[0], bi, A[0]);
    A[1] = madc_hi_cc(c, a[0], bi, A[1]);
#pragma unroll
    for (int j = 2; j < N; j += 2) {
      A[j] = madc_lo_cc(c, a[j], bi, A[j]);
      A[j + 1] = madc_hi_cc(c, a[j], bi, A[j + 1]);
    }
    B[N - 1] = addc(c, B[N - 1], 0);
  }
  const uint32_t m = A[0] * M::kPinv;
  B[0] = mad_lo_cc(c, m, M::p(1), B[0]);
  B[1] = madc_hi_cc(c, m, M::p(1), B[1]);
#pragma unroll
  for (int j = 2; j < N; j += 2) {
    B[j] = madc_lo_cc(c, m, M::p(j + 1), B[j]);
    B[j + 1] = madc_hi_cc(c, m, M::p(j + 1), B[j + 1]);
  }
  A[0] = mad_lo_cc(c, m, M::p(0), A[0]);
  A[1] = madc_hi_cc(c, m, M::p(0), A[1]);
#pragma unroll
  for (int j = 2; j < N; j += 2) {
    A[j] = madc_lo_cc(c, m, M::p(j), A[j]);
    A[j + 1] = madc_hi_cc(c, m, M::p(j), A[j + 1]);
  }
  B[N - 1] = addc(c, B[N - 1], 0);
}

// r = t - p if t >= p, else t (t < 2p), by the borrow of t - p
template <class M>
ZT_HD void final_sub1(uint32_t* r, const uint32_t* t) {
  constexpr int N = M::N;
  uint32_t d[N];
  Carry c;
  d[0] = sub_cc(c, t[0], M::p(0));
#pragma unroll
  for (int j = 1; j < N; ++j) d[j] = subc_cc(c, t[j], M::p(j));
  const uint32_t keep = subc(c, 0, 0);  // all ones where t < p
#pragma unroll
  for (int j = 0; j < N; ++j) r[j] = (t[j] & keep) | (d[j] & ~keep);
}

template <class M>
ZT_HD void mont_mul1(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  constexpr int N = M::N;
  static_assert(N % 2 == 0, "even limb count");
  uint32_t ev[N], od[N];
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    mad_redc_step<M>(ev, od, a, b[i], i == 0);
    mad_redc_step<M>(od, ev, a, b[i + 1], false);
  }
  // after the last step A = od (od[0] = 0), B = ev: T = ev + od >> 32
  uint32_t t[N];
  Carry c;
  t[0] = add_cc(c, ev[0], od[1]);
#pragma unroll
  for (int j = 1; j < N - 1; ++j) t[j] = addc_cc(c, ev[j], od[j + 1]);
  t[N - 1] = addc(c, ev[N - 1], 0);
  final_sub1<M>(r, t);
}

// ---------------------------------------------------------------------------
// A group of TPI > 1 lanes: the CIOS product on slices, in TPI blocks of L
// steps.  Lane l keeps a window w of 2L + 1 words: w[0, L) are T's words
// [l L, (l + 1) L) above the block's base, w[L, 2L] words the lane has
// carried above them, pending for the lanes above.  Step k of a block adds
// a_l bi and p_l m at w[k]; m comes from lane 0's w[k] (no other lane adds
// below it), so one shuffle per step is on the dependent path.  At the end
// of a block the base rises by L words: each lane takes the next lane's
// w[0, L) into its w[L, 2L), in L independent shuffles.

// w[0, L + 2) += x y (x: L words of this lane, y: one word): the even
// limbs of x on one chain, then the odd ones, each product's lo and hi
// halves side by side (ptxas pairs them into one wide multiply-add)
template <int L>
ZT_HD void mac_at(uint32_t* w, const uint32_t* x, uint32_t y) {
  Carry c;
  w[0] = mad_lo_cc(c, x[0], y, w[0]);
  w[1] = madc_hi_cc(c, x[0], y, w[1]);
#pragma unroll
  for (int j = 2; j < L; j += 2) {
    w[j] = madc_lo_cc(c, x[j], y, w[j]);
    w[j + 1] = madc_hi_cc(c, x[j], y, w[j + 1]);
  }
  if constexpr (L % 2 == 0) w[L] = addc_cc(c, w[L], 0);
  w[L + 1] = addc(c, w[L + 1], 0);
  w[1] = mad_lo_cc(c, x[1], y, w[1]);
  w[2] = madc_hi_cc(c, x[1], y, w[2]);
#pragma unroll
  for (int j = 3; j < L; j += 2) {
    w[j] = madc_lo_cc(c, x[j], y, w[j]);
    w[j + 1] = madc_hi_cc(c, x[j], y, w[j + 1]);
  }
  if constexpr (L % 2 == 1) w[L] = addc_cc(c, w[L], 0);
  w[L + 1] = addc(c, w[L + 1], 0);
}

template <int L>
ZT_HD bool slice_all(const uint32_t* t, uint32_t v) {
  bool r = true;
#pragma unroll
  for (int j = 0; j < L; ++j) r = r && t[j] == v;
  return r;
}

// r = t - p if the group's t >= p, else t (t < 2p); p: this lane's slice
template <class Lane, int L>
ZT_HD void final_sub_lanes(uint32_t* r, const uint32_t* t,
                           const uint32_t* p) {
  uint32_t d[L];
  Carry c;
  d[0] = sub_cc(c, t[0], p[0]);
#pragma unroll
  for (int j = 1; j < L; ++j) d[j] = subc_cc(c, t[j], p[j]);
  const uint32_t gen = subc(c, 0, 0) & 1u;
  uint32_t lt;
  const uint32_t bin =
      Lane::resolve(gen, slice_all<L>(d, 0u), lt);
  d[0] = sub_cc(c, d[0], bin);
#pragma unroll
  for (int j = 1; j < L; ++j) d[j] = subc_cc(c, d[j], 0);
  const uint32_t keep = 0u - lt;  // all ones where t < p
#pragma unroll
  for (int j = 0; j < L; ++j) r[j] = (t[j] & keep) | (d[j] & ~keep);
}

template <class M, class Lane>
ZT_HD void mont_mul_lanes(uint32_t* r, const uint32_t* a, const uint32_t* b,
                          const uint32_t* p) {
  constexpr int TPI = Lane::kTpi, N = M::N, L = N / TPI;
  static_assert(L >= 3, "at least three words a lane");
  uint32_t w[2 * L + 1];
#pragma unroll
  for (int j = 0; j < 2 * L + 1; ++j) w[j] = 0;
#pragma unroll
  for (int blk = 0; blk < TPI; ++blk) {
#pragma unroll
    for (int k = 0; k < L; ++k) {
      // step blk L + k: b's word of that index lives in lane blk
      mac_at<L>(w + k, a, Lane::shfl(b[k], blk));
      const uint32_t m = Lane::shfl(w[k] * M::kPinv, 0);
      mac_at<L>(w + k, p, m);
    }
    // the base rises by L words; lane 0's w[0, L) is zero and drops out
    uint32_t up[L];
#pragma unroll
    for (int j = 0; j < L; ++j) up[j] = Lane::from_above(w[j]);
    Carry c;
    w[0] = add_cc(c, w[L], up[0]);
#pragma unroll
    for (int j = 1; j < L; ++j) w[j] = addc_cc(c, w[L + j], up[j]);
    w[L] = addc(c, w[2 * L], 0);
#pragma unroll
    for (int j = L + 1; j < 2 * L + 1; ++j) w[j] = 0;
  }
  // the word each lane carried past its top goes up once (the top lane's
  // is 0: T < 2p < 2^(32N)); then the 0/1 carries ripple through the masks
  const uint32_t u = Lane::from_below(w[L]);
  Carry c;
  w[0] = add_cc(c, w[0], u);
#pragma unroll
  for (int j = 1; j < L; ++j) w[j] = addc_cc(c, w[j], 0);
  const uint32_t gen = addc(c, 0, 0);
  uint32_t out;
  const uint32_t cin =
      Lane::resolve(gen, slice_all<L>(w, 0xffffffffu), out);
  w[0] = add_cc(c, w[0], cin);
#pragma unroll
  for (int j = 1; j < L; ++j) w[j] = addc_cc(c, w[j], 0);
  final_sub_lanes<Lane, L>(r, w, p);
}

// ---------------------------------------------------------------------------
// The field type for the group law (curve.cuh), over modulus M with TPI
// lanes per element.  W = L words of an element live in each thread; in
// memory a coordinate is N words, and load/store move this lane's slice.

template <class M, int TPI, bool Uniform = false>
struct FqF {
  static constexpr int NB = M::N;       // limbs of the prime field
  static constexpr int L = NB / TPI;    // limbs a lane holds
  static constexpr int W = L;           // words of an element in a thread
  static constexpr int ROW = NB;        // words of a coordinate in memory
  static constexpr int kTpi = TPI;
  static constexpr bool kUniform = Uniform;
  static_assert(NB % TPI == 0, "TPI divides N");
  using B3 = int;
  using B3Arg = int;
  using Lane = Lanes<TPI, Uniform>;
  using Base = FqF;
  // base products of one product (mul_side_by_side)
  static constexpr int kParts = 1;
  // this lane's slice of p (TPI > 1; with one lane p is all immediates)
  struct Params {
    uint32_t p[TPI > 1 ? L : 1];
  };

  ZT_HD static Params params() {
    Params F;
    if constexpr (TPI > 1)
      lane_slice<Lane, L>(F.p, PLimbs<M>{});
    else
      F.p[0] = M::p(0);
    return F;
  }
  ZT_HD static B3 b3_lane(B3Arg b3) { return b3; }
  ZT_HD static bool any(bool f) { return Lane::any(f); }
  ZT_HD static bool all(bool f) { return Lane::all(f); }
  // word j of this lane's slice of p
  ZT_HD static uint32_t pw(const Params& F, int j) {
    if constexpr (TPI > 1)
      return F.p[j];
    else
      return M::p(j);
  }

  // this lane's slice of coordinate k of a row
  ZT_HD static void load(uint32_t* r, const uint32_t* row, int k) {
    load_slice(r, row + k * ROW);
  }
  ZT_HD static void store(uint32_t* row, const uint32_t* a, int k) {
    store_slice(row + k * ROW, a);
  }
  // L words at coord + lane L, in 16- or 8-byte pieces where they align
  ZT_HD static void load_slice(uint32_t* r, const uint32_t* coord) {
    const uint32_t* s = coord + Lane::lane() * L;
#if defined(__CUDA_ARCH__)
    if constexpr (L % 4 == 0) {
#pragma unroll
      for (int j = 0; j < L; j += 4) {
        const uint4 v = *reinterpret_cast<const uint4*>(s + j);
        r[j] = v.x, r[j + 1] = v.y, r[j + 2] = v.z, r[j + 3] = v.w;
      }
      return;
    } else if constexpr (L % 2 == 0) {
#pragma unroll
      for (int j = 0; j < L; j += 2) {
        const uint2 v = *reinterpret_cast<const uint2*>(s + j);
        r[j] = v.x, r[j + 1] = v.y;
      }
      return;
    }
#endif
#pragma unroll
    for (int j = 0; j < L; ++j) r[j] = s[j];
  }
  ZT_HD static void store_slice(uint32_t* coord, const uint32_t* a) {
    uint32_t* s = coord + Lane::lane() * L;
#if defined(__CUDA_ARCH__)
    if constexpr (L % 4 == 0) {
#pragma unroll
      for (int j = 0; j < L; j += 4)
        *reinterpret_cast<uint4*>(s + j) =
            make_uint4(a[j], a[j + 1], a[j + 2], a[j + 3]);
      return;
    } else if constexpr (L % 2 == 0) {
#pragma unroll
      for (int j = 0; j < L; j += 2)
        *reinterpret_cast<uint2*>(s + j) = make_uint2(a[j], a[j + 1]);
      return;
    }
#endif
#pragma unroll
    for (int j = 0; j < L; ++j) s[j] = a[j];
  }

  ZT_HD static void copy(uint32_t* r, const uint32_t* a) {
#pragma unroll
    for (int j = 0; j < L; ++j) r[j] = a[j];
  }
  ZT_HD static void zero(uint32_t* r) {
#pragma unroll
    for (int j = 0; j < L; ++j) r[j] = 0;
  }
  ZT_HD static void one(uint32_t* r, const Params&) {
    lane_slice<Lane, L>(r, OneLimbs<M>{});
  }
  // a vote of the group: every lane gets the same answer
  ZT_HD static bool is_zero(const uint32_t* a) {
    uint32_t acc = 0;
#pragma unroll
    for (int j = 0; j < L; ++j) acc |= a[j];
    return Lane::ballot(acc != 0) == 0;
  }

  // r = a + b mod p
  ZT_HD static void add(uint32_t* r, const uint32_t* a, const uint32_t* b,
                        const Params& F) {
    uint32_t s[L];
    Carry c;
    s[0] = add_cc(c, a[0], b[0]);
#pragma unroll
    for (int j = 1; j < L; ++j) s[j] = addc_cc(c, a[j], b[j]);
    if constexpr (TPI > 1) {
      const uint32_t gen = addc(c, 0, 0);
      uint32_t out;  // 0: a + b < 2p < 2^(32N)
      const uint32_t cin =
          Lane::resolve(gen, slice_all<L>(s, 0xffffffffu), out);
      s[0] = add_cc(c, s[0], cin);
#pragma unroll
      for (int j = 1; j < L; ++j) s[j] = addc_cc(c, s[j], 0);
      final_sub_lanes<Lane, L>(r, s, F.p);
    } else {
      final_sub1<M>(r, s);
    }
  }

  // r = a - b mod p: the difference, plus p where it borrowed
  ZT_HD static void sub(uint32_t* r, const uint32_t* a, const uint32_t* b,
                        const Params& F) {
    uint32_t d[L], pm[L];
    Carry c;
    d[0] = sub_cc(c, a[0], b[0]);
#pragma unroll
    for (int j = 1; j < L; ++j) d[j] = subc_cc(c, a[j], b[j]);
    uint32_t under = subc(c, 0, 0) & 1u;
    if constexpr (TPI > 1) {
      const uint32_t gen = under;
      const uint32_t bin =
          Lane::resolve(gen, slice_all<L>(d, 0u), under);
      d[0] = sub_cc(c, d[0], bin);
#pragma unroll
      for (int j = 1; j < L; ++j) d[j] = subc_cc(c, d[j], 0);
    }
    const uint32_t mask = 0u - under;
#pragma unroll
    for (int j = 0; j < L; ++j)
      pm[j] = pw(F, j) & mask;
    r[0] = add_cc(c, d[0], pm[0]);
#pragma unroll
    for (int j = 1; j < L; ++j) r[j] = addc_cc(c, d[j], pm[j]);
    if constexpr (TPI > 1) {
      // the carry out of the group is the 2^(32N) that the borrow lent
      const uint32_t gen = addc(c, 0, 0);
      uint32_t out;
      const uint32_t cin =
          Lane::resolve(gen, slice_all<L>(r, 0xffffffffu), out);
      r[0] = add_cc(c, r[0], cin);
#pragma unroll
      for (int j = 1; j < L; ++j) r[j] = addc_cc(c, r[j], 0);
    }
  }

  // r = -a mod p (0 stays 0)
  ZT_HD static void neg(uint32_t* r, const uint32_t* a, const Params& F) {
    uint32_t pp[L];
#pragma unroll
    for (int j = 0; j < L; ++j) pp[j] = pw(F, j);
    const uint32_t keep = is_zero(a) ? 0u : ~0u;
    sub(r, pp, a, F);  // p - a: no borrow for a <= p
#pragma unroll
    for (int j = 0; j < L; ++j) r[j] &= keep;
  }

  ZT_HD static void mul(uint32_t* r, const uint32_t* a,
                            const uint32_t* b, const Params& F) {
    if constexpr (TPI > 1)
      mont_mul_lanes<M, Lane>(r, a, b, F.p);
    else
      mont_mul1<M>(r, a, b);
  }

  // r = k a for a small integer k: double-and-add, then a negation for
  // k < 0.  k is the same in every lane, so the branches are the group's.
  ZT_HD static void mul_small(uint32_t* r, const uint32_t* a, int k,
                              const Params& F) {
    uint32_t acc[L];
    copy(acc, a);
    const unsigned mag = k < 0 ? (unsigned)(-k) : (unsigned)k;
    int top = 31;
    while (top > 0 && !((mag >> top) & 1u)) --top;
    for (int bit = top - 1; bit >= 0; --bit) {
      add(acc, acc, acc, F);
      if ((mag >> bit) & 1u) add(acc, acc, a, F);
    }
    if (k < 0)
      neg(r, acc, F);
    else
      copy(r, acc);
  }
  ZT_HD static void mul_b3(uint32_t* r, const uint32_t* a, B3 b3,
                           const Params& F) {
    mul_small(r, a, b3, F);
  }

  // mul_side_by_side: the operands of base product j of a b, and r from
  // the base products t (here one product, a b itself)
  ZT_HD static void part(uint32_t* x, uint32_t* y, const uint32_t* a,
                         const uint32_t* b, int, const Params&) {
    copy(x, a);
    copy(y, b);
  }
  ZT_HD static void join(uint32_t* r, const uint32_t (*t)[L],
                         const Params&) {
    copy(r, t[0]);
  }
};

// Fq2 = Fq[u] / (u^2 - nr) over the BLS12-377 base field, nr = -5, as
// field2.cuh's Fq2 (Karatsuba, three base products) on the fast core.  In
// memory a coordinate is c0 | c1 (2 x 12 words); a lane holds its slice of
// c0 in words [0, L) and of c1 in [L, 2L).
template <int TPI, bool Uniform = false>
struct Fq2F {
  using Base = FqF<Bls377Fq, TPI, Uniform>;
  static constexpr int NB = 12;
  static constexpr int L = Base::L;
  static constexpr int W = 2 * L;
  static constexpr int ROW = 2 * NB;
  static constexpr int kTpi = TPI;
  static constexpr bool kUniform = Uniform;
  static constexpr int kNr = -5;
  using Params = typename Base::Params;
  using Lane = Lanes<TPI, Uniform>;
  static constexpr int kParts = 3;
  // b3 of the D-twist: this lane's slice; the launcher passes all of it
  struct B3 {
    uint32_t c[W];
  };
  struct B3Arg {
    uint32_t c[ROW];
  };

  ZT_HD static Params params() { return Base::params(); }
  ZT_HD static bool any(bool f) { return Lane::any(f); }
  ZT_HD static bool all(bool f) { return Lane::all(f); }
  ZT_HD static B3 b3_lane(const B3Arg& b3) {
    B3 r;
    lane_slice<Lane, L>(r.c, Words{b3.c});
    lane_slice<Lane, L>(r.c + L, Words{b3.c + NB});
    return r;
  }

  ZT_HD static void load(uint32_t* r, const uint32_t* row, int k) {
    Base::load_slice(r, row + k * ROW);
    Base::load_slice(r + L, row + k * ROW + NB);
  }
  ZT_HD static void store(uint32_t* row, const uint32_t* a, int k) {
    Base::store_slice(row + k * ROW, a);
    Base::store_slice(row + k * ROW + NB, a + L);
  }
  ZT_HD static void copy(uint32_t* r, const uint32_t* a) {
#pragma unroll
    for (int j = 0; j < W; ++j) r[j] = a[j];
  }
  ZT_HD static void zero(uint32_t* r) {
#pragma unroll
    for (int j = 0; j < W; ++j) r[j] = 0;
  }
  ZT_HD static void one(uint32_t* r, const Params& F) {
    Base::one(r, F);
    Base::zero(r + L);
  }
  ZT_HD static bool is_zero(const uint32_t* a) {
    uint32_t acc = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) acc |= a[j];
    return Lane::ballot(acc != 0) == 0;
  }
  ZT_HD static void add(uint32_t* r, const uint32_t* a, const uint32_t* b,
                        const Params& F) {
    Base::add(r, a, b, F);
    Base::add(r + L, a + L, b + L, F);
  }
  ZT_HD static void sub(uint32_t* r, const uint32_t* a, const uint32_t* b,
                        const Params& F) {
    Base::sub(r, a, b, F);
    Base::sub(r + L, a + L, b + L, F);
  }
  ZT_HD static void neg(uint32_t* r, const uint32_t* a, const Params& F) {
    Base::neg(r, a, F);
    Base::neg(r + L, a + L, F);
  }
  // Karatsuba: c1 = (a0 + a1)(b0 + b1) - a0 b0 - a1 b1, c0 = a0 b0 + nr a1
  // b1.  r may alias a or b: it is written after the last read.
  ZT_HD static void mul(uint32_t* r, const uint32_t* a,
                            const uint32_t* b, const Params& F) {
    uint32_t t0[L], t1[L], s[L], u[L];
    Base::mul(t0, a, b, F);
    Base::mul(t1, a + L, b + L, F);
    Base::add(s, a, a + L, F);
    Base::add(u, b, b + L, F);
    Base::mul(s, s, u, F);
    Base::sub(s, s, t0, F);
    Base::sub(r + L, s, t1, F);
    Base::mul_small(t1, t1, kNr, F);
    Base::add(r, t0, t1, F);
  }
  ZT_HD static void mul_b3(uint32_t* r, const uint32_t* a, const B3& b3,
                           const Params& F) {
    mul(r, a, b3.c, F);
  }

  // mul_side_by_side: Karatsuba's three base products of a b (a0 b0, a1
  // b1, (a0 + a1)(b0 + b1)) and the product from them, the values of mul
  ZT_HD static void part(uint32_t* x, uint32_t* y, const uint32_t* a,
                         const uint32_t* b, int j, const Params& F) {
    if (j == 2) {
      Base::add(x, a, a + L, F);
      Base::add(y, b, b + L, F);
    } else {
      Base::copy(x, a + j * L);
      Base::copy(y, b + j * L);
    }
  }
  ZT_HD static void join(uint32_t* r, const uint32_t (*t)[L],
                         const Params& F) {
    uint32_t s[L], u[L];
    Base::sub(s, t[2], t[0], F);
    Base::sub(r + L, s, t[1], F);
    Base::mul_small(u, t[1], kNr, F);
    Base::add(r, t[0], u, F);
  }
};

// ---------------------------------------------------------------------------
// Products side by side: r[i] = a[i] b[i] for i < P over the field type Fld
// (FqF or Fq2F, Uniform), where every lane of the warp holds its slice of
// the same operands (one point a warp).  The P products are Q = P kParts
// base products; the warp's G = 32 / TPI groups take them G at a time:
// in round s group g computes base product s G + g (the groups past Q
// repeat the round's first), its operands picked by selects on g, so that
// the warp runs one instruction stream and every shuffle names it whole.
// Then lane l of every group takes each result of the round from lane l
// of the group that computed it, one whole-warp shuffle per word, and
// every group forms the P products from them.  A single base product
// (Q = 1) is computed by every group and needs no shuffle.  r may alias a
// or b: it is written after the last read.
template <class Fld, int P>
ZT_HD void mul_side_by_side(uint32_t* const* r, const uint32_t* const* a,
                            const uint32_t* const* b,
                            const typename Fld::Params& F) {
  using Base = typename Fld::Base;
  using Lane = typename Fld::Lane;
  constexpr int L = Base::L, K = Fld::kParts, Q = P * K;
  constexpr int TPI = Fld::kTpi, G = 32 / TPI;
  static_assert(Fld::kUniform, "products side by side need the whole warp");
  if constexpr (Q == 1) {
    Fld::mul(r[0], a[0], b[0], F);
    return;
  }
  uint32_t x[Q][L], y[Q][L], t[Q][L];
#pragma unroll
  for (int q = 0; q < Q; ++q)
    Fld::part(x[q], y[q], a[q / K], b[q / K], q % K, F);
  const int g = Lane::group(), l = Lane::lane();
#pragma unroll
  for (int s = 0; s < Q; s += G) {
    uint32_t u[L], v[L], w[L];
#pragma unroll
    for (int j = 0; j < L; ++j) {
      u[j] = x[s][j];
      v[j] = y[s][j];
#pragma unroll
      for (int q = s + 1; q < s + G && q < Q; ++q) {
        u[j] = g == q - s ? x[q][j] : u[j];
        v[j] = g == q - s ? y[q][j] : v[j];
      }
    }
    Base::mul(w, u, v, F);
#pragma unroll
    for (int q = s; q < s + G && q < Q; ++q)
#pragma unroll
      for (int j = 0; j < L; ++j)
        t[q][j] = Lane::shfl_warp(w[j], (q - s) * TPI + l);
  }
#pragma unroll
  for (int i = 0; i < P; ++i) Fld::join(r[i], t + i * K, F);
}
