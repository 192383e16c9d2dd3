// CPU build of the device math in field.cuh, field2.cuh, field_fast.cuh
// and curve.cuh (g++), so the tests can hold the exact functions the CUDA
// kernels run against the plain PyTorch versions on a machine without a
// GPU.
//
// ``form`` picks the field type as the kernel builds do: 12 or 24 is
// Fq<12> / Fq<24> (or FqF over BLS12-377 / BW6-761 Fq), 2 is Fq2 over 12
// limbs (or Fq2F).  ``b3`` points to the kernel's b3 bytes (an int32 over
// Fq, 2 x 12 Montgomery limbs over Fq2).  The fast core's entries take
// ``tpi`` too: with TPI > 1 the TPI lanes of a group, and for K1, K3, K5
// and K6 over lanes the 32 lanes of a warp, run as coroutines of one
// thread that exchange words in the order a warp's shuffles and ballots
// would.  The entries over field.cuh's types (zt_cpu_fp_mul, zt_cpu_jac)
// test the older field code, which no kernel runs.
#include <string.h>
#include <ucontext.h>

#include <type_traits>
#include <vector>

#include "field_fast.cuh"
#include "curve.cuh"

namespace {

template <class Fld>
void mul_batch(uint32_t* r, const uint32_t* a, const uint32_t* b, long n,
               const typename Fld::Params& F) {
  for (long i = 0; i < n; ++i)
    Fld::mul(r + i * Fld::W, a + i * Fld::W, b + i * Fld::W, F);
}

// op 0: out = p + q (K4's law); op 1: out = 2^k p (K5's)
template <class Fld>
void jac_batch(int op, const uint32_t* a, const uint32_t* b, uint32_t* out,
               long n, int k, const typename Fld::Params& F) {
  constexpr int W = Fld::W;
  for (long i = 0; i < n; ++i) {
    Jac<Fld> p, q;
    proj_load<Fld>(p, a + (size_t)i * 3 * W);
    if (op == 0) {
      proj_load<Fld>(q, b + (size_t)i * 3 * W);
      jac_add<Fld>(p, p, q, F);
    } else {
      for (int j = 0; j < k; ++j) jac_dbl<Fld>(p, p, F);
    }
    proj_store<Fld>(out + (size_t)i * 3 * W, p);
  }
}

// The constants of field.cuh's types, as the tests pass them: host
// pointers to the base prime and R mod p, and -p^-1 mod 2^32
template <class Fld>
typename Fld::Params field_params(const void* p, const void* one,
                                  unsigned pinv) {
  typename Fld::Params F;
  const uint32_t* P = static_cast<const uint32_t*>(p);
  const uint32_t* O = static_cast<const uint32_t*>(one);
  for (int i = 0; i < Fld::NB; ++i) {
    F.p[i] = P[i];
    F.one[i] = O[i];
  }
  F.pinv = pinv;
  return F;
}

// Calls fn.template operator()<Fld>() for the field type of ``form``.
template <class Fn>
int dispatch(int form, Fn&& fn) {
  if (form == 12) return fn(static_cast<Fq<12>*>(nullptr)), 0;
  if (form == 24) return fn(static_cast<Fq<24>*>(nullptr)), 0;
  if (form == 2) return fn(static_cast<Fq2*>(nullptr)), 0;
  return 1;
}


// -- the fast core ---------------------------------------------------------

// The lanes of one emulated warp as coroutines of this thread.  The
// scheduler resumes them in turn; each runs to its next exchange, deposits
// its word and yields, so a lane resumed has every lane's word of its
// exchange.  Two banks of slots, used in turn, keep the words of one
// exchange until the last lane has read them: lane 0 deposits its next
// word while lanes above it have still to read.  Every lane must make the
// same exchanges (the kernels run one path a warp, and a shuffle or vote
// that names the whole warp hangs or reads garbage on the card where one
// does not): each exchange checks that every lane is at it, made from the
// same code address, and a lane out of step sets lanes_diverged, which the
// entries below report.
thread_local bool lanes_diverged = false;

struct LaneSet {
  static constexpr size_t kStack = 256 << 10;
  int width;
  uint32_t slots[2][32] = {};
  const void* sites[2][32] = {};
  unsigned calls[32] = {};
  bool done[32] = {};
  ucontext_t sched, ctx[32];
  void (*call)(void*) = nullptr;
  void* body = nullptr;

  static void exchange(void* c, int lane, uint32_t v, uint32_t* all,
                       const void* site) {
    LaneSet& S = *static_cast<LaneSet*>(c);
    const unsigned k = ++S.calls[lane];
    uint32_t* slot = S.slots[k & 1];
    slot[lane] = v;
    S.sites[k & 1][lane] = site;
    swapcontext(&S.ctx[lane], &S.sched);
    // lanes resumed before this one have gone on to their next exchange
    // or ended; the others wait at this one
    for (int i = 0; i < S.width; ++i) {
      const bool at = i < lane ? S.calls[i] == k + 1 ||
                                     (S.calls[i] == k && S.done[i])
                               : S.calls[i] == k && !S.done[i];
      lanes_diverged |= !at || S.sites[k & 1][i] != site;
      all[i] = slot[i];
    }
  }

  static void entry() {
    LaneSet& S = *static_cast<LaneSet*>(zt_lane_emu.ctx);
    const int lane = zt_lane_emu.lane;
    S.call(S.body);
    S.done[lane] = true;
  }
};

// the one lane of a width-1 warp
void exchange_alone(void*, int, uint32_t v, uint32_t* all, const void*) {
  all[0] = v;
}

// body() once per lane of a warp of ``width`` lanes (1, TPI or 32)
template <class Fn>
void run_lanes(int width, Fn body) {
  if (width == 1) {
    zt_lane_emu = ZtLaneEmu{0, 1, nullptr, &exchange_alone};
    body();
    return;
  }
  LaneSet S;
  S.width = width;
  S.body = &body;
  S.call = [](void* f) { (*static_cast<Fn*>(f))(); };
  std::vector<char> stacks((size_t)width * LaneSet::kStack);
  for (int l = 0; l < width; ++l) {
    getcontext(&S.ctx[l]);
    S.ctx[l].uc_stack.ss_sp = stacks.data() + (size_t)l * LaneSet::kStack;
    S.ctx[l].uc_stack.ss_size = LaneSet::kStack;
    S.ctx[l].uc_link = &S.sched;
    makecontext(&S.ctx[l], &LaneSet::entry, 0);
  }
  for (int live = width; live > 0;) {
    live = 0;
    for (int l = 0; l < width; ++l) {
      if (S.done[l]) continue;
      zt_lane_emu = ZtLaneEmu{l, width, &S, &LaneSet::exchange};
      swapcontext(&S.sched, &S.ctx[l]);
      live += !S.done[l];
    }
  }
  for (int l = 1; l < width; ++l)
    lanes_diverged |= S.calls[l] != S.calls[0];
}

// op 0: r = a b, 1: a + b, 2: a - b, 3: -a; rows of Fld::ROW words
template <class Fld>
void fast_field_batch(int op, uint32_t* r, const uint32_t* a,
                      const uint32_t* b, long n) {
  run_lanes(Fld::kTpi, [&] {
    const typename Fld::Params F = Fld::params();
    for (long i = 0; i < n; ++i) {
      uint32_t x[Fld::W], y[Fld::W], z[Fld::W];
      Fld::load(x, a, (int)i);
      Fld::load(y, b, (int)i);
      if (op == 0) Fld::mul(z, x, y, F);
      if (op == 1) Fld::add(z, x, y, F);
      if (op == 2) Fld::sub(z, x, y, F);
      if (op == 3) Fld::neg(z, x, F);
      Fld::store(r, z, (int)i);
    }
  });
}

// kind 0: out = p + q (K2, complete projective), 1: out = p + q (K4,
// Jacobian)
template <class Fld>
void fast_add_batch(int kind, const uint32_t* pp, const uint32_t* q,
                    uint32_t* out, long n, const void* b3) {
  typename Fld::B3Arg b3v{};
  if (kind == 0) memcpy(&b3v, b3, sizeof(b3v));
  run_lanes(Fld::kTpi, [&] {
    const typename Fld::Params F = Fld::params();
    const typename Fld::B3 B = Fld::b3_lane(b3v);
    for (long i = 0; i < n; ++i) {
      const size_t row = (size_t)i * 3 * Fld::ROW;
      Proj<Fld> a, b;
      proj_load<Fld>(a, pp + row);
      proj_load<Fld>(b, q + row);
      if (kind == 0)
        proj_add<Fld>(a, a, b, B, F);
      else
        jac_add<Fld>(a, a, b, F);
      proj_store<Fld>(out + row, a);
    }
  });
}

// kind 0: out = 2^k p (K3, complete projective), 1: out = 2^k p (K5,
// Jacobian), a warp of 32 lanes a point with the products of each step
// side by side
template <class Fld>
void fast_dbl_batch(int kind, const uint32_t* pp, uint32_t* out, long n,
                    int k, const void* b3) {
  typename Fld::B3Arg b3v{};
  if (kind == 0) memcpy(&b3v, b3, sizeof(b3v));
  run_lanes(32, [&] {
    const typename Fld::Params F = Fld::params();
    const typename Fld::B3 B = Fld::b3_lane(b3v);
    for (long i = 0; i < n; ++i) {
      const size_t row = (size_t)i * 3 * Fld::ROW;
      Proj<Fld> a;
      proj_load<Fld>(a, pp + row);
      for (int j = 0; j < k; ++j) {
        if (kind == 0)
          proj_dbl_side<Fld>(a, a, B, F);
        else
          jac_dbl_side<Fld>(a, a, F);
      }
      if (Fld::Lane::group() == 0) proj_store<Fld>(out + row, a);
    }
  });
}

// K1 over the fast core, as fast_kernels.cu builds it (Uniform): the
// segments in warps of 32 / TPI groups, each warp's 32 lanes run together
template <class Fld>
void fast_reduce_batch(int affine, const uint32_t* pts, const int32_t* ent,
                       const int32_t* seg, int nseg, uint32_t* out,
                       const void* b3) {
  typename Fld::B3Arg b3v;
  memcpy(&b3v, b3, sizeof(b3v));
  constexpr int G = 32 / Fld::kTpi;
  const long long warps = (nseg + G - 1) / G;
  run_lanes(32, [&] {
    const typename Fld::Params F = Fld::params();
    const typename Fld::B3 B = Fld::b3_lane(b3v);
    for (long long w = 0; w < warps; ++w) {
      const long long s = w * G + Fld::Lane::group();
      if (affine)
        reduce_segment<Fld, true>(out, pts, ent, seg, nseg, s, B, F);
      else
        reduce_segment<Fld, false>(out, pts, ent, seg, nseg, s, B, F);
    }
  });
}

// K6 over the fast core, as fast_kernels.cu builds it: over lanes a warp
// of 32 / TPI points at a time (Uniform, the tail repeating the last
// point), at one thread a point alone (branches)
template <class Fld>
void fast_aff_batch(const uint32_t* a, const uint8_t* ainf, const uint32_t* b,
                    const uint8_t* binf, uint32_t* out, long n) {
  constexpr int W = Fld::W, G = Fld::kUniform ? 32 / Fld::kTpi : 1;
  run_lanes(G * Fld::kTpi, [&] {
    const typename Fld::Params F = Fld::params();
    for (long w = 0; w < (n + G - 1) / G; ++w) {
      const long g = w * G + (G > 1 ? Fld::Lane::group() : 0);
      const long i = g < n ? g : n - 1;
      const size_t row = (size_t)i * 2 * Fld::ROW;
      uint32_t x1[W], y1[W], x2[W], y2[W];
      Fld::load(x1, a + row, 0);
      Fld::load(y1, a + row, 1);
      Fld::load(x2, b + row, 0);
      Fld::load(y2, b + row, 1);
      Jac<Fld> r;
      aff_add<Fld>(r, x1, y1, ainf[i] != 0, x2, y2, binf[i] != 0, F);
      if (g < n) proj_store<Fld>(out + (size_t)i * 3 * Fld::ROW, r);
    }
  });
}

// Calls fn.template operator()<Fld>() for the fast field type of (form,
// tpi), with the kernels' vote span: warp-wide (Uniform) for K2 and for K4
// over lanes, as fast_kernels.cu builds them; a group here is the warp.
template <bool U, class Fn>
int dispatch_fast_u(int form, int tpi, Fn&& fn) {
  auto go = [&](auto* tag) { return fn(tag), 0; };
  if (form == 12 && tpi == 1) return go((FqF<Bls377Fq, 1, U>*)nullptr);
  if (form == 12 && tpi == 2) return go((FqF<Bls377Fq, 2, U>*)nullptr);
  if (form == 12 && tpi == 4) return go((FqF<Bls377Fq, 4, U>*)nullptr);
  if (form == 24 && tpi == 1) return go((FqF<Bw6Fq, 1, U>*)nullptr);
  if (form == 24 && tpi == 2) return go((FqF<Bw6Fq, 2, U>*)nullptr);
  if (form == 24 && tpi == 4) return go((FqF<Bw6Fq, 4, U>*)nullptr);
  if (form == 24 && tpi == 8) return go((FqF<Bw6Fq, 8, U>*)nullptr);
  if (form == 2 && tpi == 1) return go((Fq2F<1, U>*)nullptr);
  if (form == 2 && tpi == 2) return go((Fq2F<2, U>*)nullptr);
  if (form == 2 && tpi == 4) return go((Fq2F<4, U>*)nullptr);
  return 1;
}

// rc of a fast-core entry: 1 for a (form, TPI) that is not built, 2 where
// the lanes of an emulated warp fell out of step
template <class Go>
int checked(Go&& go) {
  lanes_diverged = false;
  const int rc = go();
  return rc ? rc : lanes_diverged ? 2 : 0;
}

template <class Fn>
int dispatch_fast(int form, int tpi, bool uniform, Fn&& fn) {
  return uniform ? dispatch_fast_u<true>(form, tpi, fn)
                 : dispatch_fast_u<false>(form, tpi, fn);
}

}  // namespace

extern "C" int zt_cpu_fp_mul(int form, uint32_t* r, const uint32_t* a,
                             const uint32_t* b, long n, const uint32_t* p,
                             const uint32_t* one, unsigned pinv) {
  return dispatch(form, [&](auto* tag) {
    using Fld = std::remove_pointer_t<decltype(tag)>;
    mul_batch<Fld>(r, a, b, n, field_params<Fld>(p, one, pinv));
  });
}

extern "C" int zt_cpu_jac(int form, int op, const uint32_t* a,
                          const uint32_t* b, uint32_t* out, long n, int k,
                          const uint32_t* p, const uint32_t* one,
                          unsigned pinv) {
  return dispatch(form, [&](auto* tag) {
    using Fld = std::remove_pointer_t<decltype(tag)>;
    jac_batch<Fld>(op, a, b, out, n, k, field_params<Fld>(p, one, pinv));
  });
}

extern "C" int zt_cpu_fast_field(int form, int tpi, int op, uint32_t* r,
                                 const uint32_t* a, const uint32_t* b,
                                 long n) {
  return checked([&] {
    return dispatch_fast(form, tpi, false, [&](auto* tag) {
      using Fld = std::remove_pointer_t<decltype(tag)>;
      fast_field_batch<Fld>(op, r, a, b, n);
    });
  });
}

extern "C" int zt_cpu_fast_add(int form, int tpi, int kind, const uint32_t* p,
                               const uint32_t* q, uint32_t* out, long n,
                               const void* b3) {
  return checked([&] {
    return dispatch_fast(form, tpi, kind == 0 || tpi > 1, [&](auto* tag) {
      using Fld = std::remove_pointer_t<decltype(tag)>;
      fast_add_batch<Fld>(kind, p, q, out, n, b3);
    });
  });
}

// K3 (kind 0) and K5 (kind 1) over the fast core, as fast_kernels.cu
// builds them (Uniform, one warp a point)
extern "C" int zt_cpu_fast_dbl(int form, int tpi, int kind, const uint32_t* p,
                               uint32_t* out, long n, int k, const void* b3) {
  return checked([&] {
    return dispatch_fast_u<true>(form, tpi, [&](auto* tag) {
      using Fld = std::remove_pointer_t<decltype(tag)>;
      fast_dbl_batch<Fld>(kind, p, out, n, k, b3);
    });
  });
}

// K1 over the fast core in the form and TPI of a kernel variant; affine
// as zt_bucket_reduce takes it
extern "C" int zt_cpu_fast_reduce(int form, int tpi, int affine,
                                  const uint32_t* pts, const int32_t* ent,
                                  const int32_t* seg, int nseg, uint32_t* out,
                                  const void* b3) {
  if (nseg <= 0) return 0;
  return checked([&] {
    return dispatch_fast_u<true>(form, tpi, [&](auto* tag) {
      using Fld = std::remove_pointer_t<decltype(tag)>;
      fast_reduce_batch<Fld>(affine, pts, ent, seg, nseg, out, b3);
    });
  });
}

// K6 over the fast core in the form and TPI of a kernel variant
extern "C" int zt_cpu_fast_aff_add(int form, int tpi, const uint32_t* a,
                                   const uint8_t* ainf, const uint32_t* b,
                                   const uint8_t* binf, uint32_t* out,
                                   long n) {
  if (n <= 0) return 0;
  return checked([&] {
    return dispatch_fast(form, tpi, tpi > 1, [&](auto* tag) {
      using Fld = std::remove_pointer_t<decltype(tag)>;
      fast_aff_batch<Fld>(a, ainf, b, binf, out, n);
    });
  });
}

// The fast core's compile-time constants of a prime field (form 12 or 24):
// p and R mod p into p_out and one_out (N words each); returns -p^-1 mod
// 2^32, or 0 for an unknown form.
extern "C" unsigned zt_cpu_fast_consts(int form, uint32_t* p_out,
                                       uint32_t* one_out) {
  auto put = [&](auto* tag) {
    using M = std::remove_pointer_t<decltype(tag)>;
    for (int i = 0; i < M::N; ++i) {
      p_out[i] = M::p(i);
      one_out[i] = M::one(i);
    }
    return (unsigned)M::kPinv;
  };
  if (form == 12) return put((Bls377Fq*)nullptr);
  if (form == 24) return put((Bw6Fq*)nullptr);
  return 0;
}
