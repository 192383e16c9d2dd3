// CPU build of the device math in field.cuh, field2.cuh, field_fast.cuh
// and curve.cuh (g++), so the tests can hold the exact functions the CUDA
// kernels run against the plain PyTorch versions on a machine without a
// GPU.
//
// ``form`` picks the field type as the kernel builds do: 12 or 24 is
// Fq<12> / Fq<24> (or FqF over BLS12-377 / BW6-761 Fq), 2 is Fq2 over 12
// limbs (or Fq2F).  ``b3`` points to the kernel's b3 bytes (an int32 over
// Fq, 2 x 12 Montgomery limbs over Fq2).  The fast core's entries take
// ``tpi`` too: with TPI > 1 the TPI lanes of a group run as TPI threads
// that exchange words through a barrier, in the order a warp's shuffles
// and ballots would.
#include <string.h>

#include <atomic>
#include <thread>
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

template <class Fld>
void reduce_batch(int affine, const uint32_t* pts, const int32_t* ent,
                  const int32_t* seg, int nseg, uint32_t* out,
                  const typename Fld::B3& b3, const typename Fld::Params& F) {
  for (int s = 0; s < nseg; ++s) {
    uint32_t* o = out + (size_t)s * 3 * Fld::W;
    if (affine)
      reduce_segment<Fld, true>(o, pts, ent, seg[s], seg[s + 1], b3, F);
    else
      reduce_segment<Fld, false>(o, pts, ent, seg[s], seg[s + 1], b3, F);
  }
}

// k == 0: out = p + q (K2); k > 0: out = 2^k p (K3)
template <class Fld>
void proj_batch(const uint32_t* p, const uint32_t* q, uint32_t* out, long n,
                int k, const typename Fld::B3& b3,
                const typename Fld::Params& F) {
  for (long i = 0; i < n; ++i) {
    const size_t row = (size_t)i * 3 * Fld::W;
    Proj<Fld> a, b;
    proj_load<Fld>(a, p + row);
    if (k == 0) {
      proj_load<Fld>(b, q + row);
      proj_add<Fld>(a, a, b, b3, F);
    } else {
      for (int j = 0; j < k; ++j) proj_dbl<Fld>(a, a, b3, F);
    }
    proj_store<Fld>(out + row, a);
  }
}

// op 0: out = p + q (K4); op 1: out = 2^k p (K5); op 2: out = a + b for
// affine rows a, b with byte infinity flags ainf, binf (K6)
template <class Fld>
void jac_batch(int op, const uint32_t* a, const uint8_t* ainf,
               const uint32_t* b, const uint8_t* binf, uint32_t* out, long n,
               int k, const typename Fld::Params& F) {
  constexpr int W = Fld::W;
  for (long i = 0; i < n; ++i) {
    Jac<Fld> p, q;
    if (op == 2) {
      const size_t row = (size_t)i * 2 * W;
      aff_add<Fld>(p, a + row, a + row + W, ainf[i] != 0, b + row,
                   b + row + W, binf[i] != 0, F);
    } else {
      proj_load<Fld>(p, a + (size_t)i * 3 * W);
      if (op == 0) {
        proj_load<Fld>(q, b + (size_t)i * 3 * W);
        jac_add<Fld>(p, p, q, F);
      } else {
        for (int j = 0; j < k; ++j) jac_dbl<Fld>(p, p, F);
      }
    }
    proj_store<Fld>(out + (size_t)i * 3 * W, p);
  }
}

template <class Fld>
struct Args {
  typename Fld::Params F;
  typename Fld::B3 b3;
  Args(const void* p, const void* one, unsigned pinv, const void* b3v)
      : F(field_params<Fld>(p, one, pinv)), b3() {
    if (b3v) b3 = field_b3<Fld>(b3v);
  }
};

// Calls fn.template operator()<Fld>() for the field type of ``form``.
template <class Fn>
int dispatch(int form, Fn&& fn) {
  if (form == 12) return fn(static_cast<Fq<12>*>(nullptr)), 0;
  if (form == 24) return fn(static_cast<Fq<24>*>(nullptr)), 0;
  if (form == 2) return fn(static_cast<Fq2*>(nullptr)), 0;
  return 1;
}


// -- the fast core ---------------------------------------------------------

// The lanes of one group: a barrier, and two banks of slots used in turn,
// so that a lane may deposit its next word while the others still read the
// last exchange's.
struct LaneGroup {
  int tpi;
  std::atomic<int> arrived{0};
  std::atomic<unsigned> gen{0};
  uint32_t slots[2][8] = {};
  unsigned calls[8] = {};

  explicit LaneGroup(int t) : tpi(t) {}

  void barrier() {
    const unsigned g = gen.load(std::memory_order_acquire);
    if (arrived.fetch_add(1, std::memory_order_acq_rel) + 1 == tpi) {
      arrived.store(0, std::memory_order_relaxed);
      gen.fetch_add(1, std::memory_order_release);
    } else {
      while (gen.load(std::memory_order_acquire) == g)
        std::this_thread::yield();
    }
  }

  static void exchange(void* ctx, int lane, uint32_t v, uint32_t* all) {
    LaneGroup& G = *static_cast<LaneGroup*>(ctx);
    uint32_t* s = G.slots[G.calls[lane]++ & 1];
    s[lane] = v;
    G.barrier();
    for (int i = 0; i < G.tpi; ++i) all[i] = s[i];
  }
};

// body() once per lane of a group of Fld::kTpi lanes
template <class Fld, class Fn>
void run_lanes(Fn body) {
  constexpr int T = Fld::kTpi;
  if constexpr (T == 1) {
    body();
  } else {
    LaneGroup G(T);
    std::vector<std::thread> th;
    for (int l = 0; l < T; ++l)
      th.emplace_back([&G, &body, l] {
        zt_lane_emu.lane = l;
        zt_lane_emu.ctx = &G;
        zt_lane_emu.exchange = &LaneGroup::exchange;
        body();
      });
    for (auto& t : th) t.join();
  }
}

// op 0: r = a b, 1: a + b, 2: a - b, 3: -a; rows of Fld::ROW words
template <class Fld>
void fast_field_batch(int op, uint32_t* r, const uint32_t* a,
                      const uint32_t* b, long n) {
  run_lanes<Fld>([&] {
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
  run_lanes<Fld>([&] {
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

// Calls fn.template operator()<Fld>() for the fast field type of (form,
// tpi), with the kernels' vote span: warp-wide (Uniform) for K2 and for K4
// over lanes, as add_kernels.cu builds them; a group here is the warp.
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
    Args<Fld> A(p, one, pinv, nullptr);
    mul_batch<Fld>(r, a, b, n, A.F);
  });
}

extern "C" int zt_cpu_bucket_reduce(int form, int affine,
                                    const uint32_t* pts, const int32_t* ent,
                                    const int32_t* seg, int nseg,
                                    uint32_t* out, const uint32_t* p,
                                    const uint32_t* one, unsigned pinv,
                                    const void* b3) {
  return dispatch(form, [&](auto* tag) {
    using Fld = std::remove_pointer_t<decltype(tag)>;
    Args<Fld> A(p, one, pinv, b3);
    reduce_batch<Fld>(affine, pts, ent, seg, nseg, out, A.b3, A.F);
  });
}

extern "C" int zt_cpu_proj(int form, const uint32_t* pp, const uint32_t* q,
                           uint32_t* out, long n, int k, const uint32_t* p,
                           const uint32_t* one, unsigned pinv,
                           const void* b3) {
  return dispatch(form, [&](auto* tag) {
    using Fld = std::remove_pointer_t<decltype(tag)>;
    Args<Fld> A(p, one, pinv, b3);
    proj_batch<Fld>(pp, q, out, n, k, A.b3, A.F);
  });
}

extern "C" int zt_cpu_jac(int form, int op, const uint32_t* a,
                          const uint8_t* ainf, const uint32_t* b,
                          const uint8_t* binf, uint32_t* out, long n, int k,
                          const uint32_t* p, const uint32_t* one,
                          unsigned pinv) {
  return dispatch(form, [&](auto* tag) {
    using Fld = std::remove_pointer_t<decltype(tag)>;
    Args<Fld> A(p, one, pinv, nullptr);
    jac_batch<Fld>(op, a, ainf, b, binf, out, n, k, A.F);
  });
}

extern "C" int zt_cpu_fast_field(int form, int tpi, int op, uint32_t* r,
                                 const uint32_t* a, const uint32_t* b,
                                 long n) {
  return dispatch_fast(form, tpi, false, [&](auto* tag) {
    using Fld = std::remove_pointer_t<decltype(tag)>;
    fast_field_batch<Fld>(op, r, a, b, n);
  });
}

extern "C" int zt_cpu_fast_add(int form, int tpi, int kind, const uint32_t* p,
                               const uint32_t* q, uint32_t* out, long n,
                               const void* b3) {
  return dispatch_fast(form, tpi, kind == 0 || tpi > 1, [&](auto* tag) {
    using Fld = std::remove_pointer_t<decltype(tag)>;
    fast_add_batch<Fld>(kind, p, q, out, n, b3);
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
