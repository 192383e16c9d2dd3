// CPU build of the device math in field.cuh, field2.cuh and curve.cuh
// (g++), so the tests can hold the exact functions the CUDA kernels run
// against the plain PyTorch versions on a machine without a GPU.
//
// ``form`` picks the field type as the kernel builds do: 12 or 24 is
// Fq<12> / Fq<24>, 2 is Fq2 over 12 limbs.  ``b3`` points to the kernel's
// b3 bytes (an int32 over Fq, 2 x 12 Montgomery limbs over Fq2).
#include <type_traits>

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
