// Complete projective group law for short Weierstrass curves with a = 0
// (Renes-Costello-Batina 2016, algorithms 7, 8 and 9), written once over a
// field type Fld -- Fq<12>, Fq<24> (field.cuh) or Fq2 (field2.cuh) -- so
// the bucket reduce (K1) and the msm8 kernels (K2 proj_add, K3
// proj_dbl_chain) share one body.  The plain PyTorch twins are
// ec/curve_torch.py (proj_add, proj_add_mixed, proj_dbl) and ec/msm.py
// (bucket_reduce_ref).  b3 = 3b is Fld::B3: a small signed integer over Fq
// (3 BLS12-377 G1, -3 BW6-761 G1, 12 BW6-761 G2) or the Fq2 constant
// (0, -3/5) of the BLS12-377 G2 twist.
#pragma once
#include "field.cuh"
#include "field2.cuh"

template <class Fld>
struct Proj {
  uint32_t x[Fld::W], y[Fld::W], z[Fld::W];
};

template <class Fld>
ZT_HD void proj_identity(Proj<Fld>& r, const typename Fld::Params& F) {
  Fld::zero(r.x);
  Fld::one(r.y, F);
  Fld::zero(r.z);
}

// a row of 3 W words (x | y | z)
template <class Fld>
ZT_HD void proj_load(Proj<Fld>& r, const uint32_t* src) {
  Fld::copy(r.x, src);
  Fld::copy(r.y, src + Fld::W);
  Fld::copy(r.z, src + 2 * Fld::W);
}

template <class Fld>
ZT_HD void proj_store(uint32_t* dst, const Proj<Fld>& p) {
  Fld::copy(dst, p.x);
  Fld::copy(dst + Fld::W, p.y);
  Fld::copy(dst + 2 * Fld::W, p.z);
}

// r = p + q, RCB16 algorithm 7 (complete, any inputs).  r may alias p.
template <class Fld>
ZT_HD void proj_add(Proj<Fld>& r, const Proj<Fld>& p, const Proj<Fld>& q,
                    const typename Fld::B3& b3,
                    const typename Fld::Params& F) {
  constexpr int W = Fld::W;
  uint32_t t0[W], t1[W], t2[W], t3[W], t4[W], x3[W], y3[W], z3[W], u[W];
  Fld::mul(t0, p.x, q.x, F);
  Fld::mul(t1, p.y, q.y, F);
  Fld::mul(t2, p.z, q.z, F);
  Fld::add(u, p.x, p.y, F);
  Fld::add(t3, q.x, q.y, F);
  Fld::mul(t3, u, t3, F);
  Fld::add(u, t0, t1, F);
  Fld::sub(t3, t3, u, F);  // X1Y2 + X2Y1
  Fld::add(u, p.y, p.z, F);
  Fld::add(t4, q.y, q.z, F);
  Fld::mul(t4, u, t4, F);
  Fld::add(u, t1, t2, F);
  Fld::sub(t4, t4, u, F);  // Y1Z2 + Y2Z1
  Fld::add(u, p.x, p.z, F);
  Fld::add(y3, q.x, q.z, F);
  Fld::mul(y3, u, y3, F);
  Fld::add(u, t0, t2, F);
  Fld::sub(y3, y3, u, F);  // X1Z2 + X2Z1
  Fld::add(x3, t0, t0, F);
  Fld::add(t0, x3, t0, F);
  Fld::mul_b3(t2, t2, b3, F);
  Fld::add(z3, t1, t2, F);
  Fld::sub(t1, t1, t2, F);
  Fld::mul_b3(y3, y3, b3, F);
  Fld::mul(x3, t4, y3, F);
  Fld::mul(t2, t3, t1, F);
  Fld::sub(x3, t2, x3, F);
  Fld::mul(y3, y3, t0, F);
  Fld::mul(t1, t1, z3, F);
  Fld::add(y3, t1, y3, F);
  Fld::mul(t0, t0, t3, F);
  Fld::mul(z3, z3, t4, F);
  Fld::add(z3, z3, t0, F);
  Fld::copy(r.x, x3);
  Fld::copy(r.y, y3);
  Fld::copy(r.z, z3);
}

// r = p + (qx, qy, 1), RCB16 algorithm 8: the same values as algorithm 7
// with Z2 = 1, one multiply fewer per cross term.  q must not be the
// identity (the MSM never feeds it one).  r may alias p.
template <class Fld>
ZT_HD void proj_add_mixed(Proj<Fld>& r, const Proj<Fld>& p,
                          const uint32_t* qx, const uint32_t* qy,
                          const typename Fld::B3& b3,
                          const typename Fld::Params& F) {
  constexpr int W = Fld::W;
  uint32_t t0[W], t1[W], t2[W], t3[W], t4[W], x3[W], y3[W], z3[W], u[W];
  Fld::mul(t0, p.x, qx, F);
  Fld::mul(t1, p.y, qy, F);
  Fld::add(u, p.x, p.y, F);
  Fld::add(t3, qx, qy, F);
  Fld::mul(t3, u, t3, F);
  Fld::add(u, t0, t1, F);
  Fld::sub(t3, t3, u, F);
  Fld::mul(t4, qy, p.z, F);
  Fld::add(t4, t4, p.y, F);
  Fld::mul(y3, qx, p.z, F);
  Fld::add(y3, y3, p.x, F);
  Fld::add(x3, t0, t0, F);
  Fld::add(t0, x3, t0, F);
  Fld::mul_b3(t2, p.z, b3, F);
  Fld::add(z3, t1, t2, F);
  Fld::sub(t1, t1, t2, F);
  Fld::mul_b3(y3, y3, b3, F);
  Fld::mul(x3, t4, y3, F);
  Fld::mul(t2, t3, t1, F);
  Fld::sub(x3, t2, x3, F);
  Fld::mul(y3, y3, t0, F);
  Fld::mul(t1, t1, z3, F);
  Fld::add(y3, t1, y3, F);
  Fld::mul(t0, t0, t3, F);
  Fld::mul(z3, z3, t4, F);
  Fld::add(z3, z3, t0, F);
  Fld::copy(r.x, x3);
  Fld::copy(r.y, y3);
  Fld::copy(r.z, z3);
}

// r = 2p, RCB16 algorithm 9 (complete, a = 0): 6M + 2S + one b3 multiply.
// Mirrors ec_pallas.py:_proj_dbl_t.  r may alias p.
template <class Fld>
ZT_HD void proj_dbl(Proj<Fld>& r, const Proj<Fld>& p,
                    const typename Fld::B3& b3,
                    const typename Fld::Params& F) {
  constexpr int W = Fld::W;
  uint32_t t0[W], t1[W], t2[W], x3[W], y3[W], z3[W];
  Fld::mul(t0, p.y, p.y, F);
  Fld::add(z3, t0, t0, F);
  Fld::add(z3, z3, z3, F);
  Fld::add(z3, z3, z3, F);  // 8 Y^2
  Fld::mul(t1, p.y, p.z, F);
  Fld::mul(t2, p.z, p.z, F);
  Fld::mul_b3(t2, t2, b3, F);
  Fld::mul(x3, t2, z3, F);
  Fld::add(y3, t0, t2, F);
  Fld::mul(z3, t1, z3, F);
  Fld::add(t1, t2, t2, F);
  Fld::add(t2, t1, t2, F);  // 3 b3 Z^2
  Fld::sub(t0, t0, t2, F);
  Fld::mul(y3, t0, y3, F);
  Fld::add(y3, x3, y3, F);
  Fld::mul(t1, p.x, p.y, F);
  Fld::mul(x3, t0, t1, F);
  Fld::add(x3, x3, x3, F);
  Fld::copy(r.x, x3);
  Fld::copy(r.y, y3);
  Fld::copy(r.z, z3);
}

// Sum of the points named by ent[lo..hi), starting from (0:1:0), into
// out[0..3W).  Entry e names point e >> 1, negated when e & 1.  AFFINE
// points are (x, y) rows of 2W words; otherwise (x, y, z) rows of 3W.
template <class Fld, bool AFFINE>
ZT_HD void reduce_segment(uint32_t* out, const uint32_t* pts,
                          const int32_t* ent, int lo, int hi,
                          const typename Fld::B3& b3,
                          const typename Fld::Params& F) {
  constexpr int W = Fld::W;
  Proj<Fld> acc;
  proj_identity<Fld>(acc, F);
  for (int k = lo; k < hi; ++k) {
    const int e = ent[k];
    const uint32_t* src = pts + (size_t)(e >> 1) * (AFFINE ? 2 : 3) * W;
    Proj<Fld> q;
    Fld::copy(q.x, src);
    Fld::copy(q.y, src + W);
    if (e & 1) Fld::neg(q.y, q.y, F);
    if (AFFINE) {
      proj_add_mixed<Fld>(acc, acc, q.x, q.y, b3, F);
    } else {
      Fld::copy(q.z, src + 2 * W);
      proj_add<Fld>(acc, acc, q, b3, F);
    }
  }
  proj_store<Fld>(out, acc);
}

// The field type of one build: -DZT_LIMBS=12|24 (Fq) or -DZT_FQ2=1, and
// the kernel constants as the C launchers receive them (host pointers to
// the base prime, R mod p and b3: an int32 over Fq, 2 x NB limbs over Fq2).
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

template <class Fld>
typename Fld::B3 field_b3(const void* b3) {
  typename Fld::B3 out;
  const unsigned char* src = static_cast<const unsigned char*>(b3);
  unsigned char* dst = reinterpret_cast<unsigned char*>(&out);
  for (size_t i = 0; i < sizeof(out); ++i) dst[i] = src[i];
  return out;
}

#if defined(ZT_FQ2)
using ZtField = Fq2;
#elif defined(ZT_LIMBS)
using ZtField = Fq<ZT_LIMBS>;
#endif
