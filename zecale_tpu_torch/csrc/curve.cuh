// Group laws for short Weierstrass curves with a = 0, written once over a
// field type Fld: the fast core's FqF / Fq2F (field_fast.cuh) for the
// kernels K1-K6 in fast_kernels.cu, and field.cuh's Fq<N> / field2.cuh's
// Fq2 for the CPU tests of the older field code (host_check.cpp):
//
//   * the complete projective law (Renes-Costello-Batina 2016, algorithms
//     7, 8 and 9), shared by the bucket reduce (K1 bucket_reduce, through
//     reduce_segment) and the msm8 kernels (K2 proj_add, K3
//     proj_dbl_chain).  Plain PyTorch twins: ec/curve_torch.py (proj_add,
//     proj_add_mixed, proj_dbl) and ec/msm.py (bucket_reduce_ref).  b3 =
//     3b is Fld::B3: a small signed integer over Fq (3 BLS12-377 G1, -3
//     BW6-761 G1, 12 BW6-761 G2) or the Fq2 constant (0, -3/5) of the
//     BLS12-377 G2 twist;
//   * the unified Jacobian law of the JAX package's JacCurve, shared by K4
//     jac_add, K5 jac_dbl_chain and K6 aff_add.  Plain PyTorch twins:
//     ec/curve_torch.py (jac_add, jac_dbl, aff_add).  It needs no curve
//     constant.
//
// The doublings also have a form with the products of each step side by
// side (proj_dbl_side, jac_dbl_side: field_fast.cuh mul_side_by_side), for
// a warp that owns one point: K3 and K5 run it.  Where the field's votes
// span the whole warp (Fld::kUniform), every thread runs one path: the
// bucket reduce loops to the longest segment of the warp and selects, and
// jac_add / aff_add compute every case a warp needs and select.
#pragma once
#include "field.cuh"
#include "field2.cuh"
#include "field_fast.cuh"

template <class Fld>
struct Proj {
  uint32_t x[Fld::W], y[Fld::W], z[Fld::W];
};

// r = c ? a : b, word by word; r may alias a or b
template <class Fld>
ZT_HD void field_pick(uint32_t* r, bool c, const uint32_t* a,
                      const uint32_t* b) {
#pragma unroll
  for (int j = 0; j < Fld::W; ++j) r[j] = c ? a[j] : b[j];
}

template <class Fld>
ZT_HD void point_pick(Proj<Fld>& r, bool c, const Proj<Fld>& a,
                      const Proj<Fld>& b) {
  field_pick<Fld>(r.x, c, a.x, b.x);
  field_pick<Fld>(r.y, c, a.y, b.y);
  field_pick<Fld>(r.z, c, a.z, b.z);
}

template <class Fld>
ZT_HD void proj_identity(Proj<Fld>& r, const typename Fld::Params& F) {
  Fld::zero(r.x);
  Fld::one(r.y, F);
  Fld::zero(r.z);
}

// a row of three coordinates (x | y | z), each Fld::ROW words in memory;
// the field type moves the words this thread holds (all of them, or its
// lane's slice where several threads share a point)
template <class Fld>
ZT_HD void proj_load(Proj<Fld>& r, const uint32_t* src) {
  Fld::load(r.x, src, 0);
  Fld::load(r.y, src, 1);
  Fld::load(r.z, src, 2);
}

template <class Fld>
ZT_HD void proj_store(uint32_t* dst, const Proj<Fld>& p) {
  Fld::store(dst, p.x, 0);
  Fld::store(dst, p.y, 1);
  Fld::store(dst, p.z, 2);
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

// r = b3 a, by every group alone where b3 is a small integer (additions),
// as products side by side where it is an Fq2 constant
template <class Fld>
ZT_HD void mul_b3_side(uint32_t* r, const uint32_t* a,
                       const typename Fld::B3& b3,
                       const typename Fld::Params& F) {
  if constexpr (Fld::kParts == 1) {
    Fld::mul_b3(r, a, b3, F);
  } else {
    uint32_t* const rs[1] = {r};
    const uint32_t* const as[1] = {a};
    const uint32_t* const bs[1] = {b3.c};
    mul_side_by_side<Fld, 1>(rs, as, bs, F);
  }
}

// proj_dbl's values with its products side by side, one warp a point
// (K3): Y^2, YZ, Z^2 and XY; then b3 Z^2; then b3 Z^2 8Y^2,
// YZ 8Y^2, (Y^2 - 3 b3 Z^2)(Y^2 + b3 Z^2) and (Y^2 - 3 b3 Z^2) XY.
// r may alias p.
template <class Fld>
ZT_HD void proj_dbl_side(Proj<Fld>& r, const Proj<Fld>& p,
                         const typename Fld::B3& b3,
                         const typename Fld::Params& F) {
  constexpr int W = Fld::W;
  uint32_t t0[W], t1[W], t2[W], xy[W], z8[W], u[W], v[W];
  uint32_t x3[W], y3[W], z3[W], w[W];
  {
    uint32_t* const rs[4] = {t0, t1, t2, xy};
    const uint32_t* const as[4] = {p.y, p.y, p.z, p.x};
    const uint32_t* const bs[4] = {p.y, p.z, p.z, p.y};
    mul_side_by_side<Fld, 4>(rs, as, bs, F);
  }
  Fld::add(z8, t0, t0, F);
  Fld::add(z8, z8, z8, F);
  Fld::add(z8, z8, z8, F);  // 8 Y^2
  mul_b3_side<Fld>(t2, t2, b3, F);
  Fld::add(v, t0, t2, F);   // Y^2 + b3 Z^2
  Fld::add(u, t2, t2, F);
  Fld::add(u, u, t2, F);
  Fld::sub(u, t0, u, F);    // Y^2 - 3 b3 Z^2
  {
    uint32_t* const rs[4] = {x3, z3, y3, w};
    const uint32_t* const as[4] = {t2, t1, u, u};
    const uint32_t* const bs[4] = {z8, z8, v, xy};
    mul_side_by_side<Fld, 4>(rs, as, bs, F);
  }
  Fld::add(r.y, x3, y3, F);
  Fld::add(r.x, w, w, F);
  Fld::copy(r.z, z3);
}

// ---------------------------------------------------------------------------
// The unified Jacobian law (x = X/Z^2, y = Y/Z^3; Z = 0 is infinity) of
// ec/curve_jax.py:JacCurve and the Pallas bodies ec/ec_pallas.py
// _jac_add_t (168), _jac_dbl_t (229) and _aff_aff_add_t (247).  Its
// formulas are not complete.  The TPU bodies computed every branch and
// selected; a thread here branches on the same tests, and the outputs are
// the reference's field values in every case, the coordinates it carries
// through points at infinity included: O + Q is Q's triple as it stands,
// P + O is P's, and P + (-P) keeps the generic X3, Y3 with Z3 = 0.  The
// tests on H and R are exact because every field op here returns canonical
// values in [0, p).

// A Jacobian point is the same three rows of W words as a projective one.
template <class Fld>
using Jac = Proj<Fld>;

// r = 2p, dbl-2009-l: 2M + 5S.  Z = 0 stays Z3 = 0.  r may alias p.
template <class Fld>
ZT_HD void jac_dbl(Jac<Fld>& r, const Jac<Fld>& p,
                   const typename Fld::Params& F) {
  constexpr int W = Fld::W;
  uint32_t a[W], b[W], c[W], d[W], e[W], t[W];
  Fld::mul(a, p.x, p.x, F);  // A = X^2
  Fld::mul(b, p.y, p.y, F);  // B = Y^2
  Fld::add(d, p.x, b, F);
  Fld::mul(t, p.y, p.z, F);
  Fld::add(r.z, t, t, F);    // Z3 = 2 Y Z; p is not read after this
  Fld::mul(c, b, b, F);      // C = B^2
  Fld::mul(d, d, d, F);
  Fld::sub(d, d, a, F);
  Fld::sub(d, d, c, F);
  Fld::add(d, d, d, F);      // D = 2((X + B)^2 - A - C)
  Fld::add(e, a, a, F);
  Fld::add(e, e, a, F);      // E = 3A
  Fld::mul(t, e, e, F);
  Fld::sub(t, t, d, F);
  Fld::sub(r.x, t, d, F);    // X3 = E^2 - 2D
  Fld::sub(d, d, r.x, F);
  Fld::mul(d, e, d, F);
  Fld::add(c, c, c, F);
  Fld::add(c, c, c, F);
  Fld::add(c, c, c, F);
  Fld::sub(r.y, d, c, F);    // Y3 = E(D - X3) - 8C
}

// jac_dbl's values with its products side by side, one warp a point (K5): X^2, Y^2 and YZ; then B^2, (X + B)^2 and E^2; then
// E(D - X3).  r may alias p.
template <class Fld>
ZT_HD void jac_dbl_side(Jac<Fld>& r, const Jac<Fld>& p,
                        const typename Fld::Params& F) {
  constexpr int W = Fld::W;
  uint32_t a[W], b[W], c[W], d[W], e[W], t[W], z3[W];
  {
    uint32_t* const rs[3] = {a, b, t};
    const uint32_t* const as[3] = {p.x, p.y, p.y};
    const uint32_t* const bs[3] = {p.x, p.y, p.z};
    mul_side_by_side<Fld, 3>(rs, as, bs, F);
  }
  Fld::add(d, p.x, b, F);
  Fld::add(z3, t, t, F);     // Z3 = 2 Y Z
  Fld::add(e, a, a, F);
  Fld::add(e, e, a, F);      // E = 3A
  {
    uint32_t* const rs[3] = {c, d, t};
    const uint32_t* const as[3] = {b, d, e};
    const uint32_t* const bs[3] = {b, d, e};
    mul_side_by_side<Fld, 3>(rs, as, bs, F);  // C = B^2, (X + B)^2, E^2
  }
  Fld::sub(d, d, a, F);
  Fld::sub(d, d, c, F);
  Fld::add(d, d, d, F);      // D = 2((X + B)^2 - A - C)
  Fld::sub(t, t, d, F);
  Fld::sub(r.x, t, d, F);    // X3 = E^2 - 2D
  Fld::sub(d, d, r.x, F);
  {
    uint32_t* const rs[1] = {d};
    const uint32_t* const as[1] = {e};
    const uint32_t* const bs[1] = {d};
    mul_side_by_side<Fld, 1>(rs, as, bs, F);
  }
  Fld::add(c, c, c, F);
  Fld::add(c, c, c, F);
  Fld::add(c, c, c, F);
  Fld::sub(r.y, d, c, F);    // Y3 = E(D - X3) - 8C
  Fld::copy(r.z, z3);
}

// jac_add over a field type whose votes span the whole warp
// (Fld::kUniform): the shuffles of the field ops name every thread of the
// warp, so all threads run one path.  Each computes the generic sum, and
// the doubling too where any point of the warp needs it, and selects its
// own case at the end: the same triples as jac_add's branches.
template <class Fld>
ZT_HD void jac_add_warp(Jac<Fld>& r, const Jac<Fld>& p, const Jac<Fld>& q,
                        const typename Fld::Params& F) {
  constexpr int W = Fld::W;
  const bool pinf = Fld::is_zero(p.z), qinf = Fld::is_zero(q.z);
  if (Fld::all(pinf || qinf)) {
    point_pick<Fld>(r, pinf, q, p);
    return;
  }
  Jac<Fld> g, d = p;  // d: the doubling, where any point needs it
  uint32_t z1z1[W], z2z2[W], u1[W], h[W], s1[W], rr[W], t[W];
  Fld::mul(z1z1, p.z, p.z, F);
  Fld::mul(z2z2, q.z, q.z, F);
  Fld::mul(u1, p.x, z2z2, F);   // U1
  Fld::mul(h, q.x, z1z1, F);    // U2
  Fld::mul(t, q.z, z2z2, F);
  Fld::mul(s1, p.y, t, F);      // S1
  Fld::mul(t, p.z, z1z1, F);
  Fld::mul(rr, q.y, t, F);      // S2
  Fld::sub(h, h, u1, F);        // H = U2 - U1
  Fld::sub(rr, rr, s1, F);      // R = S2 - S1
  const bool hz = Fld::is_zero(h), rz = Fld::is_zero(rr);  // both votes
  const bool dbl = hz && rz && !pinf && !qinf;
  if (Fld::any(dbl)) jac_dbl<Fld>(d, p, F);
  Fld::add(t, p.z, q.z, F);
  Fld::mul(t, t, t, F);
  Fld::sub(t, t, z1z1, F);
  Fld::sub(t, t, z2z2, F);
  Fld::mul(g.z, t, h, F);       // Z3 = ((Z1 + Z2)^2 - Z1Z1 - Z2Z2) H
  Fld::add(t, h, h, F);
  Fld::mul(t, t, t, F);         // I = (2H)^2
  Fld::mul(z1z1, h, t, F);      // J = H I
  Fld::mul(u1, u1, t, F);       // V = U1 I
  Fld::add(rr, rr, rr, F);      // r = 2R
  Fld::mul(t, rr, rr, F);
  Fld::sub(t, t, z1z1, F);
  Fld::sub(t, t, u1, F);
  Fld::sub(g.x, t, u1, F);      // X3 = r^2 - J - 2V
  Fld::sub(u1, u1, g.x, F);
  Fld::mul(u1, rr, u1, F);
  Fld::mul(s1, s1, z1z1, F);
  Fld::add(s1, s1, s1, F);
  Fld::sub(g.y, u1, s1, F);     // Y3 = r(V - X3) - 2 S1 J
  point_pick<Fld>(g, dbl, d, g);
  point_pick<Fld>(g, qinf, p, g);
  point_pick<Fld>(r, pinf, q, g);
}

// r = p + q, add-2007-bl (11M + 5S), with dbl-2009-l where P = Q.  r may
// alias p or q.
template <class Fld>
ZT_HD void jac_add(Jac<Fld>& r, const Jac<Fld>& p, const Jac<Fld>& q,
                   const typename Fld::Params& F) {
  constexpr int W = Fld::W;
  if constexpr (Fld::kUniform) {
    jac_add_warp<Fld>(r, p, q, F);
    return;
  }
  if (Fld::is_zero(p.z)) {
    if (&r != &q) r = q;
    return;
  }
  if (Fld::is_zero(q.z)) {
    if (&r != &p) r = p;
    return;
  }
  uint32_t z1z1[W], z2z2[W], u1[W], h[W], s1[W], rr[W], t[W];
  Fld::mul(z1z1, p.z, p.z, F);
  Fld::mul(z2z2, q.z, q.z, F);
  Fld::mul(u1, p.x, z2z2, F);   // U1
  Fld::mul(h, q.x, z1z1, F);    // U2
  Fld::mul(t, q.z, z2z2, F);
  Fld::mul(s1, p.y, t, F);      // S1
  Fld::mul(t, p.z, z1z1, F);
  Fld::mul(rr, q.y, t, F);      // S2
  Fld::sub(h, h, u1, F);        // H = U2 - U1
  Fld::sub(rr, rr, s1, F);      // R = S2 - S1
  if (Fld::is_zero(h) && Fld::is_zero(rr)) {
    jac_dbl<Fld>(r, p, F);
    return;
  }
  Fld::add(t, p.z, q.z, F);     // p and q are not read after this
  Fld::mul(t, t, t, F);
  Fld::sub(t, t, z1z1, F);
  Fld::sub(t, t, z2z2, F);
  Fld::mul(z2z2, t, h, F);      // Z3 = ((Z1 + Z2)^2 - Z1Z1 - Z2Z2) H
  Fld::add(t, h, h, F);
  Fld::mul(t, t, t, F);         // I = (2H)^2
  Fld::mul(z1z1, h, t, F);      // J = H I
  Fld::mul(u1, u1, t, F);       // V = U1 I
  Fld::add(rr, rr, rr, F);      // r = 2R
  Fld::mul(t, rr, rr, F);
  Fld::sub(t, t, z1z1, F);
  Fld::sub(t, t, u1, F);
  Fld::sub(t, t, u1, F);        // X3 = r^2 - J - 2V
  Fld::sub(u1, u1, t, F);
  Fld::mul(u1, rr, u1, F);
  Fld::mul(s1, s1, z1z1, F);
  Fld::add(s1, s1, s1, F);
  Fld::sub(r.y, u1, s1, F);     // Y3 = r(V - X3) - 2 S1 J
  Fld::copy(r.x, t);
  Fld::copy(r.z, z2z2);
}

// aff_add over a field type whose votes span the whole warp
// (Fld::kUniform), as jac_add_warp: each group computes the generic sum,
// and the doubling of the lifted point too where any point of the warp has
// P = Q, and selects its own case at the end: the same triples as
// aff_add's branches.
template <class Fld>
ZT_HD void aff_add_warp(Jac<Fld>& r, const uint32_t* x1, const uint32_t* y1,
                        bool inf1, const uint32_t* x2, const uint32_t* y2,
                        bool inf2, const typename Fld::Params& F) {
  constexpr int W = Fld::W;
  // O + Q is Q's (x, y, 1), P + O is P's, O + O keeps P's x, y with Z = 0
  Jac<Fld> o;
  uint32_t z0[W];
  field_pick<Fld>(o.x, inf1, x2, x1);
  field_pick<Fld>(o.y, inf1, y2, y1);
  Fld::one(o.z, F);
  Fld::zero(z0);
  field_pick<Fld>(o.z, inf1 && inf2, z0, o.z);
  if (Fld::all(inf1 || inf2)) {
    r = o;
    return;
  }
  Jac<Fld> g, d;  // d: the doubling of (x1, y1, 1), where any point needs it
  uint32_t h[W], ry[W], i4[W], j[W], v[W], t[W];
  Fld::sub(h, x2, x1, F);
  Fld::sub(ry, y2, y1, F);
  const bool hz = Fld::is_zero(h), rz = Fld::is_zero(ry);  // both votes
  const bool dbl = hz && rz && !inf1 && !inf2;
  Fld::copy(d.x, x1);
  Fld::copy(d.y, y1);
  Fld::one(d.z, F);
  if (Fld::any(dbl)) jac_dbl<Fld>(d, d, F);
  Fld::mul(t, h, h, F);
  Fld::add(t, t, t, F);
  Fld::add(i4, t, t, F);        // I = 4 H^2
  Fld::mul(j, h, i4, F);        // J = H I
  Fld::mul(v, x1, i4, F);       // V = X1 I
  Fld::add(ry, ry, ry, F);      // r = 2 (Y2 - Y1)
  Fld::mul(t, ry, ry, F);
  Fld::sub(t, t, j, F);
  Fld::sub(t, t, v, F);
  Fld::sub(g.x, t, v, F);       // X3 = r^2 - J - 2V
  Fld::sub(v, v, g.x, F);
  Fld::mul(v, ry, v, F);
  Fld::mul(j, y1, j, F);
  Fld::add(j, j, j, F);
  Fld::sub(g.y, v, j, F);       // Y3 = r(V - X3) - 2 Y1 J
  Fld::add(g.z, h, h, F);       // Z3 = 2H (0 where P = -Q)
  point_pick<Fld>(g, dbl, d, g);
  point_pick<Fld>(r, inf1 || inf2, o, g);
}

// r = (x1, y1) + (x2, y2) with infinity flags, a Jacobian result:
// mmadd-2007-bl (4M + 2S), and where P = Q the doubling of (x1, y1, 1),
// which is mdbl-2007-bl's values.  A point at infinity lifts to Z = 0,
// any other to Z = 1.
template <class Fld>
ZT_HD void aff_add(Jac<Fld>& r, const uint32_t* x1, const uint32_t* y1,
                   bool inf1, const uint32_t* x2, const uint32_t* y2,
                   bool inf2, const typename Fld::Params& F) {
  constexpr int W = Fld::W;
  if constexpr (Fld::kUniform) {
    aff_add_warp<Fld>(r, x1, y1, inf1, x2, y2, inf2, F);
    return;
  }
  if (inf1 || inf2) {
    const bool take2 = inf1;
    Fld::copy(r.x, take2 ? x2 : x1);
    Fld::copy(r.y, take2 ? y2 : y1);
    if (take2 && inf2)
      Fld::zero(r.z);
    else
      Fld::one(r.z, F);
    return;
  }
  uint32_t h[W], ry[W], i4[W], j[W], v[W], t[W];
  Fld::sub(h, x2, x1, F);
  Fld::sub(ry, y2, y1, F);
  if (Fld::is_zero(h) && Fld::is_zero(ry)) {
    Jac<Fld> p;
    Fld::copy(p.x, x1);
    Fld::copy(p.y, y1);
    Fld::one(p.z, F);
    jac_dbl<Fld>(r, p, F);
    return;
  }
  Fld::mul(t, h, h, F);
  Fld::add(t, t, t, F);
  Fld::add(i4, t, t, F);        // I = 4 H^2
  Fld::mul(j, h, i4, F);        // J = H I
  Fld::mul(v, x1, i4, F);       // V = X1 I
  Fld::add(ry, ry, ry, F);      // r = 2 (Y2 - Y1)
  Fld::mul(t, ry, ry, F);
  Fld::sub(t, t, j, F);
  Fld::sub(t, t, v, F);
  Fld::sub(t, t, v, F);         // X3 = r^2 - J - 2V
  Fld::sub(v, v, t, F);
  Fld::mul(v, ry, v, F);
  Fld::mul(j, y1, j, F);
  Fld::add(j, j, j, F);
  Fld::sub(r.y, v, j, F);       // Y3 = r(V - X3) - 2 Y1 J
  Fld::copy(r.x, t);
  Fld::add(r.z, h, h, F);       // Z3 = 2H (0 where P = -Q)
}

// The bucket reduce (K1): row s of out is the sum of the points named by
// ent[seg[s]..seg[s + 1]), starting from (0:1:0).  Entry e names point
// e >> 1, negated when e & 1.  AFFINE points are (x, y) rows of 2 ROW
// words, added by proj_add_mixed; otherwise (x, y, z) rows of 3 ROW, added
// by proj_add.  A group of TPI lanes owns segment s; a group past nseg
// (the tail of the last block) repeats segment nseg - 1 and stores
// nothing.  The field's shuffles and votes name the whole warp
// (Fld::kUniform), so the warp runs one trip count, the length of its
// longest segment: a group past its own end still adds a valid operand
// (its last entry again, or point 0 for an empty segment; never the
// identity, which proj_add_mixed does not take) and keeps its sum by a
// select.  The negation is computed for every entry and selected, since
// it holds a vote.
template <class Fld, bool AFFINE>
ZT_HD void reduce_segment(uint32_t* out, const uint32_t* pts,
                          const int32_t* ent, const int32_t* seg, int nseg,
                          long long s, const typename Fld::B3& b3,
                          const typename Fld::Params& F) {
  static_assert(Fld::kUniform, "one trip count a warp needs the whole warp");
  constexpr int W = Fld::W;
  const int own = (int)(s < nseg ? s : nseg - 1);
  const int lo = seg[own], len = seg[own + 1] - lo;
  const int trips = (int)Fld::Lane::warp_max((uint32_t)len);
  Proj<Fld> acc, t, q;
  uint32_t ny[W];
  proj_identity<Fld>(acc, F);
#pragma unroll 1
  for (int k = 0; k < trips; ++k) {
    const int e = len > 0 ? ent[lo + (k < len ? k : len - 1)] : 0;
    const uint32_t* src =
        pts + (size_t)(e >> 1) * (AFFINE ? 2 : 3) * Fld::ROW;
    Fld::load(q.x, src, 0);
    Fld::load(q.y, src, 1);
    Fld::neg(ny, q.y, F);
    field_pick<Fld>(q.y, e & 1, ny, q.y);
    if constexpr (AFFINE) {
      proj_add_mixed<Fld>(t, acc, q.x, q.y, b3, F);
    } else {
      Fld::load(q.z, src, 2);
      proj_add<Fld>(t, acc, q, b3, F);
    }
    point_pick<Fld>(acc, k < len, t, acc);
  }
  if (s < nseg) proj_store<Fld>(out + (size_t)s * 3 * Fld::ROW, acc);
}
