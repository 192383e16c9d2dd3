/* Native elliptic-curve engine: Jacobian group law, Pippenger MSM, radix-2
 * FFT and batched inversion over the shared Montgomery core (fp_core.h).
 *
 * This is the host-side runtime equivalent of libff's multiexp + libfqfft
 * (SURVEY.md section 2b) — an independent C implementation serving two
 * roles: the fast CPU prover path (zero-hardware recursion tests, serving
 * hosts without a TPU) and the oracle for the TPU kernels at scale.
 *
 * Field elements are vectors of ext_k * nl u64 limbs (ext_k = 1 for Fq,
 * 2 for Fq2 towers with non-residue nr).  Points:
 *   affine:   2 coords + uint8 infinity flag array (separate)
 *   jacobian: 3 coords, Z == 0 encodes infinity.
 * All coordinates Montgomery form.
 */

#include <stdlib.h>

#include "fp_core.h"

#define MAX_EXT 6
#define MAX_EW (MAX_EXT * MAX_LIMBS)

typedef struct {
    fp_ctx fp;
    int k;                 /* extension degree: 1, 2, 3 or 6 */
    int ew;                /* element width in u64 = k * nl */
    u64 nr[MAX_LIMBS];     /* non-residue (Montgomery) for k == 2 */
} ext_ctx;

long ext_ctx_size(void) { return (long)sizeof(ext_ctx); }

void ext_init(ext_ctx *e, int nl, const u64 *mod, const u64 *r2, u64 n0inv,
              int k, const u64 *nr_mont)
{
    e->fp.nl = nl;
    memcpy(e->fp.mod, mod, nl * sizeof(u64));
    memcpy(e->fp.r2, r2, nl * sizeof(u64));
    e->fp.n0inv = n0inv;
    e->k = k;
    e->ew = k * nl;
    if (k >= 2)
        memcpy(e->nr, nr_mont, nl * sizeof(u64));
}

/* -- extension field ops ---------------------------------------------------*/

static void eadd(const ext_ctx *e, u64 *o, const u64 *a, const u64 *b)
{
    for (int i = 0; i < e->k; ++i)
        fp_add(&e->fp, o + i * e->fp.nl, a + i * e->fp.nl, b + i * e->fp.nl);
}

static void esub(const ext_ctx *e, u64 *o, const u64 *a, const u64 *b)
{
    for (int i = 0; i < e->k; ++i)
        fp_sub(&e->fp, o + i * e->fp.nl, a + i * e->fp.nl, b + i * e->fp.nl);
}

static void emul(const ext_ctx *e, u64 *o, const u64 *a, const u64 *b)
{
    const fp_ctx *c = &e->fp;
    int nl = c->nl;
    if (e->k == 1) {
        fp_montmul(c, o, a, b);
        return;
    }
    if (e->k == 2) {
        /* Karatsuba over Fq2 = Fq[u]/(u^2 - nr) */
        u64 t0[MAX_LIMBS], t1[MAX_LIMBS], sa[MAX_LIMBS], sb[MAX_LIMBS],
            mid[MAX_LIMBS], nr_t1[MAX_LIMBS];
        fp_montmul(c, t0, a, b);
        fp_montmul(c, t1, a + nl, b + nl);
        fp_add(c, sa, a, a + nl);
        fp_add(c, sb, b, b + nl);
        fp_montmul(c, mid, sa, sb);
        fp_sub(c, mid, mid, t0);
        fp_sub(c, mid, mid, t1);
        fp_montmul(c, nr_t1, t1, e->nr);
        fp_add(c, o, t0, nr_t1);
        memcpy(o + nl, mid, nl * sizeof(u64));
        return;
    }
    if (e->k > 3) {
        /* generic binomial schoolbook: k^2 muls, fold u^k = nr */
        int k = e->k;
        u64 accl[MAX_EXT][MAX_LIMBS], acch[MAX_EXT][MAX_LIMBS];
        u64 t[MAX_LIMBS];
        memset(accl, 0, sizeof(accl));
        memset(acch, 0, sizeof(acch));
        for (int i = 0; i < k; ++i)
            for (int j = 0; j < k; ++j) {
                fp_montmul(c, t, a + i * nl, b + j * nl);
                if (i + j < k)
                    fp_add(c, accl[i + j], accl[i + j], t);
                else
                    fp_add(c, acch[i + j - k], acch[i + j - k], t);
            }
        for (int i = 0; i < k; ++i) {
            fp_montmul(c, t, acch[i], e->nr);
            fp_add(c, o + i * nl, accl[i], t);
        }
        return;
    }
    /* Karatsuba over Fq3 = Fq[u]/(u^3 - nr): 6 base muls */
    {
        const u64 *a0 = a, *a1 = a + nl, *a2 = a + 2 * nl;
        const u64 *b0 = b, *b1 = b + nl, *b2 = b + 2 * nl;
        u64 t0[MAX_LIMBS], t1[MAX_LIMBS], t2[MAX_LIMBS];
        u64 s01[MAX_LIMBS], s02[MAX_LIMBS], s12[MAX_LIMBS];
        u64 sa[MAX_LIMBS], sb[MAX_LIMBS], tmp[MAX_LIMBS];
        fp_montmul(c, t0, a0, b0);
        fp_montmul(c, t1, a1, b1);
        fp_montmul(c, t2, a2, b2);
        fp_add(c, sa, a0, a1); fp_add(c, sb, b0, b1);
        fp_montmul(c, s01, sa, sb);
        fp_sub(c, s01, s01, t0); fp_sub(c, s01, s01, t1);
        fp_add(c, sa, a0, a2); fp_add(c, sb, b0, b2);
        fp_montmul(c, s02, sa, sb);
        fp_sub(c, s02, s02, t0); fp_sub(c, s02, s02, t2);
        fp_add(c, sa, a1, a2); fp_add(c, sb, b1, b2);
        fp_montmul(c, s12, sa, sb);
        fp_sub(c, s12, s12, t1); fp_sub(c, s12, s12, t2);
        /* c0 = t0 + nr*s12 ; c1 = s01 + nr*t2 ; c2 = s02 + t1 */
        fp_montmul(c, tmp, s12, e->nr);
        fp_add(c, o, t0, tmp);
        fp_montmul(c, tmp, t2, e->nr);
        fp_add(c, o + nl, s01, tmp);
        fp_add(c, o + 2 * nl, s02, t1);
    }
}

static void esqr(const ext_ctx *e, u64 *o, const u64 *a) { emul(e, o, a, a); }

static void edbl_(const ext_ctx *e, u64 *o, const u64 *a)
{
    eadd(e, o, a, a);
}

static int eis_zero(const ext_ctx *e, const u64 *a)
{
    for (int i = 0; i < e->ew; ++i)
        if (a[i])
            return 0;
    return 1;
}

/* -- Jacobian group law (short Weierstrass, generic a via a_mont) --------- */

typedef struct {
    ext_ctx f;
    u64 a_coeff[MAX_EW]; /* curve a (Montgomery); 0 for BLS/BW6 */
    int a_is_zero;
} curve_ctx;

long curve_ctx_size(void) { return (long)sizeof(curve_ctx); }

void curve_init(curve_ctx *cc, int nl, const u64 *mod, const u64 *r2,
                u64 n0inv, int k, const u64 *nr_mont, const u64 *a_mont)
{
    ext_init(&cc->f, nl, mod, r2, n0inv, k, nr_mont);
    memcpy(cc->a_coeff, a_mont, cc->f.ew * sizeof(u64));
    cc->a_is_zero = eis_zero(&cc->f, a_mont);
}

/* P <- 2P (dbl-2007-bl general-a / dbl-2009-l for a=0). */
static void jac_dbl(const curve_ctx *cc, u64 *X, u64 *Y, u64 *Z)
{
    const ext_ctx *e = &cc->f;
    int w = e->ew;
    u64 A[MAX_EW], B[MAX_EW], C[MAX_EW], D[MAX_EW], E[MAX_EW], F[MAX_EW],
        t[MAX_EW], t2[MAX_EW];
    if (eis_zero(e, Z))
        return;
    esqr(e, A, X);              /* A = X^2 */
    esqr(e, B, Y);              /* B = Y^2 */
    esqr(e, C, B);              /* C = B^2 */
    eadd(e, t, X, B);
    esqr(e, t, t);
    esub(e, t, t, A);
    esub(e, t, t, C);
    edbl_(e, D, t);             /* D = 2((X+B)^2 - A - C) */
    edbl_(e, E, A);
    eadd(e, E, E, A);           /* E = 3A */
    if (!cc->a_is_zero) {       /* + a Z^4 */
        esqr(e, t, Z);
        esqr(e, t, t);
        emul(e, t, t, cc->a_coeff);
        eadd(e, E, E, t);
    }
    esqr(e, F, E);              /* F = E^2 */
    edbl_(e, t, D);
    esub(e, F, F, t);           /* X3 = F - 2D */
    emul(e, t2, Y, Z);
    edbl_(e, Z, t2);            /* Z3 = 2YZ */
    esub(e, t, D, F);
    emul(e, t, E, t);
    edbl_(e, t2, C);
    edbl_(e, t2, t2);
    edbl_(e, t2, t2);
    esub(e, Y, t, t2);          /* Y3 = E(D - X3) - 8C */
    memcpy(X, F, w * sizeof(u64));
}

/* (X,Y,Z) += affine (x2,y2); handles all special cases. */
static void jac_add_mixed(const curve_ctx *cc, u64 *X, u64 *Y, u64 *Z,
                          const u64 *x2, const u64 *y2, const u64 *one_m)
{
    const ext_ctx *e = &cc->f;
    int w = e->ew;
    u64 Z1Z1[MAX_EW], U2[MAX_EW], S2[MAX_EW], H[MAX_EW], R[MAX_EW],
        HH[MAX_EW], I[MAX_EW], J[MAX_EW], V[MAX_EW], t[MAX_EW];
    if (eis_zero(e, Z)) {
        memcpy(X, x2, w * sizeof(u64));
        memcpy(Y, y2, w * sizeof(u64));
        memcpy(Z, one_m, w * sizeof(u64));
        return;
    }
    esqr(e, Z1Z1, Z);
    emul(e, U2, x2, Z1Z1);
    emul(e, S2, Z, Z1Z1);
    emul(e, S2, y2, S2);
    esub(e, H, U2, X);
    esub(e, R, S2, Y);
    if (eis_zero(e, H)) {
        if (eis_zero(e, R)) {
            jac_dbl(cc, X, Y, Z);
            return;
        }
        memset(Z, 0, w * sizeof(u64)); /* inverse: infinity */
        return;
    }
    esqr(e, HH, H);
    edbl_(e, I, HH);
    edbl_(e, I, I);             /* I = 4HH */
    emul(e, J, H, I);
    edbl_(e, R, R);             /* r = 2R */
    emul(e, V, X, I);
    esqr(e, t, R);
    esub(e, t, t, J);
    esub(e, t, t, V);
    esub(e, t, t, V);           /* X3 */
    emul(e, Y, Y, J);
    edbl_(e, Y, Y);             /* 2 Y1 J */
    esub(e, V, V, t);
    emul(e, V, R, V);
    esub(e, Y, V, Y);           /* Y3 = r(V - X3) - 2 Y1 J */
    eadd(e, Z, Z, H);
    esqr(e, Z, Z);
    esub(e, Z, Z, Z1Z1);
    esub(e, Z, Z, HH);          /* Z3 = (Z1+H)^2 - Z1Z1 - HH */
    memcpy(X, t, w * sizeof(u64));
}

/* (X,Y,Z) += (X2,Y2,Z2) full Jacobian (add-2007-bl with special cases). */
static void jac_add(const curve_ctx *cc, u64 *X, u64 *Y, u64 *Z,
                    const u64 *X2, const u64 *Y2, const u64 *Z2)
{
    const ext_ctx *e = &cc->f;
    int w = e->ew;
    if (eis_zero(e, Z2))
        return;
    if (eis_zero(e, Z)) {
        memcpy(X, X2, w * sizeof(u64));
        memcpy(Y, Y2, w * sizeof(u64));
        memcpy(Z, Z2, w * sizeof(u64));
        return;
    }
    u64 Z1Z1[MAX_EW], Z2Z2[MAX_EW], U1[MAX_EW], U2[MAX_EW], S1[MAX_EW],
        S2[MAX_EW], H[MAX_EW], R[MAX_EW], I[MAX_EW], J[MAX_EW], V[MAX_EW],
        t[MAX_EW];
    esqr(e, Z1Z1, Z);
    esqr(e, Z2Z2, Z2);
    emul(e, U1, X, Z2Z2);
    emul(e, U2, X2, Z1Z1);
    emul(e, S1, Z2, Z2Z2);
    emul(e, S1, Y, S1);
    emul(e, S2, Z, Z1Z1);
    emul(e, S2, Y2, S2);
    esub(e, H, U2, U1);
    esub(e, R, S2, S1);
    if (eis_zero(e, H)) {
        if (eis_zero(e, R)) {
            jac_dbl(cc, X, Y, Z);
            return;
        }
        memset(Z, 0, w * sizeof(u64));
        return;
    }
    edbl_(e, I, H);
    esqr(e, I, I);              /* I = (2H)^2 */
    emul(e, J, H, I);
    edbl_(e, R, R);
    emul(e, V, U1, I);
    esqr(e, t, R);
    esub(e, t, t, J);
    esub(e, t, t, V);
    esub(e, t, t, V);           /* X3 */
    emul(e, S1, S1, J);
    edbl_(e, S1, S1);
    esub(e, V, V, t);
    emul(e, V, R, V);
    esub(e, Y, V, S1);          /* Y3 */
    eadd(e, Z, Z, Z2);
    esqr(e, Z, Z);
    esub(e, Z, Z, Z1Z1);
    esub(e, Z, Z, Z2Z2);
    emul(e, Z, Z, H);           /* Z3 = ((Z1+Z2)^2 - Z1Z1 - Z2Z2) H */
    memcpy(X, t, w * sizeof(u64));
}

/* -- Pippenger MSM ---------------------------------------------------------
 * scalars: n * sbytes bytes little-endian (standard form);
 * points: affine coords x|y interleaved per point (2*ew u64 each) +
 *         uint8 infinity flags; one_m = Montgomery 1 element (ew u64).
 * out: one Jacobian point (3*ew u64).
 */
static void msm_one_window(const curve_ctx *cc, u64 *win_out, u64 *buckets,
                           const uint8_t *scalars, long sbytes,
                           const u64 *pts, const uint8_t *inf, long n,
                           int cbits, long bitpos, const u64 *one_m)
{
    const ext_ctx *e = &cc->f;
    int w = e->ew;
    long nb = 1L << cbits;
    memset(buckets, 0, (size_t)nb * 3 * w * sizeof(u64));
    for (long i = 0; i < n; ++i) {
        if (inf && inf[i])
            continue;
        long byte = bitpos >> 3;
        int shift = (int)(bitpos & 7);
        u64 vraw = 0;
        for (int bby = 0; bby < 4 && byte + bby < sbytes; ++bby)
            vraw |= (u64)scalars[i * sbytes + byte + bby] << (8 * bby);
        u64 d = (vraw >> shift) & (nb - 1);
        if (!d)
            continue;
        u64 *bk = buckets + (size_t)d * 3 * w;
        jac_add_mixed(cc, bk, bk + w, bk + 2 * w, pts + (size_t)i * 2 * w,
                      pts + (size_t)i * 2 * w + w, one_m);
    }
    /* suffix-sum bucket reduction */
    u64 run[3 * MAX_EW];
    memset(run, 0, 3 * w * sizeof(u64));
    memset(win_out, 0, 3 * w * sizeof(u64));
    for (long d = nb - 1; d >= 1; --d) {
        u64 *bk = buckets + (size_t)d * 3 * w;
        jac_add(cc, run, run + w, run + 2 * w, bk, bk + w, bk + 2 * w);
        jac_add(cc, win_out, win_out + w, win_out + 2 * w, run, run + w,
                run + 2 * w);
    }
}

void msm_pippenger(const curve_ctx *cc, u64 *out, const uint8_t *scalars,
                   long sbytes, const u64 *pts, const uint8_t *inf, long n,
                   int cbits, const u64 *one_m)
{
    const ext_ctx *e = &cc->f;
    int w = e->ew;
    int nbits = (int)(sbytes * 8);
    int W = (nbits + cbits - 1) / cbits;
    long nb = 1L << cbits;
    u64 *wins = (u64 *)malloc((size_t)W * 3 * w * sizeof(u64));
    u64 *all_buckets = (u64 *)malloc((size_t)W * nb * 3 * w * sizeof(u64));

    /* windows are independent — parallel across cores (the reference's
     * MULTICORE/OpenMP axis, CMakeLists.txt:80-84) */
#pragma omp parallel for schedule(dynamic)
    for (int win = 0; win < W; ++win)
        msm_one_window(cc, wins + (size_t)win * 3 * w,
                       all_buckets + (size_t)win * nb * 3 * w, scalars,
                       sbytes, pts, inf, n, cbits, (long)win * cbits,
                       one_m);

    u64 *acc = out;
    memset(acc, 0, 3 * w * sizeof(u64));
    for (int win = W - 1; win >= 0; --win) {
        if (win != W - 1)
            for (int b = 0; b < cbits; ++b)
                jac_dbl(cc, acc, acc + w, acc + 2 * w);
        u64 *s = wins + (size_t)win * 3 * w;
        jac_add(cc, acc, acc + w, acc + 2 * w, s, s + w, s + 2 * w);
    }
    free(all_buckets);
    free(wins);
}

/* -- fixed-base batch scalar multiplication (trusted setup) ----------------
 * out[i] = scalars[i] * base, base affine (2*ew u64).  Windowed with an
 * on-the-fly table (2^c entries, Jacobian).
 */
void fixed_base_mul_batch(const curve_ctx *cc, u64 *out,
                          const uint8_t *scalars, long sbytes, long n,
                          const u64 *base_aff, int cbits, const u64 *one_m)
{
    const ext_ctx *e = &cc->f;
    int w = e->ew;
    int nbits = (int)(sbytes * 8);
    int W = (nbits + cbits - 1) / cbits;
    long nb = 1L << cbits;
    /* table[w][d] = d * 2^(c*w) * base (Jacobian) */
    u64 *table = (u64 *)malloc((size_t)W * nb * 3 * w * sizeof(u64));
    u64 cur[3 * MAX_EW];
    memcpy(cur, base_aff, 2 * w * sizeof(u64));
    memcpy(cur + 2 * w, one_m, w * sizeof(u64));
    for (int win = 0; win < W; ++win) {
        u64 *row = table + (size_t)win * nb * 3 * w;
        memset(row, 0, 3 * w * sizeof(u64)); /* d = 0: infinity */
        for (long d = 1; d < nb; ++d) {
            u64 *dst = row + (size_t)d * 3 * w;
            memcpy(dst, row + (size_t)(d - 1) * 3 * w, 3 * w * sizeof(u64));
            jac_add(cc, dst, dst + w, dst + 2 * w, cur, cur + w, cur + 2 * w);
        }
        for (int b = 0; b < cbits; ++b)
            jac_dbl(cc, cur, cur + w, cur + 2 * w);
    }
#pragma omp parallel for schedule(static)
    for (long i = 0; i < n; ++i) {
        u64 *o = out + (size_t)i * 3 * w;
        memset(o, 0, 3 * w * sizeof(u64));
        for (int win = 0; win < W; ++win) {
            long bitpos = (long)win * cbits;
            long byte = bitpos >> 3;
            int shift = (int)(bitpos & 7);
            u64 vraw = 0;
            for (int bby = 0; bby < 4 && byte + bby < sbytes; ++bby)
                vraw |= (u64)scalars[i * sbytes + byte + bby] << (8 * bby);
            u64 d = (vraw >> shift) & (nb - 1);
            if (!d)
                continue;
            const u64 *src = table + ((size_t)win * nb + d) * 3 * w;
            jac_add(cc, o, o + w, o + 2 * w, src, src + w, src + 2 * w);
        }
    }
    free(table);
}

/* -- batched inversion + Jacobian -> affine --------------------------------*/

static void epow(const ext_ctx *e, u64 *out, const u64 *a, const u64 *exp,
                 int explimbs, const u64 *one_m)
{
    int w = e->ew;
    u64 acc[MAX_EW];
    memcpy(acc, one_m, w * sizeof(u64));
    int top = explimbs * 64 - 1;
    while (top >= 0 && !((exp[top / 64] >> (top % 64)) & 1))
        --top;
    for (int b = top; b >= 0; --b) {
        esqr(e, acc, acc);
        if ((exp[b / 64] >> (b % 64)) & 1)
            emul(e, acc, acc, a);
    }
    memcpy(out, acc, w * sizeof(u64));
}

/* out affine pairs + inf flags from n Jacobian points.  exp = p - 2 for the
 * base field (inversion via Fermat on Z products, Montgomery trick). */
void jac_to_affine_batch(const curve_ctx *cc, u64 *out_xy, uint8_t *out_inf,
                         const u64 *jac, long n, const u64 *exp,
                         int explimbs, const u64 *one_m)
{
    const ext_ctx *e = &cc->f;
    int w = e->ew;
    u64 *pref = (u64 *)malloc((size_t)(n + 1) * w * sizeof(u64));
    memcpy(pref, one_m, w * sizeof(u64));
    for (long i = 0; i < n; ++i) {
        const u64 *Z = jac + (size_t)i * 3 * w + 2 * w;
        if (eis_zero(e, Z))
            memcpy(pref + (size_t)(i + 1) * w, pref + (size_t)i * w,
                   w * sizeof(u64));
        else
            emul(e, pref + (size_t)(i + 1) * w, pref + (size_t)i * w, Z);
    }
    u64 inv_all[MAX_EW], zi[MAX_EW], zi2[MAX_EW];
    epow(e, inv_all, pref + (size_t)n * w, exp, explimbs, one_m);
    for (long i = n - 1; i >= 0; --i) {
        const u64 *Z = jac + (size_t)i * 3 * w + 2 * w;
        u64 *oxy = out_xy + (size_t)i * 2 * w;
        if (eis_zero(e, Z)) {
            out_inf[i] = 1;
            memset(oxy, 0, 2 * w * sizeof(u64));
            continue;
        }
        out_inf[i] = 0;
        emul(e, zi, inv_all, pref + (size_t)i * w); /* 1/Z_i */
        emul(e, inv_all, inv_all, Z);
        esqr(e, zi2, zi);
        emul(e, oxy, jac + (size_t)i * 3 * w, zi2);
        emul(e, zi2, zi2, zi);
        emul(e, oxy + w, jac + (size_t)i * 3 * w + w, zi2);
    }
    free(pref);
}

/* -- radix-2 FFT over the base field (k must be 1) --------------------------
 * values: n elements Montgomery form, in place; omega: n-th root
 * (Montgomery); if sinv != NULL multiply all outputs by it (1/n for ifft).
 */
void fft_radix2(const ext_ctx *e, u64 *v, long n, const u64 *omega,
                const u64 *sinv, const u64 *one_m)
{
    const fp_ctx *c = &e->fp;
    int nl = c->nl;
    int bits = 0;
    while ((1L << bits) < n)
        ++bits;
    /* bit reversal */
    for (long i = 0; i < n; ++i) {
        long r = 0;
        for (int b = 0; b < bits; ++b)
            if (i & (1L << b))
                r |= 1L << (bits - 1 - b);
        if (r > i) {
            u64 tmp[MAX_LIMBS];
            memcpy(tmp, v + i * nl, nl * sizeof(u64));
            memcpy(v + i * nl, v + r * nl, nl * sizeof(u64));
            memcpy(v + r * nl, tmp, nl * sizeof(u64));
        }
    }
    u64 *stage_w = (u64 *)malloc((size_t)(n / 2 > 0 ? n / 2 : 1) * nl *
                                 sizeof(u64));
    for (long half = 1; half < n; half <<= 1) {
        /* w = omega^(n / (2 half)) ; twiddles w^0..w^(half-1) */
        u64 wstep[MAX_LIMBS];
        memcpy(wstep, omega, nl * sizeof(u64));
        for (long m = n / (2 * half); m > 1; m >>= 1)
            fp_montmul(c, wstep, wstep, wstep);
        memcpy(stage_w, one_m, nl * sizeof(u64));
        for (long j = 1; j < half; ++j)
            fp_montmul(c, stage_w + j * nl, stage_w + (j - 1) * nl, wstep);
        for (long blk = 0; blk < n; blk += 2 * half) {
            for (long j = 0; j < half; ++j) {
                u64 *u = v + (blk + j) * nl;
                u64 *t = v + (blk + half + j) * nl;
                u64 tv[MAX_LIMBS];
                fp_montmul(c, tv, t, stage_w + j * nl);
                fp_sub(c, t, u, tv);
                fp_add(c, u, u, tv);
            }
        }
    }
    free(stage_w);
    if (sinv)
        for (long i = 0; i < n; ++i)
            fp_montmul(c, v + i * nl, v + i * nl, sinv);
}

/* elementwise ops used by the QAP pipeline (all Montgomery, k == 1) */
void fp_mul_arrays(const ext_ctx *e, u64 *out, const u64 *a, const u64 *b,
                   long n)
{
    for (long i = 0; i < n; ++i)
        fp_montmul(&e->fp, out + i * e->fp.nl, a + i * e->fp.nl,
                   b + i * e->fp.nl);
}

void fp_add_arrays(const ext_ctx *e, u64 *out, const u64 *a, const u64 *b,
                   long n)
{
    for (long i = 0; i < n; ++i)
        fp_add(&e->fp, out + i * e->fp.nl, a + i * e->fp.nl,
               b + i * e->fp.nl);
}

void fp_sub_arrays(const ext_ctx *e, u64 *out, const u64 *a, const u64 *b,
                   long n)
{
    for (long i = 0; i < n; ++i)
        fp_sub(&e->fp, out + i * e->fp.nl, a + i * e->fp.nl,
               b + i * e->fp.nl);
}

void fp_mul_scalar_sub_mul(const ext_ctx *e, u64 *out, const u64 *a,
                           const u64 *b, const u64 *cc, const u64 *zinv,
                           long n)
{
    /* out = (a*b - cc) * zinv */
    const fp_ctx *c = &e->fp;
    u64 t[MAX_LIMBS];
    for (long i = 0; i < n; ++i) {
        fp_montmul(c, t, a + i * c->nl, b + i * c->nl);
        fp_sub(c, t, t, cc + i * c->nl);
        fp_montmul(c, out + i * c->nl, t, zinv);
    }
}


/* -- BW6-761 Tate pairing (direct sextic Fq6 = Fq[w]/(w^6 - xi)) -----------
 *
 * Independent implementation of the host oracle's algorithm
 * (zecale_tpu/pairing/host_pairing.py): Tate pairing with the Miller loop
 * over G1 and denominator elimination; G2 coords (in Fq, M-type untwist by
 * w^-2 / w^-3) land at sparse sextic positions 4 / 3 scaled by xi^-1, so
 * every line is a 3-sparse Fq6 element and f*l costs 18 base muls.
 *
 * The G1 double-and-add chain is computed FIRST in Jacobian form, batch
 * normalized (one inversion), and all line slopes produced with a second
 * batched inversion — no per-step Fermat inversions.
 */

typedef struct {
    u64 xt[MAX_LIMBS], yt[MAX_LIMBS]; /* affine T before the step */
    u64 lam[MAX_LIMBS];               /* line slope */
    uint8_t is_add;
    uint8_t skip;                     /* vertical line (omitted) */
} miller_step;

static void fq_batch_inverse(const fp_ctx *c, u64 *vals, long n,
                             const u64 *exp, int explimbs, const u64 *one_m)
{
    /* in-place inversion of n field elements (zero entries pass through) */
    u64 *pref = (u64 *)malloc((size_t)(n + 1) * c->nl * sizeof(u64));
    memcpy(pref, one_m, c->nl * sizeof(u64));
    for (long i = 0; i < n; ++i) {
        const u64 *v = vals + (size_t)i * c->nl;
        int z = 1;
        for (int j = 0; j < c->nl; ++j)
            if (v[j]) { z = 0; break; }
        if (z)
            memcpy(pref + (size_t)(i + 1) * c->nl, pref + (size_t)i * c->nl,
                   c->nl * sizeof(u64));
        else
            fp_montmul(c, pref + (size_t)(i + 1) * c->nl,
                       pref + (size_t)i * c->nl, v);
    }
    /* Fermat on the total product */
    u64 acc[MAX_LIMBS];
    {
        const u64 *base = pref + (size_t)n * c->nl;
        memcpy(acc, one_m, c->nl * sizeof(u64));
        int top = explimbs * 64 - 1;
        while (top >= 0 && !((exp[top / 64] >> (top % 64)) & 1))
            --top;
        for (int b = top; b >= 0; --b) {
            fp_montmul(c, acc, acc, acc);
            if ((exp[b / 64] >> (b % 64)) & 1)
                fp_montmul(c, acc, acc, base);
        }
    }
    for (long i = n - 1; i >= 0; --i) {
        u64 *v = vals + (size_t)i * c->nl;
        int z = 1;
        for (int j = 0; j < c->nl; ++j)
            if (v[j]) { z = 0; break; }
        if (z)
            continue;
        u64 vi[MAX_LIMBS];
        fp_montmul(c, vi, acc, pref + (size_t)i * c->nl);
        fp_montmul(c, acc, acc, v);
        memcpy(v, vi, c->nl * sizeof(u64));
    }
    free(pref);
}

/* The shared Miller-chain builder: walks the G1 double-and-add chain for
 * the group-order bits, batch-normalizes every intermediate T (ONE
 * Fermat), and produces all line slopes with a second batched inversion.
 * Returns the number of steps; steps[s] = {xt, yt, lam, is_add, skip}.
 * Used by both the BW6-761 (direct sextic) and BLS12-377 (sextic over
 * Fq2) Miller products. */
static long build_miller_steps(const curve_ctx *g1, const u64 *px,
                               const u64 *py, const uint8_t *r_bits,
                               int nbits, miller_step *steps, u64 *jac,
                               u64 *affs, uint8_t *ainf, u64 *dens,
                               const u64 *exp_p2, int exp_limbs,
                               const u64 *one_m)
{
    const fp_ctx *c = &g1->f.fp;
    int nl = c->nl;
    long ns = 0;
    u64 T[3 * MAX_LIMBS];
    memcpy(T, px, nl * sizeof(u64));
    memcpy(T + nl, py, nl * sizeof(u64));
    memcpy(T + 2 * nl, one_m, nl * sizeof(u64));
    for (int b = 1; b < nbits; ++b) {
        memcpy(jac + (size_t)ns * 3 * nl, T, 3 * nl * sizeof(u64));
        steps[ns].is_add = 0;
        ++ns;
        jac_dbl(g1, T, T + nl, T + 2 * nl);
        if (r_bits[b]) {
            memcpy(jac + (size_t)ns * 3 * nl, T, 3 * nl * sizeof(u64));
            steps[ns].is_add = 1;
            ++ns;
            jac_add_mixed(g1, T, T + nl, T + 2 * nl, px, py, one_m);
        }
    }
    jac_to_affine_batch(g1, affs, ainf, jac, ns, exp_p2, exp_limbs, one_m);
    for (long s = 0; s < ns; ++s) {
        u64 *xt = affs + (size_t)s * 2 * nl;
        u64 *yt = xt + nl;
        memcpy(steps[s].xt, xt, nl * sizeof(u64));
        memcpy(steps[s].yt, yt, nl * sizeof(u64));
        steps[s].skip = 0;
        if (ainf[s]) { /* T infinite: line degenerate, skip */
            steps[s].skip = 1;
            memset(dens + (size_t)s * nl, 0, nl * sizeof(u64));
            continue;
        }
        if (!steps[s].is_add) {
            fp_add(c, dens + (size_t)s * nl, yt, yt); /* 2y */
            int z = 1;
            for (int j = 0; j < nl; ++j)
                if (dens[(size_t)s * nl + j]) { z = 0; break; }
            if (z)
                steps[s].skip = 1; /* 2-torsion: vertical tangent */
        } else {
            u64 d[MAX_LIMBS];
            fp_sub(c, d, px, xt); /* x1 - xt */
            int z = 1;
            for (int j = 0; j < nl; ++j)
                if (d[j]) { z = 0; break; }
            if (z)
                steps[s].skip = 1; /* T == +-P: vertical chord */
            memcpy(dens + (size_t)s * nl, d, nl * sizeof(u64));
        }
    }
    fq_batch_inverse(c, dens, ns, exp_p2, exp_limbs, one_m);
    for (long s = 0; s < ns; ++s) {
        if (steps[s].skip)
            continue;
        u64 num[MAX_LIMBS];
        if (!steps[s].is_add) {
            u64 xx[MAX_LIMBS];
            fp_montmul(c, xx, steps[s].xt, steps[s].xt);
            fp_add(c, num, xx, xx);
            fp_add(c, num, num, xx); /* 3x^2 (a == 0) */
            if (!g1->a_is_zero)
                fp_add(c, num, num, g1->a_coeff);
        } else {
            fp_sub(c, num, py, steps[s].yt); /* y1 - yt */
        }
        fp_montmul(c, steps[s].lam, num, dens + (size_t)s * nl);
    }
    return ns;
}


/* f *= l where l = c0 + c3 w^3 + c4 w^4 (3-sparse sextic). */
static void fq6_mul_sparse034(const ext_ctx *e6, u64 *f, const u64 *c0,
                              const u64 *c3, const u64 *c4)
{
    const fp_ctx *c = &e6->fp;
    int nl = c->nl;
    u64 out[6][MAX_LIMBS], t[MAX_LIMBS];
    memset(out, 0, sizeof(out));
    const u64 *coeffs[3] = {c0, c3, c4};
    const int pos[3] = {0, 3, 4};
    for (int s = 0; s < 3; ++s)
        for (int i = 0; i < 6; ++i) {
            int d = i + pos[s];
            fp_montmul(c, t, f + (size_t)i * nl, coeffs[s]);
            if (d >= 6) {
                fp_montmul(c, t, t, e6->nr);
                d -= 6;
            }
            fp_add(c, out[d], out[d], t);
        }
    memcpy(f, out, 6 * nl * sizeof(u64));
}

/* prod_i e(P_i, Q_i) WITHOUT final exponentiation.
 * ps/qs: n affine pairs (2*nl u64 each); skip[i] nonzero -> pair omitted.
 * r_bits: the group order's bits MSB-first as a byte array of length nbits.
 * xi_inv_m: xi^{-1} Montgomery; a_g1: G1 curve a (Montgomery, usually 0).
 */
void bw6_miller_product(const ext_ctx *e6, const curve_ctx *g1,
                        const u64 *ps, const u64 *qs, const uint8_t *skip,
                        long n, const uint8_t *r_bits, int nbits,
                        const u64 *xi_inv_m, const u64 *exp_p2,
                        int exp_limbs, const u64 *one_m, u64 *out_f)
{
    const fp_ctx *c = &e6->fp;
    int nl = c->nl;
    long max_steps = 2L * nbits + 8;
    /* f = 1 */
    memset(out_f, 0, 6 * (size_t)nl * sizeof(u64));
    memcpy(out_f, one_m, nl * sizeof(u64));

    miller_step *steps = (miller_step *)malloc(
        (size_t)max_steps * sizeof(miller_step));
    u64 *jac = (u64 *)malloc((size_t)max_steps * 3 * nl * sizeof(u64));
    u64 *affs = (u64 *)malloc((size_t)max_steps * 2 * nl * sizeof(u64));
    uint8_t *ainf = (uint8_t *)malloc((size_t)max_steps);
    u64 *dens = (u64 *)malloc((size_t)max_steps * nl * sizeof(u64));

    for (long pi = 0; pi < n; ++pi) {
        if (skip && skip[pi])
            continue;
        const u64 *px = ps + (size_t)pi * 2 * nl;
        const u64 *py = px + nl;
        const u64 *qx = qs + (size_t)pi * 2 * nl;
        const u64 *qy = qx + nl;

        long ns = build_miller_steps(g1, px, py, r_bits, nbits, steps,
                                     jac, affs, ainf, dens, exp_p2,
                                     exp_limbs, one_m);
        (void)ns;
        /* phase B: per-pair f accumulation with sparse lines */
        u64 fpair[6 * MAX_LIMBS];
        memset(fpair, 0, 6 * (size_t)nl * sizeof(u64));
        memcpy(fpair, one_m, nl * sizeof(u64));
        long s = 0;
        for (int b = 1; b < nbits; ++b) {
            /* f = f^2 * l_dbl */
            emul(e6, fpair, fpair, fpair);
            if (!steps[s].skip) {
                u64 c0[MAX_LIMBS], c3[MAX_LIMBS], c4[MAX_LIMBS],
                    t[MAX_LIMBS];
                fp_montmul(c, t, steps[s].lam, steps[s].xt);
                fp_sub(c, c0, t, steps[s].yt); /* lam*xt - yt */
                fp_montmul(c, c3, qy, xi_inv_m);
                fp_montmul(c, t, steps[s].lam, qx);
                fp_montmul(c, t, t, xi_inv_m);
                u64 zero[MAX_LIMBS];
                memset(zero, 0, sizeof(zero));
                fp_sub(c, c4, zero, t); /* -lam*xq*xi^-1 */
                fq6_mul_sparse034(e6, fpair, c0, c3, c4);
            }
            ++s;
            if (r_bits[b]) {
                if (!steps[s].skip) {
                    u64 c0[MAX_LIMBS], c3[MAX_LIMBS], c4[MAX_LIMBS],
                        t[MAX_LIMBS];
                    fp_montmul(c, t, steps[s].lam, steps[s].xt);
                    fp_sub(c, c0, t, steps[s].yt);
                    fp_montmul(c, c3, qy, xi_inv_m);
                    fp_montmul(c, t, steps[s].lam, qx);
                    fp_montmul(c, t, t, xi_inv_m);
                    u64 zero[MAX_LIMBS];
                    memset(zero, 0, sizeof(zero));
                    fp_sub(c, c4, zero, t);
                    fq6_mul_sparse034(e6, fpair, c0, c3, c4);
                }
                ++s;
            }
        }
        emul(e6, out_f, out_f, fpair);
    }
    free(steps);
    free(jac);
    free(affs);
    free(ainf);
    free(dens);
}

/* out = f ^ exp over the extension (exp little-endian u64s). */
void ext_pow(const ext_ctx *e, u64 *out, const u64 *f, const u64 *exp,
             int explimbs, const u64 *one_m)
{
    epow(e, out, f, exp, explimbs, one_m);
}

/* -- generic Tate pairing with DENSE lines (MNT4-298 / MNT6-298) ----------
 *
 * For the MNT curves the full extension IS a direct binomial over Fq
 * (Fq4 = Fq[w]/(w^4 - 17), Fq6 = Fq[w]/(w^6 - 5): the tower generators
 * satisfy u = w^2 / v = w^2), so f rides the existing generic ext_ctx.
 * The untwisted G2 coordinates spread over several direct positions
 * (their lines are DENSE), so each line is assembled coefficient-wise
 * from a host-precomputed monomial placement table:
 *     x' = sum_j x_j * sx_j * w^{px_j},   y' = sum_j y_j * sy_j * w^{py_j}
 * and multiplied with a full emul.  The G1 chain is the shared
 * build_miller_steps.
 *
 * qs layout per pair: fg2_deg x-components then fg2_deg y-components,
 * nl u64 each.  px/py: positions in [0, k); sx/sy: Montgomery scales.
 */
void generic_miller_product(const ext_ctx *ek, const curve_ctx *g1,
                            const u64 *ps, const u64 *qs,
                            const uint8_t *skip, long n,
                            const uint8_t *r_bits, int nbits, int fg2_deg,
                            const int *px, const u64 *sx, const int *py,
                            const u64 *sy, const u64 *exp_p2,
                            int exp_limbs, const u64 *one_m, u64 *out_f)
{
    const fp_ctx *c = &ek->fp;
    int nl = c->nl;
    int k = ek->k;
    long max_steps = 2L * nbits + 8;
    memset(out_f, 0, (size_t)ek->ew * sizeof(u64));
    memcpy(out_f, one_m, nl * sizeof(u64));

    miller_step *steps = (miller_step *)malloc(
        (size_t)max_steps * sizeof(miller_step));
    u64 *jac = (u64 *)malloc((size_t)max_steps * 3 * nl * sizeof(u64));
    u64 *affs = (u64 *)malloc((size_t)max_steps * 2 * nl * sizeof(u64));
    uint8_t *ainf = (uint8_t *)malloc((size_t)max_steps);
    u64 *dens = (u64 *)malloc((size_t)max_steps * nl * sizeof(u64));

    for (long pi = 0; pi < n; ++pi) {
        if (skip && skip[pi])
            continue;
        const u64 *px_ = ps + (size_t)pi * 2 * nl;
        const u64 *py_ = px_ + nl;
        const u64 *qx = qs + (size_t)pi * 2 * fg2_deg * nl;
        const u64 *qy = qx + (size_t)fg2_deg * nl;

        long ns = build_miller_steps(g1, px_, py_, r_bits, nbits, steps,
                                     jac, affs, ainf, dens, exp_p2,
                                     exp_limbs, one_m);
        (void)ns;

        u64 fpair[MAX_EW];
        memset(fpair, 0, (size_t)ek->ew * sizeof(u64));
        memcpy(fpair, one_m, nl * sizeof(u64));
        long s = 0;
        for (int b = 1; b < nbits; ++b) {
            int reps = r_bits[b] ? 2 : 1;
            for (int a_ = 0; a_ < reps; ++a_) {
                if (a_ == 0)
                    esqr(ek, fpair, fpair);
                if (!steps[s].skip) {
                    u64 l[MAX_EW], t[MAX_LIMBS];
                    memset(l, 0, (size_t)ek->ew * sizeof(u64));
                    /* l0 = lam*xt - yt */
                    fp_montmul(c, t, steps[s].lam, steps[s].xt);
                    fp_sub(c, l, t, steps[s].yt);
                    for (int j = 0; j < fg2_deg; ++j) {
                        /* l[px_j] -= lam * x_j * sx_j */
                        fp_montmul(c, t, steps[s].lam, qx + (size_t)j * nl);
                        fp_montmul(c, t, t, sx + (size_t)j * nl);
                        fp_sub(c, l + (size_t)px[j] * nl,
                               l + (size_t)px[j] * nl, t);
                        /* l[py_j] += y_j * sy_j */
                        fp_montmul(c, t, qy + (size_t)j * nl,
                                   sy + (size_t)j * nl);
                        fp_add(c, l + (size_t)py[j] * nl,
                               l + (size_t)py[j] * nl, t);
                    }
                    emul(ek, fpair, fpair, l);
                }
                ++s;
            }
        }
        emul(ek, out_f, out_f, fpair);
    }
    free(steps);
    free(jac);
    free(affs);
    free(ainf);
    free(dens);
}

/* -- BLS12-377 Tate pairing (towered sextic Fq12 = Fq2[w]/(w^6 - u)) ------
 *
 * Two-level composition: the base of the sextic is Fq2 = Fq[u]/(u^2+5)
 * (the existing k=2 ext_ctx), and w^6 folds to the Fq2 generator u.  The
 * G1 Miller chain is SHARED with the BW6 path (build_miller_steps); only
 * the line placement differs: the D-type untwist multiplies G2 coords by
 * w^2 / w^3 (host_pairing.py: c = 1/w, untwist_x = w^2), so each line is
 * the 3-sparse element
 *     l = (lam*xt - yt)  +  (-lam * xq) w^2  +  (yq) w^3
 * with the w^2/w^3 coefficients in Fq2.
 */

typedef struct {
    ext_ctx fq2;            /* k=2 over fp */
    u64 nr2[2 * MAX_LIMBS]; /* w^6 = nr2 (an Fq2 element, Montgomery) */
} tow_ctx;

long tow_ctx_size(void) { return (long)sizeof(tow_ctx); }

void tow_init(tow_ctx *t, int nl, const u64 *mod, const u64 *r2, u64 n0inv,
              const u64 *qnr_mont, const u64 *nr2_mont)
{
    ext_init(&t->fq2, nl, mod, r2, n0inv, 2, qnr_mont);
    memcpy(t->nr2, nr2_mont, 2 * (size_t)nl * sizeof(u64));
}

/* schoolbook 6x6 over Fq2 with w^6 -> nr2 fold (36 Fq2 muls) */
static void tow_mul(const tow_ctx *t, u64 *o, const u64 *a, const u64 *b)
{
    const ext_ctx *e = &t->fq2;
    int w = e->ew; /* u64s per Fq2 element */
    u64 accl[6][2 * MAX_LIMBS], acch[6][2 * MAX_LIMBS],
        tmp[2 * MAX_LIMBS];
    memset(accl, 0, sizeof(accl));
    memset(acch, 0, sizeof(acch));
    for (int i = 0; i < 6; ++i)
        for (int j = 0; j < 6; ++j) {
            emul(e, tmp, a + (size_t)i * w, b + (size_t)j * w);
            if (i + j < 6)
                eadd(e, accl[i + j], accl[i + j], tmp);
            else
                eadd(e, acch[i + j - 6], acch[i + j - 6], tmp);
        }
    for (int i = 0; i < 6; ++i) {
        emul(e, tmp, acch[i], t->nr2);
        eadd(e, o + (size_t)i * w, accl[i], tmp);
    }
}

/* f *= l with l = c0 + c2 w^2 + c3 w^3 (c_i in Fq2). */
static void tow_mul_sparse023(const tow_ctx *t, u64 *f, const u64 *c0,
                              const u64 *c2, const u64 *c3)
{
    const ext_ctx *e = &t->fq2;
    int w = e->ew;
    u64 out[6][2 * MAX_LIMBS], tmp[2 * MAX_LIMBS];
    memset(out, 0, sizeof(out));
    const u64 *coeffs[3] = {c0, c2, c3};
    const int pos[3] = {0, 2, 3};
    for (int s = 0; s < 3; ++s)
        for (int i = 0; i < 6; ++i) {
            int d = i + pos[s];
            emul(e, tmp, f + (size_t)i * w, coeffs[s]);
            if (d >= 6) {
                emul(e, tmp, tmp, t->nr2);
                d -= 6;
            }
            eadd(e, out[d], out[d], tmp);
        }
    /* row stride of `out` is 2*MAX_LIMBS, not the element width w:
     * copy per coefficient */
    for (int i = 0; i < 6; ++i)
        memcpy(f + (size_t)i * w, out[i], (size_t)w * sizeof(u64));
}

/* out = f ^ exp over Fq12 (exp little-endian u64s; one12 = 1 in Fq12). */
void tow_pow(const tow_ctx *t, u64 *out, const u64 *f, const u64 *exp,
             int explimbs, const u64 *one12)
{
    int w12 = 12 * t->fq2.fp.nl;
    u64 acc[12 * MAX_LIMBS];
    memcpy(acc, one12, (size_t)w12 * sizeof(u64));
    int top = explimbs * 64 - 1;
    while (top >= 0 && !((exp[top / 64] >> (top % 64)) & 1))
        --top;
    for (int b = top; b >= 0; --b) {
        tow_mul(t, acc, acc, acc);
        if ((exp[b / 64] >> (b % 64)) & 1)
            tow_mul(t, acc, acc, f);
    }
    memcpy(out, acc, (size_t)w12 * sizeof(u64));
}

/* test exports */
void tow_mul_pub(const tow_ctx *t, u64 *o, const u64 *a, const u64 *b)
{
    tow_mul(t, o, a, b);
}

void tow_sparse023_pub(const tow_ctx *t, u64 *f, const u64 *c0,
                       const u64 *c2, const u64 *c3)
{
    tow_mul_sparse023(t, f, c0, c2, c3);
}

/* prod_i f_{r,P_i}(psi(Q_i)) WITHOUT final exponentiation.
 * ps: n G1 affine pairs (2*nl u64); qs: n G2 affine pairs with Fq2
 * coords (4*nl u64: x0 x1 y0 y1); out_f: 12*nl u64. */
void bls_miller_product(const tow_ctx *tw, const curve_ctx *g1,
                        const u64 *ps, const u64 *qs, const uint8_t *skip,
                        long n, const uint8_t *r_bits, int nbits,
                        const u64 *exp_p2, int exp_limbs,
                        const u64 *one_m, u64 *out_f)
{
    const fp_ctx *c = &tw->fq2.fp;
    int nl = c->nl;
    int w2 = 2 * nl;
    long max_steps = 2L * nbits + 8;
    memset(out_f, 0, 12 * (size_t)nl * sizeof(u64));
    memcpy(out_f, one_m, nl * sizeof(u64));

    miller_step *steps = (miller_step *)malloc(
        (size_t)max_steps * sizeof(miller_step));
    u64 *jac = (u64 *)malloc((size_t)max_steps * 3 * nl * sizeof(u64));
    u64 *affs = (u64 *)malloc((size_t)max_steps * 2 * nl * sizeof(u64));
    uint8_t *ainf = (uint8_t *)malloc((size_t)max_steps);
    u64 *dens = (u64 *)malloc((size_t)max_steps * nl * sizeof(u64));

    for (long pi = 0; pi < n; ++pi) {
        if (skip && skip[pi])
            continue;
        const u64 *px = ps + (size_t)pi * 2 * nl;
        const u64 *py = px + nl;
        const u64 *qx = qs + (size_t)pi * 4 * nl; /* (x0, x1) */
        const u64 *qy = qx + w2;                  /* (y0, y1) */

        long ns = build_miller_steps(g1, px, py, r_bits, nbits, steps,
                                     jac, affs, ainf, dens, exp_p2,
                                     exp_limbs, one_m);
        (void)ns;

        u64 fpair[12 * MAX_LIMBS];
        memset(fpair, 0, 12 * (size_t)nl * sizeof(u64));
        memcpy(fpair, one_m, nl * sizeof(u64));
        long s = 0;
        for (int b = 1; b < nbits; ++b) {
            int reps = r_bits[b] ? 2 : 1;
            for (int a_ = 0; a_ < reps; ++a_) {
                if (a_ == 0) /* f = f^2 before the doubling line */
                    tow_mul(tw, fpair, fpair, fpair);
                if (!steps[s].skip) {
                    u64 c0[2 * MAX_LIMBS], c2[2 * MAX_LIMBS],
                        c3[2 * MAX_LIMBS], t[MAX_LIMBS],
                        zero[MAX_LIMBS];
                    memset(zero, 0, sizeof(zero));
                    /* c0 = lam*xt - yt (Fq, embedded in the c0 lane) */
                    memset(c0, 0, sizeof(c0));
                    fp_montmul(c, t, steps[s].lam, steps[s].xt);
                    fp_sub(c, c0, t, steps[s].yt);
                    /* c2 = -lam * xq (componentwise over Fq2) */
                    fp_montmul(c, t, steps[s].lam, qx);
                    fp_sub(c, c2, zero, t);
                    fp_montmul(c, t, steps[s].lam, qx + nl);
                    fp_sub(c, c2 + nl, zero, t);
                    /* c3 = yq */
                    memcpy(c3, qy, (size_t)w2 * sizeof(u64));
                    tow_mul_sparse023(tw, fpair, c0, c2, c3);
                }
                ++s;
            }
        }
        tow_mul(tw, out_f, out_f, fpair);
    }
    free(steps);
    free(jac);
    free(affs);
    free(ainf);
    free(dens);
}
