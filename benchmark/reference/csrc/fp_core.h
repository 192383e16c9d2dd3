/* Shared Montgomery field core for the native engines.
 *
 * Conventions (same as witness_engine.c round 1):
 *   - field elements are little-endian uint64 limb vectors of fixed length
 *     fp_ctx.nl (<= MAX_LIMBS), Montgomery form unless stated otherwise;
 *   - contexts are caller-allocated opaque buffers (fp_ctx_size()).
 *
 * Replaces libff's GMP-backed Fp for host-side bulk work (SURVEY.md
 * section 2b) — independent implementation (CIOS multiplication).
 */
#ifndef ZECALE_FP_CORE_H
#define ZECALE_FP_CORE_H

#include <stdint.h>
#include <string.h>

typedef uint64_t u64;
typedef unsigned __int128 u128;

#define MAX_LIMBS 12 /* up to 768-bit moduli (BW6-761) */

typedef struct {
    int nl;
    u64 mod[MAX_LIMBS];
    u64 r2[MAX_LIMBS];
    u64 n0inv;
} fp_ctx;

static inline int fp_geq(const fp_ctx *c, const u64 *a, const u64 *b)
{
    for (int i = c->nl - 1; i >= 0; --i) {
        if (a[i] > b[i])
            return 1;
        if (a[i] < b[i])
            return 0;
    }
    return 1;
}

static inline void fp_sub_nocarry(const fp_ctx *c, u64 *out, const u64 *a,
                                  const u64 *b)
{
    u128 borrow = 0;
    for (int i = 0; i < c->nl; ++i) {
        u128 d = (u128)a[i] - b[i] - borrow;
        out[i] = (u64)d;
        borrow = (d >> 64) ? 1 : 0;
    }
}

static inline void fp_add(const fp_ctx *c, u64 *out, const u64 *a,
                          const u64 *b)
{
    u128 carry = 0;
    for (int i = 0; i < c->nl; ++i) {
        u128 s = (u128)a[i] + b[i] + carry;
        out[i] = (u64)s;
        carry = s >> 64;
    }
    if (carry || fp_geq(c, out, c->mod))
        fp_sub_nocarry(c, out, out, c->mod);
}

static inline void fp_sub(const fp_ctx *c, u64 *out, const u64 *a,
                          const u64 *b)
{
    u64 tmp[MAX_LIMBS];
    u128 borrow = 0;
    for (int i = 0; i < c->nl; ++i) {
        u128 d = (u128)a[i] - b[i] - borrow;
        tmp[i] = (u64)d;
        borrow = (d >> 64) ? 1 : 0;
    }
    if (borrow) {
        u128 carry = 0;
        for (int i = 0; i < c->nl; ++i) {
            u128 s = (u128)tmp[i] + c->mod[i] + carry;
            tmp[i] = (u64)s;
            carry = s >> 64;
        }
    }
    memcpy(out, tmp, c->nl * sizeof(u64));
}

/* CIOS Montgomery multiplication. */
static inline void fp_montmul(const fp_ctx *c, u64 *out, const u64 *a,
                              const u64 *b)
{
    int nl = c->nl;
    u64 t[MAX_LIMBS + 2];
    memset(t, 0, sizeof(t));
    for (int i = 0; i < nl; ++i) {
        u128 carry = 0;
        u64 ai = a[i];
        for (int j = 0; j < nl; ++j) {
            u128 s = (u128)t[j] + (u128)ai * b[j] + carry;
            t[j] = (u64)s;
            carry = s >> 64;
        }
        u128 s = (u128)t[nl] + carry;
        t[nl] = (u64)s;
        t[nl + 1] = (u64)(s >> 64);

        u64 m = t[0] * c->n0inv;
        carry = ((u128)t[0] + (u128)m * c->mod[0]) >> 64;
        for (int j = 1; j < nl; ++j) {
            u128 s2 = (u128)t[j] + (u128)m * c->mod[j] + carry;
            t[j - 1] = (u64)s2;
            carry = s2 >> 64;
        }
        s = (u128)t[nl] + carry;
        t[nl - 1] = (u64)s;
        t[nl] = t[nl + 1] + (u64)(s >> 64);
    }
    if (t[nl] || fp_geq(c, t, c->mod))
        fp_sub_nocarry(c, t, t, c->mod);
    memcpy(out, t, nl * sizeof(u64));
}

static inline int fp_is_zero(const fp_ctx *c, const u64 *a)
{
    for (int i = 0; i < c->nl; ++i)
        if (a[i])
            return 0;
    return 1;
}

#endif /* ZECALE_FP_CORE_H */
