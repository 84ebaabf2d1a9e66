/* Copy of tendermint_tpu/native/ed25519_batch.c for the port's CPU plane (tendermint_tpu_torch/native), with two additions at its end: tm_ed25519_basemul and tm_sr25519_challenge_batch. */
/* Batched ed25519 verification via the random-linear-combination batch
 * equation — the CPU-fallback analog of the reference's curve25519-voi
 * batch verifier (reference: crypto/ed25519/ed25519.go:202-237, which
 * wraps voi's ed25519.VerifyBatch).
 *
 * The kernel checks, for terms
 *
 *   zb*B  +  sum a_i * (-A_i)  +  sum z_i * (-R_i)
 *   where   zb  = sum z_i*s_i mod L,  a_i = z_i*k_i mod L,
 *           z_i = 128-bit random,     k_i = SHA512(R|A|M) mod L
 *
 * (tm_ed25519_verify_full computes the hashes and mod-L products
 * natively; the older tm_*_batch_verify entries take them
 * precomputed — the sr25519 path still preps its merlin challenges in
 * Python),
 *
 * and the kernel answers whether [8] * (that sum) is the identity —
 * the cofactored (ZIP-215) batch equation. Field/point arithmetic
 * mirrors crypto/ed25519_math.py exactly (radix-2^51 limbs; unified
 * add-2008-hwcd-3 addition, complete for a=-1 and nonsquare d, so
 * small-order/mixed-order ZIP-215 points are handled identically).
 * Multi-scalar multiplication is Pippenger with 8-bit windows.
 *
 * Returns 1 = batch equation holds (every signature valid),
 *         0 = equation fails (caller falls back per-signature for the
 *             bitmap, like the reference does on batch failure),
 *        -1 = some encoding failed ZIP-215 decoding (caller falls
 *             back; the bad index is identified there).
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* IFMA path needs target-attribute + AVX-512 IFMA intrinsic support
 * (GCC >= 7, or clang); older toolchains must still compile the
 * scalar kernel rather than lose the whole library */
#if defined(__x86_64__) && \
    ((defined(__GNUC__) && !defined(__clang__) && __GNUC__ >= 7) || \
     (defined(__clang__) && __clang_major__ >= 7))
#define TM_HAVE_IFMA_BUILD 1
#include <immintrin.h>
#endif

typedef uint64_t fe[5];
typedef unsigned __int128 u128;

#define MASK51 0x7ffffffffffffULL

static const fe FE_D = {0x34dca135978a3ULL, 0x1a8283b156ebdULL, 0x5e7a26001c029ULL, 0x739c663a03cbbULL, 0x52036cee2b6ffULL};
static const fe FE_2D = {0x69b9426b2f159ULL, 0x35050762add7aULL, 0x3cf44c0038052ULL, 0x6738cc7407977ULL, 0x2406d9dc56dffULL};
static const fe FE_SQRTM1 = {0x61b274a0ea0b0ULL, 0x0d5a5fc8f189dULL, 0x7ef5e9cbd0c60ULL, 0x78595a6804c9eULL, 0x2b8324804fc1dULL};
static const fe FE_BX = {0x62d608f25d51aULL, 0x412a4b4f6592aULL, 0x75b7171a4b31dULL, 0x1ff60527118feULL, 0x216936d3cd6e5ULL};
static const fe FE_BY = {0x6666666666658ULL, 0x4ccccccccccccULL, 0x1999999999999ULL, 0x3333333333333ULL, 0x6666666666666ULL};
static const fe FE_BT = {0x68ab3a5b7dda3ULL, 0x00eea2a5eadbbULL, 0x2af8df483c27eULL, 0x332b375274732ULL, 0x67875f0fd78b7ULL};

static void fe_copy(fe r, const fe a) { memcpy(r, a, sizeof(fe)); }

static void fe_zero(fe r) { memset(r, 0, sizeof(fe)); }

static void fe_one(fe r) { fe_zero(r); r[0] = 1; }

static void fe_add(fe r, const fe a, const fe b) {
    for (int i = 0; i < 5; i++) r[i] = a[i] + b[i];
}

/* r = a - b, biased by 2p so limbs stay nonnegative (inputs < 2^52) */
static void fe_sub(fe r, const fe a, const fe b) {
    r[0] = a[0] + 0xfffffffffffdaULL - b[0];
    r[1] = a[1] + 0xffffffffffffeULL - b[1];
    r[2] = a[2] + 0xffffffffffffeULL - b[2];
    r[3] = a[3] + 0xffffffffffffeULL - b[3];
    r[4] = a[4] + 0xffffffffffffeULL - b[4];
}

static void fe_neg(fe r, const fe a) {
    fe z;
    fe_zero(z);
    fe_sub(r, z, a);
}

static void fe_carry(fe r) {
    uint64_t c;
    c = r[0] >> 51; r[0] &= MASK51; r[1] += c;
    c = r[1] >> 51; r[1] &= MASK51; r[2] += c;
    c = r[2] >> 51; r[2] &= MASK51; r[3] += c;
    c = r[3] >> 51; r[3] &= MASK51; r[4] += c;
    c = r[4] >> 51; r[4] &= MASK51; r[0] += 19 * c;
    c = r[0] >> 51; r[0] &= MASK51; r[1] += c;
}

static void fe_mul(fe r, const fe a, const fe b) {
    u128 t0, t1, t2, t3, t4;
    uint64_t b1_19 = 19 * b[1], b2_19 = 19 * b[2], b3_19 = 19 * b[3],
             b4_19 = 19 * b[4];

    t0 = (u128)a[0] * b[0] + (u128)a[1] * b4_19 + (u128)a[2] * b3_19 +
         (u128)a[3] * b2_19 + (u128)a[4] * b1_19;
    t1 = (u128)a[0] * b[1] + (u128)a[1] * b[0] + (u128)a[2] * b4_19 +
         (u128)a[3] * b3_19 + (u128)a[4] * b2_19;
    t2 = (u128)a[0] * b[2] + (u128)a[1] * b[1] + (u128)a[2] * b[0] +
         (u128)a[3] * b4_19 + (u128)a[4] * b3_19;
    t3 = (u128)a[0] * b[3] + (u128)a[1] * b[2] + (u128)a[2] * b[1] +
         (u128)a[3] * b[0] + (u128)a[4] * b4_19;
    t4 = (u128)a[0] * b[4] + (u128)a[1] * b[3] + (u128)a[2] * b[2] +
         (u128)a[3] * b[1] + (u128)a[4] * b[0];

    uint64_t c;
    uint64_t r0 = (uint64_t)t0 & MASK51; c = (uint64_t)(t0 >> 51);
    t1 += c;
    uint64_t r1 = (uint64_t)t1 & MASK51; c = (uint64_t)(t1 >> 51);
    t2 += c;
    uint64_t r2 = (uint64_t)t2 & MASK51; c = (uint64_t)(t2 >> 51);
    t3 += c;
    uint64_t r3 = (uint64_t)t3 & MASK51; c = (uint64_t)(t3 >> 51);
    t4 += c;
    uint64_t r4 = (uint64_t)t4 & MASK51; c = (uint64_t)(t4 >> 51);
    r0 += 19 * c;
    c = r0 >> 51; r0 &= MASK51; r1 += c;
    r[0] = r0; r[1] = r1; r[2] = r2; r[3] = r3; r[4] = r4;
}

static void fe_sq(fe r, const fe a) { fe_mul(r, a, a); }

static uint64_t load64_le(const uint8_t *b) {
    uint64_t v = 0;
    for (int i = 7; i >= 0; i--) v = (v << 8) | b[i];
    return v;
}

/* 255 low bits of the encoding (bit 255 — the x sign — is dropped);
 * values >= p are fine: arithmetic is mod p (ZIP-215 non-canonical y) */
static void fe_frombytes(fe r, const uint8_t *s) {
    r[0] = load64_le(s) & MASK51;
    r[1] = (load64_le(s + 6) >> 3) & MASK51;
    r[2] = (load64_le(s + 12) >> 6) & MASK51;
    r[3] = (load64_le(s + 19) >> 1) & MASK51;
    r[4] = (load64_le(s + 24) >> 12) & MASK51;
}

/* canonical little-endian encoding (fully reduced mod p) */
static void fe_tobytes(uint8_t *s, const fe a) {
    fe t;
    fe_copy(t, a);
    fe_carry(t);
    fe_carry(t);
    /* q = whether t >= p, computed by propagating (t + 19) carries */
    uint64_t q = (t[0] + 19) >> 51;
    q = (t[1] + q) >> 51;
    q = (t[2] + q) >> 51;
    q = (t[3] + q) >> 51;
    q = (t[4] + q) >> 51;
    t[0] += 19 * q;
    uint64_t c;
    c = t[0] >> 51; t[0] &= MASK51; t[1] += c;
    c = t[1] >> 51; t[1] &= MASK51; t[2] += c;
    c = t[2] >> 51; t[2] &= MASK51; t[3] += c;
    c = t[3] >> 51; t[3] &= MASK51; t[4] += c;
    t[4] &= MASK51;
    uint64_t w0 = t[0] | (t[1] << 51);
    uint64_t w1 = (t[1] >> 13) | (t[2] << 38);
    uint64_t w2 = (t[2] >> 26) | (t[3] << 25);
    uint64_t w3 = (t[3] >> 39) | (t[4] << 12);
    memcpy(s, &w0, 8);
    memcpy(s + 8, &w1, 8);
    memcpy(s + 16, &w2, 8);
    memcpy(s + 24, &w3, 8);
}

static int fe_iszero(const fe a) {
    uint8_t s[32];
    fe_tobytes(s, a);
    uint8_t acc = 0;
    for (int i = 0; i < 32; i++) acc |= s[i];
    return acc == 0;
}

static int fe_eq(const fe a, const fe b) {
    fe d;
    fe_sub(d, a, b);
    return fe_iszero(d);
}

static void fe_sqn(fe r, const fe a, int n) {
    fe_sq(r, a);
    for (int i = 1; i < n; i++) fe_sq(r, r);
}

/* a^(2^252 - 3): the exponent in the combined sqrt/division trick
 * ((p-5)/8), via the standard 2^k-1 addition chain (251 squarings +
 * ~12 multiplies — decompression cost is dominated by this power). */
static void fe_pow2523(fe r, const fe z) {
    fe t0, t1, t2;
    fe_sq(t0, z);                  /* z^2 */
    fe_sqn(t1, t0, 2);
    fe_mul(t1, t1, z);             /* z^9 */
    fe_mul(t0, t1, t0);            /* z^11 */
    fe_sq(t0, t0);                 /* z^22 */
    fe_mul(t0, t0, t1);            /* z^31 = z^(2^5-1) */
    fe_sqn(t1, t0, 5);
    fe_mul(t0, t1, t0);            /* z^(2^10-1) */
    fe_sqn(t1, t0, 10);
    fe_mul(t1, t1, t0);            /* z^(2^20-1) */
    fe_sqn(t2, t1, 20);
    fe_mul(t1, t2, t1);            /* z^(2^40-1) */
    fe_sqn(t1, t1, 10);
    fe_mul(t0, t1, t0);            /* z^(2^50-1) */
    fe_sqn(t1, t0, 50);
    fe_mul(t1, t1, t0);            /* z^(2^100-1) */
    fe_sqn(t2, t1, 100);
    fe_mul(t1, t2, t1);            /* z^(2^200-1) */
    fe_sqn(t1, t1, 50);
    fe_mul(t0, t1, t0);            /* z^(2^250-1) */
    fe_sqn(t0, t0, 2);
    fe_mul(r, t0, z);              /* z^(2^252-3) */
}

/* ------------------------------------------------------------------
 * SHA-512 (FIPS 180-4) — the k = SHA512(R|A|M) challenge hashes, so
 * the whole ed25519 batch prep can run in one native call.
 * ------------------------------------------------------------------ */

static const uint64_t SHA512_K[80] = {
    0x428a2f98d728ae22ULL, 0x7137449123ef65cdULL, 0xb5c0fbcfec4d3b2fULL,
    0xe9b5dba58189dbbcULL, 0x3956c25bf348b538ULL, 0x59f111f1b605d019ULL,
    0x923f82a4af194f9bULL, 0xab1c5ed5da6d8118ULL, 0xd807aa98a3030242ULL,
    0x12835b0145706fbeULL, 0x243185be4ee4b28cULL, 0x550c7dc3d5ffb4e2ULL,
    0x72be5d74f27b896fULL, 0x80deb1fe3b1696b1ULL, 0x9bdc06a725c71235ULL,
    0xc19bf174cf692694ULL, 0xe49b69c19ef14ad2ULL, 0xefbe4786384f25e3ULL,
    0x0fc19dc68b8cd5b5ULL, 0x240ca1cc77ac9c65ULL, 0x2de92c6f592b0275ULL,
    0x4a7484aa6ea6e483ULL, 0x5cb0a9dcbd41fbd4ULL, 0x76f988da831153b5ULL,
    0x983e5152ee66dfabULL, 0xa831c66d2db43210ULL, 0xb00327c898fb213fULL,
    0xbf597fc7beef0ee4ULL, 0xc6e00bf33da88fc2ULL, 0xd5a79147930aa725ULL,
    0x06ca6351e003826fULL, 0x142929670a0e6e70ULL, 0x27b70a8546d22ffcULL,
    0x2e1b21385c26c926ULL, 0x4d2c6dfc5ac42aedULL, 0x53380d139d95b3dfULL,
    0x650a73548baf63deULL, 0x766a0abb3c77b2a8ULL, 0x81c2c92e47edaee6ULL,
    0x92722c851482353bULL, 0xa2bfe8a14cf10364ULL, 0xa81a664bbc423001ULL,
    0xc24b8b70d0f89791ULL, 0xc76c51a30654be30ULL, 0xd192e819d6ef5218ULL,
    0xd69906245565a910ULL, 0xf40e35855771202aULL, 0x106aa07032bbd1b8ULL,
    0x19a4c116b8d2d0c8ULL, 0x1e376c085141ab53ULL, 0x2748774cdf8eeb99ULL,
    0x34b0bcb5e19b48a8ULL, 0x391c0cb3c5c95a63ULL, 0x4ed8aa4ae3418acbULL,
    0x5b9cca4f7763e373ULL, 0x682e6ff3d6b2b8a3ULL, 0x748f82ee5defb2fcULL,
    0x78a5636f43172f60ULL, 0x84c87814a1f0ab72ULL, 0x8cc702081a6439ecULL,
    0x90befffa23631e28ULL, 0xa4506cebde82bde9ULL, 0xbef9a3f7b2c67915ULL,
    0xc67178f2e372532bULL, 0xca273eceea26619cULL, 0xd186b8c721c0c207ULL,
    0xeada7dd6cde0eb1eULL, 0xf57d4f7fee6ed178ULL, 0x06f067aa72176fbaULL,
    0x0a637dc5a2c898a6ULL, 0x113f9804bef90daeULL, 0x1b710b35131c471bULL,
    0x28db77f523047d84ULL, 0x32caab7b40c72493ULL, 0x3c9ebe0a15c9bebcULL,
    0x431d67c49c100d4cULL, 0x4cc5d4becb3e42b6ULL, 0x597f299cfc657e2aULL,
    0x5fcb6fab3ad6faecULL, 0x6c44198c4a475817ULL,
};

#define ROR64(x, n) (((x) >> (n)) | ((x) << (64 - (n))))

static void sha512_block(uint64_t st[8], const uint8_t *p) {
    uint64_t w[80];
    for (int i = 0; i < 16; i++) {
        uint64_t v = 0;
        for (int j = 0; j < 8; j++) v = (v << 8) | p[i * 8 + j];
        w[i] = v;
    }
    for (int i = 16; i < 80; i++) {
        uint64_t s0 = ROR64(w[i - 15], 1) ^ ROR64(w[i - 15], 8) ^
                      (w[i - 15] >> 7);
        uint64_t s1 = ROR64(w[i - 2], 19) ^ ROR64(w[i - 2], 61) ^
                      (w[i - 2] >> 6);
        w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint64_t a = st[0], b = st[1], c = st[2], d = st[3], e = st[4],
             f = st[5], g = st[6], h = st[7];
    for (int i = 0; i < 80; i++) {
        uint64_t S1 = ROR64(e, 14) ^ ROR64(e, 18) ^ ROR64(e, 41);
        uint64_t ch = (e & f) ^ (~e & g);
        uint64_t t1 = h + S1 + ch + SHA512_K[i] + w[i];
        uint64_t S0 = ROR64(a, 28) ^ ROR64(a, 34) ^ ROR64(a, 39);
        uint64_t mj = (a & b) ^ (a & c) ^ (b & c);
        uint64_t t2 = S0 + mj;
        h = g; g = f; f = e; e = d + t1;
        d = c; c = b; b = a; a = t1 + t2;
    }
    st[0] += a; st[1] += b; st[2] += c; st[3] += d;
    st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

/* digest64 = SHA-512 of the concatenation of up to three chunks */
static void sha512_3(uint8_t out[64], const uint8_t *c1, size_t n1,
                     const uint8_t *c2, size_t n2, const uint8_t *c3,
                     size_t n3) {
    uint64_t st[8] = {
        0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL,
        0x3c6ef372fe94f82bULL, 0xa54ff53a5f1d36f1ULL,
        0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
        0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL,
    };
    uint8_t buf[128];
    size_t fill = 0;
    uint64_t total = 0;
    const uint8_t *chunks[3] = {c1, c2, c3};
    size_t lens[3] = {n1, n2, n3};
    for (int c = 0; c < 3; c++) {
        const uint8_t *p = chunks[c];
        size_t n = lens[c];
        total += n;
        while (n) {
            size_t take = 128 - fill;
            if (take > n) take = n;
            memcpy(buf + fill, p, take);
            fill += take;
            p += take;
            n -= take;
            if (fill == 128) {
                sha512_block(st, buf);
                fill = 0;
            }
        }
    }
    /* padding: 0x80, zeros, 128-bit big-endian bit length */
    buf[fill++] = 0x80;
    if (fill > 112) {
        memset(buf + fill, 0, 128 - fill);
        sha512_block(st, buf);
        fill = 0;
    }
    memset(buf + fill, 0, 128 - fill);
    uint64_t bits = total * 8;
    for (int j = 0; j < 8; j++)
        buf[120 + j] = (uint8_t)(bits >> (8 * (7 - j)));
    sha512_block(st, buf);
    for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++)
            out[i * 8 + j] = (uint8_t)(st[i] >> (8 * (7 - j)));
}

/* ------------------------------------------------------------------
 * Scalar arithmetic mod L = 2^252 + delta (delta < 2^125), for the
 * host-prep offload: k = digest mod L, a = z*k mod L, zb = sum z*s.
 * Reduction is Barrett with MU = floor(2^512 / L): q = (x*MU) >> 512,
 * r = x - q*L, then at most two conditional subtracts (classic bound
 * r < 3L). Differential-tested against Python big-ints over random
 * and boundary inputs via the tm_sc_mod_l_test hook
 * (tests/test_crypto.py::test_native_scalar_and_sha512_building_blocks).
 * ------------------------------------------------------------------ */

/* L as 4x64 little-endian limbs */
static const uint64_t SC_L[4] = {
    0x5812631a5cf5d3edULL, 0x14def9dea2f79cd6ULL, 0x0000000000000000ULL,
    0x1000000000000000ULL,
};

static void sc4_frombytes(uint64_t r[4], const uint8_t *b) {
    for (int i = 0; i < 4; i++) r[i] = load64_le(b + 8 * i);
}

static void sc4_tobytes(uint8_t *b, const uint64_t r[4]) {
    for (int i = 0; i < 4; i++)
        for (int j = 0; j < 8; j++)
            b[8 * i + j] = (uint8_t)(r[i] >> (8 * j));
}

/* ge/lt over 4-limb little-endian */
static int sc4_gte(const uint64_t a[4], const uint64_t b[4]) {
    for (int i = 3; i >= 0; i--) {
        if (a[i] > b[i]) return 1;
        if (a[i] < b[i]) return 0;
    }
    return 1;
}

static void sc4_sub(uint64_t r[4], const uint64_t a[4],
                    const uint64_t b[4]) {
    unsigned __int128 borrow = 0;
    for (int i = 0; i < 4; i++) {
        unsigned __int128 d =
            (unsigned __int128)a[i] - b[i] - (uint64_t)borrow;
        r[i] = (uint64_t)d;
        borrow = (d >> 64) ? 1 : 0;
    }
}

/* generic little-endian multiply: r[na+nb] = a[na] * b[nb] */
static void sc_mul_nn(uint64_t *r, const uint64_t *a, int na,
                      const uint64_t *b, int nb) {
    memset(r, 0, (size_t)(na + nb) * 8);
    for (int i = 0; i < na; i++) {
        unsigned __int128 carry = 0;
        for (int j = 0; j < nb; j++) {
            unsigned __int128 cur = (unsigned __int128)a[i] * b[j] +
                                    r[i + j] + (uint64_t)carry;
            r[i + j] = (uint64_t)cur;
            carry = cur >> 64;
        }
        r[i + nb] += (uint64_t)carry;
    }
}

/* r(4 limbs, < L) = x (nx <= 8 limbs, little-endian, < 2^512) mod L.
 * Barrett reduction: q = floor(x * MU / 2^512) with
 * MU = floor(2^512 / L); r = x - q*L, then at most a few conditional
 * subtracts (classic bound r < 3L). Differential-tested against
 * Python big-ints over random and boundary inputs. */
static void sc_mod_l(uint64_t r[4], const uint64_t *x, int nx) {
    static const uint64_t MU[5] = {
        0xed9ce5a30a2c131bULL, 0x2106215d086329a7ULL,
        0xffffffffffffffebULL, 0xffffffffffffffffULL,
        0x000000000000000fULL,
    };
    uint64_t xs[8];
    memset(xs, 0, sizeof(xs));
    memcpy(xs, x, (size_t)nx * 8);
    uint64_t prod[13];
    sc_mul_nn(prod, xs, 8, MU, 5);        /* x * MU, 13 limbs */
    uint64_t q[5];
    memcpy(q, prod + 8, 5 * 8);           /* >> 512 */
    uint64_t ql[9];
    sc_mul_nn(ql, q, 5, SC_L, 4);         /* q * L */
    /* r = x - q*L: fits comfortably in 5 limbs (< 3L < 2^254) */
    uint64_t rem[8];
    unsigned __int128 borrow = 0;
    for (int i = 0; i < 8; i++) {
        unsigned __int128 d =
            (unsigned __int128)xs[i] - ql[i] - (uint64_t)borrow;
        rem[i] = (uint64_t)d;
        borrow = (d >> 64) ? 1 : 0;
    }
    while (sc4_gte(rem, SC_L)) sc4_sub(rem, rem, SC_L);
    memcpy(r, rem, 32);
}

/* r = a*b mod L (a: 4 limbs < L, b: nb limbs) */
static void sc_mulmod(uint64_t r[4], const uint64_t a[4],
                      const uint64_t *b, int nb) {
    uint64_t prod[8];
    memset(prod, 0, sizeof(prod));
    for (int i = 0; i < 4; i++) {
        unsigned __int128 carry = 0;
        for (int j = 0; j < nb; j++) {
            unsigned __int128 cur = (unsigned __int128)a[i] * b[j] +
                                    prod[i + j] + (uint64_t)carry;
            prod[i + j] = (uint64_t)cur;
            carry = cur >> 64;
        }
        int k = i + nb;
        while (carry) {
            unsigned __int128 cur =
                (unsigned __int128)prod[k] + (uint64_t)carry;
            prod[k] = (uint64_t)cur;
            carry = cur >> 64;
            k++;
        }
    }
    sc_mod_l(r, prod, 8);
}

static void sc_addmod(uint64_t r[4], const uint64_t a[4],
                      const uint64_t b[4]) {
    uint64_t sum[5];
    unsigned __int128 carry = 0;
    for (int i = 0; i < 4; i++) {
        unsigned __int128 cur =
            (unsigned __int128)a[i] + b[i] + (uint64_t)carry;
        sum[i] = (uint64_t)cur;
        carry = cur >> 64;
    }
    sum[4] = (uint64_t)carry;
    sc_mod_l(r, sum, 5);
}

/* ------------------------------------------------------------------
 * 8-way field exponentiation with AVX-512 IFMA (radix-2^52, 5 limbs,
 * one zmm register per limb holding 8 field elements). Only the
 * pow2523 chain — the dominant cost of point decompression — runs
 * vectorized; everything else stays scalar radix-2^51. Functions are
 * target-attributed so the binary stays runnable on non-AVX-512
 * hosts (runtime-gated via __builtin_cpu_supports).
 * ------------------------------------------------------------------ */

#define MASK52 0xfffffffffffffULL

/* canonical bytes -> radix-2^52 limbs */
static void fe52_frombytes(uint64_t l[5], const uint8_t *s) {
    l[0] = load64_le(s) & MASK52;
    l[1] = (load64_le(s + 6) >> 4) & MASK52;
    l[2] = load64_le(s + 13) & MASK52;
    l[3] = (load64_le(s + 19) >> 4) & MASK52;
    uint64_t top = 0;
    memcpy(&top, s + 26, 6); /* bits 208..255; input < p so < 2^47 */
    l[4] = top;
}

/* radix-2^52 limbs (each < 2^52) -> canonical bytes */
static void fe52_tobytes(uint8_t *s, const uint64_t l_in[5]) {
    uint64_t l[5];
    memcpy(l, l_in, sizeof(l));
    uint64_t c;
    c = l[0] >> 52; l[0] &= MASK52; l[1] += c;
    c = l[1] >> 52; l[1] &= MASK52; l[2] += c;
    c = l[2] >> 52; l[2] &= MASK52; l[3] += c;
    c = l[3] >> 52; l[3] &= MASK52; l[4] += c;
    /* top limb weight 2^208; bit 47 of it is bit 255 overall */
    c = l[4] >> 47; l[4] &= (1ULL << 47) - 1; l[0] += 19 * c;
    c = l[0] >> 52; l[0] &= MASK52; l[1] += c;
    /* conditional subtract p via the (t + 19) carry trick */
    uint64_t q = (l[0] + 19) >> 52;
    q = (l[1] + q) >> 52;
    q = (l[2] + q) >> 52;
    q = (l[3] + q) >> 52;
    q = (l[4] + q) >> 47;
    l[0] += 19 * q;
    c = l[0] >> 52; l[0] &= MASK52; l[1] += c;
    c = l[1] >> 52; l[1] &= MASK52; l[2] += c;
    c = l[2] >> 52; l[2] &= MASK52; l[3] += c;
    c = l[3] >> 52; l[3] &= MASK52; l[4] += c;
    l[4] &= (1ULL << 47) - 1;
    uint64_t w0 = l[0] | (l[1] << 52);
    uint64_t w1 = (l[1] >> 12) | (l[2] << 40);
    uint64_t w2 = (l[2] >> 24) | (l[3] << 28);
    uint64_t w3 = (l[3] >> 36) | (l[4] << 16);
    memcpy(s, &w0, 8);
    memcpy(s + 8, &w1, 8);
    memcpy(s + 16, &w2, 8);
    memcpy(s + 24, &w3, 8);
}

#ifdef TM_HAVE_IFMA_BUILD

typedef struct { __m512i l[5]; } fe8;

#define TM_IFMA_TARGET \
    __attribute__((target("avx512f,avx512ifma,avx512dq,avx512vl")))

/* r = a * b mod p over 8 lanes. Operand limbs must be < 2^52; output
 * limbs are masked < 2^52. Schoolbook into 10 accumulators via
 * vpmadd52{lo,hi}, then 2^260 = 608 (mod p) folding. */
TM_IFMA_TARGET static void fe8_mul(fe8 *r, const fe8 *a, const fe8 *b) {
    __m512i z = _mm512_setzero_si512();
    __m512i t[10];
    for (int k = 0; k < 10; k++) t[k] = z;
    for (int i = 0; i < 5; i++) {
        for (int j = 0; j < 5; j++) {
            t[i + j] = _mm512_madd52lo_epu64(t[i + j], a->l[i], b->l[j]);
            t[i + j + 1] =
                _mm512_madd52hi_epu64(t[i + j + 1], a->l[i], b->l[j]);
        }
    }
    const __m512i mask = _mm512_set1_epi64((long long)MASK52);
    const __m512i c608 = _mm512_set1_epi64(608); /* 2^260 mod p */
    /* carry the high half so its limbs fit madd52 operands */
    __m512i c;
    for (int k = 5; k < 9; k++) {
        c = _mm512_srli_epi64(t[k], 52);
        t[k] = _mm512_and_si512(t[k], mask);
        t[k + 1] = _mm512_add_epi64(t[k + 1], c);
    }
    c = _mm512_srli_epi64(t[9], 52); /* weight 2^520 = 608^2 mod p */
    t[9] = _mm512_and_si512(t[9], mask);
    t[0] = _mm512_add_epi64(
        t[0], _mm512_mullo_epi64(c, _mm512_set1_epi64(608 * 608)));
    /* fold t[5..9] into t[0..4]: value += 608 * t[5+j] * 2^(52j) */
    for (int j = 0; j < 5; j++) {
        t[j] = _mm512_madd52lo_epu64(t[j], t[5 + j], c608);
        if (j < 4)
            t[j + 1] = _mm512_madd52hi_epu64(t[j + 1], t[5 + j], c608);
    }
    /* hi of 608*t[9] has weight 2^260 again: one more 608 fold */
    __m512i h = _mm512_madd52hi_epu64(z, t[9], c608);
    t[0] = _mm512_madd52lo_epu64(t[0], h, c608);
    /* Two carry passes, FOLD-FIRST ordering: reduce t4's overflow into
     * t0 before t0's own carry is computed, then run the chain down to
     * t4 (which only receives t3's small carry and is NOT re-folded in
     * the same pass). This makes the bound provable: after pass 1 all
     * limbs < 2^56-ish shrink to t0<2^52+2^14, t1..t3 masked, t4<2^48;
     * after pass 2 every limb is strictly < 2^52 — the operand bound
     * vpmadd52 requires (it reads only the low 52 bits). A mask-last
     * ordering would leave t0 <= 2^52+18 reachable in theory. */
    const __m512i mask47 = _mm512_set1_epi64((1LL << 47) - 1);
    const __m512i c19 = _mm512_set1_epi64(19);
    for (int pass = 0; pass < 2; pass++) {
        c = _mm512_srli_epi64(t[4], 47); /* bit 255 boundary */
        t[4] = _mm512_and_si512(t[4], mask47);
        t[0] = _mm512_add_epi64(t[0], _mm512_mullo_epi64(c, c19));
        for (int k = 0; k < 4; k++) {
            c = _mm512_srli_epi64(t[k], 52);
            t[k] = _mm512_and_si512(t[k], mask);
            t[k + 1] = _mm512_add_epi64(t[k + 1], c);
        }
    }
    for (int k = 0; k < 5; k++) r->l[k] = t[k];
}

TM_IFMA_TARGET static void fe8_sqn(fe8 *r, int n) {
    for (int i = 0; i < n; i++) fe8_mul(r, r, r);
}

/* the fe_pow2523 addition chain, 8 lanes at once */
TM_IFMA_TARGET static void fe8_pow2523(fe8 *r, const fe8 *zin) {
    fe8 z = *zin, t0, t1, t2;
    fe8_mul(&t0, &z, &z);               /* z^2 */
    t1 = t0;
    fe8_sqn(&t1, 2);
    fe8_mul(&t1, &t1, &z);              /* z^9 */
    fe8_mul(&t0, &t1, &t0);             /* z^11 */
    fe8_mul(&t0, &t0, &t0);             /* z^22 */
    fe8_mul(&t0, &t0, &t1);             /* z^31 */
    t1 = t0;
    fe8_sqn(&t1, 5);
    fe8_mul(&t0, &t1, &t0);             /* z^(2^10-1) */
    t1 = t0;
    fe8_sqn(&t1, 10);
    fe8_mul(&t1, &t1, &t0);             /* z^(2^20-1) */
    t2 = t1;
    fe8_sqn(&t2, 20);
    fe8_mul(&t1, &t2, &t1);             /* z^(2^40-1) */
    fe8_sqn(&t1, 10);
    fe8_mul(&t0, &t1, &t0);             /* z^(2^50-1) */
    t1 = t0;
    fe8_sqn(&t1, 50);
    fe8_mul(&t1, &t1, &t0);             /* z^(2^100-1) */
    t2 = t1;
    fe8_sqn(&t2, 100);
    fe8_mul(&t1, &t2, &t1);             /* z^(2^200-1) */
    fe8_sqn(&t1, 50);
    fe8_mul(&t0, &t1, &t0);             /* z^(2^250-1) */
    fe8_sqn(&t0, 2);
    fe8_mul(r, &t0, &z);                /* z^(2^252-3) */
}

/* vals[0..7] (radix-51) -> pow2523 of each, in place */
TM_IFMA_TARGET static void pow2523_x8(fe *vals) {
    uint64_t limbs[8][5];
    uint8_t buf[32];
    for (int e = 0; e < 8; e++) {
        fe_tobytes(buf, vals[e]);
        fe52_frombytes(limbs[e], buf);
    }
    fe8 x;
    for (int k = 0; k < 5; k++) {
        uint64_t lane[8];
        for (int e = 0; e < 8; e++) lane[e] = limbs[e][k];
        x.l[k] = _mm512_loadu_si512((const void *)lane);
    }
    fe8 out;
    fe8_pow2523(&out, &x);
    for (int k = 0; k < 5; k++) {
        uint64_t lane[8];
        _mm512_storeu_si512((void *)lane, out.l[k]);
        for (int e = 0; e < 8; e++) limbs[e][k] = lane[e];
    }
    for (int e = 0; e < 8; e++) {
        fe52_tobytes(buf, limbs[e]);
        fe_frombytes(vals[e], buf);
    }
}

static int have_ifma(void) {
    static int cached = -1;
    if (cached < 0) {
        const char *off = getenv("TM_TPU_NO_IFMA");
        cached = !(off && off[0]) &&
                 __builtin_cpu_supports("avx512ifma") &&
                 __builtin_cpu_supports("avx512f") &&
                 __builtin_cpu_supports("avx512dq");
    }
    return cached;
}

#else /* !TM_HAVE_IFMA_BUILD */

static int have_ifma(void) { return 0; }

static void pow2523_x8(fe *vals) { (void)vals; }

#endif

/* pow2523 over an array: IFMA 8-way where possible, scalar remainder */
static void pow2523_many(fe *vals, size_t n) {
    size_t i = 0;
    if (have_ifma())
        for (; i + 8 <= n; i += 8) pow2523_x8(vals + i);
    for (; i < n; i++) fe_pow2523(vals[i], vals[i]);
}

/* extended (twisted Edwards) coordinates, mirrors ed25519_math.Point */
typedef struct { fe X, Y, Z, T; } ge;

static void ge_identity(ge *r) {
    fe_zero(r->X);
    fe_one(r->Y);
    fe_one(r->Z);
    fe_zero(r->T);
}

/* unified add-2008-hwcd-3 (complete for a=-1, d nonsquare — same
 * formula as ed25519_math.point_add, valid for P==Q and small order) */
static void ge_add(ge *r, const ge *p, const ge *q) {
    fe a, b, c, d, e, f, g, h, t1, t2;
    fe_sub(t1, p->Y, p->X);
    fe_sub(t2, q->Y, q->X);
    fe_carry(t1);
    fe_carry(t2);
    fe_mul(a, t1, t2);
    fe_add(t1, p->Y, p->X);
    fe_add(t2, q->Y, q->X);
    fe_mul(b, t1, t2);
    fe_mul(c, p->T, FE_2D);
    fe_mul(c, c, q->T);
    fe_mul(d, p->Z, q->Z);
    fe_add(d, d, d);
    fe_sub(e, b, a);
    fe_sub(f, d, c);
    fe_add(g, d, c);
    fe_add(h, b, a);
    fe_carry(e);
    fe_carry(f);
    fe_carry(g);
    fe_carry(h);
    fe_mul(r->X, e, f);
    fe_mul(r->Y, g, h);
    fe_mul(r->Z, f, g);
    fe_mul(r->T, e, h);
}

/* Cached-operand form of a Z=1 point (decoded/negated terms and the
 * basepoint all have Z=1): q_cached = (Y-X, Y+X, 2d*T). Addition
 * against it costs 7 muls instead of 9 — same hwcd-3 formula with the
 * two operand-prep muls and the Z2 mul hoisted out (Dv = 2*Z1). */
typedef struct { fe YmX, YpX, T2d; } ge_cached;

static void ge_to_cached(ge_cached *c, const ge *p) {
    fe_sub(c->YmX, p->Y, p->X);
    fe_carry(c->YmX);
    fe_add(c->YpX, p->Y, p->X);
    fe_carry(c->YpX);
    fe_mul(c->T2d, p->T, FE_2D);
}

static void ge_add_cached(ge *r, const ge *p, const ge_cached *q) {
    fe a, b, c, d, e, f, g, h, t1;
    fe_sub(t1, p->Y, p->X);
    fe_carry(t1);
    fe_mul(a, t1, q->YmX);
    fe_add(t1, p->Y, p->X);
    fe_mul(b, t1, q->YpX);
    fe_mul(c, p->T, q->T2d);
    fe_add(d, p->Z, p->Z);       /* Z2 == 1 */
    fe_carry(d);
    fe_sub(e, b, a);
    fe_sub(f, d, c);
    fe_add(g, d, c);
    fe_add(h, b, a);
    fe_carry(e);
    fe_carry(f);
    fe_carry(g);
    fe_carry(h);
    fe_mul(r->X, e, f);
    fe_mul(r->Y, g, h);
    fe_mul(r->Z, f, g);
    fe_mul(r->T, e, h);
}

/* dbl-2008-hwcd, mirrors ed25519_math.point_double */
static void ge_dbl(ge *r, const ge *p) {
    fe a, b, c, h, e, g, f, t;
    fe_sq(a, p->X);
    fe_sq(b, p->Y);
    fe_sq(c, p->Z);
    fe_add(c, c, c);
    fe_carry(c);
    fe_add(h, a, b);
    fe_carry(h);
    fe_add(t, p->X, p->Y);
    fe_carry(t);
    fe_sq(t, t);
    fe_sub(e, h, t);
    fe_sub(g, a, b);
    fe_add(f, c, g);
    fe_carry(e);
    fe_carry(g);
    fe_carry(f);
    fe_mul(r->X, e, f);
    fe_mul(r->Y, g, h);
    fe_mul(r->Z, f, g);
    fe_mul(r->T, e, h);
}

static void ge_neg(ge *r, const ge *p) {
    fe_neg(r->X, p->X);
    fe_carry(r->X);
    fe_copy(r->Y, p->Y);
    fe_copy(r->Z, p->Z);
    fe_neg(r->T, p->T);
    fe_carry(r->T);
}

/* ZIP-215 decompression, mirroring ed25519_math.decompress/_recover_x:
 * non-canonical y accepted (reduced mod p); x recovered via the
 * combined sqrt; "-0" (x == 0 with sign bit 1) rejected. Split into
 * prelude -> pow2523 -> finish so the dominant power can be computed
 * for 8 points at once (the IFMA batch path); the scalar wrapper at
 * the bottom preserves the one-shot form. */
static void zip215_pre(const uint8_t *s, fe u, fe v, fe powin) {
    fe y, y2, t;
    fe_frombytes(y, s);
    fe_sq(y2, y);
    fe_one(u);
    fe_sub(u, y2, u);
    fe_carry(u);                 /* u = y^2 - 1 */
    fe_mul(v, y2, FE_D);
    fe_one(t);
    fe_add(v, v, t);
    fe_carry(v);                 /* v = d*y^2 + 1 */
    fe_sq(t, v);
    fe_mul(t, t, v);             /* v^3 */
    fe_sq(powin, t);
    fe_mul(powin, powin, v);     /* v^7 */
    fe_mul(powin, powin, u);     /* u*v^7 */
}

static int zip215_fin(ge *r, const uint8_t *s, const fe u, const fe v,
                      const fe powed) {
    fe v3, x, vx2, y;
    int sign = s[31] >> 7;
    fe_sq(v3, v);
    fe_mul(v3, v3, v);           /* v^3 */
    fe_mul(x, powed, v3);
    fe_mul(x, x, u);             /* x = u*v^3*(u*v^7)^((p-5)/8) */

    fe_sq(vx2, x);
    fe_mul(vx2, vx2, v);         /* v*x^2 */
    if (!fe_eq(vx2, u)) {
        fe nu;
        fe_neg(nu, u);
        if (!fe_eq(vx2, nu)) return 0;  /* u/v is not a square */
        fe_mul(x, x, FE_SQRTM1);        /* now v*x^2 == u */
    }

    uint8_t xb[32];
    fe_tobytes(xb, x);
    int xzero = 1;
    for (int i = 0; i < 32; i++) xzero &= (xb[i] == 0);
    if (xzero && sign) return 0; /* "-0" rejected (RFC 8032 + ZIP-215) */
    if ((xb[0] & 1) != sign) {
        fe_neg(x, x);
        fe_carry(x);
    }
    fe_frombytes(y, s);
    fe_copy(r->X, x);
    fe_copy(r->Y, y);
    fe_one(r->Z);
    fe_mul(r->T, x, y);
    return 1;
}

/* uniform prelude/finish adapters so the batch driver can run the
 * pow2523 stage for the whole batch at once: slots a..d hold the
 * per-curve intermediates (zip215: a=u, b=v; ristretto: a=u1, b=u2,
 * c=v, d=vu) */
typedef struct { fe a, b, c, d; } pre_t;

static int zip215_pre2(const uint8_t *s, pre_t *p, fe powin) {
    zip215_pre(s, p->a, p->b, powin);
    return 1;
}

static int zip215_fin2(ge *r, const uint8_t *s, const pre_t *p,
                       const fe powed) {
    return zip215_fin(r, s, p->a, p->b, powed);
}

/* ristretto255 decode (RFC 9496 §4.3.1, mirrors crypto/ristretto.py
 * decode): canonical nonneg s -> extended point representative in 2E.
 * Split into prelude -> pow2523 -> finish like the ZIP-215 decoder;
 * the power input is vu^7 (sqrt_ratio with u=1: r = vu^3*(vu^7)^e). */
static int rist_pre(const uint8_t *bytes, fe u1, fe u2, fe v, fe vu,
                    fe powin) {
    fe s, one, ss, u2s, du1;
    uint8_t canon[32];
    fe_frombytes(s, bytes);
    fe_tobytes(canon, s);
    /* canonical: no high bit, value < p (re-encode matches), even */
    if ((bytes[31] & 0x80) || memcmp(canon, bytes, 32) != 0) return 0;
    if (bytes[0] & 1) return 0;
    fe_one(one);
    fe_sq(ss, s);
    fe_sub(u1, one, ss);
    fe_carry(u1);                /* 1 - s^2 */
    fe_add(u2, one, ss);
    fe_carry(u2);                /* 1 + s^2 */
    fe_sq(u2s, u2);
    fe_sq(du1, u1);
    fe_mul(du1, du1, FE_D);      /* D*u1^2 */
    fe_neg(v, du1);
    fe_carry(v);
    fe_sub(v, v, u2s);
    fe_carry(v);                 /* -D*u1^2 - u2^2 */
    fe_mul(vu, v, u2s);
    fe_sq(powin, vu);
    fe_mul(powin, powin, vu);    /* vu^3 */
    fe_sq(powin, powin);
    fe_mul(powin, powin, vu);    /* vu^7 */
    return 1;
}

static int rist_fin(ge *r, const uint8_t *bytes, const fe u1, const fe u2,
                    const fe v, const fe vu, const fe powed) {
    fe s, one, invsq, check, none, nonei, dx, dy, x, y, tt, s2;
    fe_frombytes(s, bytes);
    fe_one(one);
    fe_sq(invsq, vu);
    fe_mul(invsq, invsq, vu);    /* vu^3 */
    fe_mul(invsq, invsq, powed); /* vu^3*(vu^7)^((p-5)/8) */
    /* sqrt_ratio_m1(1, vu) checks (mirrors fe_sqrt_ratio_m1 u=1) */
    fe_sq(check, invsq);
    fe_mul(check, check, vu);    /* vu*r^2 */
    int correct = fe_eq(check, one);
    fe_neg(none, one);
    fe_carry(none);
    int flipped = fe_eq(check, none);
    fe_mul(nonei, none, FE_SQRTM1);
    int flipped_i = fe_eq(check, nonei);
    if (flipped || flipped_i) fe_mul(invsq, invsq, FE_SQRTM1);
    uint8_t ib[32];
    fe_tobytes(ib, invsq);
    if (ib[0] & 1) {             /* |r| */
        fe_neg(invsq, invsq);
        fe_carry(invsq);
    }
    int was_square = correct || flipped;
    fe_mul(dx, invsq, u2);
    fe_mul(dy, invsq, dx);
    fe_mul(dy, dy, v);
    fe_add(s2, s, s);
    fe_carry(s2);
    fe_mul(x, s2, dx);
    uint8_t xb[32];
    fe_tobytes(xb, x);
    if (xb[0] & 1) {             /* |x| */
        fe_neg(x, x);
        fe_carry(x);
    }
    fe_mul(y, u1, dy);
    fe_mul(tt, x, y);
    uint8_t tb[32];
    fe_tobytes(tb, tt);
    if (!was_square || (tb[0] & 1) || fe_iszero(y)) return 0;
    fe_copy(r->X, x);
    fe_copy(r->Y, y);
    fe_one(r->Z);
    fe_copy(r->T, tt);
    return 1;
}

static int rist_pre2(const uint8_t *s, pre_t *p, fe powin) {
    return rist_pre(s, p->a, p->b, p->c, p->d, powin);
}

static int rist_fin2(ge *r, const uint8_t *s, const pre_t *p,
                     const fe powed) {
    return rist_fin(r, s, p->a, p->b, p->c, p->d, powed);
}

/* ---- ristretto255 encode (RFC 9496 §4.3.2) -------------------------
 *
 * The inverse of rist_pre/rist_fin, needed by the sign/keygen path
 * (R = r*B and A = a*B leave the library as canonical 32-byte
 * encodings). Mirrors crypto/ristretto.py encode() — that Python
 * implementation is the differential oracle in the tests. */

/* 1/sqrt(a-d) = sqrt_ratio_m1(1, a-d) for a = -1, nonneg root
 * (value from crypto/ristretto.py _INVSQRT_A_MINUS_D) */
static const fe FE_INVSQRT_AMD = {
    0x0fdaa805d40eaULL, 0x2eb482e57d339ULL, 0x007610274bc58ULL,
    0x6510b613dc8ffULL, 0x786c8905cfaffULL};

static int fe_isneg(const fe a) {
    uint8_t b[32];
    fe_tobytes(b, a);
    return b[0] & 1;
}

/* r = |1/sqrt(v)| via sqrt_ratio_m1(1, v): r = v^3*(v^7)^((p-5)/8)
 * with the sqrt(-1) fixups; returns was_square. Single-shot form of
 * the inline sequence in rist_fin (which takes a batched power). */
static int fe_invsqrt(fe r, const fe v) {
    fe powin, powed, check, one, none, nonei;
    fe_sq(powin, v);
    fe_mul(powin, powin, v);     /* v^3 */
    fe_sq(powin, powin);
    fe_mul(powin, powin, v);     /* v^7 */
    fe_pow2523(powed, powin);
    fe_sq(r, v);
    fe_mul(r, r, v);             /* v^3 */
    fe_mul(r, r, powed);         /* v^3*(v^7)^((p-5)/8) */
    fe_sq(check, r);
    fe_mul(check, check, v);     /* v*r^2 */
    fe_one(one);
    int correct = fe_eq(check, one);
    fe_neg(none, one);
    fe_carry(none);
    int flipped = fe_eq(check, none);
    fe_mul(nonei, none, FE_SQRTM1);
    int flipped_i = fe_eq(check, nonei);
    if (flipped || flipped_i) fe_mul(r, r, FE_SQRTM1);
    if (fe_isneg(r)) {           /* |r| */
        fe_neg(r, r);
        fe_carry(r);
    }
    return correct || flipped;
}

static void rist_encode(uint8_t out[32], const ge *p) {
    fe u1, u2, t1, invsq, den1, den2, zinv, x, y, den_inv, tmp, s;
    fe_add(t1, p->Z, p->Y);
    fe_carry(t1);
    fe_sub(u1, p->Z, p->Y);
    fe_carry(u1);
    fe_mul(u1, t1, u1);          /* (Z+Y)(Z-Y) */
    fe_mul(u2, p->X, p->Y);
    fe_sq(tmp, u2);
    fe_mul(tmp, tmp, u1);        /* u1*u2^2 */
    fe_invsqrt(invsq, tmp);      /* square for every valid point */
    fe_mul(den1, invsq, u1);
    fe_mul(den2, invsq, u2);
    fe_mul(zinv, den1, den2);
    fe_mul(zinv, zinv, p->T);
    fe_mul(tmp, p->T, zinv);
    if (fe_isneg(tmp)) {         /* rotate */
        fe ix, iy;
        fe_mul(ix, p->X, FE_SQRTM1);
        fe_mul(iy, p->Y, FE_SQRTM1);
        fe_copy(x, iy);
        fe_copy(y, ix);
        fe_mul(den_inv, den1, FE_INVSQRT_AMD);
    } else {
        fe_copy(x, p->X);
        fe_copy(y, p->Y);
        fe_copy(den_inv, den2);
    }
    fe_mul(tmp, x, zinv);
    if (fe_isneg(tmp)) {
        fe_neg(y, y);
        fe_carry(y);
    }
    fe_sub(s, p->Z, y);
    fe_carry(s);
    fe_mul(s, den_inv, s);
    if (fe_isneg(s)) {           /* |s| */
        fe_neg(s, s);
        fe_carry(s);
    }
    fe_tobytes(out, s);
}

/* ---- decoded-point cache -------------------------------------------
 *
 * The reference caches 4096 expanded public keys for repeated
 * verification (crypto/ed25519/ed25519.go:50-56, curve25519-voi's
 * cache.Verifier): consensus re-verifies the same validator set every
 * height and light sync re-verifies the same ~150 keys per header, so
 * the decompression (dominated by the pow2523 sqrt) is pure rework.
 * Here the cache lives at the decode seam of the batch driver: A_i
 * (pubkey) slots consult it; R_i (nonce) slots never repeat and skip
 * it. Keyed by the EXACT 32-byte encoding plus a curve id — ZIP-215
 * accepts non-canonical encodings that decode differently from their
 * canonical forms, and the same bytes under the ristretto decoder give
 * an unrelated point, so both must be part of the identity.
 *
 * 4-way set-associative, 8192 sets (32768 entries, ~7.6 MB): a 10k
 * validator set loads the sets at lambda=1.22, where Poisson overflow
 * past 4 ways — each overflow is a repeated miss every height — is
 * <1% of keys (at 4096 sets it measured 35% eviction churn).
 * Round-robin eviction per set,
 * lazily allocated. Guarded by a dependency-free C11 spinlock: ctypes
 * releases the GIL during calls, so two Python threads can be in the
 * library at once; the critical sections are memcmp/memcpy-short.
 * TM_TPU_NO_PKCACHE=1 disables (A/B switch, like TM_TPU_NO_IFMA). */

#include <stdatomic.h>

#define PKC_SETS 8192u /* power of two */
#define PKC_WAYS 4u

typedef struct {
    uint8_t key[32];
    uint8_t curve;  /* 1 = zip215, 2 = ristretto255 */
    uint8_t valid;
    ge pt;          /* decoded extended point, Z = 1 */
} pkc_entry;

static pkc_entry *pkc_table; /* PKC_SETS * PKC_WAYS, lazy */
static uint8_t pkc_rr[PKC_SETS];
static atomic_flag pkc_lock = ATOMIC_FLAG_INIT;
/* hits = lookups served from the table; misses = fresh successful
 * decodes of uncached keys (counted at insert, so a batch that aborts
 * on an undecodable encoding doesn't skew the ratio); inserts tracks
 * misses except under alloc failure; evictions = overwritten ways. */
static uint64_t pkc_stats[4]; /* hits, misses, inserts, evictions */

static void pkc_acquire(void) {
    while (atomic_flag_test_and_set_explicit(&pkc_lock,
                                             memory_order_acquire)) {
    }
}

static void pkc_release(void) {
    atomic_flag_clear_explicit(&pkc_lock, memory_order_release);
}

static int pkc_enabled(void) {
    static int cached = -1;
    if (cached < 0) {
        const char *off = getenv("TM_TPU_NO_PKCACHE");
        cached = !(off && off[0]);
    }
    return cached;
}

static unsigned pkc_set(const uint8_t *key, uint8_t curve) {
    /* point encodings are near-uniform bytes; fold + one mix step */
    uint64_t h = load64_le(key) ^ load64_le(key + 8) ^
                 load64_le(key + 16) ^ load64_le(key + 24);
    h ^= (uint64_t)curve * 0x9e3779b97f4a7c15ULL;
    h ^= h >> 33;
    h *= 0xff51afd7ed558ccdULL;
    h ^= h >> 33;
    return (unsigned)(h & (PKC_SETS - 1));
}

/* 1 = hit (out filled), 0 = miss. Never allocates. */
static int pkc_get(uint8_t curve, const uint8_t *key, ge *out) {
    if (!pkc_enabled()) return 0;
    int hit = 0;
    pkc_acquire();
    if (pkc_table) {
        pkc_entry *set = pkc_table + (size_t)pkc_set(key, curve) * PKC_WAYS;
        for (unsigned w = 0; w < PKC_WAYS; w++) {
            if (set[w].valid && set[w].curve == curve &&
                memcmp(set[w].key, key, 32) == 0) {
                *out = set[w].pt;
                hit = 1;
                break;
            }
        }
    }
    if (hit) pkc_stats[0]++;
    pkc_release();
    return hit;
}

static void pkc_put(uint8_t curve, const uint8_t *key, const ge *pt) {
    if (!pkc_enabled()) return;
    pkc_acquire();
    pkc_stats[1]++; /* a completed fresh decode == the real miss */
    if (!pkc_table) {
        pkc_table = calloc((size_t)PKC_SETS * PKC_WAYS, sizeof(pkc_entry));
        if (!pkc_table) { /* allocation failure: stay cacheless */
            pkc_release();
            return;
        }
    }
    unsigned si = pkc_set(key, curve);
    pkc_entry *set = pkc_table + (size_t)si * PKC_WAYS;
    unsigned victim = PKC_WAYS;
    for (unsigned w = 0; w < PKC_WAYS; w++) {
        if (set[w].valid && set[w].curve == curve &&
            memcmp(set[w].key, key, 32) == 0) {
            victim = w; /* refresh in place */
            break;
        }
        if (victim == PKC_WAYS && !set[w].valid) victim = w;
    }
    if (victim == PKC_WAYS) {
        victim = pkc_rr[si];
        pkc_rr[si] = (uint8_t)((pkc_rr[si] + 1) % PKC_WAYS);
        pkc_stats[3]++;
    }
    memcpy(set[victim].key, key, 32);
    set[victim].curve = curve;
    set[victim].pt = *pt;
    set[victim].valid = 1;
    pkc_stats[2]++;
    pkc_release();
}

/* test/observability hooks */
void tm_pk_cache_stats(uint64_t out[4]) {
    pkc_acquire();
    memcpy(out, pkc_stats, sizeof(pkc_stats));
    pkc_release();
}

void tm_pk_cache_clear(void) {
    pkc_acquire();
    if (pkc_table)
        memset(pkc_table, 0,
               (size_t)PKC_SETS * PKC_WAYS * sizeof(pkc_entry));
    memset(pkc_rr, 0, sizeof(pkc_rr));
    memset(pkc_stats, 0, sizeof(pkc_stats));
    pkc_release();
}

/* little-endian bit-window extraction: `width` bits starting at
 * `bitpos` (width <= 16, so at most 3 bytes are touched) */
static inline unsigned get_window(const uint8_t *scalar, int bitpos,
                                  int width) {
    int byte = bitpos >> 3, shift = bitpos & 7;
    unsigned v = scalar[byte];
    if (byte + 1 < 32) v |= (unsigned)scalar[byte + 1] << 8;
    if (shift + width > 16 && byte + 2 < 32)
        v |= (unsigned)scalar[byte + 2] << 16;
    return (v >> shift) & ((1u << width) - 1);
}

/* Pippenger with `width`-bit windows: per-term cost ~(256/width) adds
 * plus a fixed 2*2^width-add bucket aggregation per window — the
 * large-batch MSM. width 8 suits mid-size batches, width 11 the
 * 8192-signature calls (bucket array must stay L2-resident). */
static int ge_msm_pippenger(ge *result, const uint8_t *scalars,
                            const ge *pts, size_t n, int width) {
    int nbuckets = (1 << width) - 1;
    int nwindows = (253 + width - 1) / width;
    ge *buckets = malloc((size_t)nbuckets * sizeof(ge));
    /* terms are Z=1 (decoded points / the basepoint): precompute the
     * cached form once so every bucket add costs 7 muls, not 9 */
    ge_cached *cpts = malloc(n * sizeof(ge_cached));
    if (!buckets || !cpts) {
        free(buckets);
        free(cpts);
        return 0;
    }
    for (size_t i = 0; i < n; i++) ge_to_cached(&cpts[i], &pts[i]);
    ge_identity(result);
    for (int w = nwindows - 1; w >= 0; w--) {
        if (w != nwindows - 1)
            for (int k = 0; k < width; k++) ge_dbl(result, result);
        for (int d = 0; d < nbuckets; d++) ge_identity(&buckets[d]);
        for (size_t i = 0; i < n; i++) {
            unsigned d = get_window(scalars + i * 32, w * width, width);
            if (d)
                ge_add_cached(&buckets[d - 1], &buckets[d - 1], &cpts[i]);
        }
        ge run, acc;
        ge_identity(&run);
        ge_identity(&acc);
        for (int d = nbuckets - 1; d >= 0; d--) {
            ge_add(&run, &run, &buckets[d]);
            ge_add(&acc, &acc, &run);
        }
        ge_add(result, result, &acc);
    }
    free(buckets);
    free(cpts);
    return 1;
}

/* Straus with 4-bit windows and per-term tables: ~78 adds per term
 * with only a ~250-doubling fixed cost — wins below ~1000 terms
 * (commit-sized batches and single verifies). */
static int ge_msm_straus(ge *result, const uint8_t *scalars,
                         const ge *pts, size_t n) {
    /* tables[i][d-1] = d * pts[i] for d in 1..15 */
    ge *tables = malloc(n * 15 * sizeof(ge));
    if (!tables) return 0;
    for (size_t i = 0; i < n; i++) {
        ge *t = tables + i * 15;
        t[0] = pts[i];
        for (int d = 1; d < 15; d++) ge_add(&t[d], &t[d - 1], &pts[i]);
    }
    ge_identity(result);
    for (int w = 63; w >= 0; w--) {
        if (w != 63)
            for (int k = 0; k < 4; k++) ge_dbl(result, result);
        int byte = w >> 1;
        for (size_t i = 0; i < n; i++) {
            int b = scalars[i * 32 + byte];
            int d = (w & 1) ? (b >> 4) : (b & 0x0f);
            if (d) ge_add(result, result, &tables[i * 15 + d - 1]);
        }
    }
    free(tables);
    return 1;
}

/* MSM dispatch by term count (total adds, ~offsets included):
 *   Straus w4      ~78n + 250        — small batches and singles
 *   Pippenger w8   ~64n + 16k        — mid batches
 *   Pippenger w11  ~23n + 94k        — big batches (8192-sig calls);
 *                  w13 models fewer adds but its 1.3 MB bucket array
 *                  thrashes L2 and measured SLOWER — don't "fix" this
 * Crossovers: Straus->w8 at ~1.1k terms, w8->w11 at ~3.4k terms.
 * Scalars are 32-byte little-endian (< L < 2^253). */
static int ge_msm(ge *result, const uint8_t *scalars, const ge *pts,
                  size_t n) {
    if (n < 1024 && ge_msm_straus(result, scalars, pts, n)) return 1;
    if (n >= 3400 && ge_msm_pippenger(result, scalars, pts, n, 11))
        return 1;
    if (ge_msm_pippenger(result, scalars, pts, n, 8)) return 1;
    return ge_msm_straus(result, scalars, pts, n);
}

/* Shared driver: decode all A_i/R_i (prelude pass, batched pow2523,
 * finish pass), then check
 * [8](zb*B + sum a_i*(-A_i) + sum z_i*(-R_i)) == identity.
 * A_i slots go through the decoded-point cache (curve tags the
 * decoder); R_i nonces never repeat, so they always decode. Only the
 * cache misses enter the batched pow2523 stage — the point of the
 * cache is skipping that power for keys seen last height. */
static int batch_verify_common(
    const uint8_t *pk_bytes, const uint8_t *r_bytes, const uint8_t *zb,
    const uint8_t *a_scalars, const uint8_t *z_scalars, uint64_t n,
    uint8_t curve, int (*pre)(const uint8_t *, pre_t *, fe),
    int (*fin)(ge *, const uint8_t *, const pre_t *, const fe)) {
    size_t nterms = 2 * (size_t)n + 1;
    size_t npts = 2 * (size_t)n;
    ge *pts = malloc(nterms * sizeof(ge));
    uint8_t *scalars = malloc(nterms * 32);
    pre_t *pres = malloc(npts * sizeof(pre_t));
    fe *pows = malloc(npts * sizeof(fe));
    uint32_t *need = malloc(npts * sizeof(uint32_t));
    size_t nneed = 0;
    int rc = -1;
    if (!pts || !scalars || !pres || !pows || !need) goto done;

    /* term 0: zb * B */
    fe_copy(pts[0].X, FE_BX);
    fe_copy(pts[0].Y, FE_BY);
    fe_one(pts[0].Z);
    fe_copy(pts[0].T, FE_BT);
    memcpy(scalars, zb, 32);

    /* pass 1: cache lookups + preludes (canonicality + everything
     * before the power). Term slot i = A_i, n+i = R_i; pres/pows are
     * compact over the slots that actually need a decode. */
    for (uint64_t i = 0; i < n; i++) {
        ge cached;
        if (pkc_get(curve, pk_bytes + 32 * i, &cached)) {
            ge_neg(&pts[1 + i], &cached);
        } else {
            if (!pre(pk_bytes + 32 * i, &pres[nneed], pows[nneed]))
                goto done;
            need[nneed++] = (uint32_t)i;
        }
        if (!pre(r_bytes + 32 * i, &pres[nneed], pows[nneed])) goto done;
        need[nneed++] = (uint32_t)(n + i);
        memcpy(scalars + 32 * (1 + i), a_scalars + 32 * i, 32);
        memcpy(scalars + 32 * (1 + n + i), z_scalars + 32 * i, 32);
    }

    /* pass 2: the sqrt/division powers for the misses (8-way IFMA
     * lanes when the host supports it) */
    pow2523_many(pows, nneed);

    /* pass 3: finish decoding, negate into the term array, insert
     * fresh A_i decodes into the cache */
    for (size_t j = 0; j < nneed; j++) {
        uint32_t slot = need[j];
        const uint8_t *enc = slot < n ? pk_bytes + 32 * (size_t)slot
                                      : r_bytes + 32 * ((size_t)slot - n);
        ge t;
        if (!fin(&t, enc, &pres[j], pows[j])) goto done;
        if (slot < n) pkc_put(curve, enc, &t);
        ge_neg(&pts[1 + slot], &t);
    }

    {
        ge sum;
        if (!ge_msm(&sum, scalars, pts, nterms)) goto done; /* rc -1 */
        /* cofactored: [8] * sum must be the identity */
        ge_dbl(&sum, &sum);
        ge_dbl(&sum, &sum);
        ge_dbl(&sum, &sum);
        /* identity in extended coords: X == 0 and Y == Z */
        rc = (fe_iszero(sum.X) && fe_eq(sum.Y, sum.Z)) ? 1 : 0;
    }

done:
    free(pts);
    free(scalars);
    free(pres);
    free(pows);
    free(need);
    return rc;
}

/* See file header for the contract. */
int tm_ed25519_batch_verify(const uint8_t *pk_bytes, const uint8_t *r_bytes,
                            const uint8_t *zb, const uint8_t *a_scalars,
                            const uint8_t *z_scalars, uint64_t n) {
    return batch_verify_common(pk_bytes, r_bytes, zb, a_scalars, z_scalars,
                               n, 1, zip215_pre2, zip215_fin2);
}

/* Whole-batch ed25519 verify with the host prep done natively: the
 * challenge hashes k_i = SHA512(R|A|M) mod L, the random-linear-
 * combination products a_i = z_i*k_i and zb = sum z_i*s_i mod L, and
 * the cofactored batch equation — one call, no per-signature Python.
 * sigs = n*64 (R||s); msgs = concatenated messages with n+1 offsets;
 * rand16 = n*16 random weights (caller-supplied so the RLC randomness
 * stays under the caller's control). Limb loads/stores go through the
 * endian-neutral byte helpers like the rest of the file. Returns
 * 1/0/-1 like the others;
 * a non-canonical s (>= L) returns 0 (invalid somewhere — caller
 * falls back per-signature for the bitmap). */
int tm_ed25519_verify_full(const uint8_t *pks, const uint8_t *sigs,
                           const uint8_t *msgs, const uint64_t *moffs,
                           const uint8_t *rand16, uint64_t n) {
    uint8_t *a_sc = malloc(n * 32);
    uint8_t *z_sc = malloc(n * 32);
    uint8_t *r_b = malloc(n * 32);
    if (!a_sc || !z_sc || !r_b) {
        free(a_sc);
        free(z_sc);
        free(r_b);
        return -1;
    }
    int rc;
    uint64_t zb[4] = {0, 0, 0, 0};
    for (uint64_t i = 0; i < n; i++) {
        const uint8_t *sig = sigs + 64 * i;
        uint64_t s[4];
        sc4_frombytes(s, sig + 32);
        if (sc4_gte(s, SC_L)) {
            rc = 0; /* non-canonical s: invalid under ZIP-215 */
            goto done;
        }
        uint8_t dig[64];
        sha512_3(dig, sig, 32, pks + 32 * i, 32, msgs + moffs[i],
                 (size_t)(moffs[i + 1] - moffs[i]));
        uint64_t d8[8], k[4], z[2], a[4], zs[4];
        for (int w = 0; w < 8; w++) d8[w] = load64_le(dig + 8 * w);
        sc_mod_l(k, d8, 8);
        z[0] = load64_le(rand16 + 16 * i);
        z[1] = load64_le(rand16 + 16 * i + 8);
        sc_mulmod(a, k, z, 2);
        sc4_tobytes(a_sc + 32 * i, a);
        sc_mulmod(zs, s, z, 2);
        sc_addmod(zb, zb, zs);
        memset(z_sc + 32 * i, 0, 32);
        memcpy(z_sc + 32 * i, rand16 + 16 * i, 16);
        memcpy(r_b + 32 * i, sig, 32);
    }
    uint8_t zb_bytes[32];
    sc4_tobytes(zb_bytes, zb);
    rc = batch_verify_common(pks, r_b, zb_bytes, a_sc, z_sc, n, 1,
                             zip215_pre2, zip215_fin2);
done:
    free(a_sc);
    free(z_sc);
    free(r_b);
    return rc;
}

/* test hooks: differential checks of the scalar/hash building blocks
 * against Python (tests/test_crypto.py) */
void tm_sc_mod_l_test(const uint8_t *x64, uint8_t *out32) {
    uint64_t xl[8], r[4];
    for (int w = 0; w < 8; w++) xl[w] = load64_le(x64 + 8 * w);
    sc_mod_l(r, xl, 8);
    sc4_tobytes(out32, r);
}

void tm_sha512_test(const uint8_t *a, uint64_t na, uint8_t *out64) {
    sha512_3(out64, a, (size_t)na, NULL, 0, NULL, 0);
}

/* sr25519: same batch equation over ristretto255 representatives
 * (schnorrkel verify is s*B - k*A == R as ristretto POINTS, i.e. equal
 * cosets mod the 4-torsion). Soundness of the cofactored check: all
 * decoded representatives lie in 2E, and 2E ∩ E[8] is exactly the
 * 4-torsion set ristretto quotients by — so for decoded inputs,
 * [8]*(sum) == identity  <=>  every per-signature coset equation
 * holds (w.h.p. over the random z_i), the same argument schnorrkel's
 * own batch verification uses. Challenges k_i (merlin transcripts)
 * and all scalar products arrive precomputed, like the ed25519 entry. */
int tm_sr25519_batch_verify(const uint8_t *pk_bytes, const uint8_t *r_bytes,
                            const uint8_t *zb, const uint8_t *a_scalars,
                            const uint8_t *z_scalars, uint64_t n) {
    return batch_verify_common(pk_bytes, r_bytes, zb, a_scalars, z_scalars,
                               n, 2, rist_pre2, rist_fin2);
}

/* ---- Keccak-f[1600] + STROBE-128 + merlin (sr25519 challenges) -----
 *
 * The full-native sr25519 entry needs the schnorrkel Fiat-Shamir
 * challenge k = merlin_transcript(msg, pk, R) mod L computed here, the
 * way tm_ed25519_verify_full owns its SHA-512 challenges — otherwise
 * every batch pays ~3 us/sig of Python transcript work
 * (crypto/merlin.py is the differential oracle; merlin spec
 * merlin.cool, STROBE spec strobe.sourceforge.io; reference consumer:
 * crypto/sr25519/batch.go via curve25519-voi's schnorrkel). Keccak
 * round constants / rotation schedule are the published FIPS-202
 * values (keccakf_core.h, the ONE permutation shared with keccakf.c).
 * Lanes go through the endian-neutral byte helpers like the rest of
 * the file. */

#include "keccakf_core.h"

static inline void store64_le(uint8_t *b, uint64_t v) {
    for (int i = 0; i < 8; i++) b[i] = (uint8_t)(v >> (8 * i));
}

/* STROBE-128: rate 166, the merlin subset (meta-AD, AD, PRF).
 * Mirrors crypto/merlin.py _Strobe128 exactly — that implementation
 * reproduces merlin's published test vector and is the differential
 * oracle for this one (tests/test_sr25519.py). */
#define STROBE_R 166u
#define SF_I 0x01u
#define SF_A 0x02u
#define SF_C 0x04u
#define SF_M 0x10u
#define SF_K 0x20u

/* No cur_flags field: the Python oracle keeps it only to validate
 * 'more'-continuations, and every STROBE call here is internal with a
 * fixed operation pattern — there is no continuation to validate. */
typedef struct {
    uint8_t st[200];
    unsigned pos, pos_begin;
} strobe_t;

static void strobe_runf(strobe_t *s) {
    uint64_t lanes[25];
    s->st[s->pos] ^= (uint8_t)s->pos_begin;
    s->st[s->pos + 1] ^= 0x04;
    s->st[STROBE_R + 1] ^= 0x80;
    for (int i = 0; i < 25; i++) lanes[i] = load64_le(s->st + 8 * i);
    tm_keccakf_core(lanes);
    for (int i = 0; i < 25; i++) store64_le(s->st + 8 * i, lanes[i]);
    s->pos = 0;
    s->pos_begin = 0;
}

static void strobe_absorb(strobe_t *s, const uint8_t *d, size_t n) {
    for (size_t i = 0; i < n; i++) {
        s->st[s->pos++] ^= d[i];
        if (s->pos == STROBE_R) strobe_runf(s);
    }
}

static void strobe_begin(strobe_t *s, uint8_t flags) {
    uint8_t hdr[2];
    hdr[0] = (uint8_t)s->pos_begin;
    hdr[1] = flags;
    s->pos_begin = s->pos + 1;
    strobe_absorb(s, hdr, 2);
    if ((flags & (SF_C | SF_K)) && s->pos != 0) strobe_runf(s);
}

static void strobe_meta_ad(strobe_t *s, const uint8_t *d, size_t n,
                           int more) {
    if (!more) strobe_begin(s, SF_M | SF_A);
    strobe_absorb(s, d, n);
}

static void strobe_ad(strobe_t *s, const uint8_t *d, size_t n) {
    strobe_begin(s, SF_A);
    strobe_absorb(s, d, n);
}

static void strobe_prf(strobe_t *s, uint8_t *out, size_t n) {
    strobe_begin(s, SF_I | SF_A | SF_C);
    size_t got = 0;
    while (got < n) {
        size_t take = n - got;
        if (take > STROBE_R - s->pos) take = STROBE_R - s->pos;
        memcpy(out + got, s->st + s->pos, take);
        memset(s->st + s->pos, 0, take);
        s->pos += take;
        got += take;
        if (s->pos == STROBE_R) strobe_runf(s);
    }
}

static void merlin_append(strobe_t *s, const char *label, size_t llen,
                          const uint8_t *msg, size_t mlen) {
    uint8_t le[4];
    le[0] = (uint8_t)mlen;
    le[1] = (uint8_t)(mlen >> 8);
    le[2] = (uint8_t)(mlen >> 16);
    le[3] = (uint8_t)(mlen >> 24);
    strobe_meta_ad(s, (const uint8_t *)label, llen, 0);
    strobe_meta_ad(s, le, 4, 1);
    strobe_ad(s, msg, mlen);
}

/* The constant schnorrkel signing-context prefix:
 * merlin Transcript("SigningContext") + append_message("", "")
 * (crypto/sr25519.py _signing_transcript; reference privkey.go:16).
 * Rebuilt per batch call — 3 permutations, negligible — so there is
 * no shared mutable state to lock. */
static void merlin_signing_prefix(strobe_t *s) {
    memset(s, 0, sizeof(*s));
    s->st[0] = 1;
    s->st[1] = STROBE_R + 2;
    s->st[2] = 1;
    s->st[3] = 0;
    s->st[4] = 1;
    s->st[5] = 96;
    memcpy(s->st + 6, "STROBEv1.0.2", 12);
    {
        uint64_t lanes[25];
        for (int i = 0; i < 25; i++) lanes[i] = load64_le(s->st + 8 * i);
        tm_keccakf_core(lanes);
        for (int i = 0; i < 25; i++) store64_le(s->st + 8 * i, lanes[i]);
    }
    strobe_meta_ad(s, (const uint8_t *)"Merlin v1.0", 11, 0);
    merlin_append(s, "dom-sep", 7, (const uint8_t *)"SigningContext", 14);
    merlin_append(s, "", 0, (const uint8_t *)"", 0);
}

/* k = merlin challenge mod L for one (pk, R, msg) triple, from a
 * caller-provided copy of the signing prefix. */
static void sr_challenge(const strobe_t *prefix, const uint8_t *pk,
                         const uint8_t *r, const uint8_t *msg, size_t mlen,
                         uint64_t k[4]) {
    strobe_t t = *prefix;
    uint8_t wide[64], le[4] = {64, 0, 0, 0};
    uint64_t d8[8];
    merlin_append(&t, "sign-bytes", 10, msg, mlen);
    merlin_append(&t, "proto-name", 10, (const uint8_t *)"Schnorr-sig", 11);
    merlin_append(&t, "sign:pk", 7, pk, 32);
    merlin_append(&t, "sign:R", 6, r, 32);
    strobe_meta_ad(&t, (const uint8_t *)"sign:c", 6, 0);
    strobe_meta_ad(&t, le, 4, 1);
    strobe_prf(&t, wide, 64);
    for (int w = 0; w < 8; w++) d8[w] = load64_le(wide + 8 * w);
    sc_mod_l(k, d8, 8);
}

/* differential test hook: the C challenge vs crypto/sr25519._challenge */
/* k = merlin challenge for (pk, R, msg) under the signing context —
 * the production sign-path entry (crypto/sr25519.py sign()). The
 * fixed prefix is rebuilt per call: one STROBE init + Keccak-f
 * permutation (~1 us), not worth a locked static cache. */
void tm_sr25519_challenge(const uint8_t *pk, const uint8_t *r,
                          const uint8_t *msg, uint64_t mlen,
                          uint8_t *out32) {
    strobe_t prefix;
    uint64_t k[4];
    merlin_signing_prefix(&prefix);
    sr_challenge(&prefix, pk, r, msg, (size_t)mlen, k);
    sc4_tobytes(out32, k);
}

/* differential test hook (tests/test_sr25519.py): same computation,
 * kept under the historical name */
void tm_sr25519_challenge_test(const uint8_t *pk, const uint8_t *r,
                               const uint8_t *msg, uint64_t mlen,
                               uint8_t *out32) {
    tm_sr25519_challenge(pk, r, msg, mlen, out32);
}

/* Whole-batch sr25519 verify with the host prep done natively — the
 * sr25519 analog of tm_ed25519_verify_full: schnorrkel signature
 * parsing (v1 marker bit, s < L), merlin challenges, RLC products,
 * and the cofactored equation over ristretto decoding, in one call.
 * sigs = n*64 (R||s with the marker bit in s[31]); msgs/moffs/rand16
 * as in the ed25519 entry. Returns 1 all-valid / 0 invalid-somewhere
 * (incl. malformed signatures — caller falls back per-signature for
 * the bitmap) / -1 alloc failure. */
int tm_sr25519_verify_full(const uint8_t *pks, const uint8_t *sigs,
                           const uint8_t *msgs, const uint64_t *moffs,
                           const uint8_t *rand16, uint64_t n) {
    uint8_t *a_sc = malloc(n * 32);
    uint8_t *z_sc = malloc(n * 32);
    uint8_t *r_b = malloc(n * 32);
    if (!a_sc || !z_sc || !r_b) {
        free(a_sc);
        free(z_sc);
        free(r_b);
        return -1;
    }
    int rc;
    uint64_t zb[4] = {0, 0, 0, 0};
    strobe_t prefix;
    merlin_signing_prefix(&prefix);
    for (uint64_t i = 0; i < n; i++) {
        const uint8_t *sig = sigs + 64 * i;
        uint8_t sb[32];
        uint64_t s[4], k[4], z[2], a[4], zs[4];
        if (!(sig[63] & 0x80)) {
            rc = 0; /* pre-v0.1.1 signature without the marker */
            goto done;
        }
        memcpy(sb, sig + 32, 32);
        sb[31] &= 0x7f;
        sc4_frombytes(s, sb);
        if (sc4_gte(s, SC_L)) {
            rc = 0; /* non-canonical s */
            goto done;
        }
        sr_challenge(&prefix, pks + 32 * i, sig, msgs + moffs[i],
                     (size_t)(moffs[i + 1] - moffs[i]), k);
        z[0] = load64_le(rand16 + 16 * i);
        z[1] = load64_le(rand16 + 16 * i + 8);
        sc_mulmod(a, k, z, 2);
        sc4_tobytes(a_sc + 32 * i, a);
        sc_mulmod(zs, s, z, 2);
        sc_addmod(zb, zb, zs);
        memset(z_sc + 32 * i, 0, 32);
        memcpy(z_sc + 32 * i, rand16 + 16 * i, 16);
        memcpy(r_b + 32 * i, sig, 32);
    }
    {
        uint8_t zb_bytes[32];
        sc4_tobytes(zb_bytes, zb);
        rc = batch_verify_common(pks, r_b, zb_bytes, a_sc, z_sc, n, 2,
                                 rist_pre2, rist_fin2);
    }
done:
    free(a_sc);
    free(z_sc);
    free(r_b);
    return rc;
}

/* ---- constant-time fixed-base multiply (secret-scalar path) --------
 *
 * The verify-side MSMs (Straus/Pippenger above) branch and index
 * tables by scalar digits — fine there, those scalars are public
 * (signatures, RLC weights). Sign/keygen scalars are the Schnorr
 * witness and the private key: partial nonce leakage across many
 * signatures is lattice-recoverable, so this path uses a branchless
 * 16-way select and an unconditional complete addition per window —
 * digit-independent control flow and memory access pattern. */

static uint64_t ct_eq_u64(uint64_t a, uint64_t b) {
    uint64_t d = a ^ b;
    return 1 & ((d - 1) >> 63); /* 1 iff d == 0 */
}

static void fe_cmov(fe r, const fe a, uint64_t cond) {
    uint64_t mask = (uint64_t)0 - cond;
    for (int i = 0; i < 5; i++) r[i] ^= mask & (r[i] ^ a[i]);
}

static void ge_cmov(ge *r, const ge *a, uint64_t cond) {
    fe_cmov(r->X, a->X, cond);
    fe_cmov(r->Y, a->Y, cond);
    fe_cmov(r->Z, a->Z, cond);
    fe_cmov(r->T, a->T, cond);
}

/* d*B for d = 0..15 — basepoint multiples are compile-time-constant
 * values, built once on first use (building them per sign call cost
 * ~14 redundant point adds). 0=empty, 1=building, 2=ready; the table
 * contents are public, only the SELECTION below is secret. */
static ge BASE_TABLE16[16];
static atomic_int base_table_state;

static void base_table_init(void) {
    if (atomic_load_explicit(&base_table_state, memory_order_acquire) == 2)
        return;
    int expected = 0;
    if (atomic_compare_exchange_strong(&base_table_state, &expected, 1)) {
        ge_identity(&BASE_TABLE16[0]);
        fe_copy(BASE_TABLE16[1].X, FE_BX);
        fe_copy(BASE_TABLE16[1].Y, FE_BY);
        fe_one(BASE_TABLE16[1].Z);
        fe_copy(BASE_TABLE16[1].T, FE_BT);
        for (int d = 2; d < 16; d++)
            ge_add(&BASE_TABLE16[d], &BASE_TABLE16[d - 1], &BASE_TABLE16[1]);
        atomic_store_explicit(&base_table_state, 2, memory_order_release);
    } else {
        while (atomic_load_explicit(&base_table_state, memory_order_acquire)
               != 2) {
        }
    }
}

/* R = k*B, 4-bit windows MSB-first; the unified ge_add is complete
 * (a = -1 HWCD), so adding the selected entry — identity included —
 * needs no digit-dependent branch. */
static void ge_basemul_ct(ge *r, const uint8_t *scalar) {
    base_table_init();
    ge_identity(r);
    for (int w = 63; w >= 0; w--) {
        if (w != 63)
            for (int k = 0; k < 4; k++) ge_dbl(r, r);
        int byte = w >> 1;
        uint64_t d = (w & 1) ? (uint64_t)(scalar[byte] >> 4)
                             : (uint64_t)(scalar[byte] & 0x0f);
        ge sel = BASE_TABLE16[0];
        for (uint64_t j = 1; j < 16; j++)
            ge_cmov(&sel, &BASE_TABLE16[j], ct_eq_u64(d, j));
        ge_add(r, r, &sel);
    }
}

/* Fixed-base scalar multiply + ristretto encode in one call:
 * out = encode(scalar * B). Serves the sr25519 sign/keygen hot spots
 * (R = r*B, A = a*B — schnorrkel's sign path does exactly these two
 * basepoint multiplies; reference surface: crypto/sr25519/privkey.go).
 * scalar: 32-byte little-endian, already reduced mod L. Returns 0
 * (kept int-returning for ABI stability with earlier revisions). */
int tm_ristretto_basemul(const uint8_t *scalar, uint8_t *out) {
    ge R;
    ge_basemul_ct(&R, scalar);
    rist_encode(out, &R);
    return 0;
}

/* The Edwards twin of tm_ristretto_basemul, for ed25519 keygen (A = aB)
 * and signing (R = rB): out = the RFC 8032 encoding of scalar * B, y
 * little-endian with the sign of x in the top bit. scalar: 32 bytes
 * little-endian, any value (B has order L, so a clamped key need not be
 * reduced). With a table of d * 16^w * B for each of the 64 nibble
 * positions w, a multiply is 64 additions and no doubling; each entry is
 * picked by a constant-time select over all 16, as ge_basemul_ct picks
 * its. 1/Z is Z^(p-2) = (Z^(2^252-3))^8 * Z^3. Returns 0. */
static ge POS_TABLE16[64][16]; /* 160 KB, public contents */
static atomic_int pos_table_state;

static void pos_table_init(void) {
    if (atomic_load_explicit(&pos_table_state, memory_order_acquire) == 2)
        return;
    int expected = 0;
    if (atomic_compare_exchange_strong(&pos_table_state, &expected, 1)) {
        ge base;
        base_table_init();
        base = BASE_TABLE16[1];
        for (int w = 0; w < 64; w++) {
            ge_identity(&POS_TABLE16[w][0]);
            POS_TABLE16[w][1] = base;
            for (int d = 2; d < 16; d++)
                ge_add(&POS_TABLE16[w][d], &POS_TABLE16[w][d - 1], &base);
            for (int k = 0; k < 4; k++) ge_dbl(&base, &base);
        }
        atomic_store_explicit(&pos_table_state, 2, memory_order_release);
    } else {
        while (atomic_load_explicit(&pos_table_state, memory_order_acquire)
               != 2) {
        }
    }
}

int tm_ed25519_basemul(const uint8_t *scalar, uint8_t *out) {
    ge R;
    fe zinv, z3, x, y;
    pos_table_init();
    ge_identity(&R);
    for (int w = 0; w < 64; w++) {
        uint64_t d = (w & 1) ? (uint64_t)(scalar[w >> 1] >> 4)
                             : (uint64_t)(scalar[w >> 1] & 0x0f);
        ge sel = POS_TABLE16[w][0];
        for (uint64_t j = 1; j < 16; j++)
            ge_cmov(&sel, &POS_TABLE16[w][j], ct_eq_u64(d, j));
        ge_add(&R, &R, &sel);
    }
    fe_pow2523(zinv, R.Z);
    fe_sqn(zinv, zinv, 3);
    fe_sq(z3, R.Z);
    fe_mul(z3, z3, R.Z);
    fe_mul(zinv, zinv, z3);
    fe_mul(x, R.X, zinv);
    fe_mul(y, R.Y, zinv);
    fe_tobytes(out, y);
    out[31] |= (uint8_t)(fe_isneg(x) << 7);
    return 0;
}

/* The merlin challenges of a whole window in one call (the port's own,
 * for crypto/sr25519.challenge_batch and the sr25519 device window's
 * upload): out row i (32 bytes) is tm_sr25519_challenge(pks + 32 i,
 * rs + 32 i, msgs + offs[i], offs[i + 1] - offs[i]), computed from one
 * signing-context prefix. Returns 0. */
int tm_sr25519_challenge_batch(uint64_t n, const uint8_t *pks,
                               const uint8_t *rs, const uint8_t *msgs,
                               const uint64_t *offs, uint8_t *out) {
    strobe_t prefix;
    uint64_t k[4];
    merlin_signing_prefix(&prefix);
    for (uint64_t i = 0; i < n; i++) {
        sr_challenge(&prefix, pks + 32 * i, rs + 32 * i, msgs + offs[i],
                     (size_t)(offs[i + 1] - offs[i]), k);
        sc4_tobytes(out + 32 * i, k);
    }
    return 0;
}
