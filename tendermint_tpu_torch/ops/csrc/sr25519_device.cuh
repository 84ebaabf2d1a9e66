// sr25519 (schnorrkel over ristretto255) verification, the device body of
// kernel X3 (sr25519_verify.cu), eight lanes a signature.
//
// Counterpart: tendermint_tpu/ops/sr25519_kernel.py (_abs_dev :63,
// _sqrt_ratio_m1_dev :73, ristretto_decode_dev :96, _ristretto_eq_dev :134,
// _verify_tile_sr :150). It calls the field, the four-lane group formulas
// and the table layout of ed25519_device.cuh as K1 and K2 do, so every
// intermediate is the field element the plain version computes, in other
// limbs. What is X3's own: RFC 9496 decoding (§4.3.1) in place of ZIP-215
// decompression, ristretto equality (§4.4) in place of the cofactored
// compare, the fixed-base comb of B, and the lane layout below, which K1
// and K2 do not use.
//
// The lanes of one signature. X3_LANES consecutive threads work on one
// signature, in two groups of X3_GROUP: lane l has coordinate l & 3 (X, Y,
// Z, T of a point, as in ed25519_device.cuh) and group l / X3_GROUP. The
// four lanes of a coordinate set are a width-4 segment of the warp, so
// the four-lane exchanges and group formulas of ed25519_device.cuh work in
// every segment unchanged; x3_shfl reaches any lane of the signature.
// Both groups decode A and R and build -A's table; then group 0 walks
// [k](-A) with that table while group 1 sums [s]B from a fixed-base comb
// (sr25519_comb.cuh: [j 16^w]B for every window w, so no doublings), in
// step with group 0's additions, and one addition joins the two sums.
//
// ops/x3_variants.py builds the designs this one was chosen from out of
// this header by text replacement (four lanes with [s]B on the doubling
// chain, as X3 was first built; each multiply split between two sets of
// four lanes; both) and times them; sr25519_verify.cu has the numbers.
//
// Like ed25519_device.cuh it includes no CUDA runtime header, so a host
// compiler builds it too (tests/test_torch_csrc.py runs the lane body in
// lock-step there, X3_LANES lanes a signature, and holds it against the
// host oracle).

#pragma once
#include "ed25519_device.cuh"
#include "sr25519_comb.cuh"

// threads a signature, and of each of its two groups
#define X3_LANES 8
#define X3_GROUP (X3_LANES / 2)

// x3_lane: this thread's lane in its signature; x3_shfl: v of lane src
// of the same signature. A host harness that runs the lanes in lock-step
// defines ED25519_HOST_LANES and both functions.
#ifndef ED25519_HOST_LANES
__device__ __forceinline__ int x3_lane() {
  return threadIdx.x & (X3_LANES - 1);
}
__device__ __forceinline__ uint32_t x3_shfl(uint32_t v, int src) {
  return __shfl_sync(0xffffffffu, v, src, X3_LANES);
}
#define X3_LDG(p) __ldg(p)
#else
#define X3_LDG(p) (*(p))
#endif

// p = 2^255 - 19 as little-endian 64-bit words
__device__ __constant__ uint64_t FE_P64[4] = {
    0xffffffffffffffedULL, 0xffffffffffffffffULL, 0xffffffffffffffffULL,
    0x7fffffffffffffffULL};

// the 256-bit value of w < that of c (little-endian words)
__device__ __forceinline__ bool words_lt(const uint64_t *w,
                                         const uint64_t *c) {
  bool lt = false, decided = false;
#pragma unroll
  for (int i = 3; i >= 0; i--) {
    lt = lt || (!decided && w[i] < c[i]);
    decided = decided || w[i] != c[i];
  }
  return lt;
}

// -- ristretto255 --

// the canonical value of f is odd (RFC 9496 IS_NEGATIVE)
__device__ __forceinline__ bool fe_is_negative(const fe &f) {
  fe t = f;
  fe_canonical(t);
  return (t.v[0] & 1) != 0;
}

// CT_ABS: r = -f if f is negative, else f
__device__ __forceinline__ void fe_abs(fe &r, const fe &f) {
  const bool neg = fe_is_negative(f);
  fe n;
  fe_neg(n, f);
  fe_sel(r, neg, n, f);
}

// SQRT_RATIO_M1 (RFC 9496 §4.2): r = |sqrt(u/v)| when u/v is square,
// else |sqrt(i u/v)|; returns was_square. r is multiplied by sqrt(-1) when
// v r^2 is -u (square) or -i u (not square).
__device__ bool sqrt_ratio_m1(fe &r, const fe &u, const fe &v) {
  fe v3, v7, uv3, uv7, t, check, u_neg, u_neg_i, sqm1, ri;
  fe_sq(v3, v);
  fe_mul(v3, v3, v);
  fe_sq(v7, v3);
  fe_mul(v7, v7, v);
  fe_mul(uv3, u, v3);
  fe_mul(uv7, u, v7);
  fe_pow_p58(t, uv7);
  fe_mul(r, uv3, t);
  fe_sq(check, r);
  fe_mul(check, check, v);
  fe_neg(u_neg, u);
  fe_load_const(sqm1, FE_SQRTM1);
  fe_mul(u_neg_i, u_neg, sqm1);
  const bool correct = fe_eq(check, u);
  const bool flipped = fe_eq(check, u_neg);
  const bool flipped_i = fe_eq(check, u_neg_i);
  fe_mul(ri, r, sqm1);
  fe_sel(r, flipped || flipped_i, ri, r);
  fe_abs(r, r);
  return correct || flipped;
}

// ristretto255 decode (RFC 9496 §4.3.1) of the 32-byte encoding in four
// little-endian words w: p = (x, y, 1, x y). Returns ok: the value is
// below p (bit 255 included), even, u/v square, t non-negative and
// y != 0. Unlike ge_decompress (ZIP-215), no value >= p is accepted. An
// invalid encoding still yields bounded limbs. Counterpart:
// sr25519_kernel.ristretto_decode.
__device__ bool ristretto_decode(ge_p3 &p, const uint64_t *w) {
  const bool nonneg = (w[0] & 1) == 0;
  const bool canon = words_lt(w, FE_P64);
  uint64_t sw[4] = {w[0], w[1], w[2], w[3] & 0x7fffffffffffffffULL};
  fe s, one, d, ss, u1, u2, u2sq, u1sq, v, vu, invsqrt;
  fe_from_words(s, sw);
  fe_set_u32(one, 1);
  fe_load_const(d, FE_D);
  fe_sq(ss, s);
  fe_sub(u1, one, ss);
  fe_add(u2, one, ss);
  fe_sq(u2sq, u2);
  fe_sq(u1sq, u1);
  fe_mul(v, d, u1sq);
  fe_neg(v, v);
  fe_sub(v, v, u2sq);  // v = -(d u1^2) - u2^2
  fe_mul(vu, v, u2sq);
  const bool was_square = sqrt_ratio_m1(invsqrt, one, vu);
  fe den_x, den_y, s2, x, y, t;
  fe_mul(den_x, invsqrt, u2);
  fe_mul(den_y, invsqrt, den_x);
  fe_mul(den_y, den_y, v);
  fe_add(s2, s, s);
  fe_mul(x, s2, den_x);
  fe_abs(x, x);
  fe_mul(y, u1, den_y);
  fe_mul(t, x, y);
  const bool t_neg = fe_is_negative(t);
  const bool y_zero = fe_is_zero(y);
  p.X = x;
  p.Y = y;
  fe_set_u32(p.Z, 1);
  p.T = t;
  return was_square && !t_neg && !y_zero && nonneg && canon;
}

// This lane's coordinate of [e 16^w] B cached, from X3_COMB_TABLE[w][|e|]
// = (Y - X, Y + X, 2dT) with Z = 1 (so 2Z = 2), negated for e < 0 as
// tab_load_signed negates: lanes 0 and 1 swap, lane 3 negates. Lane 2's
// load is discarded for the constant: no lane branches.
__device__ __forceinline__ void comb_load_signed(fe &q, int w, int e,
                                                 int lane) {
  const bool neg = e < 0;
  const int m = neg ? -e : e;
  const int coord = (neg && lane < 2) ? lane ^ 1 : lane;
  const uint32_t *p = X3_COMB_TABLE[w][m][coord < 2 ? coord : 2];
  const uint32_t two = fe_mask(lane == 2);
#pragma unroll
  for (int k = 0; k < 10; k++)
    q.v[k] = (X3_LDG(p + k) & ~two) | ((k == 0 ? 2u : 0u) & two);
  fe n;
  fe_neg(n, q);
  fe_sel(q, neg && lane == 3, n, q);
}

// [s]B - [k]A for one signature, this lane's coordinate of each: a of A
// (extended), acc of the result (X, Y, Z valid, in group 0). es, ek:
// packed signed digits (sc_recode_packed). The 9-entry cached table of -A
// is built into tab (lanes 0-3 write it, group 0 reads it). Horner over 64
// windows, most significant first: group 0 takes acc <- 16 acc + e_k (-A);
// group 1 adds [e_s 16^w]B from the comb where group 0 adds -A's entry,
// and keeps its sum through group 0's doublings; one addition joins them.
// Counterpart: ed25519_kernel.dual_mult_sb_minus_ka.
__device__ __forceinline__ void x3_dual_mult(fe &acc, const fe &a,
                                             const uint32_t *es_in,
                                             const uint32_t *ek_in,
                                             uint32_t *tab, int stride) {
  const int lane = lane_id();
  const bool writer = x3_lane() < 4;
  fe e1 = a, c1, c, e2, e3, e4, t;
  ge4_neg(e1);
  ge4_identity(t);
  ge4_to_cached(c, t);
  if (writer) tab_store(tab, stride, 0, lane, c);
  ge4_to_cached(c1, e1);
  if (writer) tab_store(tab, stride, 1, lane, c1);
  e2 = e1;
  ge4_double(e2);
  ge4_to_cached(c, e2);
  if (writer) tab_store(tab, stride, 2, lane, c);
  e3 = e2;
  ge4_add_cached(e3, c1);
  ge4_to_cached(c, e3);
  if (writer) tab_store(tab, stride, 3, lane, c);
  e4 = e2;
  ge4_double(e4);
  ge4_to_cached(c, e4);
  if (writer) tab_store(tab, stride, 4, lane, c);
  t = e4;
  ge4_add_cached(t, c1);
  ge4_to_cached(c, t);
  if (writer) tab_store(tab, stride, 5, lane, c);
  t = e3;
  ge4_double(t);
  ge4_to_cached(c, t);
  if (writer) tab_store(tab, stride, 6, lane, c);
  ge4_add_cached(t, c1);
  ge4_to_cached(c, t);
  if (writer) tab_store(tab, stride, 7, lane, c);
  t = e4;
  ge4_double(t);
  ge4_to_cached(c, t);
  if (writer) tab_store(tab, stride, 8, lane, c);
  lane_sync();  // the table is read by the other lanes of the signature

  uint32_t es[8], ek[8];
#pragma unroll
  for (int m = 0; m < 8; m++) {
    es[m] = es_in[m];
    ek[m] = ek_in[m];
  }
  const bool comb = x3_lane() >= X3_GROUP;
  ge4_identity(acc);
  fe q;
#pragma unroll 1
  for (int wo = 0; wo < 8; wo++) {
    uint32_t cs = es[7], ck = ek[7];
#pragma unroll
    for (int m = 7; m > 0; m--) {
      es[m] = es[m - 1];
      ek[m] = ek[m - 1];
    }
#pragma unroll 1
    for (int j = 0; j < 8; j++) {
      const int ds = (int32_t)cs >> 28, dk = (int32_t)ck >> 28;
      cs <<= 4;
      ck <<= 4;
#pragma unroll 1
      for (int r = 0; r < 4; r++) {
        fe v = acc;
        ge4_double(v);
        fe_sel(acc, comb, acc, v);
      }
      if (comb)
        comb_load_signed(q, 63 - 8 * wo - j, ds, lane);
      else
        tab_load_signed(q, tab, stride, dk, lane);
      ge4_add_cached(acc, q);
    }
  }
  // group 0 adds group 1's [s]B, cached; group 1's lanes read group 0's
  // (the source lane wraps) and their result is not read
  fe cb, qb;
  ge4_to_cached(cb, acc);
#pragma unroll
  for (int k = 0; k < 10; k++)
    qb.v[k] = x3_shfl(cb.v[k], x3_lane() + X3_GROUP);
  ge4_add_cached(acc, qb);
}

// The whole sr25519 check of signature i on this lane, from (32, n)
// ristretto public keys, (64, n) R || s (marker in bit 511) and (32, n)
// challenges k < L, as byte rows whose elements are `es` bytes wide (1 or
// 4, as load_words reads them); lane 0 writes out[i]. Lanes of an i >= n
// run on zeros and write nothing: every lane of a warp must reach each
// shuffle, and an all-zero lane (which decodes to the identity) fails on
// its marker bit. tab: this signature's table of -A. Counterpart:
// sr25519_kernel._verify_tile_sr.
__device__ __forceinline__ void sr25519_verify_lane(
    const uint8_t *pk, const uint8_t *sig, const uint8_t *kb, bool *out,
    int n, int es, int i, uint32_t *tab, int stride) {
  const int lane = lane_id();
  const bool in = i < n;
  uint64_t aw[4], rw[4], sw[4], kw[4], ew[4];
  load_words<4>(aw, pk, 0, n, i, es, in);
  load_words<4>(rw, sig, 0, n, i, es, in);
  load_words<4>(sw, sig, 32, n, i, es, in);
  load_words<4>(kw, kb, 0, n, i, es, in);

  // coordinates 0 and 1 decode A, 2 and 3 R, in every segment: the two
  // sqrt_ratio_m1 chains run side by side, and no segment exchanges
  // inside a decode
#pragma unroll
  for (int k = 0; k < 4; k++) ew[k] = lane < 2 ? aw[k] : rw[k];
  ge_p3 P;
  const bool ok = ristretto_decode(P, ew);
  fe one, ax, ay, at, rx, ry, av;
  fe_set_u32(one, 1);
  fe_shfl(ax, P.X, 0);
  fe_shfl(ay, P.Y, 0);
  fe_shfl(at, P.T, 0);
  fe_shfl(rx, P.X, 2);
  fe_shfl(ry, P.Y, 2);
  fe_sel4(av, lane, ax, ay, one, at);
  const bool ok_a = lane_shfl(ok, 0) != 0;
  const bool ok_r = lane_shfl(ok, 2) != 0;

  // the scalars, on every lane: each needs every digit. The marker is bit
  // 511; s is checked and recoded with it cleared. k arrives reduced.
  const bool marker_ok = (sw[3] >> 63) != 0;
  sw[3] &= 0x7fffffffffffffffULL;
  const bool s_ok = sc_lt_l(sw);
  uint32_t esd[8], ekd[8];
  sc_recode_words(esd, sw);
  sc_recode_words(ekd, kw);

  fe acc;  // [s]B - [k]A; no cofactor: ristretto255 has prime order
  x3_dual_mult(acc, av, esd, ekd, tab, stride);
  // X_acc Y_R = Y_acc X_R or Y_acc Y_R = X_acc X_R (R has Z = 1): one
  // product a lane, lanes 0 and 1 compare the first, 2 and 3 the second
  fe xa, ya, p, q, m, pm;
  fe_shfl(xa, acc, 0);
  fe_shfl(ya, acc, 1);
  fe_sel4(p, lane, xa, ya, ya, xa);
  fe_sel4(q, lane, ry, rx, ry, rx);
  fe_mul(m, p, q);
  fe_shfl(pm, m, lane ^ 1);
  const bool eq = fe_eq(m, pm);
  // both exchanges on every lane: no short circuit around a shuffle
  const uint32_t eq0 = lane_shfl(eq, 0), eq2 = lane_shfl(eq, 2);
  const bool same = (eq0 | eq2) != 0;
  if (x3_lane() == 0 && in) out[i] = same && ok_a && ok_r && s_ok && marker_ok;
}
