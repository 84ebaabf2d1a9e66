// sr25519 (schnorrkel over ristretto255) verification with four threads
// ("lanes") per signature: the device body of kernel X3
// (sr25519_verify.cu).
//
// Counterpart: tendermint_tpu/ops/sr25519_kernel.py (_abs_dev :63,
// _sqrt_ratio_m1_dev :73, ristretto_decode_dev :96, _ristretto_eq_dev :134,
// _verify_tile_sr :150). It reuses the field, the four-lane group
// operations and the dual multiplication of ed25519_device.cuh, so every
// intermediate is the field element the plain version computes, in other
// limbs. What is new is the ristretto255 front and back end: RFC 9496
// decoding (§4.3.1) in place of ZIP-215 decompression, and ristretto
// equality (§4.4) in place of the cofactored projective compare.
//
// Like ed25519_device.cuh it includes no CUDA runtime header, so a host
// compiler builds it too (tests/test_torch_csrc.py runs the lane body in
// lock-step there and holds it against the host oracle).

#pragma once
#include "ed25519_device.cuh"

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
// little-endian words w, on one lane: p = (x, y, 1, x y). Returns ok: the
// value is below p (bit 255 included), even, u/v square, t non-negative
// and y != 0. Unlike ge_decompress (ZIP-215), no value >= p is accepted.
// An invalid encoding still yields bounded limbs. Counterpart:
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

// The whole sr25519 check of signature i on this lane, from (32, n)
// ristretto public keys, (64, n) R || s (marker in bit 511) and (32, n)
// challenges k < L, as byte rows whose elements are `es` bytes wide (1 or
// 4, as load_words reads them); lane 0 writes out[i]. Lanes of an i >= n
// run on zeros and write nothing: every lane of a warp must reach each
// shuffle, and an all-zero lane (which decodes to the identity) fails on
// its marker bit. tab: this signature's table of -A; btab: B's table.
// Counterpart: sr25519_kernel._verify_tile_sr.
__device__ __forceinline__ void sr25519_verify_lane(
    const uint8_t *pk, const uint8_t *sig, const uint8_t *kb, bool *out,
    int n, int es, int i, uint32_t *tab, int stride, const uint32_t *btab) {
  const int lane = lane_id();
  const bool in = i < n;
  uint64_t aw[4], rw[4], sw[4], kw[4], ew[4];
  load_words<4>(aw, pk, 0, n, i, es, in);
  load_words<4>(rw, sig, 0, n, i, es, in);
  load_words<4>(sw, sig, 32, n, i, es, in);
  load_words<4>(kw, kb, 0, n, i, es, in);

  // lanes 0 and 1 decode A, lanes 2 and 3 R: the two sqrt_ratio_m1 chains
  // run side by side, and no lane exchanges inside a decode
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
  ge4_dual_mult(acc, av, esd, ekd, tab, stride, btab);
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
  if (lane == 0 && in) out[i] = same && ok_a && ok_r && s_ok && marker_ok;
}
