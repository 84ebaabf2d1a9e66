/* Copy of tendermint_tpu/native/signbytes.c for the port's host path (tendermint_tpu_torch/native), built by tendermint_tpu_torch.native.signbytes_lib; a failed build raises, with no Python fallback behind it. */
/* Batch CanonicalVote sign-bytes assembly.
 *
 * The batch VerifyCommit host path (types/canonical.py
 * VoteSignTemplate.sign_bytes_batch) splices a per-commit constant
 * prefix/suffix around a per-signature protobuf Timestamp. The Python
 * loop costs ~5 us/signature — ~50 ms of the 10k-validator commit
 * latency budget; this file is the same splice in C (~50 ns/sig).
 * The reference marshals the equivalent bytes per signature in Go
 * (types/validation.go:152 -> vote.SignBytes).
 *
 * Byte-exactness contract (differential-tested against the Python
 * loop in tests/test_encoding.py):
 *   seconds, nanos = floordivmod(ns, 1e9)      (Python // semantics)
 *   ts  = ("\x08" varint(seconds) if seconds else "")
 *       + ("\x10" varint(nanos)   if nanos   else "")
 *   body = prefix + ts_tag + varint(len(ts)) + ts + suffix
 *   row  = varint(len(body)) + body
 * varint: unsigned base-128 LSB-first; negative int64 values encode
 * as 10-byte two's complement (proto3 int64).
 *
 * Compiled on demand by tendermint_tpu.native (cc -O2 -shared),
 * called through ctypes; Python remains the fallback.
 */
#include <stdint.h>
#include <string.h>

static inline long put_varint(uint8_t *p, uint64_t v) {
    long i = 0;
    do {
        uint8_t b = v & 0x7F;
        v >>= 7;
        p[i++] = v ? (b | 0x80) : b;
    } while (v);
    return i;
}

/* Fills `out` with n concatenated rows, lens[i] = bytes of row i.
 * Returns total bytes written, or -1 if out_cap would overflow. */
long tm_vote_sign_bytes_batch(
    const uint8_t *prefix, long prefix_len,
    const uint8_t *suffix, long suffix_len,
    uint8_t ts_tag,
    const int64_t *ts_ns, long n,
    uint8_t *out, long out_cap, int32_t *lens)
{
    /* worst case per row: 10-byte seconds varint + 5-byte nanos varint
     * + 2 field tags + 1 ts-len byte + tag + 2 body-len bytes */
    const long row_bound = prefix_len + suffix_len + 24;
    uint8_t ts[24];
    long off = 0;
    for (long i = 0; i < n; i++) {
        if (off + row_bound > out_cap) return -1;
        int64_t ns = ts_ns[i];
        /* Python divmod: floored division, nanos in [0, 1e9) */
        int64_t sec = ns / 1000000000LL;
        int64_t nano = ns % 1000000000LL;
        if (nano < 0) { nano += 1000000000LL; sec -= 1; }
        long ts_len = 0;
        if (sec) {
            ts[ts_len++] = 0x08;
            ts_len += put_varint(ts + ts_len, (uint64_t)sec);
        }
        if (nano) {
            ts[ts_len++] = 0x10;
            ts_len += put_varint(ts + ts_len, (uint64_t)nano);
        }
        /* body = prefix + ts_tag + varint(ts_len) + ts + suffix;
         * ts_len <= 17 so its varint is one byte */
        long body_len = prefix_len + 1 + 1 + ts_len + suffix_len;
        uint8_t *row = out + off;
        long w = put_varint(row, (uint64_t)body_len);
        memcpy(row + w, prefix, (size_t)prefix_len);
        w += prefix_len;
        row[w++] = ts_tag;
        row[w++] = (uint8_t)ts_len;
        memcpy(row + w, ts, (size_t)ts_len);
        w += ts_len;
        memcpy(row + w, suffix, (size_t)suffix_len);
        w += suffix_len;
        lens[i] = (int32_t)w;
        off += w;
    }
    return off;
}
