/* Copy of tendermint_tpu/native/keccakf_core.h for the port's CPU plane (tendermint_tpu_torch/native). */
/* Keccak-f[1600] permutation core, shared by keccakf.c (the merlin
 * host-prep library) and ed25519_batch.c (the in-kernel STROBE for
 * tm_sr25519_verify_full) — ONE implementation of the cryptographic
 * permutation, included statically by both compilation units so the
 * two .so files can never diverge. Round constants and the rho/pi
 * schedule are the published FIPS-202 values.
 *
 * Lane order: st[x + 5*y] (row-major y), little-endian u64 — matches
 * the 200-byte STROBE state viewed as <25Q. */
#ifndef TM_KECCAKF_CORE_H
#define TM_KECCAKF_CORE_H

#include <stdint.h>

#define TM_ROTL64(v, n) (((v) << (n)) | ((v) >> (64 - (n))))

static const uint64_t TM_KECCAK_RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

static void tm_keccakf_core(uint64_t st[25]) {
    uint64_t bc[5], t;
    for (int round = 0; round < 24; round++) {
        /* theta */
        for (int i = 0; i < 5; i++)
            bc[i] = st[i] ^ st[i + 5] ^ st[i + 10] ^ st[i + 15] ^ st[i + 20];
        for (int i = 0; i < 5; i++) {
            t = bc[(i + 4) % 5] ^ TM_ROTL64(bc[(i + 1) % 5], 1);
            for (int j = 0; j < 25; j += 5)
                st[j + i] ^= t;
        }
        /* rho + pi */
        {
            static const int piln[24] = {10, 7,  11, 17, 18, 3,  5,  16,
                                         8,  21, 24, 4,  15, 23, 19, 13,
                                         12, 2,  20, 14, 22, 9,  6,  1};
            static const int rotc[24] = {1,  3,  6,  10, 15, 21, 28, 36,
                                         45, 55, 2,  14, 27, 41, 56, 8,
                                         25, 43, 62, 18, 39, 61, 20, 44};
            t = st[1];
            for (int i = 0; i < 24; i++) {
                int j = piln[i];
                bc[0] = st[j];
                st[j] = TM_ROTL64(t, rotc[i]);
                t = bc[0];
            }
        }
        /* chi */
        for (int j = 0; j < 25; j += 5) {
            for (int i = 0; i < 5; i++)
                bc[i] = st[j + i];
            for (int i = 0; i < 5; i++)
                st[j + i] = bc[i] ^ ((~bc[(i + 1) % 5]) & bc[(i + 2) % 5]);
        }
        /* iota */
        st[0] ^= TM_KECCAK_RC[round];
    }
}

#endif /* TM_KECCAKF_CORE_H */
