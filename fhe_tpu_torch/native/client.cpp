// Native client-side runtime: BLAKE2b CSPRNG + LWE keygen/encrypt/decrypt.
//
// The role of the reference's client-facing C API and PRNG
// (the reference's src/c_api/c_api.cpp lux_fhe_* ABI;
//  the reference's src/core/include/utils/prng/blake2engine.h), rebuilt
// for this framework's deployment shape: clients (wallets, chain nodes,
// CPU-only services) generate keys and encrypt/decrypt locally through
// this dependency-free C ABI, while homomorphic evaluation runs on the
// card.  Ciphertext layout matches fhe_tpu_torch.tfhe.lwe (and
// fhe_tpu.tfhe.lwe) exactly (b = <a,s> + e + m*q/p mod q), verified by
// cross-language tests.  The port's copy of fhe_tpu/native/client.cpp.
//
// BLAKE2b is implemented from the RFC 7693 specification.

#include <cstdint>
#include <cstring>
#include <cmath>

namespace {

// ---------------------------------------------------------------------------
// BLAKE2b (RFC 7693)
// ---------------------------------------------------------------------------

const uint64_t B2B_IV[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL,
    0x3c6ef372fe94f82bULL, 0xa54ff53a5f1d36f1ULL,
    0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
    0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};

const uint8_t B2B_SIGMA[12][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3}};

inline uint64_t rotr64(uint64_t x, int n) {
    return (x >> n) | (x << (64 - n));
}

inline void b2b_g(uint64_t* v, int a, int b, int c, int d,
                  uint64_t x, uint64_t y) {
    v[a] = v[a] + v[b] + x;
    v[d] = rotr64(v[d] ^ v[a], 32);
    v[c] = v[c] + v[d];
    v[b] = rotr64(v[b] ^ v[c], 24);
    v[a] = v[a] + v[b] + y;
    v[d] = rotr64(v[d] ^ v[a], 16);
    v[c] = v[c] + v[d];
    v[b] = rotr64(v[b] ^ v[c], 63);
}

struct Blake2bState {
    uint64_t h[8];
    uint64_t t[2];
    uint8_t buf[128];
    size_t buflen;
    size_t outlen;
};

void b2b_compress(Blake2bState* S, const uint8_t* block, bool last) {
    uint64_t v[16], m[16];
    for (int i = 0; i < 16; i++)
        std::memcpy(&m[i], block + 8 * i, 8);  // little-endian hosts
    for (int i = 0; i < 8; i++) v[i] = S->h[i];
    for (int i = 0; i < 8; i++) v[i + 8] = B2B_IV[i];
    v[12] ^= S->t[0];
    v[13] ^= S->t[1];
    if (last) v[14] = ~v[14];
    for (int r = 0; r < 12; r++) {
        const uint8_t* s = B2B_SIGMA[r];
        b2b_g(v, 0, 4, 8, 12, m[s[0]], m[s[1]]);
        b2b_g(v, 1, 5, 9, 13, m[s[2]], m[s[3]]);
        b2b_g(v, 2, 6, 10, 14, m[s[4]], m[s[5]]);
        b2b_g(v, 3, 7, 11, 15, m[s[6]], m[s[7]]);
        b2b_g(v, 0, 5, 10, 15, m[s[8]], m[s[9]]);
        b2b_g(v, 1, 6, 11, 12, m[s[10]], m[s[11]]);
        b2b_g(v, 2, 7, 8, 13, m[s[12]], m[s[13]]);
        b2b_g(v, 3, 4, 9, 14, m[s[14]], m[s[15]]);
    }
    for (int i = 0; i < 8; i++) S->h[i] ^= v[i] ^ v[i + 8];
}

void b2b_init(Blake2bState* S, size_t outlen) {
    std::memset(S, 0, sizeof(*S));
    for (int i = 0; i < 8; i++) S->h[i] = B2B_IV[i];
    S->h[0] ^= 0x01010000ULL ^ (uint64_t)outlen;  // no key
    S->outlen = outlen;
}

void b2b_update(Blake2bState* S, const uint8_t* in, size_t inlen) {
    while (inlen > 0) {
        if (S->buflen == 128) {
            S->t[0] += 128;
            if (S->t[0] < 128) S->t[1]++;
            b2b_compress(S, S->buf, false);
            S->buflen = 0;
        }
        size_t take = 128 - S->buflen;
        if (take > inlen) take = inlen;
        std::memcpy(S->buf + S->buflen, in, take);
        S->buflen += take;
        in += take;
        inlen -= take;
    }
}

void b2b_final(Blake2bState* S, uint8_t* out) {
    S->t[0] += S->buflen;
    if (S->t[0] < S->buflen) S->t[1]++;
    std::memset(S->buf + S->buflen, 0, 128 - S->buflen);
    b2b_compress(S, S->buf, true);
    std::memcpy(out, S->h, S->outlen);
}

// ---------------------------------------------------------------------------
// Blake2Engine: counter-mode CSPRNG (blake2engine.h role)
// ---------------------------------------------------------------------------

struct Blake2Engine {
    uint8_t seed[32];
    uint64_t counter;
    uint8_t pool[64];
    size_t avail;

    void init(const uint8_t* s) {
        std::memcpy(seed, s, 32);
        counter = 0;
        avail = 0;
    }

    void refill() {
        Blake2bState st;
        b2b_init(&st, 64);
        b2b_update(&st, seed, 32);
        uint8_t ctr[8];
        std::memcpy(ctr, &counter, 8);
        b2b_update(&st, ctr, 8);
        b2b_final(&st, pool);
        counter++;
        avail = 64;
    }

    uint64_t next_u64() {
        if (avail < 8) refill();
        uint64_t x;
        std::memcpy(&x, pool + (64 - avail), 8);
        avail -= 8;
        return x;
    }

    // rejection-sampled uniform in [0, q)
    uint64_t uniform(uint64_t q) {
        uint64_t lim = UINT64_MAX - (UINT64_MAX % q);
        uint64_t x;
        do {
            x = next_u64();
        } while (x >= lim);
        return x % q;
    }

    // uniform double in [0, 1)
    double uniform01() {
        return (next_u64() >> 11) * (1.0 / 9007199254740992.0);
    }

    // discrete Gaussian by Box-Muller + rounding (reference default
    // generator's rounded-continuous mode, discretegaussiangenerator.h)
    int64_t gaussian(double std_dev) {
        double u1 = uniform01(), u2 = uniform01();
        if (u1 < 1e-300) u1 = 1e-300;
        double g = std::sqrt(-2.0 * std::log(u1)) *
                   std::cos(2.0 * M_PI * u2);
        return (int64_t)std::llround(g * std_dev);
    }
};

}  // namespace

extern "C" {

int fhe_client_version() { return 10400; }  // tracks reference "1.4.2" ABI

// BLAKE2b one-shot hash (out 1..64 bytes)
void fhe_blake2b(const uint8_t* in, int64_t inlen, uint8_t* out,
                 int outlen) {
    Blake2bState st;
    b2b_init(&st, (size_t)outlen);
    b2b_update(&st, in, (size_t)inlen);
    b2b_final(&st, out);
}

// Fill `out[count]` with uniform uint64 values in [0, q) from seed||stream
void fhe_prng_uniform(const uint8_t* seed32, uint64_t stream, uint64_t q,
                      uint64_t* out, int64_t count) {
    Blake2Engine eng;
    uint8_t s[32];
    std::memcpy(s, seed32, 32);
    // domain-separate streams by folding the stream id into the seed
    for (int i = 0; i < 8; i++) s[i] ^= (uint8_t)(stream >> (8 * i));
    eng.init(s);
    for (int64_t i = 0; i < count; i++) out[i] = eng.uniform(q);
}

void fhe_prng_gaussian(const uint8_t* seed32, uint64_t stream,
                       double std_dev, int64_t* out, int64_t count) {
    Blake2Engine eng;
    uint8_t s[32];
    std::memcpy(s, seed32, 32);
    for (int i = 0; i < 8; i++) s[i] ^= (uint8_t)(stream >> (8 * i));
    eng.init(s);
    for (int64_t i = 0; i < count; i++) out[i] = eng.gaussian(std_dev);
}

// Ternary secret key in {-1,0,1}
void fhe_lwe_keygen(const uint8_t* seed32, int n, int32_t* sk_out) {
    Blake2Engine eng;
    eng.init(seed32);
    for (int i = 0; i < n; i++)
        sk_out[i] = (int32_t)eng.uniform(3) - 1;
}

// Batch LWE encrypt: b = <a, s> + e + m*(q/p) mod q.
// a_out: [batch, n] row-major; b_out: [batch].
void fhe_lwe_encrypt(const int32_t* sk, int n, uint64_t q, int p,
                     const int32_t* m, int64_t batch,
                     const uint8_t* seed32, double std_dev,
                     uint32_t* a_out, uint32_t* b_out) {
    Blake2Engine eng;
    eng.init(seed32);
    for (int64_t j = 0; j < batch; j++) {
        uint64_t dot = 0;
        uint32_t* row = a_out + j * n;
        for (int i = 0; i < n; i++) {
            uint64_t ai = eng.uniform(q);
            row[i] = (uint32_t)ai;
            int64_t si = sk[i];
            uint64_t term = (uint64_t)((__int128)ai * ((si % (int64_t)q +
                            (int64_t)q) % (int64_t)q) % q);
            dot = (dot + term) % q;
        }
        int64_t e = eng.gaussian(std_dev);
        uint64_t enc = (uint64_t)(((int64_t)(m[j] % p) * (int64_t)(q / p) +
                                   e) % (int64_t)q + (int64_t)q) % q;
        b_out[j] = (uint32_t)((dot + enc) % q);
    }
}

// Batch LWE decrypt: m = round(p/q * (b - <a, s>)) mod p
void fhe_lwe_decrypt(const int32_t* sk, int n, uint64_t q, int p,
                     const uint32_t* a, const uint32_t* b, int64_t batch,
                     int32_t* m_out) {
    for (int64_t j = 0; j < batch; j++) {
        uint64_t dot = 0;
        const uint32_t* row = a + j * n;
        for (int i = 0; i < n; i++) {
            int64_t si = sk[i];
            uint64_t sm = (uint64_t)((si % (int64_t)q + (int64_t)q) %
                                     (int64_t)q);
            dot = (dot + (uint64_t)((__int128)row[i] * sm % q)) % q;
        }
        uint64_t r = (b[j] + q - dot) % q;
        r = (r + q / (2 * (uint64_t)p)) % q;
        m_out[j] = (int32_t)(((__int128)r * p) / q % p);
    }
}

}  // extern "C"
