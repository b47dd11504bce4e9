// CRT codec: exact big-integer reconstruction / reduction for RNS residue
// tensors -- the native runtime component backing host-side encode/decode.
//
// Role parity: the reference's math HAL big-integer backends
// (the reference's src/core/include/math/hal/bigintfxd, used by
// DCRTPolyImpl::CRTInterpolate) -- here re-scoped to the only places the
// framework needs host big-int arithmetic: decrypt-side CRT
// reconstruction (centered mod-t for BGV, scaled-round for BFV, centered
// double for CKKS) and encrypt-side residue generation.
//
// Port of fhe_tpu/native/crt_codec.cpp with one change: a lifted
// coefficient is reduced mod Q by binary long division (big_mod), where
// fhe_tpu's subtracts Q once per step, up to max(q_i) ~ 2^28 steps a
// coefficient (about a second a coefficient).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 crt_codec.cpp -o libcrt_codec.so
// (no external dependencies; uses unsigned __int128).

#include <cstdint>
#include <cstring>
#include <vector>

using u32 = uint32_t;
using u64 = uint64_t;
using u128 = unsigned __int128;

namespace {

// little-endian multi-word big integer helpers (words = u64)
struct Big {
    std::vector<u64> w;
    void trim() { while (w.size() > 1 && w.back() == 0) w.pop_back(); }
};

void big_add(Big& a, const Big& b) {
    size_t n = std::max(a.w.size(), b.w.size());
    a.w.resize(n, 0);
    u64 carry = 0;
    for (size_t i = 0; i < n; ++i) {
        u128 s = (u128)a.w[i] + (i < b.w.size() ? b.w[i] : 0) + carry;
        a.w[i] = (u64)s;
        carry = (u64)(s >> 64);
    }
    if (carry) a.w.push_back(carry);
}

void big_mul_u64(Big& a, u64 m) {
    u64 carry = 0;
    for (size_t i = 0; i < a.w.size(); ++i) {
        u128 p = (u128)a.w[i] * m + carry;
        a.w[i] = (u64)p;
        carry = (u64)(p >> 64);
    }
    if (carry) a.w.push_back(carry);
}

// a mod m (m < 2^63) for multi-word a
u64 big_mod_u64(const Big& a, u64 m) {
    u128 r = 0;
    for (size_t i = a.w.size(); i-- > 0;) {
        r = ((r << 64) | a.w[i]) % m;  // note: (r<<64) needs r < m < 2^63
    }
    return (u64)r;
}

// compare a >= b
bool big_ge(const Big& a, const Big& b) {
    size_t n = std::max(a.w.size(), b.w.size());
    for (size_t i = n; i-- > 0;) {
        u64 x = i < a.w.size() ? a.w[i] : 0;
        u64 y = i < b.w.size() ? b.w[i] : 0;
        if (x != y) return x > y;
    }
    return true;
}

void big_sub(Big& a, const Big& b) {  // a -= b, requires a >= b
    u64 borrow = 0;
    for (size_t i = 0; i < a.w.size(); ++i) {
        u64 y = (i < b.w.size() ? b.w[i] : 0);
        u128 d = (u128)a.w[i] - y - borrow;
        a.w[i] = (u64)d;
        borrow = (u64)(d >> 64) ? 1 : 0;
    }
    a.trim();
}

// Precompute CRT lift constants: for basis {q_i}, c_i = qhat_i * inv_i mod Q
// where qhat_i = Q / q_i, inv_i = qhat_i^{-1} mod q_i.
struct CrtPlan {
    std::vector<Big> c;   // [L] lift coefficients mod Q
    Big Q;                // product
    Big Qhalf;
};

u64 inv_mod_u64(u64 a, u64 m) {  // extended euclid, m < 2^63
    int64_t t = 0, newt = 1;
    int64_t r = (int64_t)m, newr = (int64_t)(a % m);
    while (newr != 0) {
        int64_t qq = r / newr;
        int64_t tmp = t - qq * newt; t = newt; newt = tmp;
        tmp = r - qq * newr; r = newr; newr = tmp;
    }
    if (t < 0) t += (int64_t)m;
    return (u64)t;
}

// a %= m by binary long division: subtract the largest m * 2^k <= a until
// a < m (one subtraction per quotient bit; subtracting m alone would take
// up to a / m steps, ~2^28 for a lifted coefficient)
void big_mod(Big& a, const Big& m) {
    while (big_ge(a, m)) {
        Big next = m;
        while (true) {
            Big try2 = next;
            big_mul_u64(try2, 2);
            if (big_ge(a, try2)) next = try2; else break;
        }
        big_sub(a, next);
    }
}

CrtPlan make_plan(const u32* mods, int L) {
    CrtPlan p;
    p.Q.w = {1};
    for (int i = 0; i < L; ++i) big_mul_u64(p.Q, mods[i]);
    p.c.resize(L);
    for (int i = 0; i < L; ++i) {
        Big qhat; qhat.w = {1};
        for (int j = 0; j < L; ++j)
            if (j != i) big_mul_u64(qhat, mods[j]);
        u64 qhat_mod = big_mod_u64(qhat, mods[i]);
        u64 inv = inv_mod_u64(qhat_mod, mods[i]);
        big_mul_u64(qhat, inv);
        big_mod(qhat, p.Q);
        p.c[i] = qhat;
    }
    // Qhalf = Q / 2
    p.Qhalf = p.Q;
    u64 rem = 0;
    for (size_t i = p.Qhalf.w.size(); i-- > 0;) {
        u128 cur = ((u128)rem << 64) | p.Qhalf.w[i];
        p.Qhalf.w[i] = (u64)(cur >> 1);
        rem = (u64)(cur & 1);
    }
    p.Qhalf.trim();
    return p;
}

// reconstruct one coefficient: x = sum_i r_i * c_i mod Q
void lift(const CrtPlan& p, const u32* res, int L, int stride, Big& out) {
    out.w.assign(1, 0);
    for (int i = 0; i < L; ++i) {
        Big t = p.c[i];
        big_mul_u64(t, res[(size_t)i * stride]);
        big_add(out, t);
    }
    // out < L * max(q_i) * Q
    big_mod(out, p.Q);
}

}  // namespace

extern "C" {

// residues: [L, N] uint32 (limb-major); out: [N] int64 = centered(x) mod t
// (result in [0, t)). Exact for any t < 2^62.
void crt_center_mod(const u32* residues, const u32* mods, int L, int N,
                    u64 t, int64_t* out) {
    CrtPlan p = make_plan(mods, L);
    Big x;
    for (int k = 0; k < N; ++k) {
        lift(p, residues + k, L, N, x);
        u64 r = big_mod_u64(x, t);
        if (big_ge(x, p.Qhalf) && !big_ge(p.Qhalf, x)) {
            // x > Q/2: centered value x - Q; (x - Q) mod t = r - (Q mod t)
            u64 qt = big_mod_u64(p.Q, t);
            r = (r + t - qt) % t;
        }
        out[k] = (int64_t)r;
    }
}

// out: [N] float64 = centered(x) as double (CKKS decode input)
void crt_center_double(const u32* residues, const u32* mods, int L, int N,
                       double* out) {
    CrtPlan p = make_plan(mods, L);
    Big x;
    for (int k = 0; k < N; ++k) {
        lift(p, residues + k, L, N, x);
        bool neg = big_ge(x, p.Qhalf) && !big_ge(p.Qhalf, x);
        Big v = x;
        if (neg) { Big q = p.Q; big_sub(q, x); v = q; }
        double d = 0, scale = 1;
        for (size_t i = 0; i < v.w.size(); ++i) {
            d += (double)v.w[i] * scale;
            scale *= 18446744073709551616.0;  // 2^64
        }
        out[k] = neg ? -d : d;
    }
}

// out: [N] int64 = round(t * x / Q) mod t (BFV decrypt), exact integers
void crt_scale_round_mod(const u32* residues, const u32* mods, int L, int N,
                         u64 t, int64_t* out) {
    CrtPlan p = make_plan(mods, L);
    Big x;
    for (int k = 0; k < N; ++k) {
        lift(p, residues + k, L, N, x);
        // y = 2*t*x + Q ; result = floor(y / (2Q)) mod t
        big_mul_u64(x, 2 * t);
        big_add(x, p.Q);
        // divide by 2Q via schoolbook long division (divisor multi-word):
        // compute quotient mod t only: q = (y - (y mod 2Q)) / 2Q.
        // Since we only need q mod t, do: q mod t = ((y - r) / 2Q) mod t.
        // Simplest exact route: full long division.
        Big div = p.Q; big_mul_u64(div, 2);
        // long division: repeated shift-subtract (bit by bit)
        int bits = (int)(x.w.size() * 64);
        Big rem; rem.w = {0};
        u64 qmodt = 0;
        for (int b = bits - 1; b >= 0; --b) {
            // rem = rem*2 + bit b of x
            big_mul_u64(rem, 2);
            u64 bit = (x.w[b / 64] >> (b % 64)) & 1;
            if (bit) { Big one; one.w = {1}; big_add(rem, one); }
            qmodt = (u64)((((u128)qmodt) * 2) % t);
            if (big_ge(rem, div)) { big_sub(rem, div); qmodt = (qmodt + 1) % t; }
        }
        out[k] = (int64_t)qmodt;
    }
}

// residues out: [L, N] uint32 from int64 signed coefficients (encrypt side)
void signed_to_residues(const int64_t* coeffs, const u32* mods, int L, int N,
                        u32* out) {
    for (int i = 0; i < L; ++i) {
        int64_t m = (int64_t)mods[i];
        for (int k = 0; k < N; ++k) {
            int64_t v = coeffs[k] % m;
            if (v < 0) v += m;
            out[(size_t)i * N + k] = (u32)v;
        }
    }
}

}  // extern "C"
