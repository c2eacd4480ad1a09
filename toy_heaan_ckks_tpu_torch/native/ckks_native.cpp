// Native host runtime of the PyTorch/CUDA CKKS port.
//
// The card owns the ring arithmetic; this layer owns the host-side runtime
// around it: deterministic Miller-Rabin prime machinery, exact residue
// reduction at encode, and exact centered CRT reconstruction at decode
// (schoolbook multiword integers, no Q < 2^128 ceiling). It is the port's
// own copy of the JAX package's native layer, with the same C ABI and the
// same results.
//
// Exposed as a plain C ABI consumed via ctypes.

#include <cstdint>
#include <cstring>
#include <initializer_list>

using u64 = uint64_t;
using u32 = uint32_t;
using i64 = int64_t;
using u128 = unsigned __int128;

static inline u64 mulmod(u64 a, u64 b, u64 m) {
    return (u64)(((u128)a * b) % m);
}

static u64 powmod(u64 a, u64 e, u64 m) {
    u64 r = 1 % m;
    a %= m;
    while (e) {
        if (e & 1) r = mulmod(r, a, m);
        a = mulmod(a, a, m);
        e >>= 1;
    }
    return r;
}

// Deterministic Miller-Rabin for u64: the reference's 12 fixed bases
// (src/math/primes.rs:21) form a deterministic witness set for n < 3.3e24.
extern "C" int ckks_is_prime_u64(u64 n) {
    if (n < 2) return 0;
    for (u64 p : {2ull, 3ull, 5ull, 7ull, 11ull, 13ull, 17ull, 19ull,
                  23ull, 29ull, 31ull, 37ull}) {
        if (n == p) return 1;
        if (n % p == 0) return 0;
    }
    u64 d = n - 1;
    int r = 0;
    while ((d & 1) == 0) { d >>= 1; ++r; }
    for (u64 a : {2ull, 3ull, 5ull, 7ull, 11ull, 13ull, 17ull, 19ull,
                  23ull, 29ull, 31ull, 37ull}) {
        u64 x = powmod(a, d, n);
        if (x == 1 || x == n - 1) continue;
        bool witness = true;
        for (int i = 0; i < r - 1; ++i) {
            x = mulmod(x, x, n);
            if (x == n - 1) { witness = false; break; }
        }
        if (witness) return 0;
    }
    return 1;
}

// First prime p == 1 (mod two_n) with p > start, stepping the congruence
// class (reference: src/math/primes.rs:171-197). Returns 0 on u64 overflow.
extern "C" u64 ckks_first_prime_up(u64 start, u64 two_n) {
    u64 rem = start % two_n;
    u64 cand;
    if (rem == 1) {
        if (start > UINT64_MAX - two_n) return 0;
        cand = start + two_n;
    } else {
        u64 add = (two_n + 1 - rem) % two_n;
        if (start > UINT64_MAX - add) return 0;
        cand = start + add;
        if (cand <= start) return 0;
    }
    while (!ckks_is_prime_u64(cand)) {
        if (cand > UINT64_MAX - two_n) return 0;
        cand += two_n;
    }
    return cand;
}

// Largest prime p == 1 (mod two_n) with p < bound, or 0 if none
// (reference: src/math/primes.rs:199-219).
extern "C" u64 ckks_first_prime_down(u64 bound, u64 two_n) {
    if (bound <= 2) return 0;
    u64 v = bound - 1;
    u64 rem = v % two_n;
    u64 delta = (rem + two_n - 1) % two_n;
    if (delta > v) return 0;
    u64 cand = v - delta;
    for (;;) {
        if (cand <= 2) return 0;
        if (ckks_is_prime_u64(cand)) return cand;
        if (cand < two_n) return 0;
        cand -= two_n;
    }
}

// out[i*n + j] = coeffs[j] mod moduli[i], non-negative (rem_euclid —
// reference: src/rings/backends/rns_ntt/poly.rs:49-67).
extern "C" void ckks_reduce_coeffs(const i64* coeffs, i64 n,
                                   const u64* moduli, i64 L, u64* out) {
    for (i64 i = 0; i < L; ++i) {
        const i64 q = (i64)moduli[i];
        u64* row = out + (size_t)i * n;
        for (i64 j = 0; j < n; ++j) {
            i64 r = coeffs[j] % q;
            if (r < 0) r += q;
            row[j] = (u64)r;
        }
    }
}

// ── multiword (little-endian u64 limbs) helpers for CRT ─────────────────────

static void mw_add(u64* a, const u64* b, int W) {  // a += b
    unsigned __int128 carry = 0;
    for (int i = 0; i < W; ++i) {
        unsigned __int128 s = (unsigned __int128)a[i] + b[i] + (u64)carry;
        a[i] = (u64)s;
        carry = s >> 64;
    }
}

static void mw_sub(u64* a, const u64* b, int W) {  // a -= b (mod 2^(64W))
    unsigned __int128 borrow = 0;
    for (int i = 0; i < W; ++i) {
        unsigned __int128 d =
            (unsigned __int128)a[i] - b[i] - (u64)borrow;
        a[i] = (u64)d;
        borrow = (d >> 64) ? 1 : 0;
    }
}

static int mw_cmp(const u64* a, const u64* b, int W) {
    for (int i = W - 1; i >= 0; --i) {
        if (a[i] != b[i]) return a[i] < b[i] ? -1 : 1;
    }
    return 0;
}

static void mw_mul_u64_add(u64* acc, const u64* a, u64 s, int W) {
    // acc += a * s
    u64 carry = 0;
    for (int i = 0; i < W; ++i) {
        u128 p = (u128)a[i] * s + acc[i] + carry;
        acc[i] = (u64)p;
        carry = (u64)(p >> 64);
    }
}

static void mw_mul_u64(u64* out, const u64* a, u64 s, int W) {
    u64 carry = 0;
    for (int i = 0; i < W; ++i) {
        u128 p = (u128)a[i] * s + carry;
        out[i] = (u64)p;
        carry = (u64)(p >> 64);
    }
}

// out = a / d (multiword by u64); returns remainder.
static u64 mw_div_u64(u64* out, const u64* a, u64 d, int W) {
    u128 rem = 0;
    for (int i = W - 1; i >= 0; --i) {
        u128 cur = (rem << 64) | a[i];
        out[i] = (u64)(cur / d);
        rem = cur % d;
    }
    return (u64)rem;
}

static u64 inv_mod_u64(u64 a, u64 m) {
    // extended Euclid on i128 (m < 2^63 in practice)
    __int128 t = 0, newt = 1, r = m, newr = a % m;
    while (newr != 0) {
        __int128 qq = r / newr;
        __int128 tmp = t - qq * newt; t = newt; newt = tmp;
        tmp = r - qq * newr; r = newr; newr = tmp;
    }
    if (t < 0) t += m;
    return (u64)t;
}

// Centered CRT reconstruction: residues (L x n, row-major) -> n coefficient
// values in two's-complement little-endian u64 words (W words each),
// centered in (-Q/2, Q/2]. W must satisfy 2^(64W) > 2 * L * Q.
// Reference semantics: basis.rs:158-180, without its Q < 2^128 ceiling.
extern "C" int ckks_crt_reconstruct(const u64* residues, i64 n,
                                    const u64* moduli, i64 L, i64 W,
                                    u64* out) {
    if (W > 64 || L > 256) return -1;
    u64 Q[64] = {0};
    Q[0] = 1;
    for (i64 i = 0; i < L; ++i) mw_mul_u64(Q, Q, moduli[i], (int)W);

    // Qi = Q / q_i; qi_inv = (Qi mod q_i)^{-1} mod q_i
    u64* Qi = new u64[(size_t)L * W];
    u64* qi_inv = new u64[L];
    for (i64 i = 0; i < L; ++i) {
        mw_div_u64(Qi + (size_t)i * W, Q, moduli[i], (int)W);
        // Qi mod q_i via repeated folding
        u128 rem = 0;
        for (int w = (int)W - 1; w >= 0; --w)
            rem = ((rem << 64) | Qi[(size_t)i * W + w]) % moduli[i];
        qi_inv[i] = inv_mod_u64((u64)rem, moduli[i]);
    }

    u64 halfQ[64];
    std::memcpy(halfQ, Q, sizeof(halfQ));
    // halfQ = Q / 2
    for (int i = 0; i < (int)W; ++i) {
        halfQ[i] = (Q[i] >> 1) |
                   ((i + 1 < (int)W) ? (Q[i + 1] << 63) : 0);
    }

    u64 acc[64];
    for (i64 j = 0; j < n; ++j) {
        std::memset(acc, 0, sizeof(acc));
        for (i64 i = 0; i < L; ++i) {
            u64 r = residues[(size_t)i * n + j] % moduli[i];
            u64 s = mulmod(r, qi_inv[i], moduli[i]);
            mw_mul_u64_add(acc, Qi + (size_t)i * W, s, (int)W);
        }
        // acc < L * Q: reduce by repeated subtraction (L small)
        while (mw_cmp(acc, Q, (int)W) >= 0) mw_sub(acc, Q, (int)W);
        // center: if acc > Q/2, acc -= Q (wraps to two's complement)
        if (mw_cmp(acc, halfQ, (int)W) > 0) mw_sub(acc, Q, (int)W);
        std::memcpy(out + (size_t)j * W, acc, (size_t)W * 8);
    }
    delete[] Qi;
    delete[] qi_inv;
    return 0;
}

// Batched residue-to-double decode helper: value = centered(x)/2^scale as
// f64 (sufficient for slot decode; exact path is ckks_crt_reconstruct).
extern "C" int ckks_crt_to_double(const u64* residues, i64 n,
                                  const u64* moduli, i64 L, i64 W,
                                  double scale, double* out) {
    u64* words = new u64[(size_t)n * W];
    int rc = ckks_crt_reconstruct(residues, n, moduli, L, W, words);
    if (rc != 0) { delete[] words; return rc; }
    for (i64 j = 0; j < n; ++j) {
        const u64* w = words + (size_t)j * W;
        bool neg = (w[W - 1] >> 63) != 0;
        double v = 0.0, base = 1.0;
        if (!neg) {
            for (int i = 0; i < (int)W; ++i) {
                v += (double)w[i] * base;
                base *= 18446744073709551616.0;
            }
        } else {
            // two's complement negative: v = -(~w + 1)
            u128 carry = 1;
            for (int i = 0; i < (int)W; ++i) {
                u128 s = (u128)(~w[i]) + (u64)carry;
                v += (double)((u64)s) * base;
                carry = s >> 64;
                base *= 18446744073709551616.0;
            }
            v = -v;
        }
        out[j] = v / scale;
    }
    delete[] words;
    return 0;
}
