// Full lux_fhe_* C API over fhe_tpu_torch's compute path (the port's copy
// of fhe_tpu/native/capi.cpp: the same symbols and signatures).
//
// Reference surface: the reference's src/c_api/c_api.cpp:73-366 -
// opaque handles, integer error codes, context/keys/encrypt/decrypt/
// gates/mux/bootstrap/marshal.  The reference wraps BinFHEContext
// in-process; here the compute path is Python (PyTorch on the card), so this
// library embeds (or joins) a CPython interpreter and delegates to
// fhe_tpu_torch.native.capi_impl, which keeps the handle registries.  The C
// side only moves int64 handles and byte buffers — no numpy C API.
//
// Two load modes:
//  * joined: loaded (via ctypes/cgo) into a process that already runs
//    Python — we only take the GIL (PyGILState_Ensure).
//  * embedded: a plain C program links this library; the first call
//    initializes an interpreter.  Set FHE_TPU_PATH to the repo root if
//    fhe_tpu_torch is not on the default sys.path.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 capi.cpp $(python3-config
//        --includes) [-lpython3.X] -o libfhecapi.so

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <string>

extern "C" {

typedef enum {
    LUX_FHE_OK = 0,
    LUX_FHE_ERR_NULL_PTR = 1,
    LUX_FHE_ERR_ALLOC = 2,
    LUX_FHE_ERR_NOT_INIT = 3,
    LUX_FHE_ERR_CONTEXT = 4,
    LUX_FHE_ERR_KEYGEN = 5,
    LUX_FHE_ERR_ENCRYPT = 6,
    LUX_FHE_ERR_DECRYPT = 7,
    LUX_FHE_ERR_GATE = 8,
    LUX_FHE_ERR_BOOTSTRAP = 9,
    LUX_FHE_ERR_SERIAL = 10,
} LuxFheError;

typedef struct { int64_t id; } LuxFheContext;
typedef struct { int64_t id; } LuxFheSecretKey;
typedef struct { int64_t id; } LuxFhePublicKey;
typedef struct { int64_t id; int generated; } LuxFheBootstrapKey;
typedef struct { int64_t id; } LuxFheCiphertext;

static PyObject* g_impl = nullptr;   // fhe_tpu_torch.native.capi_impl module
static int g_owns_interp = 0;

static int ensure_python() {
    if (!Py_IsInitialized()) {
        Py_InitializeEx(0);
        g_owns_interp = 1;
    }
    return 1;
}

// Returns the impl module with the GIL HELD; caller must release via
// PyGILState_Release(*state).  nullptr on failure (GIL released).
static PyObject* impl_acquire(PyGILState_STATE* state) {
    if (!ensure_python()) return nullptr;
    *state = PyGILState_Ensure();
    if (!g_impl) {
        const char* extra = getenv("FHE_TPU_PATH");
        if (extra && *extra) {
            PyObject* sys_path = PySys_GetObject("path");  // borrowed
            PyObject* p = PyUnicode_FromString(extra);
            if (sys_path && p) PyList_Insert(sys_path, 0, p);
            Py_XDECREF(p);
        }
        g_impl = PyImport_ImportModule("fhe_tpu_torch.native.capi_impl");
        if (!g_impl) {
            PyErr_Clear();
            PyGILState_Release(*state);
            return nullptr;
        }
    }
    return g_impl;
}

// Call impl.<name>(args...) -> int64 handle/value; -1 + err on failure.
static int64_t call_i64(const char* name, const char* fmt, ...) {
    PyGILState_STATE st;
    PyObject* mod = impl_acquire(&st);
    if (!mod) return -1;
    PyObject* func = PyObject_GetAttrString(mod, name);
    PyObject* args = nullptr;
    if (fmt) {
        va_list ap;
        va_start(ap, fmt);
        args = Py_VaBuildValue(fmt, ap);
        va_end(ap);
        if (args && !PyTuple_Check(args)) {   // single-arg fmt -> 1-tuple
            PyObject* t = PyTuple_Pack(1, args);
            Py_DECREF(args);
            args = t;
        }
    } else {
        args = PyTuple_New(0);
    }
    PyObject* ret = (func && args) ? PyObject_CallObject(func, args)
                                   : nullptr;
    Py_XDECREF(func);
    Py_XDECREF(args);
    int64_t out = -1;
    if (ret) {
        out = PyLong_AsLongLong(ret);
        if (PyErr_Occurred()) { PyErr_Clear(); out = -1; }
        Py_DECREF(ret);
    } else {
        PyErr_Clear();
    }
    PyGILState_Release(st);
    return out;
}

const char* lux_fhe_version(void) { return "1.4.2"; }

int lux_fhe_has_gpu(void) {
    return (int)call_i64("has_tpu", nullptr);
}

const char* lux_fhe_strerror(LuxFheError err) {
    switch (err) {
        case LUX_FHE_OK:            return "ok";
        case LUX_FHE_ERR_NULL_PTR:  return "null pointer argument";
        case LUX_FHE_ERR_ALLOC:     return "allocation failed";
        case LUX_FHE_ERR_NOT_INIT:  return "not initialized";
        case LUX_FHE_ERR_CONTEXT:   return "context creation failed";
        case LUX_FHE_ERR_KEYGEN:    return "key generation failed";
        case LUX_FHE_ERR_ENCRYPT:   return "encryption failed";
        case LUX_FHE_ERR_DECRYPT:   return "decryption failed";
        case LUX_FHE_ERR_GATE:      return "gate evaluation failed";
        case LUX_FHE_ERR_BOOTSTRAP: return "bootstrap failed";
        case LUX_FHE_ERR_SERIAL:    return "serialization failed";
    }
    return "unknown error";
}

LuxFheError lux_fhe_context_new(const char* param_set, const char* method,
                                LuxFheContext** out) {
    if (!param_set || !out) return LUX_FHE_ERR_NULL_PTR;
    int64_t id = call_i64("context_new", "ss", param_set,
                          method ? method : "GINX");
    if (id < 0) return LUX_FHE_ERR_CONTEXT;
    auto* c = new (std::nothrow) LuxFheContext{id};
    if (!c) return LUX_FHE_ERR_ALLOC;
    *out = c;
    return LUX_FHE_OK;
}

void lux_fhe_context_free(LuxFheContext* ctx) {
    if (!ctx) return;
    call_i64("context_free", "L", (long long)ctx->id);
    delete ctx;
}

int64_t lux_fhe_context_n(LuxFheContext* ctx) {
    return ctx ? call_i64("context_n", "L", (long long)ctx->id) : -1;
}

int64_t lux_fhe_context_ring_dim(LuxFheContext* ctx) {
    return ctx ? call_i64("context_ring_dim", "L", (long long)ctx->id) : -1;
}

int64_t lux_fhe_context_modulus(LuxFheContext* ctx) {
    return ctx ? call_i64("context_modulus", "L", (long long)ctx->id) : -1;
}

LuxFheError lux_fhe_keygen_secret(LuxFheContext* ctx, uint64_t seed,
                                  LuxFheSecretKey** out) {
    if (!ctx || !out) return LUX_FHE_ERR_NULL_PTR;
    int64_t id = call_i64("keygen_secret", "LK", (long long)ctx->id,
                          (unsigned long long)seed);
    if (id < 0) return LUX_FHE_ERR_KEYGEN;
    *out = new LuxFheSecretKey{id};
    return LUX_FHE_OK;
}

LuxFheError lux_fhe_keygen_bootstrap(LuxFheContext* ctx,
                                     LuxFheSecretKey* sk,
                                     LuxFheBootstrapKey** out) {
    if (!ctx || !sk || !out) return LUX_FHE_ERR_NULL_PTR;
    int64_t id = call_i64("keygen_bootstrap", "LL", (long long)ctx->id,
                          (long long)sk->id);
    if (id < 0) return LUX_FHE_ERR_KEYGEN;
    *out = new LuxFheBootstrapKey{id, 1};
    return LUX_FHE_OK;
}

LuxFheError lux_fhe_keygen_public(LuxFheContext* ctx, LuxFheSecretKey* sk,
                                  LuxFhePublicKey** out) {
    if (!ctx || !sk || !out) return LUX_FHE_ERR_NULL_PTR;
    int64_t id = call_i64("keygen_public", "LL", (long long)ctx->id,
                          (long long)sk->id);
    if (id < 0) return LUX_FHE_ERR_KEYGEN;
    *out = new LuxFhePublicKey{id};
    return LUX_FHE_OK;
}

void lux_fhe_secretkey_free(LuxFheSecretKey* k) {
    if (!k) return;
    call_i64("key_free", "L", (long long)k->id);
    delete k;
}

void lux_fhe_publickey_free(LuxFhePublicKey* k) {
    if (!k) return;
    call_i64("key_free", "L", (long long)k->id);
    delete k;
}

void lux_fhe_bootstrapkey_free(LuxFheBootstrapKey* k) {
    if (!k) return;
    call_i64("key_free", "L", (long long)k->id);
    delete k;
}

LuxFheError lux_fhe_encrypt(LuxFheContext* ctx, LuxFheSecretKey* sk,
                            int plaintext, LuxFheCiphertext** out) {
    if (!ctx || !sk || !out) return LUX_FHE_ERR_NULL_PTR;
    int64_t id = call_i64("encrypt", "LLi", (long long)ctx->id,
                          (long long)sk->id, plaintext ? 1 : 0);
    if (id < 0) return LUX_FHE_ERR_ENCRYPT;
    *out = new LuxFheCiphertext{id};
    return LUX_FHE_OK;
}

LuxFheError lux_fhe_encrypt_pk(LuxFheContext* ctx, LuxFhePublicKey* pk,
                               LuxFheSecretKey* rng_src, int plaintext,
                               LuxFheCiphertext** out) {
    if (!ctx || !pk || !rng_src || !out) return LUX_FHE_ERR_NULL_PTR;
    int64_t id = call_i64("encrypt_pk", "LLLi", (long long)ctx->id,
                          (long long)pk->id, (long long)rng_src->id,
                          plaintext ? 1 : 0);
    if (id < 0) return LUX_FHE_ERR_ENCRYPT;
    *out = new LuxFheCiphertext{id};
    return LUX_FHE_OK;
}

LuxFheError lux_fhe_decrypt(LuxFheContext* ctx, LuxFheSecretKey* sk,
                            LuxFheCiphertext* ct, int* plaintext) {
    if (!ctx || !sk || !ct || !plaintext) return LUX_FHE_ERR_NULL_PTR;
    int64_t v = call_i64("decrypt", "LLL", (long long)ctx->id,
                         (long long)sk->id, (long long)ct->id);
    if (v < 0) return LUX_FHE_ERR_DECRYPT;
    *plaintext = (int)v;
    return LUX_FHE_OK;
}

void lux_fhe_ciphertext_free(LuxFheCiphertext* ct) {
    if (!ct) return;
    call_i64("ciphertext_free", "L", (long long)ct->id);
    delete ct;
}

LuxFheError lux_fhe_ciphertext_clone(LuxFheCiphertext* src,
                                     LuxFheCiphertext** dst) {
    if (!src || !dst) return LUX_FHE_ERR_NULL_PTR;
    int64_t id = call_i64("ciphertext_clone", "L", (long long)src->id);
    if (id < 0) return LUX_FHE_ERR_ALLOC;
    *dst = new LuxFheCiphertext{id};
    return LUX_FHE_OK;
}

static LuxFheError eval_gate(const char* gate, LuxFheContext* ctx,
                             LuxFheBootstrapKey* bsk, LuxFheCiphertext* a,
                             LuxFheCiphertext* b, LuxFheCiphertext** out) {
    if (!ctx || !bsk || !a || !b || !out) return LUX_FHE_ERR_NULL_PTR;
    if (!bsk->generated) return LUX_FHE_ERR_NOT_INIT;
    int64_t id = call_i64("eval_gate", "LLsLL", (long long)ctx->id,
                          (long long)bsk->id, gate, (long long)a->id,
                          (long long)b->id);
    if (id < 0) return LUX_FHE_ERR_GATE;
    *out = new LuxFheCiphertext{id};
    return LUX_FHE_OK;
}

#define IMPL_GATE(name, op)                                                  \
    LuxFheError lux_fhe_##name(LuxFheContext* ctx, LuxFheBootstrapKey* bsk, \
                               LuxFheCiphertext* a, LuxFheCiphertext* b,    \
                               LuxFheCiphertext** out) {                    \
        return eval_gate(op, ctx, bsk, a, b, out);                          \
    }

IMPL_GATE(and, "AND")
IMPL_GATE(or, "OR")
IMPL_GATE(xor, "XOR")
IMPL_GATE(nand, "NAND")
IMPL_GATE(nor, "NOR")
IMPL_GATE(xnor, "XNOR")

LuxFheError lux_fhe_not(LuxFheContext* ctx, LuxFheCiphertext* ct,
                        LuxFheCiphertext** out) {
    if (!ctx || !ct || !out) return LUX_FHE_ERR_NULL_PTR;
    int64_t id = call_i64("eval_not", "LL", (long long)ctx->id,
                          (long long)ct->id);
    if (id < 0) return LUX_FHE_ERR_GATE;
    *out = new LuxFheCiphertext{id};
    return LUX_FHE_OK;
}

LuxFheError lux_fhe_mux(LuxFheContext* ctx, LuxFheBootstrapKey* bsk,
                        LuxFheCiphertext* sel, LuxFheCiphertext* a,
                        LuxFheCiphertext* b, LuxFheCiphertext** out) {
    if (!ctx || !bsk || !sel || !a || !b || !out)
        return LUX_FHE_ERR_NULL_PTR;
    if (!bsk->generated) return LUX_FHE_ERR_NOT_INIT;
    int64_t id = call_i64("eval_mux", "LLLLL", (long long)ctx->id,
                          (long long)bsk->id, (long long)sel->id,
                          (long long)a->id, (long long)b->id);
    if (id < 0) return LUX_FHE_ERR_GATE;
    *out = new LuxFheCiphertext{id};
    return LUX_FHE_OK;
}

LuxFheError lux_fhe_bootstrap(LuxFheContext* ctx, LuxFheBootstrapKey* bsk,
                              LuxFheCiphertext* ct, LuxFheCiphertext** out) {
    if (!ctx || !bsk || !ct || !out) return LUX_FHE_ERR_NULL_PTR;
    if (!bsk->generated) return LUX_FHE_ERR_NOT_INIT;
    int64_t id = call_i64("bootstrap", "LLL", (long long)ctx->id,
                          (long long)bsk->id, (long long)ct->id);
    if (id < 0) return LUX_FHE_ERR_BOOTSTRAP;
    *out = new LuxFheCiphertext{id};
    return LUX_FHE_OK;
}

// ---- serialization ---------------------------------------------------------

static LuxFheError marshal_bytes(const char* fn, int64_t id, uint8_t** data,
                                 int64_t* len) {
    if (!data || !len) return LUX_FHE_ERR_NULL_PTR;
    PyGILState_STATE st;
    PyObject* mod = impl_acquire(&st);
    if (!mod) return LUX_FHE_ERR_NOT_INIT;
    PyObject* ret = PyObject_CallMethod(mod, fn, "L", (long long)id);
    LuxFheError err = LUX_FHE_ERR_SERIAL;
    if (ret && PyBytes_Check(ret)) {
        Py_ssize_t n = PyBytes_GET_SIZE(ret);
        auto* buf = (uint8_t*)malloc(n > 0 ? (size_t)n : 1);
        if (buf) {
            memcpy(buf, PyBytes_AS_STRING(ret), (size_t)n);
            *data = buf;
            *len = (int64_t)n;
            err = LUX_FHE_OK;
        } else {
            err = LUX_FHE_ERR_ALLOC;
        }
    }
    if (!ret) PyErr_Clear();
    Py_XDECREF(ret);
    PyGILState_Release(st);
    return err;
}

static int64_t unmarshal_bytes(const char* fn, const uint8_t* data,
                               int64_t len) {
    PyGILState_STATE st;
    PyObject* mod = impl_acquire(&st);
    if (!mod) return -1;
    PyObject* ret = PyObject_CallMethod(mod, fn, "y#", (const char*)data,
                                        (Py_ssize_t)len);
    int64_t id = -1;
    if (ret) {
        id = PyLong_AsLongLong(ret);
        if (PyErr_Occurred()) { PyErr_Clear(); id = -1; }
        Py_DECREF(ret);
    } else {
        PyErr_Clear();
    }
    PyGILState_Release(st);
    return id;
}

LuxFheError lux_fhe_ciphertext_marshal(LuxFheCiphertext* ct, uint8_t** data,
                                       int64_t* len) {
    if (!ct) return LUX_FHE_ERR_NULL_PTR;
    return marshal_bytes("ciphertext_marshal", ct->id, data, len);
}

LuxFheError lux_fhe_ciphertext_unmarshal(const uint8_t* data, int64_t len,
                                         LuxFheCiphertext** out) {
    if (!data || !out) return LUX_FHE_ERR_NULL_PTR;
    int64_t id = unmarshal_bytes("ciphertext_unmarshal", data, len);
    if (id < 0) return LUX_FHE_ERR_SERIAL;
    *out = new LuxFheCiphertext{id};
    return LUX_FHE_OK;
}

LuxFheError lux_fhe_secretkey_marshal(LuxFheSecretKey* sk, uint8_t** data,
                                      int64_t* len) {
    if (!sk) return LUX_FHE_ERR_NULL_PTR;
    return marshal_bytes("secretkey_marshal", sk->id, data, len);
}

LuxFheError lux_fhe_secretkey_unmarshal(const uint8_t* data, int64_t len,
                                        LuxFheSecretKey** out) {
    if (!data || !out) return LUX_FHE_ERR_NULL_PTR;
    int64_t id = unmarshal_bytes("secretkey_unmarshal", data, len);
    if (id < 0) return LUX_FHE_ERR_SERIAL;
    *out = new LuxFheSecretKey{id};
    return LUX_FHE_OK;
}

void lux_fhe_bytes_free(uint8_t* data) { free(data); }

// ---- Threshold ABI ----------------------------------------------------------
// Reference go/threshold/threshold.go is a stub ("TODO: Implement threshold
// FHE bindings"); this ABI wires the real t-of-n pipeline
// (fhe_tpu/tfhe/threshold.py: Shamir/Feldman shares, sigma proofs,
// Lagrange combine) behind flat C calls.

typedef struct { int64_t id; } LuxFheThresholdShares;

LuxFheError lux_fhe_threshold_keygen(LuxFheContext* ctx,
                                     LuxFheSecretKey* sk, int threshold,
                                     int parties, const char* scheme,
                                     LuxFheThresholdShares** out) {
    if (!ctx || !sk || !out) return LUX_FHE_ERR_NULL_PTR;
    int64_t id = call_i64("threshold_keygen", "LLiis", (long long)ctx->id,
                          (long long)sk->id, threshold, parties,
                          scheme ? scheme : "additive");
    if (id < 0) return LUX_FHE_ERR_KEYGEN;
    *out = new (std::nothrow) LuxFheThresholdShares{id};
    return *out ? LUX_FHE_OK : LUX_FHE_ERR_ALLOC;
}

void lux_fhe_threshold_free(LuxFheThresholdShares* sh) {
    if (!sh) return;
    call_i64("threshold_free", "L", (long long)sh->id);
    delete sh;
}

int lux_fhe_threshold_parties(LuxFheThresholdShares* sh) {
    return sh ? (int)call_i64("threshold_parties", "L", (long long)sh->id)
              : -1;
}

// party_ids: 1-indexed parties participating in this decryption.
LuxFheError lux_fhe_threshold_decrypt(LuxFheContext* ctx,
                                      LuxFheThresholdShares* sh,
                                      LuxFheCiphertext* ct,
                                      const int32_t* party_ids, int count,
                                      int* plaintext) {
    if (!ctx || !sh || !ct || !party_ids || !plaintext || count <= 0)
        return LUX_FHE_ERR_NULL_PTR;
    PyGILState_STATE st;
    PyObject* mod = impl_acquire(&st);
    if (!mod) return LUX_FHE_ERR_NOT_INIT;
    PyObject* ret = PyObject_CallMethod(
        mod, "threshold_decrypt", "LLLy#", (long long)ctx->id,
        (long long)sh->id, (long long)ct->id, (const char*)party_ids,
        (Py_ssize_t)(count * (int)sizeof(int32_t)));
    int64_t v = -1;
    if (ret) {
        v = PyLong_AsLongLong(ret);
        if (PyErr_Occurred()) { PyErr_Clear(); v = -1; }
        Py_DECREF(ret);
    } else {
        PyErr_Clear();
    }
    PyGILState_Release(st);
    if (v < 0) return LUX_FHE_ERR_DECRYPT;
    *plaintext = (int)v;
    return LUX_FHE_OK;
}

// ---- CKKS ABI ---------------------------------------------------------------
// Mirrors the reference's Go bridge (go/ckks/bridge.cpp:33-234):
// raw-pointer returns, NULL on failure, malloc'd output buffers the caller
// frees.  Backed by the same capi_impl registries (ckks_* functions).

typedef struct { int64_t id; } CKKSContext;
typedef struct { int64_t id; } CKKSKeyPair;
typedef struct { int64_t id; } CKKSCiphertext;

static CKKSCiphertext* ckks_ct_wrap(int64_t id) {
    if (id < 0) return nullptr;
    return new (std::nothrow) CKKSCiphertext{id};
}

CKKSContext* ckks_context_new(int log_n, int log_q, double scale) {
    int64_t id = call_i64("ckks_context_new", "iid", log_n, log_q, scale);
    if (id < 0) return nullptr;
    return new (std::nothrow) CKKSContext{id};
}

void ckks_context_free(CKKSContext* ctx) {
    if (!ctx) return;
    call_i64("ckks_context_free", "L", (long long)ctx->id);
    delete ctx;
}

CKKSKeyPair* ckks_keygen(CKKSContext* ctx) {
    if (!ctx) return nullptr;
    int64_t id = call_i64("ckks_keygen", "LK", (long long)ctx->id,
                          (unsigned long long)0);
    if (id < 0) return nullptr;
    return new (std::nothrow) CKKSKeyPair{id};
}

void ckks_keypair_free(CKKSKeyPair* kp) {
    if (!kp) return;
    call_i64("ckks_keypair_free", "L", (long long)kp->id);
    delete kp;
}

CKKSCiphertext* ckks_encrypt(CKKSContext* ctx, CKKSKeyPair* kp,
                             double* values, int len) {
    if (!ctx || !kp || !values || len <= 0) return nullptr;
    PyGILState_STATE st;
    PyObject* mod = impl_acquire(&st);
    if (!mod) return nullptr;
    PyObject* ret = PyObject_CallMethod(
        mod, "ckks_encrypt", "LLy#", (long long)ctx->id, (long long)kp->id,
        (const char*)values, (Py_ssize_t)(len * (int)sizeof(double)));
    int64_t id = -1;
    if (ret) {
        id = PyLong_AsLongLong(ret);
        if (PyErr_Occurred()) { PyErr_Clear(); id = -1; }
        Py_DECREF(ret);
    } else {
        PyErr_Clear();
    }
    PyGILState_Release(st);
    return ckks_ct_wrap(id);
}

double* ckks_decrypt(CKKSContext* ctx, CKKSKeyPair* kp, CKKSCiphertext* ct,
                     int* out_len) {
    if (!ctx || !kp || !ct || !out_len) return nullptr;
    *out_len = 0;
    PyGILState_STATE st;
    PyObject* mod = impl_acquire(&st);
    if (!mod) return nullptr;
    PyObject* ret = PyObject_CallMethod(
        mod, "ckks_decrypt", "LLL", (long long)ctx->id, (long long)kp->id,
        (long long)ct->id);
    double* out = nullptr;
    if (ret && PyBytes_Check(ret)) {
        Py_ssize_t n = PyBytes_GET_SIZE(ret);
        out = (double*)malloc(n > 0 ? (size_t)n : sizeof(double));
        if (out) {
            memcpy(out, PyBytes_AS_STRING(ret), (size_t)n);
            *out_len = (int)(n / (Py_ssize_t)sizeof(double));
        }
    }
    if (!ret) PyErr_Clear();
    Py_XDECREF(ret);
    PyGILState_Release(st);
    return out;
}

void ckks_ciphertext_free(CKKSCiphertext* ct) {
    if (!ct) return;
    call_i64("ckks_ciphertext_free", "L", (long long)ct->id);
    delete ct;
}

CKKSCiphertext* ckks_add(CKKSContext* ctx, CKKSCiphertext* a,
                         CKKSCiphertext* b) {
    if (!ctx || !a || !b) return nullptr;
    return ckks_ct_wrap(call_i64("ckks_add", "LLL", (long long)ctx->id,
                                 (long long)a->id, (long long)b->id));
}

CKKSCiphertext* ckks_sub(CKKSContext* ctx, CKKSCiphertext* a,
                         CKKSCiphertext* b) {
    if (!ctx || !a || !b) return nullptr;
    return ckks_ct_wrap(call_i64("ckks_sub", "LLL", (long long)ctx->id,
                                 (long long)a->id, (long long)b->id));
}

// The reference's ckks_mult takes (ctx, a, b) and relies on the context's
// registered mult key (go/ckks/bridge.cpp).  ckks_keygen registers its
// eval keys on the context, so the 3-arg form keeps the reference ABI;
// the explicit-keypair variant is exported under a DISTINCT name so code
// compiled against the reference header never mis-passes a ciphertext
// where a keypair is expected.
CKKSCiphertext* ckks_mult(CKKSContext* ctx, CKKSCiphertext* a,
                          CKKSCiphertext* b) {
    if (!ctx || !a || !b) return nullptr;
    return ckks_ct_wrap(call_i64("ckks_mult_ctx", "LLL", (long long)ctx->id,
                                 (long long)a->id, (long long)b->id));
}

CKKSCiphertext* ckks_mult_kp(CKKSContext* ctx, CKKSKeyPair* kp,
                             CKKSCiphertext* a, CKKSCiphertext* b) {
    if (!ctx || !kp || !a || !b) return nullptr;
    return ckks_ct_wrap(call_i64("ckks_mult", "LLLL", (long long)ctx->id,
                                 (long long)kp->id, (long long)a->id,
                                 (long long)b->id));
}

// Realized multiplicative depth of the context's chain (callers can see
// what their logQ budget bought; nothing is silently clamped any more).
int ckks_context_levels(CKKSContext* ctx) {
    if (!ctx) return -1;
    return (int)call_i64("ckks_context_levels", "L", (long long)ctx->id);
}

CKKSCiphertext* ckks_rotate(CKKSContext* ctx, CKKSKeyPair* kp,
                            CKKSCiphertext* ct, int steps) {
    if (!ctx || !kp || !ct) return nullptr;
    return ckks_ct_wrap(call_i64("ckks_rotate", "LLLi", (long long)ctx->id,
                                 (long long)kp->id, (long long)ct->id,
                                 steps));
}

CKKSCiphertext* ckks_bootstrap(CKKSContext* ctx, CKKSKeyPair* kp,
                               CKKSCiphertext* ct) {
    if (!ctx || !kp || !ct) return nullptr;
    return ckks_ct_wrap(call_i64("ckks_bootstrap", "LLL",
                                 (long long)ctx->id, (long long)kp->id,
                                 (long long)ct->id));
}

unsigned char* ckks_serialize_ciphertext(CKKSCiphertext* ct, int* out_len) {
    if (!ct || !out_len) return nullptr;
    uint8_t* data = nullptr;
    int64_t n = 0;
    if (marshal_bytes("ckks_serialize_ciphertext", ct->id, &data, &n)
            != LUX_FHE_OK) {
        *out_len = 0;
        return nullptr;
    }
    *out_len = (int)n;
    return data;
}

CKKSCiphertext* ckks_deserialize_ciphertext(CKKSContext* ctx,
                                            unsigned char* data, int len) {
    if (!ctx || !data || len <= 0) return nullptr;
    PyGILState_STATE st;
    PyObject* mod = impl_acquire(&st);
    if (!mod) return nullptr;
    PyObject* ret = PyObject_CallMethod(
        mod, "ckks_deserialize_ciphertext", "Ly#", (long long)ctx->id,
        (const char*)data, (Py_ssize_t)len);
    int64_t id = -1;
    if (ret) {
        id = PyLong_AsLongLong(ret);
        if (PyErr_Occurred()) { PyErr_Clear(); id = -1; }
        Py_DECREF(ret);
    } else {
        PyErr_Clear();
    }
    PyGILState_Release(st);
    return ckks_ct_wrap(id);
}

}  // extern "C"
