"""RadixInt: arbitrary-precision encrypted integers over ShortInt limbs.

Port of fhe_tpu/tfhe/radix.py (reference: radix/radix.h RadixInt with
little-endian limbs of 2-bit message + 2-bit carry and lazy carry
propagation, the EUINT8..EUINT256/EADDRESS presets; lazy_carry.h, the
carry budget, normalised when the headroom is spent).

All limbs of all integers in flight live in one batched LweCiphertext
(int32 tensors on the key's device), so every LUT pass (a normalisation
round, the limb products, the comparisons) is one batched functional
bootstrap: the per-limb loops of the reference become one blind rotation
over [batch x limbs] ciphertexts.  The carry ripple, the comparison fold
and the division rounds are the sequential parts.  Plaintexts and the
decrypted results are host Python integers (numpy object arrays).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..math.modmath import add_mod
from . import funcboot, lwe, rgsw, shortint
from .params import TfheParams
from .shortint import ShortIntParams

# Limb count from which propagate_carries runs the Kogge-Stone prefix
# instead of the ripple (fhe_tpu's default crossover).
KS_THRESHOLD = 8


@dataclasses.dataclass(frozen=True)
class RadixParams:
    limb: ShortIntParams
    num_limbs: int

    @property
    def total_bits(self) -> int:
        return self.limb.message_bits * self.num_limbs

    @property
    def max_value(self) -> int:
        return (1 << self.total_bits) - 1


# radix.h:38-88: the fhEVM type presets (2-bit limbs, 2-bit carries)
EUINT4 = RadixParams(ShortIntParams(2, 2), 2)
EUINT8 = RadixParams(ShortIntParams(2, 2), 4)
EUINT16 = RadixParams(ShortIntParams(2, 2), 8)
EUINT32 = RadixParams(ShortIntParams(2, 2), 16)
EUINT64 = RadixParams(ShortIntParams(2, 2), 32)
EUINT128 = RadixParams(ShortIntParams(2, 2), 64)
EUINT256 = RadixParams(ShortIntParams(2, 2), 128)
EADDRESS = RadixParams(ShortIntParams(2, 2), 80)
EBOOL = RadixParams(ShortIntParams(2, 2), 1)


@dataclasses.dataclass
class RadixInt:
    """ct: batched LweCiphertext whose last batch axis is the limbs
    (little-endian); max_limb: the host's bound on any limb value (the
    lazy-carry budget, lazy_carry.h CarryBudget)."""
    ct: lwe.LweCiphertext
    rp: RadixParams
    max_limb: int

    @property
    def batch_shape(self) -> tuple:
        return tuple(self.ct.b.shape[:-1])


def _ct(a: torch.Tensor, b: torch.Tensor, modulus: int, p: int) -> lwe.LweCiphertext:
    return lwe.LweCiphertext(a=a.to(torch.int32), b=b.to(torch.int32), modulus=modulus,
                             pt_mod=p)


def _limb(ct: lwe.LweCiphertext, j, p: int) -> lwe.LweCiphertext:
    """Limb j (an index or a slice) of a radix ciphertext."""
    return lwe.LweCiphertext(a=ct.a[..., j, :], b=ct.b[..., j], modulus=ct.modulus, pt_mod=p)


def _limbs_of(values, rp: RadixParams) -> np.ndarray:
    vals = np.asarray(values, dtype=object).reshape(-1)
    m = rp.limb.msg_mod
    out = np.zeros((len(vals), rp.num_limbs), dtype=np.int64)
    for i, v in enumerate(vals):
        v = int(v) & rp.max_value
        for j in range(rp.num_limbs):
            out[i, j] = v % m
            v //= m
    return out


def encrypt(params: TfheParams, rp: RadixParams, sk: lwe.LweSecretKey, values,
            rng: np.random.Generator) -> RadixInt:
    vals = np.asarray(values)
    limbs = _limbs_of(vals, rp).reshape(vals.shape + (rp.num_limbs,))
    ct = shortint.encrypt(params, rp.limb, sk, limbs, rng)
    return RadixInt(ct=ct, rp=rp, max_limb=rp.limb.msg_mod - 1)


def trivial_encrypt(params: TfheParams, rp: RadixParams, values,
                    device="cuda") -> RadixInt:
    """Noiseless "encryption" (a = 0): fhevm.cpp TrivialEncrypt, on
    `device`."""
    vals = np.asarray(values)
    limbs = _limbs_of(vals, rp).reshape(vals.shape + (rp.num_limbs,))
    q, p = params.q, rp.limb.p
    b = torch.from_numpy(limbs * (q // p) % q).to(device, torch.int32)
    a = torch.zeros(limbs.shape + (params.n,), dtype=torch.int32, device=device)
    return RadixInt(ct=lwe.LweCiphertext(a=a, b=b, modulus=q, pt_mod=p), rp=rp,
                    max_limb=rp.limb.msg_mod - 1)


def _zeros_like(params: TfheParams, x: RadixInt) -> RadixInt:
    """A trivial zero of x's type and batch shape, on x's device."""
    return trivial_encrypt(params, x.rp, np.zeros(x.batch_shape, dtype=np.int64),
                           device=x.ct.a.device)


def decrypt(params: TfheParams, rp: RadixParams, sk: lwe.LweSecretKey, x: RadixInt):
    """Host Python integers (a numpy object array of the batch shape)."""
    limbs = shortint.decrypt(params, rp.limb, sk, x.ct)
    m = rp.limb.msg_mod
    # recompose little-endian; lazy carries are absorbed mod 2^total
    vals = np.zeros(limbs.shape[:-1], dtype=object)
    for j in range(rp.num_limbs):
        vals = vals + limbs[..., j].astype(object) * (m ** j)
    return np.vectorize(lambda v: int(v) & rp.max_value, otypes=[object])(vals)


def propagate_carries(params: TfheParams, key: rgsw.BootstrapKey, x: RadixInt,
                      ntt_impl=None) -> RadixInt:
    """Full carry normalisation: the sequential ripple below KS_THRESHOLD
    limbs (2L LUT passes of batch B), else the Kogge-Stone parallel prefix
    (euint256.h:9; 5 + 2 ceil(log2 L) LUT passes of batch B L)."""
    if x.rp.num_limbs >= KS_THRESHOLD:
        return propagate_carries_ks(params, key, x, ntt_impl)
    return propagate_carries_ripple(params, key, x, ntt_impl)


def propagate_carries_ripple(params: TfheParams, key: rgsw.BootstrapKey, x: RadixInt,
                             ntt_impl=None) -> RadixInt:
    """Sequential ripple of (msg, carry) LUT splits; each round's two LUT
    passes are batched over the integers."""
    rp = x.rp
    sp = rp.limb
    tabs = shortint.luts(params, sp)
    ct = x.ct
    out_a, out_b = [], []
    carry = None
    for j in range(rp.num_limbs):
        limb = _limb(ct, j, sp.p)
        if carry is not None:
            limb = lwe.add(limb, carry)
        msg = shortint.apply_lut(params, key, limb, tabs["msg"], sp, ntt_impl)
        if j + 1 < rp.num_limbs:
            carry = shortint.apply_lut(params, key, limb, tabs["carry"], sp, ntt_impl)
        out_a.append(msg.a)
        out_b.append(msg.b)
    new = _ct(torch.stack(out_a, dim=-2), torch.stack(out_b, dim=-1), ct.modulus, sp.p)
    return RadixInt(ct=new, rp=rp, max_limb=sp.msg_mod - 1)


def _shift_limbs_up(ct: lwe.LweCiphertext, d: int, p: int) -> lwe.LweCiphertext:
    """limb_j -> limb_{j+d}; the bottom d limbs become trivial zeros."""
    sh_a = torch.cat([torch.zeros_like(ct.a[..., :d, :]), ct.a[..., :-d, :]], dim=-2)
    sh_b = torch.cat([torch.zeros_like(ct.b[..., :d]), ct.b[..., :-d]], dim=-1)
    return lwe.LweCiphertext(a=sh_a, b=sh_b, modulus=ct.modulus, pt_mod=p)


def _shift_limbs_down(ct: lwe.LweCiphertext, d: int, p: int) -> lwe.LweCiphertext:
    """limb_{j+d} -> limb_j; the top d limbs become trivial zeros."""
    sh_a = torch.cat([ct.a[..., d:, :], torch.zeros_like(ct.a[..., :d, :])], dim=-2)
    sh_b = torch.cat([ct.b[..., d:], torch.zeros_like(ct.b[..., :d])], dim=-1)
    return lwe.LweCiphertext(a=sh_a, b=sh_b, modulus=ct.modulus, pt_mod=p)


def _roll_limbs(ct: lwe.LweCiphertext, k: int, p: int) -> lwe.LweCiphertext:
    return lwe.LweCiphertext(a=torch.roll(ct.a, k, dims=-2), b=torch.roll(ct.b, k, dims=-1),
                             modulus=ct.modulus, pt_mod=p)


def propagate_carries_ks(params: TfheParams, key: rgsw.BootstrapKey, x: RadixInt,
                         ntt_impl=None) -> RadixInt:
    """Kogge-Stone parallel-prefix normalisation (the reference's
    koggeStoneCarries, euint256.h:408/:867), every round one batched LUT
    pass over all L limbs of all integers in flight:

      1. split v_j -> (msg_j, car_j)                          [2 passes]
      2. s_j = msg_j + car_{j-1} (a plain add; s < 2m when carry_bits <=
         message_bits, so the residual carry is binary)
      3. generate g_j = [s_j >= m], propagate p_j = [s_j == m - 1], as
         separate boolean ciphertexts                         [2 passes]
      4. ceil(log2 L) rounds combining (g, p) pairs: g'' = g | (p & g_lo),
         p'' = p & p_lo; each AND/OR is a LUT on the plain sum of two fresh
         booleans (a packed pair would scale one operand's noise by m),
         the round's two ANDs one [2L]-lane pass              [2 a round]
      5. cin = shift(g); out = (s + cin) mod m                [1 pass]
    """
    rp = x.rp
    sp = rp.limb
    m = sp.msg_mod
    L = rp.num_limbs
    assert sp.p // m <= m, "Kogge-Stone needs carry_bits <= message_bits"
    if L == 1:
        return propagate_carries_ripple(params, key, x, ntt_impl)
    tabs = shortint.luts(params, sp)
    ct = x.ct
    q = ct.modulus
    msg = shortint.apply_lut(params, key, ct, tabs["msg"], sp, ntt_impl)
    car = shortint.apply_lut(params, key, ct, tabs["carry"], sp, ntt_impl)
    s = lwe.add(msg, _shift_limbs_up(car, 1, sp.p))
    gen_lut = funcboot.generate_lut(lambda v, pp: int(v >= m), sp.p, params.q)
    prop_lut = funcboot.generate_lut(lambda v, pp: int(v == m - 1), sp.p, params.q)
    and_lut = funcboot.generate_lut(lambda v, pp: int(v == 2), sp.p, params.q)
    or_lut = funcboot.generate_lut(lambda v, pp: int(v >= 1), sp.p, params.q)
    g = shortint.apply_lut(params, key, s, gen_lut, sp, ntt_impl)
    p = shortint.apply_lut(params, key, s, prop_lut, sp, ntt_impl)
    d = 1
    while d < L:
        # one [2L]-lane pass: u = p & g_{j-d}  |  p'' = p & p_{j-d}
        u_in = lwe.add(p, _shift_limbs_up(g, d, sp.p))
        w_in = lwe.add(p, _shift_limbs_up(p, d, sp.p))
        both = _ct(torch.cat([u_in.a, w_in.a], dim=-2), torch.cat([u_in.b, w_in.b], dim=-1),
                   q, sp.p)
        both = shortint.apply_lut(params, key, both, and_lut, sp, ntt_impl)
        u = _limb(both, slice(None, L), sp.p)
        p = _limb(both, slice(L, None), sp.p)
        g = shortint.apply_lut(params, key, lwe.add(g, u), or_lut, sp, ntt_impl)
        d *= 2
    out = lwe.add(s, _shift_limbs_up(g, 1, sp.p))
    out = shortint.apply_lut(params, key, out, tabs["msg"], sp, ntt_impl)
    return RadixInt(ct=out, rp=rp, max_limb=sp.msg_mod - 1)


def _maybe_normalize(params, key, x: RadixInt, incoming: int, ntt_impl=None) -> RadixInt:
    if x.max_limb + incoming >= x.rp.limb.p:
        return propagate_carries(params, key, x, ntt_impl)
    return x


def _carry_free(params, key, x: RadixInt, ntt_impl=None) -> RadixInt:
    """x with every limb below the message base."""
    if x.max_limb >= x.rp.limb.msg_mod:
        return propagate_carries(params, key, x, ntt_impl)
    return x


def add(params: TfheParams, key: rgsw.BootstrapKey, a: RadixInt, b: RadixInt,
        ntt_impl=None) -> RadixInt:
    """Lazy addition: a limb-wise LWE add, normalised only when the carry
    budget would overflow (lazy_carry.h:55-82)."""
    a = _maybe_normalize(params, key, a, b.max_limb, ntt_impl)
    if a.max_limb + b.max_limb >= a.rp.limb.p:
        b = propagate_carries(params, key, b, ntt_impl)
    return RadixInt(ct=lwe.add(a.ct, b.ct), rp=a.rp, max_limb=a.max_limb + b.max_limb)


def sub(params: TfheParams, key: rgsw.BootstrapKey, a: RadixInt, b: RadixInt,
        ntt_impl=None) -> RadixInt:
    """a - b = a + ~b + 1 (two's complement on the message space): ~b
    needs a carry-free b; the +1 is a trivial add to limb 0."""
    rp = a.rp
    sp = rp.limb
    b = _carry_free(params, key, b, ntt_impl)
    tabs = shortint.luts(params, sp)
    nb = shortint.apply_lut(params, key, b.ct, tabs["not"], sp, ntt_impl)
    if a.max_limb + sp.msg_mod >= sp.p:
        a = propagate_carries(params, key, a, ntt_impl)
    s = lwe.add(a.ct, nb)
    q, p = params.q, sp.p
    one = torch.zeros(rp.num_limbs, dtype=torch.int64, device=s.b.device)
    one[0] = q // p
    out = RadixInt(ct=_ct(s.a, add_mod(s.b, one, q), q, p), rp=rp,
                   max_limb=a.max_limb + sp.msg_mod)
    return propagate_carries(params, key, out, ntt_impl)


def mul(params: TfheParams, key: rgsw.BootstrapKey, a: RadixInt, b: RadixInt,
        ntt_impl=None) -> RadixInt:
    """Limb multiplication: all partial products (lo and hi) in one batched
    bootstrap each (radix.h Mul :240-283), then a carry-save column
    reduction in O(log L) LUT rounds and one normalisation."""
    rp = a.rp
    sp = rp.limb
    L = rp.num_limbs
    a = _maybe_normalize(params, key, a, sp.p, ntt_impl)
    b = _maybe_normalize(params, key, b, sp.p, ntt_impl)
    a = _carry_free(params, key, a, ntt_impl)
    b = _carry_free(params, key, b, ntt_impl)
    tabs = shortint.luts(params, sp)
    pairs = [(i, j) for i in range(L) for j in range(L) if i + j < L]
    ia = torch.tensor([i for i, _ in pairs], device=a.ct.a.device)
    jb = torch.tensor([j for _, j in pairs], device=a.ct.a.device)
    q = a.ct.modulus
    cta = _ct(a.ct.a.index_select(-2, ia), a.ct.b.index_select(-1, ia), q, sp.p)
    ctb = _ct(b.ct.a.index_select(-2, jb), b.ct.b.index_select(-1, jb), q, sp.p)
    x = shortint.pack(sp, cta, ctb)
    lo = shortint.apply_lut(params, key, x, tabs["mul_lo"], sp, ntt_impl)
    hi = shortint.apply_lut(params, key, x, tabs["mul_hi"], sp, ntt_impl)
    terms = []        # (position, idx, src) with src in {lo, hi}
    for idx, (i, j) in enumerate(pairs):
        terms.append((i + j, idx, lo))
        if i + j + 1 < L:
            terms.append((i + j + 1, idx, hi))
    return _carry_save_reduce(params, key, rp, terms, a.ct, ntt_impl)


def _sum_rows(a: torch.Tensor, b: torch.Tensor, q: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The rows (axis -3 of a, -2 of b) summed mod q, in order."""
    red_a, red_b = a[..., 0, :, :], b[..., 0, :]
    for r in range(1, a.shape[-3]):
        red_a = add_mod(red_a, a[..., r, :, :], q)
        red_b = add_mod(red_b, b[..., r, :], q)
    return red_a, red_b


def _carry_save_reduce(params: TfheParams, key: rgsw.BootstrapKey, rp: RadixParams, terms,
                       ref_ct: lwe.LweCiphertext, ntt_impl=None) -> RadixInt:
    """Wallace-tree column reduction shared by mul and mul_scalar.

    terms: (position, idx, src) with src an LweCiphertext whose limb axis
    idx indexes; every term value is below msg_mod.  Every partial product
    goes into the first free row of its column, a [rows, L] tensor of limb
    ciphertexts padded with trivial zeros; ref_ct gives the batch shape."""
    sp = rp.limb
    m = sp.msg_mod
    L = rp.num_limbs
    q = ref_ct.modulus
    counts = [0] * L
    placed = []       # (row, position, idx, src)
    for (k, idx, src) in terms:
        placed.append((counts[k], k, idx, src))
        counts[k] += 1
    rows = max(counts)
    lead = tuple(ref_ct.b.shape[:-1])
    n = ref_ct.a.shape[-1]
    dev = ref_ct.a.device
    acc_a = torch.zeros(lead + (rows, L, n), dtype=torch.int32, device=dev)
    acc_b = torch.zeros(lead + (rows, L), dtype=torch.int32, device=dev)
    for (r, k, idx, src) in placed:
        acc_a[..., r, k, :] = src.a[..., idx, :]
        acc_b[..., r, k] = src.b[..., idx]

    cap = (sp.p - 1) // (m - 1)     # rows addable without overflow
    tabs = shortint.luts(params, sp)
    while rows > cap:
        # add rows in chunks of `cap` (plain adds), then split each chunk
        # sum into (msg, carry << 1) with two batched LUT passes
        r2 = (rows + cap - 1) // cap
        sums = [_sum_rows(acc_a[..., g * cap:min((g + 1) * cap, rows), :, :],
                          acc_b[..., g * cap:min((g + 1) * cap, rows), :], q) for g in range(r2)]
        sums = _ct(torch.stack([s[0] for s in sums], dim=-3),
                   torch.stack([s[1] for s in sums], dim=-2), q, sp.p)
        msgs = shortint.apply_lut(params, key, sums, tabs["msg"], sp, ntt_impl)
        cars = shortint.apply_lut(params, key, sums, tabs["carry"], sp, ntt_impl)
        cars = _shift_limbs_up(cars, 1, sp.p)
        acc_a = torch.cat([msgs.a, cars.a], dim=-3)
        acc_b = torch.cat([msgs.b, cars.b], dim=-2)
        rows = 2 * r2

    red_a, red_b = _sum_rows(acc_a, acc_b, q)
    out = RadixInt(ct=_ct(red_a, red_b, q, sp.p), rp=rp, max_limb=min(rows, cap) * (m - 1))
    return propagate_carries(params, key, out, ntt_impl)


def compare(params: TfheParams, key: rgsw.BootstrapKey, op: str, a: RadixInt, b: RadixInt,
            ntt_impl=None) -> lwe.LweCiphertext:
    """eq/ne/lt/le/gt/ge -> an encrypted bool (comparison_luts.h: an
    MSB-first lexicographic fold)."""
    rp = a.rp
    sp = rp.limb
    a = _carry_free(params, key, a, ntt_impl)
    b = _carry_free(params, key, b, ntt_impl)
    q = a.ct.modulus
    L = rp.num_limbs

    if op in ("eq", "ne"):
        # batched limb equality, summed, then one LUT on (sum == L)
        bits = shortint.binary_op(params, key, "eq", a.ct, b.ct, sp, ntt_impl)
        tot_a, tot_b = bits.a[..., 0, :], bits.b[..., 0]
        for j in range(1, L):
            tot_a = add_mod(tot_a, bits.a[..., j, :], q)
            tot_b = add_mod(tot_b, bits.b[..., j], q)
        want = op == "eq"   # L < p holds for every supported limb sum
        lut = funcboot.generate_lut(lambda x, pp: int((x == L) == want), sp.p, params.q)
        return shortint.apply_lut(params, key, _ct(tot_a, tot_b, q, sp.p), lut, sp, ntt_impl)

    # cmp_j in {0 eq, 1 lt, 2 gt} per limb (batched), then the sequential
    # MSB -> LSB merge r' = (r != 0) ? r : cmp_j
    cmp_lut = funcboot.generate_lut(
        lambda x, pp: (0 if (x % 4) == ((x // 4) % 4)
                       else (1 if (x % 4) < ((x // 4) % 4) else 2)), sp.p, params.q)
    cmps = shortint.apply_lut(params, key, shortint.pack(sp, a.ct, b.ct), cmp_lut, sp,
                              ntt_impl)
    merge_lut = funcboot.generate_lut(
        lambda x, pp: (x % 4) if (x % 4) != 0 else ((x // 4) % 4), sp.p, params.q)
    r = _limb(cmps, L - 1, sp.p)
    for j in reversed(range(L - 1)):
        packed = shortint.pack(sp, r, _limb(cmps, j, sp.p))
        r = shortint.apply_lut(params, key, packed, merge_lut, sp, ntt_impl)
    final = {"lt": lambda v: int(v == 1), "gt": lambda v: int(v == 2),
             "le": lambda v: int(v != 2), "ge": lambda v: int(v != 1)}[op]
    lut = funcboot.generate_lut(lambda x, pp: final(x % 4), sp.p, params.q)
    return shortint.apply_lut(params, key, r, lut, sp, ntt_impl)


def bitwise(params: TfheParams, key: rgsw.BootstrapKey, op: str, a: RadixInt, b: RadixInt,
            ntt_impl=None) -> RadixInt:
    """and/or/xor: one batched packed LUT over all limbs."""
    sp = a.rp.limb
    a = _carry_free(params, key, a, ntt_impl)
    b = _carry_free(params, key, b, ntt_impl)
    out = shortint.binary_op(params, key, op, a.ct, b.ct, sp, ntt_impl)
    return RadixInt(ct=out, rp=a.rp, max_limb=sp.msg_mod - 1)


def bit_not(params: TfheParams, key: rgsw.BootstrapKey, a: RadixInt,
            ntt_impl=None) -> RadixInt:
    sp = a.rp.limb
    a = _carry_free(params, key, a, ntt_impl)
    out = shortint.apply_lut(params, key, a.ct, shortint.luts(params, sp)["not"], sp,
                             ntt_impl)
    return RadixInt(ct=out, rp=a.rp, max_limb=sp.msg_mod - 1)


def select(params: TfheParams, key: rgsw.BootstrapKey, cond: lwe.LweCiphertext,
           a: RadixInt, b: RadixInt, ntt_impl=None) -> RadixInt:
    """cond ? a : b = b + cond (a - b) (fhevm Select)."""
    rp = a.rp
    sp = rp.limb
    d = sub(params, key, a, b, ntt_impl)            # carry-free
    # cond against every limb, then a packed multiply
    cond_l = _ct(cond.a[..., None, :].expand(d.ct.a.shape), cond.b[..., None].expand(d.ct.b.shape),
                 cond.modulus, sp.p)
    prod = shortint.binary_op(params, key, "mul_lo", d.ct, cond_l, sp, ntt_impl)
    b = _carry_free(params, key, b, ntt_impl)
    out = RadixInt(ct=lwe.add(b.ct, prod), rp=rp, max_limb=2 * (sp.msg_mod - 1))
    return propagate_carries(params, key, out, ntt_impl)


def min_(params: TfheParams, key: rgsw.BootstrapKey, a: RadixInt, b: RadixInt,
         ntt_impl=None) -> RadixInt:
    """fhevm.h:9 Min: an lt compare, then a select."""
    c = compare(params, key, "lt", a, b, ntt_impl)
    return select(params, key, c, a, b, ntt_impl)


def max_(params: TfheParams, key: rgsw.BootstrapKey, a: RadixInt, b: RadixInt,
         ntt_impl=None) -> RadixInt:
    c = compare(params, key, "lt", a, b, ntt_impl)
    return select(params, key, c, b, a, ntt_impl)


def _split_after_double(params, key, x: RadixInt, roll: bool, ntt_impl) -> RadixInt:
    """After doubling carry-free limbs (v <= 6), one (msg, carry) split
    normalises without a prefix scan: the carries are binary and cannot
    generate again (the msg of an even v is 0 or 2)."""
    sp = x.rp.limb
    tabs = shortint.luts(params, sp)
    msg = shortint.apply_lut(params, key, x.ct, tabs["msg"], sp, ntt_impl)
    car = shortint.apply_lut(params, key, x.ct, tabs["carry"], sp, ntt_impl)
    car = _roll_limbs(car, 1, sp.p) if roll else _shift_limbs_up(car, 1, sp.p)
    return RadixInt(ct=lwe.add(msg, car), rp=x.rp, max_limb=sp.msg_mod - 1)


def _limb_shift(x: RadixInt, k: int, rotate: bool) -> RadixInt:
    """A plain limb-axis shift (zero fill) or rotation, no LUTs."""
    L = x.rp.num_limbs
    ct = x.ct
    if rotate:
        out = _roll_limbs(ct, k % L, ct.pt_mod)
    elif k >= 0:
        out = _shift_limbs_up(ct, k, ct.pt_mod) if k else ct
    else:
        out = _shift_limbs_down(ct, -k, ct.pt_mod)
    return RadixInt(ct=out, rp=x.rp, max_limb=x.max_limb)


def shift_left(params: TfheParams, key: rgsw.BootstrapKey, x: RadixInt, k: int,
               ntt_impl=None, rotate: bool = False) -> RadixInt:
    """Shl/Rotl by a plaintext bit count (fhevm.h:10): the whole-limb part
    is a free tensor shift; each odd bit doubles every limb and does one
    scan-free (msg, carry) split."""
    sp = x.rp.limb
    bits_per_limb = sp.message_bits
    x = _carry_free(params, key, x, ntt_impl)
    if not rotate:
        k = min(k, x.rp.total_bits)
    out = _limb_shift(x, k // bits_per_limb, rotate)
    for _ in range(k % bits_per_limb):
        out = RadixInt(ct=lwe.add(out.ct, out.ct), rp=out.rp, max_limb=2 * out.max_limb)
        out = _split_after_double(params, key, out, rotate, ntt_impl)
    return out


def shift_right(params: TfheParams, key: rgsw.BootstrapKey, x: RadixInt, k: int,
                ntt_impl=None, rotate: bool = False) -> RadixInt:
    """Shr/Rotr by a plaintext bit count: a whole-limb tensor shift and,
    per odd bit, out_j = (limb_j >> 1) + 2 (limb_{j+1} & 1): two batched
    LUT passes, carry-free by construction."""
    sp = x.rp.limb
    bits_per_limb = sp.message_bits
    m = sp.msg_mod
    x = _carry_free(params, key, x, ntt_impl)
    if not rotate:
        k = min(k, x.rp.total_bits)
    out = _limb_shift(x, -(k // bits_per_limb), rotate)
    half_lut = funcboot.generate_lut(lambda v, pp: (v % m) >> 1, sp.p, params.q)
    lsb_lut = funcboot.generate_lut(lambda v, pp: (v % m) & 1, sp.p, params.q)
    for _ in range(k % bits_per_limb):
        half = shortint.apply_lut(params, key, out.ct, half_lut, sp, ntt_impl)
        lsb = shortint.apply_lut(params, key, out.ct, lsb_lut, sp, ntt_impl)
        hi = lwe.add(lsb, lsb)
        hi = _roll_limbs(hi, -1, sp.p) if rotate else _shift_limbs_down(hi, 1, sp.p)
        out = RadixInt(ct=lwe.add(half, hi), rp=out.rp, max_limb=m - 1)
    return out


def _extract_bit(params, key, x: RadixInt, i: int, ntt_impl) -> lwe.LweCiphertext:
    """Encrypted bit i of a carry-free RadixInt (a LUT on its limb)."""
    sp = x.rp.limb
    j, b = divmod(i, sp.message_bits)
    lut = funcboot.generate_lut(lambda v, pp: (v >> b) & 1, sp.p, params.q)
    return shortint.apply_lut(params, key, _limb(x.ct, j, sp.p), lut, sp, ntt_impl)


def _add_into_limb(x: lwe.LweCiphertext, j: int, y: lwe.LweCiphertext) -> lwe.LweCiphertext:
    """x with y added into limb j."""
    q = x.modulus
    a, b = x.a.clone(), x.b.clone()
    a[..., j, :] = add_mod(a[..., j, :], y.a, q)
    b[..., j] = add_mod(b[..., j], y.b, q)
    return lwe.LweCiphertext(a=a, b=b, modulus=q, pt_mod=x.pt_mod)


def divrem(params: TfheParams, key: rgsw.BootstrapKey, a: RadixInt, b: RadixInt,
           ntt_impl=None) -> tuple[RadixInt, RadixInt]:
    """Division by an encrypted divisor (fhevm.h:8 div/rem): binary
    restoring long division, MSB first: R = 2R + a_i; q_i = [R >= b];
    R -= q_i b.  total_bits sequential rounds, each round's compare and
    select batched over the limbs.  Division by zero gives q = all ones,
    r = a (the caller handles the EVM convention)."""
    rp = a.rp
    sp = rp.limb
    a = _carry_free(params, key, a, ntt_impl)
    b = _carry_free(params, key, b, ntt_impl)
    r = _zeros_like(params, a)
    qbits = []
    for i in reversed(range(rp.total_bits)):
        r = shift_left(params, key, r, 1, ntt_impl)
        # the bit goes into limb 0 (carry-free: limb 0 is even after the shl)
        bit = _extract_bit(params, key, a, i, ntt_impl)
        r = RadixInt(ct=_add_into_limb(r.ct, 0, bit), rp=rp, max_limb=sp.msg_mod - 1)
        ge = compare(params, key, "ge", r, b, ntt_impl)
        rsub = sub(params, key, r, b, ntt_impl)
        r = select(params, key, ge, rsub, r, ntt_impl)
        qbits.append((i, ge))
    # the quotient's limbs from the bit ciphertexts, bit i scaled by 2^pos
    quo = _zeros_like(params, a).ct
    for (i, bit) in qbits:
        j, pos = divmod(i, sp.message_bits)
        for _ in range(pos):
            bit = lwe.add(bit, bit)
        quo = _add_into_limb(quo, j, bit)
    quo = lwe.LweCiphertext(a=quo.a, b=quo.b, modulus=quo.modulus, pt_mod=sp.p)
    return RadixInt(ct=quo, rp=rp, max_limb=sp.msg_mod - 1), r


def neg(params: TfheParams, key: rgsw.BootstrapKey, a: RadixInt, ntt_impl=None) -> RadixInt:
    """Two's-complement negation (fhevm.h Neg): one sub from a trivial zero."""
    return sub(params, key, _zeros_like(params, a), a, ntt_impl)


def is_zero(params: TfheParams, key: rgsw.BootstrapKey, a: RadixInt,
            ntt_impl=None) -> lwe.LweCiphertext:
    """fhevm.h IsZero: the encrypted bool [a == 0], by the limb-equality
    fold against a trivial zero."""
    return compare(params, key, "eq", a, _zeros_like(params, a), ntt_impl)


def is_nonzero(params: TfheParams, key: rgsw.BootstrapKey, a: RadixInt,
               ntt_impl=None) -> lwe.LweCiphertext:
    return compare(params, key, "ne", a, _zeros_like(params, a), ntt_impl)


def _trivial_scalar(params: TfheParams, like: RadixInt, scalar) -> RadixInt:
    """A host scalar as a trivial RadixInt of like's type and shape."""
    vals = np.empty(like.batch_shape, dtype=object)
    vals[...] = int(scalar)
    return trivial_encrypt(params, like.rp, vals, device=like.ct.a.device)


def add_scalar(params: TfheParams, key: rgsw.BootstrapKey, a: RadixInt, scalar,
               ntt_impl=None) -> RadixInt:
    """fhevm.h AddScalar: the scalar's limbs trivially encrypted, then the
    ordinary lazy add (radix.cpp AddScalarInPlace:195)."""
    return add(params, key, a, _trivial_scalar(params, a, scalar), ntt_impl)


def sub_scalar(params: TfheParams, key: rgsw.BootstrapKey, a: RadixInt, scalar,
               ntt_impl=None) -> RadixInt:
    return sub(params, key, a, _trivial_scalar(params, a, scalar), ntt_impl)


def mul_scalar(params: TfheParams, key: rgsw.BootstrapKey, a: RadixInt, scalar,
               ntt_impl=None) -> RadixInt:
    """fhevm.h MulScalar.  The scalar's limbs are known, so the partial
    products are unary LUTs of a's limbs: one batched (lo, hi) LUT pair per
    distinct scalar limb value >= 2 (a limb of 1 is a free copy), then the
    carry-save column reduction of `mul`."""
    rp = a.rp
    sp = rp.limb
    m = sp.msg_mod
    L = rp.num_limbs
    a = _carry_free(params, key, a, ntt_impl)
    s_limbs = [int(v) for v in _limbs_of(np.asarray([int(scalar)], dtype=object), rp)[0]]
    lut_out = {}
    for s in sorted(set(s_limbs)):
        if s < 2:
            continue
        lo_lut = funcboot.generate_lut(lambda v, pp, s=s: (v % m) * s % m, sp.p, params.q)
        hi_lut = funcboot.generate_lut(lambda v, pp, s=s: (v % m) * s // m, sp.p, params.q)
        lut_out[s] = (shortint.apply_lut(params, key, a.ct, lo_lut, sp, ntt_impl),
                      shortint.apply_lut(params, key, a.ct, hi_lut, sp, ntt_impl))
    terms = []
    for j, s in enumerate(s_limbs):
        if s == 0:
            continue
        for i in range(L - j):
            if s == 1:
                terms.append((i + j, i, a.ct))
            else:
                lo, hi = lut_out[s]
                terms.append((i + j, i, lo))
                if i + j + 1 < L:
                    terms.append((i + j + 1, i, hi))
    if not terms:
        return _zeros_like(params, a)
    return _carry_save_reduce(params, key, rp, terms, a.ct, ntt_impl)


def div_scalar(params: TfheParams, key: rgsw.BootstrapKey, a: RadixInt, scalar,
               ntt_impl=None) -> RadixInt:
    return divrem(params, key, a, _trivial_scalar(params, a, scalar), ntt_impl)[0]


def rem_scalar(params: TfheParams, key: rgsw.BootstrapKey, a: RadixInt, scalar,
               ntt_impl=None) -> RadixInt:
    return divrem(params, key, a, _trivial_scalar(params, a, scalar), ntt_impl)[1]


def compare_scalar(params: TfheParams, key: rgsw.BootstrapKey, op: str, a: RadixInt, scalar,
                   ntt_impl=None) -> lwe.LweCiphertext:
    return compare(params, key, op, a, _trivial_scalar(params, a, scalar), ntt_impl)


def bitwise_scalar(params: TfheParams, key: rgsw.BootstrapKey, op: str, a: RadixInt, scalar,
                   ntt_impl=None) -> RadixInt:
    return bitwise(params, key, op, a, _trivial_scalar(params, a, scalar), ntt_impl)


def _barrel(params, key, x: RadixInt, k: RadixInt, shift, ntt_impl, rotate: bool) -> RadixInt:
    """Shift or rotate x by an encrypted amount k: round i selects between
    the running value and its plaintext shift by 2^i (2^i mod total_bits
    for a rotation; a round with residue 0 is skipped) on bit i of k.  A
    shift by total_bits or more gives zero (EVM semantics), by one final
    ge-compare select."""
    nbits = x.rp.total_bits
    k = _carry_free(params, key, k, ntt_impl)
    out = x
    kbits = k.rp.total_bits if rotate else (nbits - 1).bit_length()
    for i in range(kbits):
        r = ((1 << i) % nbits) if rotate else (1 << i)
        if r == 0:
            continue
        bit = _extract_bit(params, key, k, i, ntt_impl)
        shifted = shift(params, key, out, r, ntt_impl, rotate=rotate)
        out = select(params, key, bit, shifted, out, ntt_impl)
    if not rotate:
        ge = compare_scalar(params, key, "ge", k, nbits, ntt_impl)
        out = select(params, key, ge, _zeros_like(params, x), out, ntt_impl)
    return out


def shift_left_enc(params: TfheParams, key: rgsw.BootstrapKey, x: RadixInt, k: RadixInt,
                   ntt_impl=None, rotate: bool = False) -> RadixInt:
    """Shl/Rotl by an encrypted amount: a barrel shifter (the reference's
    radix::Shl(a, bits) is a stub, radix.cpp:434-450)."""
    return _barrel(params, key, x, k, shift_left, ntt_impl, rotate)


def shift_right_enc(params: TfheParams, key: rgsw.BootstrapKey, x: RadixInt, k: RadixInt,
                    ntt_impl=None, rotate: bool = False) -> RadixInt:
    """Shr/Rotr by an encrypted amount (the barrel of shift_left_enc)."""
    return _barrel(params, key, x, k, shift_right, ntt_impl, rotate)


def encrypt_pk(params: TfheParams, rp: RadixParams, pk: lwe.LwePublicKey,
               ksk: lwe.LweSwitchingKey, values, rng: np.random.Generator) -> RadixInt:
    """Public-key radix encryption (fhevm.h EncryptPublic): every limb under
    the ring-dimension LWE public key, then switched to (n, q) with the
    bootstrap key's switching key."""
    vals = np.asarray(values)
    limbs = _limbs_of(vals, rp).reshape(vals.shape + (rp.num_limbs,))
    ct = lwe.encrypt_pk(params, pk, limbs, rng, p=rp.limb.p)
    ct = lwe.switch_ct_to_qn(params, ksk, ct)
    return RadixInt(ct=ct, rp=rp, max_limb=rp.limb.msg_mod - 1)


def cast(params: TfheParams, x: RadixInt, rp_to: RadixParams) -> RadixInt:
    """Truncate or zero-extend the limbs (fhevm Cast)."""
    L_from, L_to = x.rp.num_limbs, rp_to.num_limbs
    ct = x.ct
    if L_to <= L_from:
        out = _limb(ct, slice(None, L_to), ct.pt_mod)
    else:
        pad_a = torch.zeros(ct.a.shape[:-2] + (L_to - L_from, ct.a.shape[-1]),
                            dtype=ct.a.dtype, device=ct.a.device)
        pad_b = torch.zeros(ct.b.shape[:-1] + (L_to - L_from,), dtype=ct.b.dtype,
                            device=ct.b.device)
        out = lwe.LweCiphertext(a=torch.cat([ct.a, pad_a], dim=-2),
                                b=torch.cat([ct.b, pad_b], dim=-1), modulus=ct.modulus,
                                pt_mod=ct.pt_mod)
    return RadixInt(ct=out, rp=rp_to, max_limb=x.max_limb)
