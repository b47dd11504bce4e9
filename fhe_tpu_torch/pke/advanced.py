"""Advanced SHE: EvalSum, inner products, linear weighted sums, polynomial
and Chebyshev series evaluation, linear transforms.  Port of
fhe_tpu/pke/advanced.py.

Reference semantics: the reference's base-advancedshe.cpp (EvalSum by
log-rotations, EvalInnerProduct, EvalLinearWSum) and
ckksrns-advancedshe.cpp (EvalPolyLinear, EvalChebyshevSeries); API surface
cryptocontext.h:2708-2807.

CKKS level/scale alignment follows the FLEXIBLEAUTO pattern
(rns-leveledshe.cpp EvalMult auto-adjust :182-191): ciphertexts are
brought to a common basis by scalar-adjusted rescales before adds.

Host-side composition over `CkksContext` ops: every ring op runs on the
ciphertexts' device (on a CUDA device the NTTs are the limb-stacked
kernels 1-2), and each function issues the same ops, rotations and
plaintexts as fhe_tpu's, so a seed gives the same ciphertexts byte for
byte.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

from ..lattice import rns
from ..math.approx import chebyshev_coefficients
from .ckks import Ciphertext, CkksContext


# ---------------------------------------------------------------------------
# level/scale alignment (FLEXIBLEAUTO)
# ---------------------------------------------------------------------------

def _times(ct: Ciphertext, c: int, scale: float) -> Ciphertext:
    """ct with both components multiplied by the integer c, relabelled to
    `scale`."""
    return Ciphertext(rns.mul_scalar(ct.c0, c), rns.mul_scalar(ct.c1, c), scale)


def _level_reduce(ct: Ciphertext, drop: int) -> Ciphertext:
    return Ciphertext(rns.level_reduce(ct.c0, drop), rns.level_reduce(ct.c1, drop), ct.scale)


def adjust_to(ctx: CkksContext, ct: Ciphertext, target_mods: tuple,
              target_scale: float) -> Ciphertext:
    """Bring ct to the target basis with (approximately) the target scale:
    LevelReduce (drop limbs, value-preserving) down to one level above,
    then one scalar-adjusted rescale (the reference's AdjustLevelsAndDepth,
    rns-leveledshe.cpp).  A plain rescale would divide the scale below 1
    and destroy the message.  One level = composite_degree limbs."""
    cd = ctx.params.composite_degree
    if len(ct.moduli) < len(target_mods):
        raise ValueError(f"cannot raise a ciphertext of {len(ct.moduli)} limbs to "
                         f"{len(target_mods)}")
    if len(ct.moduli) > len(target_mods) + cd:
        ct = _level_reduce(ct, len(ct.moduli) - (len(target_mods) + cd))
    if len(ct.moduli) == len(target_mods) + cd:
        q_block = 1.0
        for q in ct.moduli[-cd:]:
            q_block *= float(q)
        c = max(1, round(target_scale * q_block / ct.scale))
        ct = ctx.rescale(_times(ct, c, ct.scale * c))
    return ct


def _match_scales(ctx: CkksContext, a: Ciphertext, b: Ciphertext
                  ) -> tuple[Ciphertext, Ciphertext]:
    """Exactly align the scales of two same-basis ciphertexts.

    Same-level ciphertexts reached by different multiplication paths carry
    scales differing by the relative offsets of the rescale prime blocks
    from 2^scale_bits (~1e-4): relabelling would inject that as message
    error.  Instead both sides are multiplied by small integers u, v with
    u a.scale ~= v b.scale (a continued-fraction approximation), exact up
    to ~2^-24 relative at the cost of <= 24 bits of headroom."""
    if abs(a.scale - b.scale) <= 1e-12 * a.scale:
        return a, Ciphertext(b.c0, b.c1, a.scale)
    # headroom-aware limit: values grow by <= limit.  With FLEXIBLEAUTO
    # level-target scales this path is a rare safety net, so a small cap
    # suffices and bounds scale inflation.
    q_bits = sum(int(q).bit_length() for q in a.moduli)
    slack = q_bits - ctx.params.scale_bits - 8
    limit = 1 << max(2, min(16, slack // 2))
    frac = Fraction(b.scale / a.scale).limit_denominator(limit)
    u, v = frac.numerator, frac.denominator
    if u <= 0 or v <= 0 or max(u, v) > limit * 4:
        return a, Ciphertext(b.c0, b.c1, a.scale)   # degenerate: relabel
    return _times(a, u, a.scale * u), _times(b, v, a.scale * u)


def _align_levels(ctx: CkksContext, a: Ciphertext, b: Ciphertext
                  ) -> tuple[Ciphertext, Ciphertext]:
    if len(a.moduli) > len(b.moduli):
        a = adjust_to(ctx, a, b.moduli, b.scale)
    elif len(b.moduli) > len(a.moduli):
        b = adjust_to(ctx, b, a.moduli, a.scale)
    return a, b


def add_aligned(ctx: CkksContext, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    """Add with automatic level/scale matching."""
    a, b = _match_scales(ctx, *_align_levels(ctx, a, b))
    return ctx.add(a, b)


def mul_aligned(ctx: CkksContext, a: Ciphertext, b: Ciphertext, evk) -> Ciphertext:
    """Multiply, relinearize and rescale with automatic level matching."""
    a, b = _align_levels(ctx, a, b)
    return ctx.rescale(ctx.mul(a, b, evk))


# ---------------------------------------------------------------------------
# rotations-based aggregation
# ---------------------------------------------------------------------------

def sum_key_gen(ctx: CkksContext, sk, rng, batch: int | None = None) -> dict:
    """Rotation keys for EvalSum's log tree (EvalSumKeyGen)."""
    slots = batch or ctx.params.N // 2
    return ctx.rotation_key_gen(sk, [1 << i for i in range(int(np.log2(slots)))], rng)


def _rotate_and_add(ctx: CkksContext, ct: Ciphertext, first: int, stop: int,
                    rot_keys: dict) -> Ciphertext:
    """out += rotate(out, r) for r = first, 2 first, ... below stop."""
    out = ct
    r = first
    while r < stop:
        out = ctx.add(out, ctx.rotate(out, r, rot_keys))
        r <<= 1
    return out


def eval_sum(ctx: CkksContext, ct: Ciphertext, batch: int, rot_keys: dict) -> Ciphertext:
    """Sum the first `batch` slots into every slot (EvalSum: log2(batch)
    rotate-and-add rounds)."""
    if batch <= 0 or batch & (batch - 1):
        raise ValueError(f"EvalSum's batch must be a power of two, got {batch}")
    return _rotate_and_add(ctx, ct, 1, batch, rot_keys)


def eval_inner_product(ctx: CkksContext, a: Ciphertext, b: Ciphertext, batch: int, evk,
                       rot_keys: dict) -> Ciphertext:
    """<a, b> over the first `batch` slots (EvalInnerProduct)."""
    return eval_sum(ctx, mul_aligned(ctx, a, b, evk), batch, rot_keys)


def eval_linear_wsum(ctx: CkksContext, cts: list[Ciphertext], weights) -> Ciphertext:
    """sum_i w_i ct_i for real weights (EvalLinearWSum)."""
    acc = None
    for ct, w in zip(cts, weights):
        term = ctx.mul_plain(ct, np.full(ctx.params.N // 2, float(w)))
        acc = term if acc is None else add_aligned(ctx, acc, term)
    return ctx.rescale(acc)


def sum_rows_key_gen(ctx: CkksContext, sk, rng, row_size: int,
                     slots: int | None = None) -> dict:
    """Rotation keys for EvalSumRows (EvalSumRowsKeyGen,
    base-advancedshe.cpp:193): indices row_size 2^j."""
    s = slots or ctx.params.N // 2
    rots = []
    r = row_size
    while r < s:
        rots.append(r)
        r <<= 1
    return ctx.rotation_key_gen(sk, rots, rng)


def eval_sum_rows(ctx: CkksContext, ct: Ciphertext, row_size: int, rot_keys: dict,
                  slots: int | None = None) -> Ciphertext:
    """Sum the rows of a row-major [numRows, row_size] slot matrix; every
    row of the result holds the column sums (EvalSumRows,
    base-advancedshe.cpp:284)."""
    return _rotate_and_add(ctx, ct, row_size, slots or ctx.params.N // 2, rot_keys)


def sum_cols_key_gen(ctx: CkksContext, sk, rng, num_cols: int) -> dict:
    """Keys for EvalSumCols (EvalSumColsKeyGen: the EvalSum indices merged
    with the negative spread rotations)."""
    n = max(1, int(np.log2(num_cols)))
    rots = [1 << i for i in range(n)] + [-(1 << i) for i in range(n)]
    return ctx.rotation_key_gen(sk, sorted(set(rots)), rng)


def eval_sum_cols(ctx: CkksContext, ct: Ciphertext, num_cols: int,
                  rot_keys: dict) -> Ciphertext:
    """Sum each row of a row-major slot matrix with rows of num_cols; the
    row sum is replicated across the row (EvalSumCols,
    base-advancedshe.cpp:304: EvalSum over the row, a column-0 mask and a
    negative-rotation spread)."""
    if num_cols <= 0 or num_cols & (num_cols - 1):
        raise ValueError(f"EvalSumCols' row length must be a power of two, got {num_cols}")
    out = eval_sum(ctx, ct, num_cols, rot_keys)
    mask = np.zeros(ctx.params.N // 2)
    mask[::num_cols] = 1.0
    out = ctx.rescale(ctx.mul_plain(out, mask))
    r = 1
    while r < num_cols:
        out = ctx.add(out, ctx.rotate(out, -r, rot_keys))
        r <<= 1
    return out


def merge_key_gen(ctx: CkksContext, sk, rng, count: int) -> dict:
    """Negative rotation keys -1 .. -(count - 1) for EvalMerge."""
    return ctx.rotation_key_gen(sk, [-i for i in range(1, count)], rng)


def eval_merge(ctx: CkksContext, cts: list[Ciphertext], rot_keys: dict) -> Ciphertext:
    """Merge slot 0 of each ciphertext into one ciphertext: out_i =
    cts[i][0] (EvalMerge, base-advancedshe.cpp:382: mask to slot 0, rotate
    into place, add)."""
    mask = np.zeros(ctx.params.N // 2)
    mask[0] = 1.0
    out = ctx.rescale(ctx.mul_plain(cts[0], mask))
    for i in range(1, len(cts)):
        t = ctx.rescale(ctx.mul_plain(cts[i], mask))
        out = add_aligned(ctx, out, ctx.rotate(t, -i, rot_keys))
    return out


def _tree(cts: list[Ciphertext], op) -> Ciphertext:
    """Pairwise reduction, the odd one out carried up a level."""
    lvl = list(cts)
    while len(lvl) > 1:
        nxt = [op(lvl[i], lvl[i + 1]) for i in range(0, len(lvl) - 1, 2)]
        if len(lvl) % 2:
            nxt.append(lvl[-1])
        lvl = nxt
    return lvl[0]


def eval_add_many(ctx: CkksContext, cts: list[Ciphertext]) -> Ciphertext:
    """Binary-tree sum (EvalAddMany, cryptocontext.h)."""
    return _tree(cts, lambda a, b: add_aligned(ctx, a, b))


def eval_mult_many(ctx: CkksContext, cts: list[Ciphertext], evk) -> Ciphertext:
    """Binary-tree product, depth log2(n) (EvalMultMany)."""
    return _tree(cts, lambda a, b: mul_aligned(ctx, a, b, evk))


def eval_negate(ctx: CkksContext, ct: Ciphertext) -> Ciphertext:
    """EvalNegate."""
    return Ciphertext(rns.neg(ct.c0), rns.neg(ct.c1), ct.scale)


def compress(ctx: CkksContext, ct: Ciphertext, towers_left: int = 1) -> Ciphertext:
    """Compress (cryptocontext.h / rns-leveledshe Compress): drop to the
    smallest basis (value-preserving LevelReduce) before transmission or
    decryption; the ciphertext shrinks to towers_left blocks."""
    drop = len(ct.moduli) - towers_left * ctx.cd
    return ct if drop <= 0 else _level_reduce(ct, drop)


# ---------------------------------------------------------------------------
# polynomial evaluation
# ---------------------------------------------------------------------------

def _twice(ct: Ciphertext) -> Ciphertext:
    return _times(ct, 2, ct.scale)


def _plain_terms(ctx: CkksContext, powers, coeffs, tol: float) -> Ciphertext | None:
    """sum_k coeffs[k] powers(k) over k >= 1 with |coeffs[k]| >= tol, each
    term a mul_plain + rescale, summed aligned; None if no term."""
    slots = ctx.params.N // 2
    acc = None
    for k in range(1, len(coeffs)):
        if abs(coeffs[k]) < tol:
            continue
        term = ctx.rescale(ctx.mul_plain(powers(k), np.full(slots, coeffs[k])))
        acc = term if acc is None else add_aligned(ctx, acc, term)
    return acc


def eval_poly(ctx: CkksContext, ct: Ciphertext, coeffs, evk) -> Ciphertext:
    """Power-basis polynomial sum_k c_k x^k (EvalPolyLinear): the powers by
    a linear chain of products; depth = deg."""
    coeffs = [float(c) for c in coeffs]
    acc = None
    power = None   # x^k ciphertext
    for k, c in enumerate(coeffs):
        if k == 0:
            continue
        power = ct if power is None else mul_aligned(ctx, power, ct, evk)
        if abs(c) < 1e-12:
            continue
        term = ctx.rescale(ctx.mul_plain(power, np.full(ctx.params.N // 2, c)))
        acc = term if acc is None else add_aligned(ctx, acc, term)
    if abs(coeffs[0]) > 1e-12:
        if acc is None:
            raise ValueError("constant-only polynomial")
        acc = ctx.add_plain(acc, np.full(ctx.params.N // 2, coeffs[0]))
    return acc


def eval_poly_linear(ctx: CkksContext, ct: Ciphertext, coeffs, evk) -> Ciphertext:
    """EvalPolyLinear (cryptocontext.h): the linear power-chain evaluator."""
    return eval_poly(ctx, ct, coeffs, evk)


def eval_poly_ps(ctx: CkksContext, ct: Ciphertext, coeffs, evk) -> Ciphertext:
    """EvalPolyPS (cryptocontext.h / ckksrns-advancedshe.cpp): power-basis
    polynomial at Paterson-Stockmeyer depth.  The monomial coefficients are
    converted exactly to the Chebyshev basis on [-1, 1] (poly2cheb, a
    linear change of basis) and evaluated by the PS Chebyshev evaluator:
    O(sqrt(deg)) nonscalar products, O(log deg) depth."""
    cheb = np.polynomial.chebyshev.poly2cheb(np.asarray([complex(c) for c in coeffs]))
    return eval_chebyshev_series_ps(ctx, ct, list(cheb), -1.0, 1.0, evk)


def eval_powers(ctx: CkksContext, ct: Ciphertext, degree: int, evk) -> list[Ciphertext]:
    """EvalPowers (cryptocontext.h): [x, x^2, ..., x^degree], x^2k by
    squaring (log depth), odd powers by one product."""
    powers: list[Ciphertext | None] = [None] * (degree + 1)
    powers[1] = ct
    for k in range(2, degree + 1):
        if k % 2 == 0:
            powers[k] = ctx.rescale(ctx.square(powers[k // 2], evk))
        else:
            powers[k] = mul_aligned(ctx, powers[k - 1], ct, evk)
    return powers[1:]


def eval_poly_with_precomp(ctx: CkksContext, powers: list[Ciphertext], coeffs,
                           evk) -> Ciphertext:
    """EvalPolyWithPrecomp: sum_k c_k x^k over the powers of eval_powers
    (powers[k - 1] = x^k)."""
    coeffs = [complex(c) for c in coeffs]
    acc = _plain_terms(ctx, lambda k: powers[k - 1], coeffs, 1e-12)
    if acc is None:
        raise ValueError("constant-only polynomial")
    if abs(coeffs[0]) > 1e-12:
        acc = ctx.add_plain(acc, np.full(ctx.params.N // 2, coeffs[0]))
    return acc


def _normalized(ctx: CkksContext, ct: Ciphertext, a: float, b: float) -> Ciphertext:
    """y = (2x - a - b) / (b - a); on [-1, 1] ct itself (one level saved)."""
    if (a, b) == (-1.0, 1.0):
        return ct
    slots = ctx.params.N // 2
    y = ctx.rescale(ctx.mul_plain(ct, np.full(slots, 2.0 / (b - a))))
    return ctx.add_plain(y, np.full(slots, -(a + b) / (b - a)))


def eval_chebyshev_series(ctx: CkksContext, ct: Ciphertext, coeffs, a: float, b: float,
                          evk) -> Ciphertext:
    """sum_k c_k T_k(y), y = (2x - a - b)/(b - a) (EvalChebyshevSeries, the
    linear three-term recurrence T_{k+1} = 2 y T_k - T_{k-1}).

    Coefficients may be complex (CKKS slots are complex)."""
    coeffs = [complex(c) for c in coeffs]
    slots = ctx.params.N // 2
    y = _normalized(ctx, ct, a, b)
    t_prev = None          # T_0 handled as plaintext 1
    t_cur = y              # T_1
    acc = ctx.rescale(ctx.mul_plain(y, np.full(slots, coeffs[1]))) if len(coeffs) > 1 else None
    for k in range(2, len(coeffs)):
        two_y_t = _twice(mul_aligned(ctx, y, t_cur, evk))
        if t_prev is None:
            # T_2 = 2 y T_1 - T_0, T_0 = 1
            t_next = ctx.add_plain(two_y_t, np.full(slots, -1.0))
        else:
            t_next = add_aligned(ctx, two_y_t, eval_negate(ctx, t_prev))
        t_prev, t_cur = t_cur, t_next
        if abs(coeffs[k]) > 1e-12:
            term = ctx.rescale(ctx.mul_plain(t_cur, np.full(slots, coeffs[k])))
            acc = term if acc is None else add_aligned(ctx, acc, term)
    if abs(coeffs[0]) > 1e-12 and acc is not None:
        acc = ctx.add_plain(acc, np.full(slots, coeffs[0]))
    return acc


def _cheb_divmod(c: list, g: int):
    """Divide sum c_i T_i by T_g in the Chebyshev basis: (q, r) with
    f = q T_g + r, deg(r) < g, by T_i = 2 T_g T_{i-g} - T_{|i-2g|}."""
    work = list(c)
    n = len(work) - 1
    q = [0.0] * (n - g + 1)
    for i in range(n, g, -1):
        if work[i] == 0.0:
            continue
        q[i - g] += 2.0 * work[i]
        work[abs(i - 2 * g)] -= work[i]
        work[i] = 0.0
    q[0] += work[g]
    work[g] = 0.0
    return q, work[:g]


def eval_chebyshev_series_ps(ctx: CkksContext, ct: Ciphertext, coeffs, a: float, b: float,
                             evk) -> Ciphertext:
    """Paterson-Stockmeyer Chebyshev evaluation (EvalChebyshevSeriesPS,
    ckksrns-advancedshe.cpp): depth ~ log2(deg) instead of deg.

    Baby steps T_1..T_k and giant steps T_{2^j k}, then f = q T_g + r split
    recursively.  Coefficients may be complex."""
    coeffs = [complex(c) for c in coeffs]
    while len(coeffs) > 1 and abs(coeffs[-1]) < 1e-14:
        coeffs.pop()
    deg = len(coeffs) - 1
    slots = ctx.params.N // 2
    if deg <= 2:
        return eval_chebyshev_series(ctx, ct, coeffs, a, b, evk)

    y = _normalized(ctx, ct, a, b)
    k = max(2, int(np.sqrt((deg + 1) / 2.0) + 0.5))
    # babies T_1..T_k: T_a T_b = (T_{a+b} + T_{|a-b|}) / 2
    T = {1: y}
    for i in range(2, k + 1):
        half = i // 2
        other = i - half
        prod = _twice(mul_aligned(ctx, T[half], T[other], evk))
        d = abs(half - other)
        if d == 0:
            T[i] = ctx.add_plain(prod, np.full(slots, -1.0))
        else:
            T[i] = add_aligned(ctx, prod, eval_negate(ctx, T[d]))
    # giants T_{2k}, T_{4k}, ...
    g = k
    while 2 * g <= deg:
        sq = _twice(mul_aligned(ctx, T[g], T[g], evk))
        T[2 * g] = ctx.add_plain(sq, np.full(slots, -1.0))
        g *= 2

    def emit(cs: list) -> Ciphertext | None:
        """sum cs_i T_i as a ciphertext (None if ~zero)."""
        d = len(cs) - 1
        while d > 0 and abs(cs[d]) < 1e-14:
            d -= 1
        cs = cs[:d + 1]
        if d <= k:
            acc = _plain_terms(ctx, T.__getitem__, cs, 1e-14)
            if abs(cs[0]) > 1e-14:
                if acc is None:
                    acc = ctx.rescale(ctx.mul_plain(T[1], np.full(slots, 0.0)))
                acc = ctx.add_plain(acc, np.full(slots, cs[0]))
            return acc
        gg = k
        while 2 * gg <= d:
            gg *= 2
        q, r = _cheb_divmod(cs, gg)
        cq = emit(q)
        cr = emit(r)
        if cq is None:
            return cr
        prod = mul_aligned(ctx, cq, T[gg], evk)
        return prod if cr is None else add_aligned(ctx, prod, cr)

    return emit(coeffs)


# ---------------------------------------------------------------------------
# linear transforms (matrix x slot vector, diagonal method)
# ---------------------------------------------------------------------------

def eval_linear_transform(ctx: CkksContext, ct: Ciphertext, M: np.ndarray,
                          rot_keys: dict) -> Ciphertext:
    """y = M @ slots(ct) by the diagonal method: y = sum_d diag_d(M)
    rot(ct, d) (the dense-matrix EvalLinearTransform of CKKS bootstrapping's
    CoeffsToSlots at level budget 1); the all-zero diagonals are skipped,
    so only their rotations' keys are needed."""
    n = M.shape[0]
    rows = np.arange(n)
    acc = None
    for d in range(n):
        diag = M[rows, (rows + d) % n]
        if not np.any(np.abs(diag) > 1e-12):
            continue
        rct = ct if d == 0 else ctx.rotate(ct, d, rot_keys)
        term = ctx.mul_plain(rct, diag)
        acc = term if acc is None else ctx.add(acc, term)
    return ctx.rescale(acc)


# ---------------------------------------------------------------------------
# function evaluation conveniences (cryptocontext.cpp:497-525)
# ---------------------------------------------------------------------------

def eval_chebyshev_function(ctx: CkksContext, func, ct: Ciphertext, a: float, b: float,
                            degree: int, evk) -> Ciphertext:
    """EvalChebyshevFunction: interpolate func on [a, b] at the Chebyshev
    nodes of the given degree, then evaluate the series (Paterson-
    Stockmeyer)."""
    coeffs = chebyshev_coefficients(func, a, b, degree)
    return eval_chebyshev_series_ps(ctx, ct, coeffs, a, b, evk)


def eval_sin(ctx, ct, a, b, degree, evk):
    """EvalSin (cryptocontext.cpp:505)."""
    return eval_chebyshev_function(ctx, np.sin, ct, a, b, degree, evk)


def eval_cos(ctx, ct, a, b, degree, evk):
    """EvalCos (cryptocontext.cpp:511)."""
    return eval_chebyshev_function(ctx, np.cos, ct, a, b, degree, evk)


def eval_logistic(ctx, ct, a, b, degree, evk):
    """EvalLogistic: 1/(1 + exp(-x)) (cryptocontext.cpp:517)."""
    return eval_chebyshev_function(ctx, lambda x: 1.0 / (1.0 + np.exp(-x)), ct, a, b,
                                   degree, evk)


def eval_divide(ctx, ct, a, b, degree, evk):
    """EvalDivide: 1/x on [a, b], 0 < a < b or a < b < 0
    (cryptocontext.cpp:523)."""
    return eval_chebyshev_function(ctx, lambda x: 1.0 / x, ct, a, b, degree, evk)
