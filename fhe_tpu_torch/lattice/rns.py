"""The RNS (double-CRT) ring: port of fhe_tpu/lattice/rns.py.

A ring element mod Q = q_0 ... q_{L-1} is one int32 tensor [..., L, N]
(limb-major, fhe_tpu's layout), limb l a residue mod its own NTT prime
q_l < 2^31; `RnsPoly` carries it with its moduli and format (COEFF or
EVAL).  `RnsPlan` stacks the limbs' `math.ntt.NttPlan` tables as [L, N].
`ntt_forward` / `ntt_inverse` transform every limb of every row: the
plain versions (`forward_plain` / `inverse_plain`, math.ntt's butterflies
over all limbs at once, each mod its own q) for a CPU tensor,
the limb-stacked NTT kernels (`kernels.ntt.forward_limbs` /
`inverse_limbs`, one launch for all limbs) for a CUDA tensor; they raise
on any other device and never fall back.  EVALUATION is natural order, as
in `math.ntt`.

Everything else here is PyTorch ops on the device of the data, as fhe_tpu
leaves it to XLA: residues are widened to int64, where any product of two
residues is exact, and every product is reduced mod its limb before a sum
(a basis switch sums L of them).  fhe_tpu multiplies in Montgomery form
against Montgomery-form constants; the port multiplies plain residues by
plain constants, which gives the same canonical residues, so every result
is byte-equal.  So is BFV's kit: HPS's `scale_and_round_t_over_q` and
BEHZ's `fast_base_conv_q_to_bsk`, `fast_rns_floor_q` and
`fast_base_conv_sk`.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..math import ntt as nttmod
from ..math.modmath import add_mod, barrett_reduce_u32, fraction_round_v, neg_mod, sub_mod

COEFF = "COEFF"
EVAL = "EVAL"


@dataclasses.dataclass(frozen=True, eq=False)
class RnsPlan:
    """Per-(N, moduli, device) tables: the limbs' NttPlans, their tables
    stacked [L, N] int32 (uint32 words), and the moduli as an int64 [L, 1]
    tensor for broadcasting against [..., L, N]."""
    N: int
    moduli: tuple[int, ...]
    plans: tuple[nttmod.NttPlan, ...]
    q: torch.Tensor
    fwd_w: torch.Tensor
    fwd_ws: torch.Tensor
    inv_w: torch.Tensor
    inv_ws: torch.Tensor

    @property
    def L(self) -> int:
        return len(self.moduli)


@functools.lru_cache(maxsize=None)
def make_rns_plan(N: int, moduli: tuple[int, ...], device: str | torch.device = "cpu") -> RnsPlan:
    """The plan of the basis `moduli` (each an NTT prime below 2^31 for N)."""
    dev = torch.device(device)
    plans = tuple(nttmod.make_plan(N, q, dev) for q in moduli)
    stack = lambda name: torch.stack([getattr(p, name) for p in plans]).contiguous()
    return RnsPlan(N=N, moduli=tuple(moduli), plans=plans,
                   q=torch.tensor(moduli, dtype=torch.int64, device=dev)[:, None],
                   fwd_w=stack("fwd_w"), fwd_ws=stack("fwd_ws"),
                   inv_w=stack("inv_w"), inv_ws=stack("inv_ws"))


def forward_plain(plan: RnsPlan, x: torch.Tensor) -> torch.Tensor:
    """[..., L, N] COEFFICIENT -> EVALUATION; plain version: math.ntt's
    forward_butterfly on every limb at once, limb l mod its own q and
    with its own table."""
    N, L = plan.N, plan.L
    q = plan.q.reshape(1, L, 1, 1)
    w_all = plan.fwd_w.to(device=x.device, dtype=torch.int64)
    y = x.reshape(-1, L, N).to(torch.int64)
    for s in range(N.bit_length() - 1):
        m, t = 1 << s, N >> (s + 1)
        yv = y.reshape(-1, L, m, 2, t)
        u = yv[..., 0, :]
        v = yv[..., 1, :] * w_all[:, m:2 * m].reshape(1, L, m, 1) % q
        y = (torch.stack([u + v, u - v + q], dim=-2) % q[..., None]).reshape(-1, L, N)
    y = y[..., plan.plans[0].br.to(x.device)]
    return y.reshape(x.shape).to(x.dtype)


def inverse_plain(plan: RnsPlan, x: torch.Tensor) -> torch.Tensor:
    """[..., L, N] EVALUATION -> COEFFICIENT; plain version: math.ntt's
    inverse_butterfly on every limb at once."""
    N, L = plan.N, plan.L
    q = plan.q.reshape(1, L, 1, 1)
    w_all = plan.inv_w.to(device=x.device, dtype=torch.int64)
    y = x.reshape(-1, L, N).to(torch.int64)[..., plan.plans[0].br.to(x.device)]
    for s in range(N.bit_length() - 1):
        h, t = N >> (s + 1), 1 << s
        yv = y.reshape(-1, L, h, 2, t)
        u = yv[..., 0, :]
        v = yv[..., 1, :]
        y = torch.stack([(u + v) % q, (u - v + q) * w_all[:, h:2 * h].reshape(1, L, h, 1) % q],
                        dim=-2).reshape(-1, L, N)
    ninv = torch.tensor([p.ninv for p in plan.plans], dtype=torch.int64, device=x.device)
    y = y * ninv.reshape(1, L, 1) % plan.q.reshape(1, L, 1)
    return y.reshape(x.shape).to(x.dtype)


def _dispatch(plan: RnsPlan, x: torch.Tensor, plain, kernel) -> torch.Tensor:
    if tuple(x.shape[-2:]) != (plan.L, plan.N):
        raise ValueError(f"RNS NTT needs [..., {plan.L}, {plan.N}], got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return plain(plan, x)
    if x.device.type != "cuda":
        raise ValueError(f"no NTT for device {x.device}")
    lead = x.shape[:-2]
    return kernel(plan, x.reshape(-1, plan.L, plan.N).contiguous()).reshape(*lead, plan.L, plan.N)


def ntt_forward(plan: RnsPlan, x: torch.Tensor) -> torch.Tensor:
    """[..., L, N] int32 COEFFICIENT -> EVALUATION, per-limb moduli: plain
    on CPU, the limb-stacked kernel on CUDA."""
    from ..kernels import ntt as kntt
    return _dispatch(plan, x, forward_plain, kntt.forward_limbs)


def ntt_inverse(plan: RnsPlan, x: torch.Tensor) -> torch.Tensor:
    """[..., L, N] int32 EVALUATION -> COEFFICIENT: plain on CPU, the
    limb-stacked kernel on CUDA."""
    from ..kernels import ntt as kntt
    return _dispatch(plan, x, inverse_plain, kntt.inverse_limbs)


# ---------------------------------------------------------------------------
# ring elements
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class RnsPoly:
    """[..., L, N] int32 ring element over basis `moduli`, in `fmt`."""
    data: torch.Tensor
    moduli: tuple
    fmt: str = EVAL

    @property
    def N(self) -> int:
        return self.data.shape[-1]

    @property
    def L(self) -> int:
        return self.data.shape[-2]

    @property
    def plan(self) -> RnsPlan:
        return make_rns_plan(self.N, self.moduli, self.data.device)

    def _q(self) -> torch.Tensor:
        """Per-limb moduli, int64 [L, 1]."""
        return self.plan.q


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


def _i64(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64)


@functools.lru_cache(maxsize=None)
def limb_constants(values: tuple, device) -> torch.Tensor:
    """Per-limb constants as an int64 [L, 1] tensor on the device (cached)."""
    return torch.tensor(values, dtype=torch.int64, device=device)[:, None]


def modulus_product(moduli) -> int:
    """The product of the moduli, a Python int."""
    out = 1
    for q in moduli:
        out *= int(q)
    return out


def to_eval(p: RnsPoly) -> RnsPoly:
    if p.fmt == EVAL:
        return p
    return RnsPoly(ntt_forward(p.plan, p.data), p.moduli, EVAL)


def to_coeff(p: RnsPoly) -> RnsPoly:
    if p.fmt == COEFF:
        return p
    return RnsPoly(ntt_inverse(p.plan, p.data), p.moduli, COEFF)


def stack(polys) -> RnsPoly:
    """Ring elements of one basis and format on a new leading axis [k, ...,
    L, N]: one NTT launch then transforms them all."""
    for p in polys[1:]:
        _same_ring(polys[0], p)
    return RnsPoly(torch.stack([p.data for p in polys]), polys[0].moduli, polys[0].fmt)


def _same_ring(a: RnsPoly, b: RnsPoly) -> None:
    if a.moduli != b.moduli or a.fmt != b.fmt:
        raise ValueError(f"ring mismatch: {a.moduli} {a.fmt} vs {b.moduli} {b.fmt}")


def add(a: RnsPoly, b: RnsPoly) -> RnsPoly:
    _same_ring(a, b)
    return RnsPoly(_i32(add_mod(a.data, b.data, a._q())), a.moduli, a.fmt)


def sub(a: RnsPoly, b: RnsPoly) -> RnsPoly:
    _same_ring(a, b)
    return RnsPoly(_i32(sub_mod(a.data, b.data, a._q())), a.moduli, a.fmt)


def neg(a: RnsPoly) -> RnsPoly:
    return RnsPoly(_i32(neg_mod(a.data, a._q())), a.moduli, a.fmt)


def mul(a: RnsPoly, b: RnsPoly) -> RnsPoly:
    """Pointwise product (EVALUATION format required)."""
    _same_ring(a, b)
    if a.fmt != EVAL:
        raise ValueError("rns.mul needs EVALUATION format")
    return RnsPoly(_i32(_i64(a.data) * _i64(b.data) % a._q()), a.moduli, EVAL)


def mul_scalar(a: RnsPoly, c) -> RnsPoly:
    """Multiply by an integer: c is an int, or one residue per limb (a
    sequence of ints, or an int64 [L, 1] tensor on a's device)."""
    if not isinstance(c, torch.Tensor):
        cs = [int(c) % q for q in a.moduli] if isinstance(c, int) else [int(v) for v in c]
        c = limb_constants(tuple(cs), a.data.device)
    return RnsPoly(_i32(_i64(a.data) * c % a._q()), a.moduli, a.fmt)


@functools.lru_cache(maxsize=None)
def _automorphism_index(N: int, k: int, device) -> torch.Tensor:
    """out[i] = in[j] with 2j + 1 = (2i + 1) k mod 2N (natural EVAL order)."""
    i = np.arange(N, dtype=np.int64)
    j = ((2 * i + 1) * k % (2 * N) - 1) // 2
    return torch.from_numpy(j).to(device)


def automorphism(p: RnsPoly, k: int) -> RnsPoly:
    """a(X) -> a(X^k) for odd k (EvalAutomorphism): in natural-order
    EVALUATION a permutation of the points, a host index table and one
    index_select on the device."""
    if p.fmt != EVAL:
        raise ValueError("automorphism needs EVALUATION format")
    k %= 2 * p.N
    if k % 2 != 1:
        raise ValueError(f"automorphism index must be odd, got {k}")
    idx = _automorphism_index(p.N, k, p.data.device)
    return RnsPoly(p.data.index_select(-1, idx), p.moduli, EVAL)


# ---------------------------------------------------------------------------
# CRT basis arithmetic (host constants, plain form)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _basis_consts(from_mods: tuple, to_mods: tuple, device):
    """ApproxSwitchCRTBasis {q_i} -> {p_j}: (Q/q_i)^-1 mod q_i as [L, 1] and
    (Q/q_i) mod p_j as [L, M, 1], int64, plain form (fhe_tpu keeps them in
    Montgomery form); and the to-basis moduli [M, 1]."""
    Q = modulus_product(from_mods)
    qhat_inv = [pow(Q // qi % qi, -1, qi) for qi in from_mods]
    qhat_to = [[Q // qi % pj for pj in to_mods] for qi in from_mods]
    return (limb_constants(tuple(qhat_inv), device),
            torch.tensor(qhat_to, dtype=torch.int64, device=device)[..., None],
            limb_constants(tuple(to_mods), device))


def _switch_sum(p: RnsPoly, to_mods: tuple):
    """(y, out): y_i = x_i (Q/q_i)^-1 mod q_i [..., L, N] and out_j =
    sum_i y_i (Q/q_i) mod p_j [..., M, N], each term reduced before the sum."""
    qhat_inv, qhat_to, pq = _basis_consts(p.moduli, tuple(to_mods), p.data.device)
    y = _i64(p.data) * qhat_inv % p._q()
    terms = y[..., :, None, :] * qhat_to % pq                   # [..., L, M, N]
    return y, terms.sum(dim=-3) % pq


def switch_crt_basis_approx(p: RnsPoly, to_mods: tuple) -> RnsPoly:
    """ApproxSwitchCRTBasis (dcrtpoly-impl.h:910): out_j = sum_i [x_i *
    (Q/q_i)^-1 mod q_i] * (Q/q_i) mod p_j, COEFFICIENT format; the result
    is x + u Q for a small integer u in [0, L), exactly as the reference."""
    if p.fmt != COEFF:
        raise ValueError("basis switch needs COEFFICIENT format")
    _, out = _switch_sum(p, to_mods)
    return RnsPoly(_i32(out), tuple(to_mods), COEFF)


def switch_crt_basis_exact(p: RnsPoly, to_mods: tuple, centered: bool = False) -> RnsPoly:
    """Exact CRT basis switch (HPS fast base conversion with correction):
    out_j = sum_i y_i (Q/q_i) - v Q mod p_j, v = floor(sum y_i / q_i) (its
    round if centered, lifting the [-Q/2, Q/2) representative), with v
    from `modmath.fraction_round_v`'s integer arithmetic."""
    if p.fmt != COEFF:
        raise ValueError("basis switch needs COEFFICIENT format")
    y, acc = _switch_sum(p, to_mods)
    v = fraction_round_v(y, p.moduli, centered)                 # [..., N], <= L
    Q = modulus_product(p.moduli)
    q_to = limb_constants(tuple(Q % pj for pj in to_mods), p.data.device)
    pq = limb_constants(tuple(to_mods), p.data.device)
    return RnsPoly(_i32(sub_mod(acc, v[..., None, :] * q_to % pq, pq)), tuple(to_mods), COEFF)


def scale_and_round_t_over_q(p: RnsPoly, q_mods: tuple, r_mods: tuple, t: int) -> RnsPoly:
    """round(t V / Q) mod R for V over the basis Q u R (BFV HPS
    ScaleAndRound, dcrtpoly.h:279-301), COEFF: floor((t V + floor(Q/2)) /
    Q) = (y - [y]_Q) / Q with y = t V + floor(Q/2), [y]_Q carried from the
    Q limbs to R by the exact switch."""
    if p.fmt != COEFF or p.moduli != tuple(q_mods) + tuple(r_mods):
        raise ValueError("scale_and_round_t_over_q needs COEFFICIENT data over q_mods + r_mods")
    Lq = len(q_mods)
    Q = modulus_product(q_mods)
    y = _i32(add_mod(mul_scalar(p, t).data,
                     limb_constants(tuple(Q // 2 % m for m in p.moduli), p.data.device), p._q()))
    z_r = switch_crt_basis_exact(RnsPoly(y[..., :Lq, :], tuple(q_mods), COEFF), tuple(r_mods))
    diff = sub(RnsPoly(y[..., Lq:, :], tuple(r_mods), COEFF), z_r)
    return mul_scalar(diff, [pow(Q % r, -1, r) for r in r_mods])


# ---------------------------------------------------------------------------
# BEHZ (eprint 2016/510) base-conversion kit
# ---------------------------------------------------------------------------

# mtilde, a power of two: fhe_tpu's mod-mtilde arithmetic wraps in uint32 and
# masks (2^16 divides 2^32); here the int64 sums are exact and the mask alone
# reduces them
_MTILDE = 1 << 16


@functools.lru_cache(maxsize=None)
def _behz_conv_consts(q_mods: tuple, bsk_mods: tuple, device):
    """FastBaseConvqToBskMontgomery's constants (dcrtpoly.h:305-312), plain
    form, int64 on the device: mtilde (Q/q_i)^-1 mod q_i [L, 1]; Q/q_i mod
    b_j [L, M, 1]; Q/q_i mod mtilde [L, 1]; -Q^-1 mod mtilde; Q mod b_j and
    mtilde^-1 mod b_j [M, 1]."""
    Q = modulus_product(q_mods)
    mt = _MTILDE
    dev_t = lambda rows: torch.tensor(rows, dtype=torch.int64, device=device)
    return (limb_constants(tuple(mt * pow(Q // qi % qi, -1, qi) % qi for qi in q_mods), device),
            dev_t([[Q // qi % bj for bj in bsk_mods] for qi in q_mods])[..., None],
            limb_constants(tuple(Q // qi % mt for qi in q_mods), device),
            mt - pow(Q % mt, -1, mt),
            limb_constants(tuple(Q % bj for bj in bsk_mods), device),
            limb_constants(tuple(pow(mt % bj, -1, bj) for bj in bsk_mods), device))


def fast_base_conv_q_to_bsk(p: RnsPoly, bsk_mods: tuple) -> RnsPoly:
    """BEHZ FastBaseConvqToBskMontgomery (dcrtpoly.h:305-312; eprint
    2016/510 3.1): the approximate conversion of mtilde x from q to Bsk u
    {mtilde}, then the small Montgomery reduction by mtilde, which removes
    the conversion's alpha Q: the result is x (or x + Q) exactly in Bsk.
    COEFFICIENT format."""
    if p.fmt != COEFF:
        raise ValueError("fast_base_conv_q_to_bsk needs COEFFICIENT format")
    mqinv, qhat_bsk, qhat_mt, negqinv_mt, q_bsk, mtinv = _behz_conv_consts(
        p.moduli, tuple(bsk_mods), p.data.device)
    bq = limb_constants(tuple(bsk_mods), p.data.device)
    mask = _MTILDE - 1
    y = _i64(p.data) * mqinv % p._q()                               # [..., L, N]
    acc = (y[..., :, None, :] * qhat_bsk % bq).sum(dim=-3) % bq     # [..., M, N]
    r = ((y * qhat_mt).sum(dim=-2) & mask) * negqinv_mt & mask      # [..., N]
    r = r[..., None, :]
    out = add_mod(acc, r * q_bsk % bq, bq) * mtinv % bq
    out = torch.where(r >= _MTILDE // 2, sub_mod(out, q_bsk, bq), out)
    return RnsPoly(_i32(out), tuple(bsk_mods), COEFF)


def fast_rns_floor_q(x_q: RnsPoly, x_bsk: RnsPoly) -> RnsPoly:
    """BEHZ FastRNSFloorq (eprint 2016/510 3.2): from the residues of one
    integer y in q and in Bsk, floor(y / Q) in Bsk (less a conversion error
    alpha < L)."""
    if x_q.fmt != COEFF or x_bsk.fmt != COEFF:
        raise ValueError("fast_rns_floor_q needs COEFFICIENT format")
    diff = sub(x_bsk, switch_crt_basis_approx(x_q, x_bsk.moduli))
    Q = modulus_product(x_q.moduli)
    return mul_scalar(diff, [pow(Q % b, -1, b) for b in x_bsk.moduli])


def fast_base_conv_sk(p: RnsPoly, q_mods: tuple) -> RnsPoly:
    """BEHZ FastBaseConvSK (Shenoy-Kumaresan): the exact conversion from Bsk
    = B u {m_sk} (m_sk the LAST limb) back to q, the m_sk residue cancelling
    the approximate conversion's alpha B."""
    if p.fmt != COEFF:
        raise ValueError("fast_base_conv_sk needs COEFFICIENT format")
    B_mods, msk = p.moduli[:-1], p.moduli[-1]
    x_B = RnsPoly(p.data[..., :-1, :], B_mods, COEFF)
    z_q = switch_crt_basis_approx(x_B, tuple(q_mods))              # x + alpha B mod q
    z_msk = switch_crt_basis_approx(x_B, (msk,)).data[..., 0, :]
    B = modulus_product(B_mods)
    # alpha = (z_msk - x_msk) B^-1 mod m_sk, centered at m_sk / 2
    alpha = sub_mod(z_msk, p.data[..., -1, :], msk) * pow(B % msk, -1, msk) % msk
    alpha = alpha[..., None, :]
    dev = p.data.device
    qq = limb_constants(tuple(q_mods), dev)
    out = sub_mod(z_q.data, alpha * limb_constants(tuple(B % q for q in q_mods), dev) % qq, qq)
    out = torch.where(alpha >= msk // 2,
                      add_mod(out, limb_constants(tuple(msk * B % q for q in q_mods), dev), qq), out)
    return RnsPoly(_i32(out), tuple(q_mods), COEFF)


def expand_crt_basis_approx(p: RnsPoly, ext_mods: tuple) -> RnsPoly:
    """ApproxModUp Q -> QP (dcrtpoly-impl.h:988): keep the Q limbs, append
    the switched P limbs."""
    ext = switch_crt_basis_approx(p, ext_mods)
    return RnsPoly(torch.cat([p.data, ext.data], dim=-2), p.moduli + tuple(ext_mods), p.fmt)


def approx_mod_down(p: RnsPoly, q_mods: tuple, p_mods: tuple, t: int | None = None) -> RnsPoly:
    """ApproxModDown QP -> Q: (x - w) P^-1 mod Q with w = x mod P switched
    to Q (up to its + u P slack).  p: COEFF over q_mods + p_mods.  For BGV
    (t given) w is lifted to a multiple of t, w = t [x_P t^-1 mod P], so
    the rounding error stays divisible by the plaintext modulus (the
    reference's tInvModq path)."""
    if p.fmt != COEFF or p.moduli != tuple(q_mods) + tuple(p_mods):
        raise ValueError("approx_mod_down needs COEFFICIENT data over q_mods + p_mods")
    Lq = len(q_mods)
    x_q = RnsPoly(p.data[..., :Lq, :], tuple(q_mods), COEFF)
    x_p = RnsPoly(p.data[..., Lq:, :], tuple(p_mods), COEFF)
    if t is not None:
        x_p = mul_scalar(x_p, [pow(t % m, -1, m) for m in p_mods])
    sw = switch_crt_basis_approx(x_p, tuple(q_mods))
    if t is not None:
        sw = mul_scalar(sw, t)
    P = modulus_product(p_mods)
    return mul_scalar(sub(x_q, sw), [pow(P % q, -1, q) for q in q_mods])


@functools.lru_cache(maxsize=None)
def _monomial_eval_table(N: int, moduli: tuple, m: int, device) -> torch.Tensor:
    """EVALUATION values of X^m over the basis, [L, N] int64:
    psi_l^(m (2k + 1)) mod q_l (MultByMonomialInPlace)."""
    e = m * (2 * np.arange(N, dtype=np.int64) + 1) % (2 * N)
    rows = []
    for q in moduli:
        psi = nttmod.make_plan(N, q).psi
        pows = np.empty(2 * N, dtype=np.int64)
        acc = 1
        for t in range(2 * N):
            pows[t] = acc
            acc = acc * psi % q
        rows.append(pows[e])
    return torch.from_numpy(np.stack(rows)).to(device)


def mul_monomial(p: RnsPoly, m: int) -> RnsPoly:
    """p(X) X^m in EVALUATION format (negacyclic: X^N = -1)."""
    if p.fmt != EVAL:
        raise ValueError("mul_monomial needs EVALUATION format")
    tbl = _monomial_eval_table(p.N, p.moduli, m % (2 * p.N), p.data.device)
    return RnsPoly(_i32(_i64(p.data) * tbl % p._q()), p.moduli, EVAL)


def level_reduce(p: RnsPoly, drop: int) -> RnsPoly:
    """Drop the last `drop` limbs without scaling (LevelReduce)."""
    if drop == 0:
        return p
    if not 0 < drop < len(p.moduli):
        raise ValueError(f"cannot drop {drop} of {len(p.moduli)} limbs")
    return RnsPoly(p.data[..., :-drop, :], p.moduli[:-drop], p.fmt)


def drop_last_element_and_scale(p: RnsPoly) -> RnsPoly:
    """CKKS rescale (DropLastElementAndScale): with last modulus q_L,
    out_i = (x_i - x_L) q_L^-1 mod q_i, COEFF data."""
    if p.fmt != COEFF:
        raise ValueError("drop_last_element_and_scale needs COEFFICIENT format")
    keep = p.moduli[:-1]
    qL = p.moduli[-1]
    qk = limb_constants(tuple(keep), p.data.device)
    diff = sub_mod(p.data[..., :-1, :], barrett_reduce_u32(p.data[..., -1:, :], qk), qk)
    return mul_scalar(RnsPoly(_i32(diff), keep, COEFF), [pow(qL % q, -1, q) for q in keep])


def to_bigint(p: RnsPoly) -> np.ndarray:
    """Host: CRT-reconstruct the exact Python-int coefficients in [0, Q)."""
    data = p.data.cpu().numpy()
    Q = modulus_product(p.moduli)
    out = np.zeros(data.shape[:-2] + (data.shape[-1],), dtype=object)
    for i, q in enumerate(p.moduli):
        qhat = Q // q
        c = pow(qhat % q, -1, q) * qhat % Q
        out = (out + data[..., i, :].astype(object) * c) % Q
    return out


def from_bigint(vals, moduli: tuple, N: int, fmt: str = COEFF, device="cuda") -> RnsPoly:
    """Host: exact integers [..., N] -> RNS residues on the device."""
    arr = np.asarray(vals, dtype=object)
    if arr.shape[-1] != N:
        raise ValueError(f"from_bigint needs [..., {N}] integers, got {arr.shape}")
    limbs = np.stack([(arr % q).astype(np.int64) for q in moduli], axis=-2)
    return RnsPoly(torch.from_numpy(limbs.astype(np.int32)).to(device), tuple(moduli), fmt)


def negacyclic_product(a, b, moduli: tuple, device="cuda") -> np.ndarray:
    """The negacyclic product of integer vectors a and b (length N, a power
    of two) mod P = prod(moduli), as Python ints in [0, P) (object array):
    the integer product itself where its coefficients lie in [0, P), and
    the centred one, after centring, where they lie within P/2.

    Forward NTTs of a and b mod each modulus (NTT primes below 2^31 for
    N), a pointwise product, an inverse NTT and the CRT on the host.  At an
    N the limb-stacked kernels take (`kernels.ntt.limb_sizes()`), a and b
    go through one limb-stacked launch each way over all moduli together;
    below it (the small-N kernels, single-modulus), one launch each way a
    modulus, a and b stacked.  The plain versions for a CPU device.  The
    one exact-product helper of `pke/fbt.py` (the schemelet's
    `_negacyclic_mul`) and `math/ntt_arb.py` (`_exact_linconv`)."""
    from ..kernels import ntt as kntt
    ab = np.stack([np.asarray(a, dtype=object), np.asarray(b, dtype=object)])
    N = ab.shape[-1]
    moduli = tuple(int(q) for q in moduli)
    if N in kntt.limb_sizes():
        e = to_eval(from_bigint(ab, moduli, N, device=device))
        prod = mul(RnsPoly(e.data[0], moduli, EVAL), RnsPoly(e.data[1], moduli, EVAL))
        return to_bigint(to_coeff(prod))
    limbs = []
    for q in moduli:
        plan = nttmod.make_plan(N, q, device)
        e = nttmod.ntt_forward(plan, torch.from_numpy((ab % q).astype(np.int64)).to(
            device=device, dtype=torch.int32))
        limbs.append(nttmod.ntt_inverse(plan, nttmod.pointwise_mul(plan, e[0], e[1])))
    return to_bigint(RnsPoly(torch.stack(limbs, dim=-2), moduli, COEFF))
