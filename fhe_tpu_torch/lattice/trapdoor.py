"""RLWE trapdoor generation and Gaussian preimage sampling (GPV/MP12).

Port of fhe_tpu/lattice/trapdoor.py (reference semantics: the C++
reference's RLWETrapdoorPair, RLWETrapdoorUtility::TrapdoorGen and
GaussSamp, with its dgsampling).

Construction (Micciancio-Peikert):
  A = [1, a, g_1 - (a*r_1 + e_1), ..., g_k - (a*r_k + e_k)],  g_i = b^i
with Gaussian trapdoor polys (r_i, e_i).  GaussSamp returns x with
<A, x> = u:
  x = p + [e.z, r.z, z],   z a G-lattice preimage of v = u - <A, p>.

* gauss_samp -- exact correctness (<A, x> = u always) with spherical
  perturbation and deterministic balanced-digit G-sampling.
* gauss_samp_corrected -- the full MP12 statistical pipeline: randomized
  G-lattice sampling (Klein/GPV over the gadget kernel basis) and a
  covariance-corrected perturbation, so Cov(x) ~ s^2 I whatever (R, E).

Device.  The public row, the trapdoor (r, e) and every preimage are int64
tensors on the device `trapdoor_gen` was given (the card unless the caller
names another).  The ring products run there through math/ntt's
negacyclic NTT (kernels 1-2 on a CUDA device, N >= 8).  Where fhe_tpu
runs one product a row (k + 2 for <A, p>, 2k for e.z and r.z), the port
stacks each sum's operands into one forward launch, multiplies and sums
in the evaluation domain, and runs one inverse launch: the same integers
mod q, so the bytes are fhe_tpu's.  A call of gauss_samp or
gauss_samp_corrected is two forward and two inverse launches.

Host.  The draws come from the caller's `np.random.Generator` in
fhe_tpu's order with fhe_tpu's numpy calls.  gauss_samp_corrected's
float64 part (the embedding FFTs, the per-frequency 2x2 Cholesky, the
Klein sampler's QR) stays host numpy, as in fhe_tpu: moving it to
torch.fft would change the rint of the floats and so the samples.  That
part reads a host copy of (e, r), made once per trapdoor.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ..math import ntt as nttmod
from ..math import samplers


@dataclasses.dataclass
class TrapdoorParams:
    N: int
    q: int
    base: int = 2
    sigma: float = 3.19

    @property
    def k(self) -> int:
        return int(math.ceil(math.log(self.q, self.base)))


@dataclasses.dataclass
class RlweTrapdoorPair:
    """The secret (R, E) polys, int64 [k, N] on the device."""
    r: torch.Tensor
    e: torch.Tensor


@dataclasses.dataclass
class TrapdoorOutput:
    a_row: torch.Tensor       # public row A: int64 [k+2, N] coefficients mod q
    pair: RlweTrapdoorPair
    params: TrapdoorParams

    @property
    def device(self) -> torch.device:
        return self.a_row.device

    @functools.cached_property
    def er_host(self) -> np.ndarray:
        """[E; R] on the host, int64 [2, k, N] (copied once): the input of
        gauss_samp_corrected's float64 covariance part."""
        return np.stack([self.pair.e.cpu().numpy(), self.pair.r.cpu().numpy()])


def _tensor(x, device) -> torch.Tensor:
    """Integers (numpy, a list or a tensor) as an int64 tensor on device."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    return torch.from_numpy(np.asarray(x, dtype=np.int64)).to(device)


def _eval(params: TrapdoorParams, x: torch.Tensor) -> torch.Tensor:
    """Rows [R, N] of integers -> EVALUATION mod q, int64: one forward launch."""
    plan = nttmod.make_plan(params.N, params.q, x.device)
    return nttmod.ntt_forward(plan, (x % params.q).to(torch.int32)).to(torch.int64)


def _coeff(params: TrapdoorParams, x: torch.Tensor) -> torch.Tensor:
    """Rows [R, N] EVALUATION mod q -> COEFFICIENT, int64: one inverse launch."""
    plan = nttmod.make_plan(params.N, params.q, x.device)
    return nttmod.ntt_inverse(plan, x.to(torch.int32)).to(torch.int64)


def _ring_mul(params: TrapdoorParams, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Negacyclic products a_i b_i mod q of rows [R, N] (a may be one row,
    broadcast): one forward launch for a and b stacked, one inverse."""
    a, b = torch.atleast_2d(a), torch.atleast_2d(b)
    e = _eval(params, torch.cat([a, b]))
    return _coeff(params, e[:a.shape[0]] * e[a.shape[0]:] % params.q)


def _ring_dots(params: TrapdoorParams, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_i a[..., i, :] b_i mod q: a [S, R, N] (S sums over the same b)
    or [R, N], b [R, N]; [S, N] or [N].  One forward launch for every row
    of a and b, the sums in the evaluation domain, one inverse launch."""
    rows = a.reshape(-1, params.N)
    e = _eval(params, torch.cat([rows, b]))
    ea = e[:rows.shape[0]].reshape(a.shape)
    sums = (ea * e[rows.shape[0]:] % params.q).sum(-2) % params.q
    return _coeff(params, sums.reshape(-1, params.N)).reshape(sums.shape)


def trapdoor_gen(params: TrapdoorParams, rng: np.random.Generator,
                 device="cuda") -> TrapdoorOutput:
    """TrapdoorGen: A = [1, a, g - (a*r + e)], on `device`."""
    N, q, k = params.N, params.q, params.k
    a = samplers.discrete_uniform(rng, q, N)
    r = samplers.discrete_gaussian_rounded(rng, params.sigma, (k, N))
    e = samplers.discrete_gaussian_rounded(rng, params.sigma, (k, N))
    a_t, r_t, e_t = (_tensor(x, device) for x in (a, r, e))
    g = torch.zeros(k, N, dtype=torch.int64, device=r_t.device)
    g[:, 0] = torch.tensor([pow(params.base, i, q) for i in range(k)], dtype=torch.int64,
                           device=g.device)
    one = torch.zeros(N, dtype=torch.int64, device=r_t.device)
    one[0] = 1                          # the constant poly 1
    rows = (g - _ring_mul(params, a_t, r_t) - e_t) % q
    return TrapdoorOutput(a_row=torch.cat([one[None], a_t[None], rows]) % q,
                          pair=RlweTrapdoorPair(r=r_t, e=e_t), params=params)


def _g_preimage(params: TrapdoorParams, v: torch.Tensor) -> torch.Tensor:
    """Balanced base-b digits z [k, N] with sum_i b^i z_i = v (mod q):
    exact because |v| < q <= b^k (the deterministic G-lattice preimage)."""
    q, b, k = params.q, params.base, params.k
    vv = v.to(torch.int64) % q
    # centered representative for smaller digits
    vv = torch.where(vv > q // 2, vv - q, vv)
    sign = torch.sign(vv)
    mag = vv.abs()
    digits = []
    for _ in range(k):
        digits.append(mag % b)
        mag = mag // b
    # signed digits of the centered representative: |digit| < b and
    # sum_i b^i digits_i = v exactly as integers (|v| <= q/2 < b^k)
    return torch.stack(digits) * sign


def _assemble(td: TrapdoorOutput, p: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """x = p + [e.z, r.z, z] mod q."""
    params = td.params
    q = params.q
    er = _ring_dots(params, torch.stack([td.pair.e, td.pair.r]), z % q)
    x = p % q
    x[:2] = (x[:2] + er) % q
    x[2:] = (x[2:] + z) % q
    return x


def gauss_samp(td: TrapdoorOutput, u, rng: np.random.Generator,
               sigma_p: float | None = None) -> torch.Tensor:
    """GaussSamp: x int64 [k+2, N] on the trapdoor's device with
    <A, x> = u mod q."""
    params = td.params
    N, q, k = params.N, params.q, params.k
    sigma_p = sigma_p or (params.sigma * (params.base + 1))
    p = _tensor(samplers.discrete_gaussian_rounded(rng, sigma_p, (k + 2, N)), td.device)
    ap = _ring_dots(params, td.a_row, p)
    v = (_tensor(u, td.device) - ap) % q
    return _assemble(td, p, _g_preimage(params, v))


# ---------------------------------------------------------------------------
# full MP12 statistical pipeline (reference dgsampling equivalents), host
# numpy where it is float64
# ---------------------------------------------------------------------------

def _gadget_kernel_basis(params: TrapdoorParams) -> np.ndarray:
    """S_q basis of Lambda^perp(g^t) mod q for arbitrary modulus
    (Genise-Micciancio; reference dgsampling): columns are k kernel
    vectors of z -> sum_i b^i z_i mod q."""
    q, b, k = params.q, params.base, params.k
    S = np.zeros((k, k), dtype=np.float64)
    for j in range(k - 1):
        S[j, j] = b
        S[j + 1, j] = -1.0
    digs = []
    qq = q
    for _ in range(k):
        digs.append(qq % b)
        qq //= b
    S[:, k - 1] = digs
    return S


def _klein_sample(S: np.ndarray, center: np.ndarray, sigma: float,
                  rng: np.random.Generator) -> np.ndarray:
    """Klein/GPV randomized nearest-plane over basis S (columns),
    vectorized over the trailing axis of `center` [k, N]: returns integer
    combinations c [k, N] with S @ c ~ D_{L(S), sigma, center}."""
    k = S.shape[0]
    Q, R = np.linalg.qr(S)                    # S = Q R, R upper triangular
    t = Q.T @ center                          # [k, N]
    c = np.zeros_like(center)
    for i in range(k - 1, -1, -1):
        ci = (t[i] - R[i, i + 1:] @ c[i + 1:]) / R[i, i]
        si = sigma / abs(R[i, i])
        c[i] = np.rint(ci + rng.normal(0.0, si, size=ci.shape))
    return c


def _g_preimage_sampled(params: TrapdoorParams, v: np.ndarray,
                        alpha: float, rng: np.random.Generator
                        ) -> np.ndarray:
    """Randomized G-lattice preimage on the host: deterministic digits
    plus a discrete-Gaussian kernel vector (SampleG semantics)."""
    z0 = _g_preimage(params, torch.from_numpy(np.asarray(v, dtype=np.int64))).numpy().astype(
        np.float64)                                  # [k, N]
    S = _gadget_kernel_basis(params)
    c = _klein_sample(S, -z0, alpha, rng)            # L(S) point near -z0
    return (z0 + S @ c).astype(np.int64)


def _embed(x: np.ndarray) -> np.ndarray:
    """Negacyclic (2N-th root) embedding of real coefficient rows."""
    N = x.shape[-1]
    tw = np.exp(1j * np.pi * np.arange(N) / N)
    return np.fft.fft(x * tw, axis=-1)


def _unembed(X: np.ndarray) -> np.ndarray:
    N = X.shape[-1]
    tw = np.exp(-1j * np.pi * np.arange(N) / N)
    return np.real(np.fft.ifft(X, axis=-1) * tw)


def gauss_samp_corrected(td: TrapdoorOutput, u, rng: np.random.Generator,
                         s: float | None = None,
                         alpha: float | None = None,
                         round_r: float = 3.0) -> torch.Tensor:
    """GaussSamp with the full MP12 covariance correction: the output
    preimage distribution is ~ spherical D_{Z, s} regardless of the
    trapdoor (R, E), because the perturbation covariance cancels the
    alpha^2 T T^t contribution of the G-sample.  x int64 [k+2, N] on the
    trapdoor's device."""
    params = td.params
    N, q, k = params.N, params.q, params.k
    b = params.base
    alpha = alpha or (params.sigma * (b + 1))      # G-sample width
    # s must dominate alpha * s1(T); ternary-Gaussian T has s1 ~
    # sigma*(sqrt(2N)+sqrt(kN)) -- use the reference's C*sigma bound
    s = s or (alpha * params.sigma * 1.2 *
              (math.sqrt(2 * N) + math.sqrt(k * N) + 4.7))
    v2 = s * s - alpha * alpha
    if v2 <= 0:
        raise ValueError(f"s = {s} must exceed alpha = {alpha}")

    # ---- perturbation p = (p01 [2,N], p2 [k,N]), host float64
    p2 = np.rint(rng.normal(0.0, math.sqrt(v2), size=(k, N)))
    # mean part A*z2 = -(alpha^2/v2) [E; R] p2   (ring products over R)
    re = td.er_host                                # [2, k, N]
    scale = -(alpha * alpha) / v2
    Ez = _embed(re.astype(np.float64))             # [2, k, N] complex
    P2 = _embed(p2)                                # [k, N]
    mean01 = scale * np.einsum("tkn,kn->tn", Ez, P2)
    # covariance part: per-frequency 2x2 Hermitian Cholesky
    beta = alpha * alpha * (1.0 + alpha * alpha / v2)
    Eh = np.einsum("kn->n", Ez[0] * np.conj(Ez[0])).real
    Rh = np.einsum("kn->n", Ez[1] * np.conj(Ez[1])).real
    C = np.einsum("kn,kn->n", Ez[0], np.conj(Ez[1]))
    # Per-frequency target Cov = N*(s^2 I - beta*M(w)); the N rides on
    # the FFT of the unit normals below (Var(FFT(g)_w) = N), so the
    # Cholesky factors the N-free part.
    s2 = s * s
    a11 = np.maximum(s2 - beta * Eh, 1e-9)
    a12 = -beta * C
    a22 = np.maximum(s2 - beta * Rh, 1e-9)
    l11 = np.sqrt(a11)
    l21 = np.conj(a12) / l11
    l22 = np.sqrt(np.maximum(a22 - (l21 * np.conj(l21)).real, 1e-9))
    # complex standard normals with Hermitian symmetry = FFT of real iid
    g = rng.normal(size=(2, N))
    G = _embed(g)                                  # unit-var real -> freq
    w1 = l11 * G[0] / math.sqrt(N)
    w2 = l21 * G[0] / math.sqrt(N) + l22 * G[1] / math.sqrt(N)
    p01 = _unembed(np.stack([mean01[0] + w1, mean01[1] + w2]))
    p01 = np.rint(p01 + rng.normal(0.0, round_r, size=(2, N)))
    p = _tensor(np.vstack([p01, p2]).astype(np.int64), td.device)

    # ---- syndrome on the device, randomized G-sample on the host
    ap = _ring_dots(params, td.a_row, p)
    v = ((_tensor(u, td.device) - ap) % q).cpu().numpy()
    z = _tensor(_g_preimage_sampled(params, v, alpha, rng), td.device)
    return _assemble(td, p, z)


def verify_preimage(td: TrapdoorOutput, x, u) -> bool:
    """Check <A, x> = u mod q (on the trapdoor's device)."""
    params = td.params
    acc = _ring_dots(params, td.a_row, _tensor(x, td.device))
    return bool(torch.equal(acc % params.q, _tensor(u, td.device) % params.q))
