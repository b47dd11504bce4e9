"""Field2n: arithmetic in the power-of-2 cyclotomic field over doubles,
on the host.

Port of fhe_tpu/lattice/field2n.py (reference semantics: the C++
reference's Field2n over R[X]/(X^N+1) in COEFFICIENT or EVALUATION
format, used by trapdoor perturbation sampling).  Evaluation format =
values at the odd 2N-th roots (math.dft.forward_special).  numpy float64
as in fhe_tpu, so every value is fhe_tpu's bit for bit."""

from __future__ import annotations

import dataclasses

import numpy as np

from ..math import dft

COEFF = "COEFF"
EVAL = "EVAL"


@dataclasses.dataclass
class Field2n:
    data: np.ndarray          # complex128 [N] (real in COEFF format)
    fmt: str = COEFF

    @classmethod
    def from_coeffs(cls, c) -> "Field2n":
        return cls(np.asarray(c, dtype=np.complex128), COEFF)

    @property
    def N(self) -> int:
        return len(self.data)

    def to_eval(self) -> "Field2n":
        if self.fmt == EVAL:
            return self
        return Field2n(dft.forward_special(self.data), EVAL)

    def to_coeff(self) -> "Field2n":
        if self.fmt == COEFF:
            return self
        return Field2n(dft.inverse_special(self.data), COEFF)

    def _bin(self, other, op) -> "Field2n":
        if self.fmt != other.fmt:
            raise ValueError(f"Field2n {self.fmt} with {other.fmt}")
        return Field2n(op(self.data, other.data), self.fmt)

    def __add__(self, other):
        return self._bin(other, np.add)

    def __sub__(self, other):
        return self._bin(other, np.subtract)

    def __mul__(self, other):
        """Negacyclic product (pointwise in EVAL)."""
        a, b = self.to_eval(), other.to_eval()
        return Field2n(a.data * b.data, EVAL)

    def inverse(self) -> "Field2n":
        ev = self.to_eval()
        return Field2n(1.0 / ev.data, EVAL)

    def transpose(self) -> "Field2n":
        """a(X) -> a(X^{-1}) = a(X^{2N-1}): conjugation in EVAL format
        (field2n.h Transpose)."""
        ev = self.to_eval()
        return Field2n(np.conj(ev.data), EVAL)

    def automorphism(self, k: int) -> "Field2n":
        """a(X) -> a(X^k), odd k."""
        if k % 2 != 1:
            raise ValueError(f"automorphism index {k} is even")
        c = self.to_coeff().data
        N = self.N
        out = np.zeros(N, dtype=np.complex128)
        for i in range(N):
            e = (i * k) % (2 * N)
            if e < N:
                out[e] += c[i]
            else:
                out[e - N] -= c[i]
        return Field2n(out, COEFF)

    def scalar_mul(self, s: float) -> "Field2n":
        return Field2n(self.data * s, self.fmt)

    def norm(self) -> float:
        return float(np.linalg.norm(self.to_coeff().data.real))

    def real_coeffs(self) -> np.ndarray:
        return self.to_coeff().data.real.copy()
