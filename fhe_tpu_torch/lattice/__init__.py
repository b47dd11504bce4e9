"""Lattice layer: the RNS ring (`rns`), the HE-standard security
tables (`stdparams`), RLWE trapdoors and preimage sampling (`trapdoor`)
and the power-of-2 cyclotomic field over doubles (`field2n`)."""

from . import field2n, rns, stdparams, trapdoor

__all__ = ["field2n", "rns", "stdparams", "trapdoor"]
