"""Lattice layer: the RNS ring (`rns`) and the HE-standard security
tables (`stdparams`)."""

from . import rns, stdparams

__all__ = ["rns", "stdparams"]
