"""Lattice layer: the RNS ring's NTT (`rns`)."""

from . import rns

__all__ = ["rns"]
