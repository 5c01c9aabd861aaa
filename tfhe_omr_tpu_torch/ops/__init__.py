"""Lattice primitives: fields, gadgets, NTT, bootstrapping, kernel wrappers."""

from tfhe_omr_tpu_torch.ops.modmath import PrimeField
from tfhe_omr_tpu_torch.ops.ntt import Ntt

__all__ = ["PrimeField", "Ntt"]
