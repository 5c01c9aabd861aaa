"""tfhe_omr_tpu_torch — the PyTorch / CUDA port of :mod:`tfhe_omr_tpu`.

The same InstantOMR pipeline (clues, detection, digests, the recipient's
decode) on an NVIDIA GPU. The JAX package is the reference: every piece of
this one is bit-equal to its counterpart there, because all of the
system's math is exact integer arithmetic mod q (device clues, whose random
bits differ, are held by decryption instead).
The layout mirrors the JAX package so each counterpart is easy to find:

* :mod:`tfhe_omr_tpu_torch.ops`   — modular arithmetic, gadget digits, the
  NTT, blind rotation, key switch, trace; plain torch versions and the
  wrappers of the hand-written CUDA kernels in ``csrc/``.
* :mod:`tfhe_omr_tpu_torch.core`  — parameters, LUTs, key generation, the
  Sender, the Detector (with the digest encoders) and the Retriever.
* :mod:`tfhe_omr_tpu_torch.parallel` — detection and digests sharded over
  several cards and over ``torch.distributed`` ranks.
* :mod:`tfhe_omr_tpu_torch.native` — the client's C++ decoder (g++, ctypes).
* :mod:`tfhe_omr_tpu_torch.utils` — stage timing and the kernel build.

This package imports torch and numpy, never jax. The kernels build with
nvcc at their first launch (:mod:`tfhe_omr_tpu_torch.utils.build`).
"""
