"""The one place where the benchmark meets the program under test,
``tfhe_omr_tpu_torch``: its parameter objects built from a configuration
file, and the server and client objects built from the benchmark's own
keys. Nothing here computes; the loops call the program through these."""

from __future__ import annotations

import torch

from tfhe_omr_tpu_torch.core.context import OmrContext
from tfhe_omr_tpu_torch.core.detector import Detector
from tfhe_omr_tpu_torch.core.errors import OmrError
from tfhe_omr_tpu_torch.core.keygen import DetectionKey
from tfhe_omr_tpu_torch.core.params import (
    GadgetRlweParams,
    KeySwitchParams,
    LweParams,
    OmrParameters,
    RetrievalParams,
)
from tfhe_omr_tpu_torch.core.retriever import Retriever
from tfhe_omr_tpu_torch.core.sender import ClueBatch
from tfhe_omr_tpu_torch.parallel import ShardedDetector, make_data_mesh

#: what a board's decode may raise when a digest is wrong
DECODE_ERRORS = (OmrError,)

__all__ = ["ClueBatch", "DECODE_ERRORS", "Server", "params_of"]


def params_of(cfg: dict) -> OmrParameters:
    """The program's parameter set of a configuration file."""

    def lwe(c):
        return LweParams(c["dimension"], c["plain_modulus"], c["cipher_modulus"],
                         c["secret_type"], c["noise_std"])

    def gadget(c):
        return GadgetRlweParams(c["dimension"], c["modulus"], c["secret_type"],
                                c["noise_std"], c["log_basis"], c["basis_len"])

    ks = cfg["first_level_ks"]
    return OmrParameters(
        clue_params=lwe(cfg["clue"]), clue_count=cfg["clue_count"],
        first_level_br=gadget(cfg["first_level_br"]),
        first_level_ks=KeySwitchParams(ks["in_dimension"], ks["out_dimension"],
                                       ks["log_modulus"], ks["log_basis"], ks["noise_std"]),
        intermediate_lwe=lwe(cfg["intermediate_lwe"]),
        second_level_br=gadget(cfg["second_level_br"]), trace=gadget(cfg["trace"]),
        output_plain_modulus=cfg["output_plain_modulus"],
        payload_length=cfg["payload_length"],
        bucket_count_per_segment=cfg["bucket_count_per_segment"],
        segment_count=cfg["segment_count"], cmb_count_per_cipher=cfg["cmb_count_per_cipher"])


class Server:
    """The detector (one ``Detector``, or one ``ShardedDetector`` over
    ``devices``) and the recipient's retriever context, from the benchmark's
    key tensors (the reference layouts of ``reference.Omr.detection_key``)."""

    def __init__(self, cfg: dict, key: dict, z2_ntt: torch.Tensor, devices: list):
        self.params = params_of(cfg)
        self.ctx = OmrContext(self.params, devices[0])
        det_key = DetectionKey(key["bsk1"], key["bsk1_sh"], key["ksk"], key["bsk2"],
                               key["bsk2_sh"], key["trace_k"], key["trace_k_sh"])
        self.detector = Detector(det_key, self.ctx)
        self.sharded = len(devices) > 1
        self.runner = (ShardedDetector(self.detector, make_data_mesh(devices))
                       if self.sharded else self.detector)
        self.z2_ntt = z2_ntt

    def layout(self, total: int, pertinent: int) -> RetrievalParams:
        return RetrievalParams.for_params(self.params, total, pertinent)

    def retriever(self, rp: RetrievalParams) -> Retriever:
        return Retriever(rp, self.ctx, self.z2_ntt)
