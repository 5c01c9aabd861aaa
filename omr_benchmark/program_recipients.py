"""Where the benchmark meets the program's detector of many recipients,
``tfhe_omr_tpu_torch.core.detector.RecipientsDetector``: built from the
benchmark's own keys (the reference layouts of ``reference.Omr
.detection_key``), one recipient's key at a time, and the recipients'
retriever contexts. Nothing here computes; ``loops/recipients.py`` calls
the program through these."""

from __future__ import annotations

from collections.abc import Iterable

import torch

from omr_benchmark.program import DECODE_ERRORS, ClueBatch, params_of
from tfhe_omr_tpu_torch.core.context import OmrContext
from tfhe_omr_tpu_torch.core.detector import RecipientsDetector, weight_seed
from tfhe_omr_tpu_torch.core.keygen import DetectionKey
from tfhe_omr_tpu_torch.core.params import RetrievalParams
from tfhe_omr_tpu_torch.core.retriever import Retriever

__all__ = ["ClueBatch", "DECODE_ERRORS", "Server", "weight_seed"]


class Server:
    """The detector of ``recipients`` recipients on ``device``, from their
    key tensors in order (an iterable that may make each as it is asked
    for), and each recipient's retriever context."""

    def __init__(self, cfg: dict, keys: Iterable[dict], recipients: int, device):
        self.params = params_of(cfg)
        self.ctx = OmrContext(self.params, device)
        self.detector = RecipientsDetector(
            (DetectionKey(k["bsk1"], k["bsk1_sh"], k["ksk"], k["bsk2"], k["bsk2_sh"],
                          k["trace_k"], k["trace_k_sh"]) for k in keys),
            self.ctx, recipients)

    def layout(self, total: int, pertinent: int) -> RetrievalParams:
        return RetrievalParams.for_params(self.params, total, pertinent)

    def retriever(self, rp: RetrievalParams, z2_ntt: torch.Tensor) -> Retriever:
        return Retriever(rp, self.ctx, z2_ntt)
