"""Sharding of detection and digest reduction over devices and processes."""

from tfhe_omr_tpu_torch.parallel import distributed
from tfhe_omr_tpu_torch.parallel.mesh import (
    DataMesh,
    RankRows,
    ShardedDetector,
    make_data_mesh,
)

__all__ = ["DataMesh", "RankRows", "ShardedDetector", "distributed",
           "make_data_mesh"]
