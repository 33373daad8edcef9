from .synthetic import (
    PlantedCoClusters,
    PlantedOverlapCoClusters,
    amazon1000_proxy,
    classic4_proxy,
    planted_cocluster_matrix,
    planted_overlapping_cocluster_matrix,
    rcv1_proxy,
    to_bcoo,
)

__all__ = [
    "PlantedCoClusters",
    "PlantedOverlapCoClusters",
    "planted_cocluster_matrix",
    "planted_overlapping_cocluster_matrix",
    "to_bcoo",
    "amazon1000_proxy",
    "classic4_proxy",
    "rcv1_proxy",
]
