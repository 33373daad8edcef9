"""Dense LAMC main path: plan, partition, SCC atom, k-means, merge, metrics."""

from .lamc import LAMCConfig, LAMCResult, lamc_cocluster
from .metrics import ari, cocluster_scores, nmi
from .partition import PartitionPlan, make_plan

__all__ = ["LAMCConfig", "LAMCResult", "lamc_cocluster", "PartitionPlan",
           "make_plan", "nmi", "ari", "cocluster_scores"]
