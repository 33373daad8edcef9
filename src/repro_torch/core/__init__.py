"""LAMC core, the reference's public API on PyTorch.

    LAMCConfig, lamc_cocluster      full pipeline (Algorithm 1)
    make_plan, PartitionPlan        probabilistic partition planning (§IV-B)
    scc, nmtf                       atom co-clusterers (§IV-C)
    signature_merge, jaccard_merge_host   hierarchical merging (§IV-D)
    nmi, ari, omega_index, overlap_f1     evaluation metrics (§V)

The unpartitioned baselines are ``core.baselines.scc_full`` / ``nmtf_full``.
As in the reference, ``nmtf`` here is the function (it shadows the submodule).
"""

from .lamc import LAMCConfig, LAMCResult, lamc_cocluster
from .merging import (
    cluster_signatures,
    finalize_assignment,
    jaccard_merge_host,
    memberships_from_votes,
    signature_merge,
)
from .metrics import ari, cocluster_scores, membership_from_labels, nmi, omega_index, overlap_f1
from .nmtf import nmtf
from .partition import (
    PartitionPlan,
    coverage_probability,
    extract_blocks,
    extract_blocks_sparse,
    make_plan,
    resample_indices,
)
from .probability import detection_probability, failure_bound, min_resamples, plan_partition
from .spectral import normalize_bipartite, randomized_svd, scc

__all__ = [
    "LAMCConfig", "LAMCResult", "lamc_cocluster",
    "PartitionPlan", "make_plan", "extract_blocks", "extract_blocks_sparse",
    "resample_indices", "coverage_probability",
    "detection_probability", "failure_bound", "min_resamples", "plan_partition",
    "scc", "nmtf", "normalize_bipartite", "randomized_svd",
    "signature_merge", "jaccard_merge_host", "cluster_signatures",
    "memberships_from_votes", "finalize_assignment",
    "nmi", "ari", "cocluster_scores",
    "membership_from_labels", "omega_index", "overlap_f1",
]
