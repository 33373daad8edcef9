"""Runtime support: the recovery loop of the out-of-core fit, its elastic
restore onto a device mesh, and the sharding policy of the LAMC state."""

from . import fault_tolerance, shardings

__all__ = ["fault_tolerance", "shardings"]
