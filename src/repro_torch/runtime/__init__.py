"""Runtime support: the recovery loop of the out-of-core fit.

The reference's ``runtime.shardings`` (device meshes) is not ported yet.
"""

from . import fault_tolerance

__all__ = ["fault_tolerance"]
