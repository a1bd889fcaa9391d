"""emme_tpu: gyrokinetic eigensolver framework on JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of EMME
(reference: ssskkkky/EMME), built for accelerators: batched kernel-integral
assembly, complex linear algebra, delta-f PIC, and mesh-sharded execution.
"""
__version__ = "0.1.0"

from . import params, geometry  # noqa: F401
from .params import Params, from_config  # noqa: F401
