"""Device kernels: the GPU DP fill (Pallas) and the XLA wavefront."""

from .specs import MODES, OUTPUTS, STRATEGIES, WIDTHS, KernelKey
from .wavefront import wavefront_align

__all__ = [
    "KernelKey",
    "MODES",
    "OUTPUTS",
    "STRATEGIES",
    "WIDTHS",
    "wavefront_align",
]
