"""parasail_rs_tpu: a batched pairwise sequence-alignment engine in JAX.

A from-scratch re-design of the capability surface of ``parasail-rs``
(safe wrapper over parasail's SIMD C library) for accelerators:

- the affine-gap DP fill (global / semi-global / local, stats, tables,
  rowcol, trace) runs batched on the device: a Pallas GPU kernel with
  one pair per thread for short pairs, and an XLA anti-diagonal
  wavefront for every output class and shape;
- query profiles are device-resident tensors; substitution matrices are a
  NumPy registry;
- scale-out is data-parallel sharding over a ``jax.sharding.Mesh`` plus a
  sequence-parallel wavefront for very long pairs;
- the serial traceback -> CIGAR walk is a batched native C++ component.

The public surface mirrors the reference prelude
(reference: src/prelude.rs:1-25).
"""

from .constants import InstructionSet, SolutionWidth, TraceFlags
from .errors import ParasailError
from .matrices import Matrix
from . import errors

__version__ = "0.5.0"

__all__ = [
    "Matrix",
    "TraceFlags",
    "SolutionWidth",
    "InstructionSet",
    "ParasailError",
    "errors",
    "__version__",
]


def __getattr__(name):
    # Lazy imports keep `import parasail_rs_tpu` light (no jax import) for
    # matrix-only / golden-only use.
    if name in ("Aligner", "AlignerBuilder"):
        from .engine.aligner import Aligner, AlignerBuilder

        return {"Aligner": Aligner, "AlignerBuilder": AlignerBuilder}[name]
    if name in ("Alignment", "Table", "TracebackTable", "Traceback", "SSWResult"):
        from .engine import result as _r

        return getattr(_r, name)
    if name == "Profile":
        from .engine.profile import Profile

        return Profile
    if name == "ProfileBuilder":
        from .engine.profile import ProfileBuilder

        return ProfileBuilder
    raise AttributeError(name)
