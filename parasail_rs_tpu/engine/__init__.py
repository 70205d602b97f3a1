"""User-facing engine: builder, aligner, profiles, and result objects.

Re-design of the reference's L2/L3 layers
(reference: src/aligner/mod.rs, src/alignment/mod.rs, src/profile/mod.rs):
configuration resolves to a typed kernel key instead of a C function-name
string, execution is a batched jitted device dispatch instead of an FFI
call, and results are host numpy views instead of raw-pointer facades.
"""

from .aligner import Aligner, AlignerBuilder
from .stream import StreamingAligner
from .profile import Profile, ProfileBuilder
from .result import Alignment, SSWResult, Table, Traceback, TracebackTable

__all__ = [
    "Aligner",
    "AlignerBuilder",
    "StreamingAligner",
    "Alignment",
    "Profile",
    "ProfileBuilder",
    "SSWResult",
    "Table",
    "Traceback",
    "TracebackTable",
]
