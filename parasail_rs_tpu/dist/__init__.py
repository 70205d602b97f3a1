"""Multi-device / multi-host scale-out.

The reference is single-process (SURVEY.md §2.3) — its only parallelism
is SIMD lanes plus user threads over Send+Sync handles.  This package
shards pair batches data-parallel over a ``jax.sharding.Mesh``
(profiles/matrices replicated, results returned per shard; XLA inserts
the collectives), and splits one long pair across devices
sequence-parallel (``seqpar_align``).
"""

from .sharded import make_device_mesh, sharded_align
from .seqpar import seqpar_align, seqpar_cigars

__all__ = ["make_device_mesh", "seqpar_align", "seqpar_cigars",
           "sharded_align"]
