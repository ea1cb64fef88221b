"""Mesh-parallel layer: sharded all-vs-all overlap discovery.

The port of :mod:`biseqt_tpu.parallel`: data-parallel query sharding
over the ranks of a ``torch.distributed`` process group laid out as a
(data, band) mesh, and the reads' all-gather for all-vs-all overlap
discovery.  The band-sharded DP engines of the JAX package are not
ported yet.
"""

from .mesh import make_mesh, DATA_AXIS, BAND_AXIS  # noqa: F401
from .allvsall import all_vs_all_overlaps, overlap_matrix_sharded  # noqa: F401
