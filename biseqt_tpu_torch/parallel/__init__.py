"""Mesh-parallel layer: sharded all-vs-all discovery, band-parallel DP.

The port of :mod:`biseqt_tpu.parallel`, over the ranks of a
``torch.distributed`` process group laid out as a (data, band) mesh
(a world of one where no group is initialised): data-parallel query
sharding and the reads' all-gather for all-vs-all overlap discovery
(:mod:`.allvsall`), resumable block-checkpointed sweeps of it
(:mod:`.sweep`), and band-axis model parallelism for giant single pairs:
the row engine (:mod:`.sharded_dp`) and the antidiagonal engine with
its checkpointed traceback (:mod:`.sharded_dp_ad`), their edge lanes
traded with the band-axis neighbours point to point.
"""

from .mesh import make_mesh, DATA_AXIS, BAND_AXIS  # noqa: F401
from .allvsall import all_vs_all_overlaps, overlap_matrix_sharded  # noqa: F401
from .sharded_dp import banded_dp_band_sharded  # noqa: F401
from .sharded_dp_ad import (  # noqa: F401
    banded_dp_band_sharded_ad, band_sharded_ad_traceback)
from .sweep import checkpointed_overlap_sweep  # noqa: F401
