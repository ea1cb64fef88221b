"""Device-mesh helpers.

The port of :mod:`biseqt_tpu.parallel.mesh`.  Axis conventions:

  * ``data`` — queries / alignment pairs (the embarrassingly parallel
    axis: each rank owns a block of rows);
  * ``band`` — lanes of a single DP band (for giant pairs: each rank
    owns a block of lanes and trades its edge lanes with its band-axis
    neighbours, :mod:`.sharded_dp`, :mod:`.sharded_dp_ad`).

The ranks are those of the default ``torch.distributed`` process group,
one card each.  Where a group is initialised, :func:`make_mesh` lays
them out as a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names=("data", "band")``; where none is, the mesh is a world
of one on ``device`` and no collective is ever called.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.banded_dp import resolve_device

DATA_AXIS = "data"
BAND_AXIS = "band"

__all__ = ["Mesh", "make_mesh", "DATA_AXIS", "BAND_AXIS"]


class Mesh:
    """A (data, band) layout of ranks.

    ``shape`` maps each axis name to its size (``mesh.shape["data"]``, as
    a JAX mesh reads); ``device`` is this rank's device; ``device_mesh``
    is the ``DeviceMesh`` over an initialised process group, or None for
    a world of one.
    """

    def __init__(self, n_data: int, n_band: int, device: torch.device,
                 device_mesh=None):
        self.shape = {DATA_AXIS: int(n_data), BAND_AXIS: int(n_band)}
        self.device = device
        self.device_mesh = device_mesh

    @property
    def data_rank(self) -> int:
        """This rank's coordinate on the data axis."""
        if self.device_mesh is None:
            return 0
        return self.device_mesh.get_local_rank(DATA_AXIS)

    @property
    def data_group(self):
        """The process group of this rank's data axis (None for a world
        of one)."""
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(DATA_AXIS)

    @property
    def band_rank(self) -> int:
        """This rank's coordinate on the band axis."""
        if self.device_mesh is None:
            return 0
        return self.device_mesh.get_local_rank(BAND_AXIS)

    @property
    def band_group(self):
        """The process group of this rank's band axis (None for a world
        of one)."""
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(BAND_AXIS)

    def band_peer(self, r: int) -> int:
        """The global rank of band coordinate ``r`` of this rank's band
        group: the peer of a point-to-point send."""
        if self.device_mesh is None:
            if r != 0:
                raise ValueError("a world of one has no band coordinate %d"
                                 % r)
            return 0
        return dist.get_global_rank(self.band_group, r)

    def __repr__(self):
        return "Mesh(data=%d, band=%d, device=%s)" % (
            self.shape[DATA_AXIS], self.shape[BAND_AXIS], self.device)


def make_mesh(n_data: int = None, n_band: int = 1, devices=None, *,
              device="cuda") -> Mesh:
    """A (data, band) mesh over the ranks of the default process group.

    ``devices`` lists the ranks to lay out (all of them by default; a
    world of one where no group is initialised).  By default every rank
    goes on the data axis; ``n_band > 1`` trades data parallelism for
    band parallelism.  A mesh that does not fit raises ``ValueError``.
    Every rank of the group calls this together (the axes' groups are
    made collectively).
    """
    device = resolve_device(device)
    grouped = dist.is_available() and dist.is_initialized()
    if devices is None:
        devices = list(range(dist.get_world_size())) if grouped else [0]
    devices = list(devices)
    if n_data is None:
        n_data = len(devices) // n_band
    if n_data < 1 or n_band < 1 or n_data * n_band > len(devices):
        raise ValueError("mesh %dx%d does not fit %d devices"
                         % (n_data, n_band, len(devices)))
    if not grouped:
        if n_data * n_band > 1:
            raise ValueError("mesh %dx%d does not fit a world of one (no "
                             "process group is initialised)"
                             % (n_data, n_band))
        return Mesh(n_data, n_band, device)
    from torch.distributed.device_mesh import DeviceMesh

    ranks = torch.tensor(devices[:n_data * n_band]).reshape(n_data, n_band)
    return Mesh(n_data, n_band, device,
                DeviceMesh(device.type, ranks,
                           mesh_dim_names=(DATA_AXIS, BAND_AXIS)))
