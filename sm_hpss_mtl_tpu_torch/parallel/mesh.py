"""Device meshes (counterpart of the JAX package's ``parallel/mesh.py``).

A :class:`Mesh` is an array of ``torch.device`` with named axes, by
default ``('data', 'time', 'model')``: ``data`` for the trial axis of the
multi-trial tuner (``train/multitrial.py``), ``time`` for the
time-sharded front end (``parallel/frontend_shard.py``) and HPSS
(``parallel/halo.py``), ``model`` a size-1 placeholder as in the JAX
package.  A device may repeat: ``[cuda:0] * 4`` is four shards on one
card, as XLA's virtual host devices give the JAX tests a mesh on one CPU.
Data parallelism across processes does not use a mesh: it is one process
per GPU over ``torch.distributed`` (``parallel/dp.py``).

A :class:`NamedSharding` names which tensor dimension maps to which mesh
axis; :meth:`NamedSharding.shards` cuts a tensor into one piece per mesh
device and puts each piece on its device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

AXES = ("data", "time", "model")


class Mesh:
    """``devices``, an array of ``torch.device`` (or a sequence, for one
    axis), with one name per axis.  ``shape`` maps each name to its size,
    as JAX's ``mesh.shape[axis]``."""

    def __init__(self, devices, axis_names=AXES):
        given = np.asarray(devices, dtype=object)
        arr = np.empty(given.shape, dtype=object)
        for idx in np.ndindex(given.shape):
            arr[idx] = torch.device(given[idx])
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-d devices for axes {axis_names}")
        types = {d.type for d in arr.flat}
        if len(types) != 1:
            raise ValueError(f"a mesh holds devices of one type, got "
                             f"{sorted(types)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device_type(self) -> str:
        return self.devices.flat[0].type

    def along(self, axis: str) -> list:
        """The devices along ``axis``, at index 0 of every other axis."""
        k = self.axis_names.index(axis)
        idx = [0] * self.devices.ndim
        idx[k] = slice(None)
        return list(self.devices[tuple(idx)])

    def check(self, x: torch.Tensor) -> None:
        """Raise unless ``x`` lies on this mesh's device type: a mesh of
        CUDA devices refuses CPU tensors, and the reverse."""
        if x.device.type != self.device_type:
            raise ValueError(f"a mesh of {self.device_type} devices takes "
                             f"{self.device_type} tensors, got one on "
                             f"{x.device}")

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.device_type})"


def make_mesh(n_data: int | None = None, n_time: int = 1, n_model: int = 1,
              devices=None) -> Mesh:
    """Mesh over ('data', 'time', 'model'), all devices on 'data' by
    default.  ``devices`` defaults to every visible CUDA device; without a
    GPU and without ``devices=`` it raises (a CPU mesh is built only when
    asked for, e.g. ``devices=[torch.device('cpu')] * 8``).  Devices may
    repeat."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not n:
            raise RuntimeError(
                "make_mesh: no GPU is visible; pass devices= for a mesh of "
                "other devices (e.g. [torch.device('cpu')] * 8)")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = list(devices)
    if n_data is None:
        n_data = len(devices) // (n_time * n_model)
    size = n_data * n_time * n_model
    if not 1 <= size <= len(devices):
        raise ValueError(f"a ({n_data}, {n_time}, {n_model}) mesh needs "
                         f"{size} devices, {len(devices)} given")
    arr = np.empty(size, dtype=object)
    arr[:] = devices[:size]
    return Mesh(arr.reshape(n_data, n_time, n_model), AXES)


@dataclass(frozen=True)
class NamedSharding:
    """Tensor dimension ``i`` is split over mesh axis ``spec[i]`` (None, or
    a dimension past ``spec``, is replicated), as JAX's
    ``NamedSharding(mesh, PartitionSpec(*spec))``."""
    mesh: Mesh
    spec: tuple = ()

    def shards(self, x: torch.Tensor) -> list:
        """One piece of ``x`` per mesh device, in the mesh's device order
        (row-major), each on its device; a split dimension must divide
        evenly by its axis size."""
        self.mesh.check(x)
        out = []
        for pos in np.ndindex(self.mesh.devices.shape):
            piece = x
            for dim, axis in enumerate(self.spec):
                if axis is None:
                    continue
                k = self.mesh.axis_names.index(axis)
                n = self.mesh.devices.shape[k]
                if x.shape[dim] % n:
                    raise ValueError(f"dimension {dim} of size "
                                     f"{x.shape[dim]} does not shard over "
                                     f"{axis}={n}")
                step = x.shape[dim] // n
                piece = piece.narrow(dim, pos[k] * step, step)
            out.append(piece.to(self.mesh.devices[pos], non_blocking=True))
        return out


def model_sharding(mesh: Mesh, axis: int, ndim: int) -> NamedSharding:
    """Dimension ``axis`` of an ``ndim``-rank parameter over 'model' (a
    size-1 placeholder: every model here fits one device)."""
    spec = [None] * ndim
    spec[axis] = "model"
    return NamedSharding(mesh, tuple(spec))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """The leading (batch) axis over 'data'."""
    return NamedSharding(mesh, ("data",))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def time_sharding(mesh: Mesh, ndim: int = 3) -> NamedSharding:
    """The trailing (time) axis of a ``(..., F, T)`` tensor over 'time'."""
    return NamedSharding(mesh, (None,) * (ndim - 1) + ("time",))
