"""Device meshes: named axes over devices (``jax.sharding.Mesh``).

A ``Mesh`` has ``axis_names``, ``shape`` (an ordered dict of axis name to
size), ``size`` and ``devices`` (None for an abstract mesh that binds no
device).  ``spec_axes`` lists the axes a sharding spec names.  These are
placement primitives for the layers that place tensors (the shardings,
the checkpoint store, the data pipeline); ``launch/mesh.py`` builds the
meshes a run uses.

On one card a mesh whose named axes all have size 1 places every tensor
whole on that card, and a spec that shards over an axis of size > 1
raises ``ConfigError`` (``Mesh.device_for``): execution across cards needs
a process per card (``torch.distributed``), a separate multi-card port.
"""
from __future__ import annotations

import math
from collections import OrderedDict

import torch

from .errors import ConfigError


class Mesh:
    """Named axes of ``sizes`` over ``devices`` (None: an abstract mesh
    that binds no device)."""

    def __init__(self, sizes, axis_names, devices=None):
        sizes, axis_names = tuple(sizes), tuple(axis_names)
        if len(sizes) != len(axis_names) or len(set(axis_names)) != \
                len(axis_names):
            raise ConfigError(f"mesh axes {axis_names} do not match sizes "
                              f"{sizes}")
        self.axis_names = axis_names
        self.shape = OrderedDict(zip(axis_names, sizes))
        self.size = math.prod(sizes)
        if devices is not None:
            devices = tuple(torch.device(d) for d in devices)
            if len(devices) != self.size:
                raise ConfigError(f"a mesh of {self.size} positions needs as "
                                  f"many devices, got {len(devices)}")
        self.devices = devices

    def __repr__(self) -> str:
        axes = ", ".join(f"{a!r}: {n}" for a, n in self.shape.items())
        where = "abstract" if self.devices is None else \
            ", ".join(str(d) for d in self.devices)
        return f"Mesh({axes}; {where})"

    def device_for(self, spec) -> torch.device:
        """The device that holds a tensor of ``spec`` whole.  Every axis
        the spec names must have size 1 and the mesh must bind one device;
        else ConfigError: sharding over an axis of size > 1 needs the
        multi-card port."""
        wide = [a for a in spec_axes(spec) if self.shape.get(a, 1) > 1]
        unknown = [a for a in spec_axes(spec) if a not in self.shape]
        if unknown:
            raise ConfigError(f"spec {spec!r} names axes {unknown} that "
                              f"{self} does not have")
        if wide:
            raise ConfigError(f"spec {spec!r} shards over mesh axes {wide} "
                              f"of size > 1: execution across cards is the "
                              f"multi-card port")
        if self.devices is None or len(self.devices) != 1:
            raise ConfigError(f"{self} does not bind exactly one device: "
                              f"execution across cards is the multi-card "
                              f"port")
        return self.devices[0]


def spec_axes(spec) -> list[str]:
    """Every mesh axis name in ``spec`` or a tree of specs (dicts, lists
    and tuples; an entry is None, an axis name or a tuple of names)."""
    if spec is None:
        return []
    if isinstance(spec, str):
        return [spec]
    if isinstance(spec, dict):
        spec = list(spec.values())
    if not isinstance(spec, (list, tuple)):
        raise ConfigError(f"sharding spec entry {spec!r} is neither a mesh "
                          f"axis name nor None")
    return [a for v in spec for a in spec_axes(v)]
