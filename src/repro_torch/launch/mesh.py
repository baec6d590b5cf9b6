"""Building device meshes: the production pod and the elastic mesh.

``make_production_mesh`` describes the pod that the shardings and the dry
run are written for (16x16 chips, or 2x16x16 over two pods) without
binding any device: like JAX's abstract mesh, it names a deployment that
this process does not drive.  ``make_mesh_for`` binds real devices, as many
as the mesh holds and only while they are present.  The ``Mesh`` type and
``spec_axes`` live in ``repro_torch.mesh``, below the layers that place
tensors; they are re-exported here.

Execution on a mesh of more than one device needs a process per card
(``torch.distributed``); that is a separate multi-card port.
"""
from __future__ import annotations

import torch

from ..errors import ConfigError
from ..kernels import ops
from ..mesh import Mesh, spec_axes

__all__ = ["Mesh", "spec_axes", "make_production_mesh", "mesh_shape_for",
           "make_mesh_for"]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: 16x16 = 256 chips, axes (data, model).  Multi-pod:
    2x16x16 = 512 chips, axes (pod, data, model); the 'pod' axis is pure
    DP across the pods.  Abstract: it binds no device."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def mesh_shape_for(n_devices: int, model_axis: int = 16) -> tuple[int, int]:
    """(data, model) of the best mesh for ``n_devices``: the model axis as
    wide as ``model_axis`` allows while it divides the device count."""
    if n_devices < 1:
        raise ConfigError(f"a mesh needs a device, got {n_devices}")
    model = min(model_axis, n_devices)
    while n_devices % model:
        model //= 2
    return n_devices // model, model


def make_mesh_for(n_devices: int, model_axis: int = 16, device=None) -> Mesh:
    """Elastic helper: the best (data, model) mesh for whatever devices
    survive, bound to the first ``n_devices`` devices of ``device``'s type
    (default: the engine's device, ``kernels.ops.ready_device()``).  The
    CPU counts as one device; asking for more devices than are present
    raises ConfigError."""
    device = ops.ready_device() if device is None else torch.device(device)
    present = torch.cuda.device_count() if device.type == "cuda" else 1
    if n_devices > present:
        raise ConfigError(f"a mesh of {n_devices} devices, but {present} "
                          f"{device.type} device(s) are present")
    shape = mesh_shape_for(n_devices, model_axis)
    if device.type != "cuda":
        devices = [device]
    elif n_devices == 1:
        devices = [torch.device("cuda", device.index or 0)]
    else:
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    return Mesh(shape, ("data", "model"), devices)
