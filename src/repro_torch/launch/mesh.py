"""Local meshes (reference: ``repro.launch.mesh``). A function, not a
module constant: importing this module touches no device.

The reference's ``make_production_mesh`` (256 or 512 TPU chips) has no
counterpart yet: multi-host meshes wait for the port's ``launch/`` and
multi-host items.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import Mesh


def make_local_mesh(data: int = 1, model: int = 1, device="cuda") -> Mesh:
    """A (data, model) mesh over the first ``data * model`` local devices
    of ``device``'s type (the CPU counts as one device)."""
    dev = resolve_device(device)
    n = data * model
    if dev.type == "cuda":
        have = torch.cuda.device_count()
        devices = [torch.device("cuda", i) for i in range(min(n, have))]
    else:
        have, devices = 1, [dev]
    if n > have:
        raise ValueError(f"a {data} x {model} mesh needs {n} {dev.type} "
                         f"devices; {have} present")
    return Mesh(np.array(devices, dtype=object).reshape(data, model),
                ("data", "model"))
