"""Parameters of the JAX package, as the port takes them.

``params_from_jax`` maps a parameter tree of ``repro.models.vision`` (or of
``DSCSExecutor.params``), whose leaves the caller has turned into numpy
arrays, onto the port's tree: the same dicts, lists and tuples, float leaves
as tensors on the device, integer scalars (strides, ViT's meta) as ints.
Convolution weights stay HWIO; ``models.vision.conv2d`` turns them into
OIHW where it calls ``F.conv2d``.  Both packages then compute the same
function, which the differential tests rely on.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve


def params_from_jax(tree: Any, device=None) -> Any:
    dev = resolve(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        if isinstance(node, (int, np.integer)) or (
                isinstance(node, np.ndarray) and node.ndim == 0
                and np.issubdtype(node.dtype, np.integer)):
            return int(node)
        return torch.tensor(np.asarray(node), device=dev)

    return conv(tree)
