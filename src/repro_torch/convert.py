"""Parameters of the JAX package, as the port takes them.

``params_from_jax`` maps a parameter tree of ``repro.models.vision`` (or of
``DSCSExecutor.params``), whose leaves the caller has turned into numpy
arrays, onto the port's tree: the same dicts, lists and tuples, float leaves
as tensors on the device, integer scalars (strides, ViT's meta) as ints.
Convolution weights stay HWIO; ``models.vision.conv2d`` turns them into
OIHW where it calls ``F.conv2d``.  Both packages then compute the same
function, which the differential tests rely on.  A bfloat16 leaf (numpy's
``ml_dtypes.bfloat16``, which ``torch.tensor`` refuses) becomes a
``torch.bfloat16`` tensor with the same bits.  The LM trees of
``repro.models.transformer`` (stacked blocks, a ``rem`` list, Whisper's
``encoder`` subtree with its own stack, ``pos_embed``, MLA's latent
projections and norms, ``patch_proj``) map the same way, and so does a NamedTuple such as the JAX ``AdamWState``, rebuilt from
positional arguments.
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
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(conv(v) for v in node))     # a NamedTuple
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        if isinstance(node, (int, np.integer)) or (
                isinstance(node, np.ndarray) and node.ndim == 0
                and np.issubdtype(node.dtype, np.integer)):
            return int(node)
        arr = np.asarray(node)
        if arr.dtype.name == "bfloat16":
            bits = np.array(arr).view(np.int16)     # a writable copy
            return torch.from_numpy(bits).view(torch.bfloat16).to(dev)
        return torch.tensor(arr, device=dev)

    return conv(tree)
