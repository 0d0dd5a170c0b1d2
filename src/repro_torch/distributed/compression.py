"""Int8 gradient compression with error feedback for the data-parallel
reduction (the classic 1-bit-Adam/TernGrad family, int8 variant).

At 1000+ node scale the cross-pod DP all-reduce is DCN-bound; quantizing
gradients to int8 (+ fp32 per-leaf scale) cuts wire bytes 4x vs fp32 /
2x vs bf16.  Error feedback keeps the quantization *unbiased over time*:
the residual e_t is added back before the next quantization, so SGD/Adam
convergence is preserved (measured: `tests/test_compression.py` trains to
the same loss +-2%).

The compress -> (reduce) -> decompress pipeline is expressed functionally;
on hardware the int8 payload is what crosses the DCN.  The port of the JAX
package's ``distributed/compression.py``: a leaf flattened to one row is
quantized by ``kernels.ops.quantize`` and restored by ``ops.dequantize``,
so on the card each leaf runs K3 and K4 (``kernels/csrc/vector_engine.cu``)
once, and on the CPU their plain versions; a per-tensor absmax is that
row's absmax, so the codes are the JAX package's.  The error state is as
stateless as the JAX package's training step makes it: zeros every step,
the residual dropped, so the step applies ``wire_transform``, the
transform ``compress_grads`` wraps in error feedback.  Over a mesh a rank that holds one block
of a split leaf quantizes it against the whole leaf's absmax (``absmax``,
an all-reduce MAX over the blocks: ``launch.steps``), so its codes are the
whole leaf's codes, block for block.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Pytree = Any


def _quantize_leaf(g: torch.Tensor, absmax: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The leaf as one row; ``absmax`` a 0-d or (1,) fp32 tensor, the whole
    leaf's where ``g`` is a block of it."""
    return ops.quantize(g.reshape(1, -1),
                        None if absmax is None else absmax.reshape(1))


def init_error_state(params: Pytree) -> Pytree:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress_grads(grads: Pytree, error: Pytree) -> Tuple[Pytree, Pytree]:
    """grads + carried error -> (dequantized int8 grads, new error).

    The returned grads are exactly what a receiver of the int8 payload
    would reconstruct; ``new_error`` is the residual to feed back next step.
    The JAX package's API with error feedback; the training step, whose
    error state is zeros, calls ``wire_transform`` alone.
    """
    g32 = [g.float() + e for g, e in zip(tree_leaves(grads),
                                         tree_leaves(error))]
    deq = list(g32)
    wire_transform(deq)
    return (tree_unflatten(grads, deq),
            tree_unflatten(grads, [g - d for g, d in zip(g32, deq)]))


def wire_transform(grads: List[torch.Tensor],
                   absmax: Optional[Sequence[Optional[torch.Tensor]]] = None
                   ) -> None:
    """The int8 quantize -> dequantize transform in place on a list of
    leaves, one leaf at a time (each fp32 leaf replaced by its dequantized
    codes, so no more than one extra leaf is held).  ``absmax[i]``: leaf
    i's whole absmax where it is a block of a split leaf, else None."""
    for i, g in enumerate(grads):
        q, scale = _quantize_leaf(g.float(),
                                  None if absmax is None else absmax[i])
        grads[i] = ops.dequantize(q, scale).view(g.shape)


def wire_bytes(params: Pytree, dtype_bytes: int = 4) -> Tuple[int, int]:
    """(uncompressed, compressed) DP-reduction payload sizes in bytes."""
    import numpy as np
    n = sum(int(np.prod(p.shape)) for p in tree_leaves(params))
    leaves = len(tree_leaves(params))
    return n * dtype_bytes, n * 1 + leaves * 4
