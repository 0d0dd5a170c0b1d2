"""PyTorch / CUDA port of the ``repro`` package for NVIDIA Hopper (H100).

It imports nothing of JAX or of ``repro``; the numpy models it shares with
that package are copies under ``repro_torch.core``.  Entry points run on the
card unless the caller passes ``device="cpu"``.
"""
