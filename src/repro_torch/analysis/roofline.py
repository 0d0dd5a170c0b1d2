"""Roofline terms from dry-run records, and the work of each hand-written
kernel with the least time the card could take for it.

Hardware constants (NVIDIA H100 80GB HBM3, SXM, 700 W; NVIDIA's data
sheet, dense rates without sparsity):
  peak bf16 compute : 989 TFLOP/s per card (tensor cores)
  HBM3 bandwidth    : 3.35 TB/s per card
  NVLink bandwidth  : 450 GB/s per card each way (900 GB/s in all)

Terms (seconds, per card):
  compute    = FLOPs_per_card / peak
  memory     = bytes_per_card / HBM_bw
  collective = collective_traffic_per_card / link_bw

MODEL_FLOPS (the "useful work" yardstick):
  train    : 6 * N_active * tokens
  prefill  : 2 * N_active * tokens
  decode   : 2 * N_active * batch       (one token per sequence)

The kernels' work (``k*_work``: bytes moved, each input read once and
each output written once, and operations, an FMA counted as two) is what
``chip_smoke.py`` holds each kernel's time against through ``bound``, and
what the kernels' shape-only forms (``kernels/shape_only.py``) report to
``torch.utils.flop_counter`` in the dry run: one count for both.
"""
from __future__ import annotations

from dataclasses import dataclass, asdict
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9

# The same card's peaks by operand type (tensor cores for bf16 and TF32;
# the FMA pipes for fp32 and fp64), and the bytes a second of its HBM.
HBM_BYTES_PER_S = HBM_BW
PEAK_OPS_PER_S = {"float32": 67e12,     # fp32 FMA pipes, no tensor cores
                  "tf32": 495e12,       # tensor cores, TF32
                  "bfloat16": PEAK_FLOPS,   # tensor cores
                  "float64": 34e12}     # fp64 FMA pipes, no tensor cores
K8_CHUNK = 64       # rows a K8/K8b block walks at a time
K7_OPS = 17         # fp32 operations a K7 element (gates, a, b, FMA)
K7B_OPS = 32        # fp32 operations a K7b element


def active_params(cfg: ModelConfig) -> int:
    """Parameter count with MoE experts discounted by k/E."""
    from repro_torch.models.transformer import param_defs, PDef

    total = 0
    def walk(tree, in_expert=False):
        nonlocal total
        if isinstance(tree, PDef):
            n = int(np.prod(tree.shape))
            if "expert" in (tree.axes or ()):
                n = n * max(cfg.experts_per_token, 1) // max(cfg.num_experts, 1)
            total += n
            return
        if isinstance(tree, dict):
            for v in tree.values():
                walk(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                walk(v)
    walk(param_defs(cfg))
    return total


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    n = active_params(cfg)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


@dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    model_flops_total: float
    peak_memory_bytes: Optional[float] = None

    @property
    def compute_s(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_chip / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes_per_chip / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs — catches remat/redundancy waste."""
        hlo_total = self.flops_per_chip * self.chips
        return self.model_flops_total / hlo_total if hlo_total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Achievable MFU proxy: useful-compute time / bound time."""
        useful_s = self.model_flops_total / self.chips / PEAK_FLOPS
        return useful_s / self.bound_s if self.bound_s else 0.0

    def to_dict(self) -> Dict:
        d = asdict(self)
        d.update(compute_s=self.compute_s, memory_s=self.memory_s,
                 collective_s=self.collective_s, dominant=self.dominant,
                 useful_ratio=self.useful_ratio,
                 roofline_fraction=self.roofline_fraction)
        return d


# ---------------------------------------------------------------------------
# the hand-written kernels: work and least time
# ---------------------------------------------------------------------------

def _esz(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def bound(nbytes, ops_, dtype):
    """(least ms for the work, "bytes" or "operations"); dtype a torch dtype
    or a key of PEAK_OPS_PER_S."""
    key = dtype if isinstance(dtype, str) else str(dtype).split(".")[1]
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops_ / PEAK_OPS_PER_S[key]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attn_pairs(Sq: int, Skv: int, causal: bool, window: int,
               q_offset: int = 0, kv_len=None) -> int:
    """The number of query-key pairs attention computes, query row i at
    position i + ``q_offset`` and key j at j: key <= query where causal,
    query - key < window where a window is set, key < ``kv_len`` where
    given."""
    q = np.arange(Sq, dtype=np.int64) + q_offset
    lo = np.maximum(q - window + 1, 0) if window else np.zeros_like(q)
    last = Skv - 1 if kv_len is None else min(int(kv_len), Skv) - 1
    hi = np.minimum(q, last) if causal else np.full_like(q, last)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def k1_work(M, K, N, dtype):
    """K1, (M, K) @ (K, N): x, w read and the output written in ``dtype``;
    2 M N K operations."""
    return (M * K + K * N + M * N) * _esz(dtype), 2 * M * N * K


def k1_bounds(M, K, N, dtype):
    """K1's bound for the work it does, (ms, by): fp32 as three TF32
    products on the tensor cores (3xTF32), bf16 as one bf16 product; and
    the fp32 FMA pipes' bound of the same product (None for bf16)."""
    nbytes, flops = k1_work(M, K, N, dtype)
    if dtype != torch.float32:
        return bound(nbytes, flops, dtype), None
    return bound(nbytes, 3 * flops, "tf32"), bound(nbytes, flops, dtype)


def k2_work(M, N, dtype, out_dtype=None):
    """K2 at (M, N): x read and the output written, scale and bias read in
    fp32; a multiply and an add an element."""
    out = _esz(out_dtype or dtype)
    return M * N * (_esz(dtype) + out) + 2 * N * 4, 2 * M * N


def k2_bound(M, N, dtype, out_dtype=None):
    return bound(*k2_work(M, N, dtype, out_dtype), torch.float32)


def k3_work(M, N, dtype, given=False):
    """K3 at (M, N): x read, the int8 codes and fp32 scales written (a
    given absmax read too); 5 operations an element."""
    return (M * N * _esz(dtype) + M * N + 4 * M + (4 * M if given else 0),
            5 * M * N)


def k3_bound(M, N, dtype, given=False):
    return bound(*k3_work(M, N, dtype, given), torch.float32)


def k4_work(M, N, out_dtype=torch.float32):
    """K4 at (M, N): the codes and scales read, the output written; one
    multiply an element."""
    return M * N + 4 * M + M * N * _esz(out_dtype), M * N


def k4_bound(M, N, out_dtype=torch.float32):
    return bound(*k4_work(M, N, out_dtype), torch.float32)


def k5_work(B, H, KV, Sq, Skv, D, causal, window, dtype, Dv=None,
            q_offset=0, kv_len=None):
    """K5 at one shape (q/k head dim D, v's Dv, D where None): q, k, v read
    and o written in ``dtype``; two products over the pairs the masks
    leave (``attn_pairs`` of ``q_offset`` and ``kv_len``), S over D and
    P V over Dv."""
    Dv = Dv or D
    nbytes = (B * H * Sq + B * KV * Skv) * (D + Dv) * _esz(dtype)
    return nbytes, 2 * B * H * (D + Dv) * attn_pairs(Sq, Skv, causal, window,
                                                     q_offset, kv_len)


def k5_bounds(B, H, KV, Sq, Skv, D, causal, window, dtype, Dv=None,
              q_offset=0, kv_len=None):
    """K5's bound for the work it does, (ms, by): fp32 as three TF32
    products on the tensor cores (3xTF32), bf16 as one bf16 product; and
    the fp32 FMA pipes' bound of the same products (None for bf16)."""
    nbytes, ops_ = k5_work(B, H, KV, Sq, Skv, D, causal, window, dtype, Dv,
                           q_offset, kv_len)
    if dtype != torch.float32:
        return bound(nbytes, ops_, dtype), None
    return bound(nbytes, 3 * ops_, "tf32"), bound(nbytes, ops_, dtype)


def k5_bound(B, H, KV, Sq, Skv, D, causal, window, dtype, Dv=None,
             q_offset=0, kv_len=None):
    """K5's bound for the work it does (``k5_bounds``' first)."""
    return k5_bounds(B, H, KV, Sq, Skv, D, causal, window, dtype, Dv,
                     q_offset, kv_len)[0]


def k5b_work(B, H, KV, Sq, Skv, D, causal, window, dtype, Dv=None,
             q_offset=0, kv_len=None):
    """K5b at one shape: q, k, v, o, dO read and dq, dk, dv written once in
    ``dtype``, the lse read in fp32; the least work is five products over
    the pairs the masks leave, S, dQ and dK over D, dP and dV over Dv (2.5
    times the forward's at D = Dv)."""
    Dv = Dv or D
    nbytes = (_esz(dtype) * (2 * B * H * Sq + 2 * B * KV * Skv) * (D + Dv)
              + 4 * B * H * Sq)
    pairs = attn_pairs(Sq, Skv, causal, window, q_offset, kv_len)
    return nbytes, 2 * (3 * D + 2 * Dv) * B * H * pairs


def k5b_bounds(B, H, KV, Sq, Skv, D, causal, window, dtype, Dv=None,
               q_offset=0, kv_len=None):
    """K5b's bound for the work it does, as ``k5_bounds``: fp32 as 3xTF32
    on the tensor cores beside the FMA pipes' bound (None for bf16)."""
    nbytes, ops_ = k5b_work(B, H, KV, Sq, Skv, D, causal, window, dtype, Dv,
                            q_offset, kv_len)
    if dtype != torch.float32:
        return bound(nbytes, ops_, dtype), None
    return bound(nbytes, 3 * ops_, "tf32"), bound(nbytes, ops_, dtype)


def k6_bound(n, n_seg=0):
    """K6 over n elements (and n_seg + 1 fenceposts, if any): 24 B an
    element (t, s read, the start written) and 6 fp64 operations; the
    serial chain is no part of this bound."""
    return bound(24 * n + (8 * (n_seg + 1) if n_seg else 0), 6 * n,
                 torch.float64)


def k7_work(B, S, W, dtype):
    """K7 at (B, S, W): x, gx, ga read and y written in ``dtype``, log_a
    and h0 in fp32; K7_OPS fp32 operations an element (the state and all
    the arithmetic are fp32 whatever the input type)."""
    return 4 * B * S * W * _esz(dtype) + 4 * (W + B * W), K7_OPS * B * S * W


def k7_bound(B, S, W, dtype):
    return bound(*k7_work(B, S, W, dtype), torch.float32)


def k7b_work(B, S, W, dtype):
    """K7b at (B, S, W): x, gx, ga, dy read and dx, dgx, dga written in
    ``dtype``, the fp32 states h32 read; log_a and h0 read, dlog_a and dh0
    written in fp32; K7B_OPS fp32 operations an element."""
    return ((7 * _esz(dtype) + 4) * B * S * W + 4 * (2 * W + 2 * B * W),
            K7B_OPS * B * S * W)


def k7b_bound(B, S, W, dtype):
    return bound(*k7b_work(B, S, W, dtype), torch.float32)


def k8_work(B, S, H, P, G, N, dtype):
    """K8 at one shape.  Bytes: x and y, B and C in ``dtype``, dt and the
    final state in fp32.  Operations of the kernel's 64-row chunks: C.B^T
    once per group over the causal pairs, W @ x over the same pairs, and
    the two (P, N) state products of every row."""
    nbytes = (_esz(dtype) * (2 * B * S * H * P + 2 * B * S * G * N)
              + 4 * (B * S * H + H + B * H * P * N))
    ops_ = (B * G * S * (K8_CHUNK + 1) * N + B * H * S * (K8_CHUNK + 1) * P
            + 4 * B * H * S * P * N)
    return nbytes, ops_


def k8_bound(B, S, H, P, G, N, dtype):
    return bound(*k8_work(B, S, H, P, G, N, dtype), dtype)


def k8b_work(B, S, H, P, G, N, dtype):
    """K8b at one shape.  Bytes: the gradient's inputs (x, dy, B and C in
    ``dtype``, dt fp32) read once and its outputs (dx, dB, dC in
    ``dtype``; ddt, dA and dh0 fp32) written once.  Operations of the
    kernel's 64-row chunks: per row and head, C.B^T and dy.x^T over the
    causal pairs, C S_in^T and B G^T, the weights on dy, the two
    (P, N)-sized products each of dC and dB, and the update of G."""
    nbytes = (_esz(dtype) * (3 * B * S * H * P + 4 * B * S * G * N)
              + 4 * (2 * B * S * H + 2 * H + B * H * P * N))
    ops_ = B * H * S * ((K8_CHUNK + 1) * (3 * N + 2 * P) + 10 * P * N)
    return nbytes, ops_


def k8b_bound(B, S, H, P, G, N, dtype):
    return bound(*k8b_work(B, S, H, P, G, N, dtype), dtype)
