"""Blocked (flash) attention on Hopper (K5).

``flash_attention`` launches ``csrc/flash_attention.cu``: online-softmax
attention with fp32 m, l and accumulator, GQA (head h reads KV head
h // (H / KV)), causal masking and a sliding window, walking only the key
tiles the masks leave.  q and k share a head dim Dqk, v has its own Dv
(MLA: q/k 96 = nope 64 + rope 32, v 64), and the scores are scaled by
1 / sqrt(Dqk); the kernel is built for the pairs in ``HEAD_DIM_PAIRS``.
bf16 runs both products on the tensor cores (``wgmma``); fp32 runs them on
the tensor cores too, each as three TF32 products (3xTF32: hi.hi + hi.lo +
lo.hi of operands split into TF32 halves, ``mma.sync``), which keeps
fp32's accuracy.  It replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention``; unlike that kernel it
needs no tile to divide Sq or Skv.
``flash_attention_plain`` is the same function as one dense masked softmax.

``flash_attention_bwd`` launches K5b, the gradient (dQ, dK, dV) by
FlashAttention-2's decomposition: P recomputed from the forward's
log-sum-exp (``return_lse``), Delta = rowsum(dO o O), dK and dV summed over
each KV head's query heads inside the kernel, no atomics.  bf16 runs its
products on ``wgmma`` with the other side's tiles copied one step ahead,
its dK/dV pass splitting a KV head's query heads over the ranks of a
thread-block cluster (``bwd_plan``; ``tests/test_torch_attention_bwd_split.py``
holds a plain model of that split against the JAX package); fp32 runs the
same two passes and the same split with each product as 3xTF32 on
``mma.sync`` (``tests/test_torch_attention_tf32.py`` holds a plain model
of that arithmetic against the JAX package).  K5b is built for the same
(Dqk, Dv) pairs as K5 (``check_bwd_dims``): S and dQ, dK run over Dqk,
dP, dV and Delta over Dv.
The TPU side has no such
kernel: the JAX package differentiates ``models/layers.py::
blocked_attention`` by autodiff.  ``flash_attention_bwd_plain`` is the same
arithmetic in fp32 PyTorch, and ``FlashAttention`` the autograd function
that runs K5 and K5b on the card and the plain versions on the CPU.

Every form takes JAX's ``_attn_block`` positions: ``q_offset`` (an int
>= 0) puts query row i at position i + q_offset against key j at j, and
``kv_len`` (None, an int, or a 0-d integer tensor: one valid-prefix
length shared by the batch) keeps the keys below it.  A pair attends
where ``kpos <= qpos + q_offset`` (causal), ``qpos + q_offset - kpos <
window`` (a window) and ``kpos < kv_len``; the kernels walk only the key
tiles (and K5b's dK/dV pass the query tiles) that the shifted diagonal,
the window and the valid prefix leave.  A ``kv_len`` tensor on the card
is read by the kernels themselves, with no copy to the host.  A row that
sees no key (no key below kv_len, or with a window every key below it
too far back) has the log-sum-exp NEG_INF: its weights are 1 / Skv on
every key, as the forward gives it the mean of V (JAX's softmax of a row
all at the mask value), and its scores, the constant mask value, pass no
gradient to Q or K.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build, shape_only

NEG_INF = -1e30
# Square head dims K5 and K5b take, and their (Dqk, Dv) pairs: those, MLA's
# (minicpm3-4b), ViT-632M's and the CPU tests' reduced MLA.
HEAD_DIMS = (16, 32, 64, 128, 256)
HEAD_DIM_PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((96, 64), (80, 80),
                                                     (32, 16))
# K5b's bf16 kernels (csrc/flash_attention.cu): rows of an other-side tile
# (and of the own tile at head dim 256; 128 own rows, 64 a warpgroup,
# below); the most ranks a cluster of the dK/dV pass has; the SMs the plan
# assumes where it is not told the card's (an H100 SXM's).  The fp32
# kernels' tiles are ``bwd_rows`` and ``bwd_tile`` with ``fp32``.
BWD_TILE = 64
MAX_CLUSTER = 8
SMS = 132


def _mask(Sq: int, Skv: int, causal: bool, window: int, device,
          q_offset: int = 0, kv_len=None) -> torch.Tensor:
    """(Sq, Skv) bool: the pairs that attend, query row i at position
    i + ``q_offset``, key j at j, the keys below ``kv_len`` (None: all)."""
    qpos = torch.arange(Sq, device=device)[:, None] + q_offset
    kpos = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= (qpos - kpos) < window
    if kv_len is not None:
        mask &= kpos < (kv_len.to(device) if isinstance(kv_len, torch.Tensor)
                        else kv_len)
    return mask


def check_offset(kernel: str, q_offset) -> int:
    """``q_offset`` as an int >= 0 (a 0-d tensor read once)."""
    q_offset = int(q_offset)
    if q_offset < 0:
        raise ValueError(f"{kernel}: q_offset {q_offset}, want >= 0")
    return q_offset


def kv_len_value(kv_len, Skv: int):
    """The number of valid keys ``kv_len`` leaves of ``Skv`` where the host
    knows it (None, an int, a tensor on the CPU), clamped to [0, Skv];
    None for a tensor on a card, which the kernels read themselves."""
    if isinstance(kv_len, torch.Tensor):
        if kv_len.device.type != "cpu":
            return None
        kv_len = int(kv_len)
    return Skv if kv_len is None else max(0, min(int(kv_len), Skv))


def _kv_len_args(kv_len, Skv: int, device):
    """(the valid-prefix length the kernels take, the 0-d int64 tensor on
    the card they read in its place, or None)."""
    if isinstance(kv_len, torch.Tensor) and kv_len.device.type != "cpu":
        if kv_len.numel() != 1 or kv_len.is_floating_point():
            raise ValueError(f"kv_len: a one-element integer tensor, got "
                             f"{tuple(kv_len.shape)} {kv_len.dtype}")
        return Skv, kv_len.reshape(()).to(device=device, dtype=torch.int64)
    return kv_len_value(kv_len, Skv), None


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          return_lse: bool = False, q_offset: int = 0,
                          kv_len=None):
    """q (B,H,Sq,D); k (B,KV,Skv,D); v (B,KV,Skv,Dv) -- dense masked
    softmax of the scores scaled by 1 / sqrt(D) -> (B,H,Sq,Dv), the mask
    ``_mask``'s.  With ``return_lse`` also each row's log-sum-exp of its
    scaled, masked scores, fp32 (B,H,Sq)."""
    B, H, Sq, D = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, Sq, D).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) / math.sqrt(D)
    mask = _mask(Sq, Skv, causal, window, q.device, q_offset, kv_len)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", w, v.float())
    o = o.reshape(B, H, Sq, v.shape[-1]).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1).reshape(B, H, Sq)
    return o


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              window: int = 0, q_offset: int = 0,
                              kv_len=None):
    """K5b's arithmetic in fp32 PyTorch: (dQ, dK, dV) in the inputs'
    dtypes from the forward's output ``o`` and log-sum-exp ``lse`` (B,H,Sq)
    and the output's cotangent ``do`` (both (B,H,Sq,Dv)).  P = exp(S - lse) where the mask
    keeps a pair, 1 / Skv on every key of a row with lse NEG_INF (it saw
    no key); dS = P o (dO V^T - rowsum(dO o O)) where the mask keeps a
    pair of a row that saw a key, else 0; dV = P^T dO and dK = scale dS^T Q
    summed over the query heads of a KV head, dQ = scale dS K."""
    B, H, Sq, D = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, KV, G, Sq, D).float()
    Dv = v.shape[-1]
    dog = do.reshape(B, KV, G, Sq, Dv).float()
    og = o.reshape(B, KV, G, Sq, Dv).float()
    kf, vf = k.float(), v.float()
    mask = _mask(Sq, Skv, causal, window, q.device, q_offset, kv_len)
    dead = (lse.reshape(B, KV, G, Sq, 1) == NEG_INF)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, kf) * scale
    p = torch.where(mask, torch.exp(s - lse.reshape(B, KV, G, Sq, 1)), 0.0)
    p = torch.where(dead, 1.0 / Skv, p)
    delta = (dog * og).sum(-1, keepdim=True)
    dp = torch.einsum("bkgqd,bksd->bkgqs", dog, vf)
    ds = torch.where(mask & ~dead, p * (dp - delta), 0.0) * scale
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dog)
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qg)
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kf)
    return (dq.reshape(B, H, Sq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def bwd_rows(D: int, fp32: bool = False) -> int:
    """Own keys of a K5b dK/dV block at q/k head dim D (Dv is never
    larger): in bf16 128 up to head dim 128 (64 a warpgroup), else 64 (the
    dQ pass's own query rows too); in fp32 (``TfBwd::KROWS``) 64, 16 at
    head dim 256."""
    if fp32:
        return 64 if D <= 128 else 16
    return 2 * BWD_TILE if D <= 128 else BWD_TILE


def bwd_tile(fp32: bool = False) -> int:
    """Query rows a step of K5b's dK/dV pass walks: 64 in bf16, 16 in fp32
    (``TfBwd::BTK``)."""
    return 16 if fp32 else BWD_TILE


def bwd_query_tiles(kt: int, Sq: int, Skv: int, causal: bool, window: int,
                    rows: int = BWD_TILE, q_offset: int = 0,
                    kv_len=None, tile: int = BWD_TILE) -> range:
    """The ``tile``-row query tiles K5b's dK/dV pass walks for the key tile
    ``kt`` of ``rows`` keys (``csrc/flash_attention.cu``'s
    ``query_range``): the rows that see any of its keys below the valid
    prefix (causal rows from its first key less ``q_offset`` on, with a
    window those before its last key + window less ``q_offset``), and
    from the first row that sees no key on, every row to Sq (such a row
    weighs every key).  ``kv_len`` as ``kv_len_value`` reads it (None:
    every key valid)."""
    k0 = kt * rows
    kvl = Skv if kv_len is None else kv_len
    q_lo, q_hi = Sq, 0
    if k0 < kvl:
        q_lo = max(0, k0 - q_offset) if causal else 0
        q_hi = (min(Sq, k0 + rows - 1 + window - q_offset) if window
                else Sq)
    dead = (0 if kvl <= 0 else
            max(0, kvl + window - 1 - q_offset) if window else Sq)
    if dead < Sq:
        q_lo, q_hi = (dead if q_hi <= q_lo else min(q_lo, dead)), Sq
    if q_hi <= q_lo:
        return range(0)
    return range(q_lo // tile, -(-q_hi // tile))


@functools.lru_cache(maxsize=256)
def bwd_plan(B: int, H: int, KV: int, Sq: int, Skv: int, D: int,
             causal: bool = True, window: int = 0, sms: int = SMS,
             cluster: int = 0, q_offset: int = 0,
             kv_len: int = None, fp32: bool = False) -> dict:
    """K5b's dK/dV pass at these shapes (D q/k's head dim; the fp32
    kernels' tiles with ``fp32``): the ``cluster`` of R ranks
    that split each KV head's G = H / KV query heads (rank r takes
    ``heads[r]`` = r, r + R, ...), the key tiles of ``key_rows`` keys in
    launch order (``key_tiles``, the heaviest first) and the
    ``query_tiles`` (of ``query_rows`` rows) each walks.  A block is (b,
    KV head, key tile, rank) and walks its heads' query tiles; R is
    ``cluster`` where given, else the smallest that brings the longest
    such walk down to the card's share of all of them (``sms`` blocks at
    once), or as near as R <=
    min(8, G) comes.  ``q_offset`` and ``kv_len`` (an int, or None: every
    key valid, as where the kernel reads a card tensor's) as
    ``bwd_query_tiles`` takes them."""
    G = H // KV
    rows, tile = bwd_rows(D, fp32), bwd_tile(fp32)
    nk = -(-Skv // rows)
    tiles = tuple(tuple(bwd_query_tiles(kt, Sq, Skv, causal, window, rows,
                                        q_offset, kv_len, tile))
                  for kt in range(nk))
    longest = max(map(len, tiles), default=0)
    share = B * KV * G * sum(map(len, tiles)) / sms
    if not 0 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"bwd_plan: cluster {cluster}, want 1..{MAX_CLUSTER}")
    cluster = cluster or min(range(1, min(MAX_CLUSTER, G) + 1),
                             key=lambda r: (max(-(-G // r) * longest, share),
                                            r))
    order = tuple(range(nk)) if causal else tuple(reversed(range(nk)))
    return {"cluster": cluster,
            "heads": tuple(tuple(range(r, G, cluster))
                           for r in range(cluster)),
            "key_rows": rows, "key_tiles": order, "query_tiles": tiles,
            "query_rows": tile}


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if lib.flash_attention.argtypes is None:
        lib.flash_attention.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float]
            + [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_void_p])
        lib.flash_attention.restype = ctypes.c_int
        lib.flash_attention_bwd.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_float]
            + [ctypes.c_int] * 4 + [ctypes.c_void_p] + [ctypes.c_int] * 2
            + [ctypes.c_void_p])
        lib.flash_attention_bwd.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_qkv(kernel: str, q, k, v) -> None:
    """q (B,H,Sq,D), k (B,KV,Skv,D), v (B,KV,Skv,Dv) with H a multiple of
    KV, (D, Dv) in ``HEAD_DIM_PAIRS``, one dtype."""
    B, H, Sq, D = q.shape
    KV, Skv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if k.shape != (B, KV, Skv, D) or v.shape != (B, KV, Skv, Dv) or H % KV:
        raise ValueError(f"{kernel}: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if (D, Dv) not in HEAD_DIM_PAIRS:
        raise ValueError(f"{kernel}: head dims (q/k {D}, v {Dv}) not in "
                         f"{HEAD_DIM_PAIRS}")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"{kernel}: q, k and v differ in dtype")


def check_bwd_dims(kernel: str, q, v) -> None:
    """K5b (and ``FlashAttention``, on the CPU too) takes the (Dqk, Dv)
    pairs of ``HEAD_DIM_PAIRS``, as K5 does, and refuses any other."""
    D, Dv = q.shape[-1], v.shape[-1]
    if (D, Dv) not in HEAD_DIM_PAIRS:
        raise ValueError(f"{kernel}: head dims (q/k {D}, v {Dv}): K5b is "
                         f"built for the pairs {HEAD_DIM_PAIRS}")


def _aligned(*tensors):
    """The kernels copy 16 bytes at a time: a view at an odd offset is
    copied."""
    return [t if t.data_ptr() % 16 == 0 else t.clone() for t in tensors]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    return_lse: bool = False, q_offset: int = 0,
                    kv_len=None):
    """q (B, H, Sq, D); k (B, KV, Skv, D); v (B, KV, Skv, Dv) -> (B, H, Sq,
    Dv), on the card; with ``return_lse`` also each row's log-sum-exp, fp32
    (B, H, Sq), which ``flash_attention_bwd`` reads.  ``q_offset`` and
    ``kv_len`` place the queries and bound the keys (the module's
    docstring)."""
    _check_qkv("flash_attention", q, k, v)
    q_offset = check_offset("flash_attention", q_offset)
    B, H, Sq, D = q.shape
    KV, Skv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    kvl, kvl_t = _kv_len_args(kv_len, Skv, q.device)
    if shape_only.is_fake(q, k, v):
        # a kv_len tensor the host cannot read counts every key
        out, lse = torch.ops.repro_torch.flash_attention(
            q, k, v, causal, window, return_lse, q_offset, kvl)
        return (out, lse) if return_lse else out
    _build.require_cuda("flash_attention", q, k, v)
    q, k, v = _aligned(q, k, v)
    out = q.new_empty((B, H, Sq, Dv))
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if q.numel() == 0:
        return (out, lse) if return_lse else out
    lib = _lib()
    with torch.cuda.device(q.device):
        code = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), B, H, KV, Sq, Skv, D,
            Dv, 1.0 / math.sqrt(D), int(causal), int(window), q_offset,
            kvl, None if kvl_t is None else kvl_t.data_ptr(),
            _build.dtype_code(q.dtype), _build.stream_of(q))
    _build.check(lib, code, "flash_attention")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, q_offset: int = 0, kv_len=None):
    """K5b on the card: (dQ, dK, dV), what ``flash_attention_bwd_plain``
    computes, each in q's dtype with fp32 accumulation.  ``o`` and ``lse``
    are what ``flash_attention(..., return_lse=True)`` returned for these
    inputs (the same ``q_offset`` and ``kv_len``); ``do`` has o's shape
    (B, H, Sq, Dv) and dtype."""
    _check_qkv("flash_attention_bwd", q, k, v)
    q_offset = check_offset("flash_attention_bwd", q_offset)
    check_bwd_dims("flash_attention_bwd", q, v)
    B, H, Sq, D = q.shape
    KV, Skv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    for name, t in (("o", o), ("do", do)):
        if tuple(t.shape) != (B, H, Sq, Dv) or t.dtype != q.dtype:
            raise ValueError(f"flash_attention_bwd: {name} "
                             f"{tuple(t.shape)} {t.dtype}, want "
                             f"{(B, H, Sq, Dv)} {q.dtype}")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} "
                         f"{lse.dtype}, want {(B, H, Sq)} float32")
    kvl, kvl_t = _kv_len_args(kv_len, Skv, q.device)
    if shape_only.is_fake(q, k, v, o, lse, do):
        return torch.ops.repro_torch.flash_attention_bwd(
            q, k, v, o, lse, do, causal, window, q_offset, kvl)
    _build.require_cuda("flash_attention_bwd", q, k, v, o, lse, do)
    q, k, v, o, do = _aligned(q, k, v, o, do)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    # a kv_len the kernel reads on the card: planned as every key valid
    cluster = bwd_plan(B, H, KV, Sq, Skv, D, bool(causal), int(window),
                       _sms(q.device), q_offset=q_offset,
                       kv_len=None if kvl_t is not None else kvl,
                       fp32=q.dtype == torch.float32)["cluster"]
    lib = _lib()
    with torch.cuda.device(q.device):
        code = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, H, KV, Sq, Skv, D, Dv,
            1.0 / math.sqrt(D), int(causal), int(window), q_offset, kvl,
            None if kvl_t is None else kvl_t.data_ptr(), cluster,
            _build.dtype_code(q.dtype), _build.stream_of(q))
    _build.check(lib, code, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention.launches = 0
flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with its gradient: K5 forward (keeping the
    log-sum-exp) and K5b backward on the card, ``flash_attention_plain``
    and ``flash_attention_bwd_plain`` on the CPU; ``apply(q, k, v,
    causal, window, q_offset=0, kv_len=None)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset=0, kv_len=None):
        check_bwd_dims("FlashAttention", q, v)
        ctx.causal, ctx.window = causal, window
        ctx.q_offset, ctx.kv_len = q_offset, kv_len
        fwd = (flash_attention_plain if q.device.type == "cpu"
               else flash_attention)
        o, lse = fwd(q, k, v, causal=causal, window=window, return_lse=True,
                     q_offset=q_offset, kv_len=kv_len)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = (flash_attention_bwd_plain if q.device.type == "cpu"
               else flash_attention_bwd)
        dq, dk, dv = bwd(q, k, v, o, lse, do.contiguous(), causal=ctx.causal,
                         window=ctx.window, q_offset=ctx.q_offset,
                         kv_len=ctx.kv_len)
        return dq, dk, dv, None, None, None, None
