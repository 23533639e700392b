"""Fused graph-guided attention + residual + LayerNorm (K1) and its backward (K2).

Counterpart of the TPU package's ``ops/pallas_attention.py`` (``_kernel``,
entry ``fused_graph_attention_ln``) and ``ops/pallas_attention_bwd.py``
(``_bwd_kernel``, entry ``fused_attention_bwd``). Per batch element, every
head:

    S = Q K^T / sqrt(dh) -> fill masked keys with -2^32+1 -> softmax
      -> x graph (shared across heads) -> l1 or sum_eps renorm
      -> x query mask -> cast to V's dtype -> @ V (f32 accumulation)
    out = LN(acc + residual)   (reference LN: eps on the unbiased std)

On CUDA tensors :func:`fused_graph_attention_ln` launches the kernels of
``csrc/graph_attention.cu`` and its backward launches the kernel of
``csrc/graph_attention_bwd.cu``; on CPU tensors they run
:func:`graph_attention_ln_plain` and :func:`graph_attention_ln_bwd_plain`,
the same functions in plain PyTorch, rounding where the kernels round. The
kernels take Tq != Tk (the decoder's one-query cross-attention) and at most
``MAX_KEYS`` keys; longer sequences are the flash kernels' (K4-K6,
``ops/flash_graph_attention.py``), which the attention modules call above
that.

K1 has three paths (:func:`k1_path`, by dtype and head width). bfloat16
with a head width that is a multiple of 16 (at most K1's own limit
``K14_TC_MAX_HEAD_DIM``, 256; K2 keeps ``TC_MAX_HEAD_DIM``, 128) runs on
the tensor cores: a kernel per (head, 64 query rows, batch element; 16
rows for the decoder's few queries, 128 above head width 128 and 128 rows,
:func:`tc_warps`) forms O = A V with ``mma.sync`` on bf16 tiles into f32
scratch, and a second kernel adds the residual and runs the LayerNorm,
counted as one launch. Above head width 128 (instance 256) Q's fragments
are read from shared memory where Q K^T needs them, as O's take 128
registers a thread. float32 with a head width that is a multiple of 4 (at most
``TC_MAX_HEAD_DIM``) runs a register-tiled FFMA kernel in the same shape
(``csrc/simt_f32.cuh``'s tiles; a block per head and 64, 48, 32 or 16 query
rows, :func:`f32_plan`): the scores into shared memory, then a warp a row
forms the weights in the first SIMT kernel's order, then O = A V in its
chunk sums, into f32 scratch, then the same LayerNorm kernel. Every sum
is the first SIMT kernel's in its order, so its output is that kernel's
bit for bit, and the float32 checks that pair two paths (data parallel,
the model axis, packing) see the bits they saw. Every other call
(bfloat16 at a head width that is no multiple of 16, float32 at a head
width that is no multiple of 4 or above 128) takes the first SIMT kernel,
which keeps all heads of up to 16 rows in one block
(:func:`simt_rows`: fewer rows where 16 rows of C + Tk floats do not fit,
as at C 2,048 with 8 heads of 256 and 512 keys). None of the port's
presets reaches it: the hidden 2,048 blocks of the MIL variants return
their attention weights and so run ``attention_core``.

K1 and K2 take every C and every head width at up to ``MAX_KEYS`` keys.
Head widths above ``SIMT_MAX_HEAD_DIM`` (256), and SIMT calls whose single
row of C does not fit a block's shared memory, take the wide path
(:func:`k1_path` and :func:`k2_path` "wide"): K1 is the wide K4 forward
with ``emit`` 3 (:func:`flash_graph_attention.attention_o`: the head's
output channels in chunks of 256 over blocks, each streaming the whole head
width through shared memory for its scores; a first pass over the keys
for m, z and b, a second for K1's weights, rounded where K1 rounds them,
and the f32 output) and then K1's LayerNorm kernel; K2 is that forward
with its row statistics, a LayerNorm backward that reads each row in
chunks (``csrc/graph_attention_bwd.cu:savqa_attention_ln_bwd``), then K5's
and K6's kernels (the wide ones above 256, whose bfloat16 operands n and dS
are K4-K6's). Each call counts as one launch of K1 or K2. C 4,096 at 32
heads of 128 keeps the tensor-core
(bfloat16) and register-tiled (float32) K1 kernels, which are per head;
only their LayerNorm epilogue sees C, and it takes any C. K2's float32
kernels take any C too (above 2,048 their LayerNorm backward is the one
that reads rows in chunks); bfloat16 at C 4,096 with 32 heads takes the
composed route below (the tensor-core rows launch does not fit, as at C
2,048 with 16 heads).

K2 has three designs of its own (:func:`k2_path`), each a rows launch
(the forward recomputed, the LayerNorm backward, dQ and per-row constants)
and a keys launch (dK and dV summed over every query row, no atomics),
counted as one. bfloat16 with a head width that is a multiple of 16 runs
all six products on the tensor cores (``mma.sync`` on bf16 tiles that
``cp.async`` streams through two-stage rings): 32 query rows a block, the
scores rebuilt from per-row maximum and sum in every pass over the keys
instead of kept, dO handed to the keys launch as the bf16 dresidual. The
decoder's one-query calls take them too: a block is a chain of latencies
whatever its rows, and theirs measured shorter than the SIMT kernels'.
float32 (up to head width 128) takes four register-tiled FFMA kernels,
counted as one: the
forward recomputed by K4's f32 body into f32 scratch (output O and per-row
m, z, b), the LayerNorm backward a warp a row (``bwd_row_tile`` rows a
dgamma/dbeta partial), dQ over keys 32 at a time with both row sums of the
renorm and softmax backwards known before the first key (from delta = dO .
O), and dK, dV over query rows 32 at a time (64 keys a block); a head
width that is a multiple of 4 up to 128. Every other call up to head width
256 keeps the first SIMT kernels, in either dtype (TF32 would not hold the
float32 path's 1e-4 either): bfloat16 at a head width that is no multiple
of 16, and float32 at a head width that is no multiple of 4; their rows launch
takes :func:`simt_bwd_rows` rows a block and their keys launch 32 keys a
block (16 above head width 128). Above head width 128, and in bfloat16
wherever the tensor-core rows launch does not fit (C 2,048 with 16 heads,
C 4,096 with 32), K2 takes the composed route (:func:`k2_path`
"composed"), the wide path's structure on tiled kernels: :func:`composed_o`
(K1's tensor-core kernel writing its f32 output o and its pass A's m, z, b
in bfloat16; K4's register-tiled kernel with ``emit="stats"`` in float32),
the LayerNorm backward at any C (``savqa_attention_ln_bwd``), then K5 and
K6 on their tensor-core or f32 kernels (instance 256 above 128), counted
as one launch; its plain version
(:func:`graph_attention_ln_bwd_composed_plain`) rounds n and dS where K5
and K6 round them and is what the card's route is held to; on CPU tensors
the wrapper runs :func:`graph_attention_ln_bwd_plain` on every route.

The model axis splits the heads over the model row; the LayerNorm needs
every column, so it runs after the heads' outputs are gathered. Three more
entries of the same kernels serve it: :func:`graph_attention_heads`, the
f32 attention output ``o`` of the heads given (the first kernel of K1's
tensor-core or f32 path alone, or its SIMT kernel writing ``o`` and
skipping its epilogue), whose
backward is K2 from ``d(o)`` (the rows launch without the forward's output
and the LayerNorm backward, then the keys launch); and
:func:`attention_ln`, ``LN(o + residual)``, K1's epilogue kernel, whose
backward is autograd of ``layer_norm``.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from structured_alignment_vqa_tpu_torch.ops import _build
from structured_alignment_vqa_tpu_torch.ops.dispatch import (
    K14_TC_MAX_HEAD_DIM,
    K56_TC_MAX_HEAD_DIM,
    SIMT_MAX_HEAD_DIM,
    SMEM_LIMIT,
    TC_MAX_HEAD_DIM,
    composite_backward,
    f32_tiled,
    kernel_path,
    tc_width,
    use_kernel,
)
from structured_alignment_vqa_tpu_torch.ops.layers import LN_EPS, NEG_MASK_VALUE, layer_norm

# F.normalize(p=1) clamps the norm at 1e-12; the graph-mask variant adds 1e-7.
L1_NORM_EPS = 1e-12
SUM_NORM_EPS = 1e-7
RENORMS = ("l1", "sum_eps")
MAX_KEYS = 512
F32_LN_MAX_C = 2048  # K2's f32 LayerNorm backward holds a row in registers up to this C
Q_TILE = 16          # query rows per block of the SIMT kernels (K1, K2's rows launch), at most
KEY_CHUNK = 64       # keys staged in shared memory at a time
N_STATS = 8          # floats per (batch, head, query row) passed between K2's launches
BWD_TC_ROWS = 32     # query rows per block of K2's tensor-core rows launch
BWD_F32_ROWS = 64    # query rows per dgamma/dbeta partial of K2's f32 LayerNorm backward
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def graph_attention_plain(q, k, v, key_mask, query_mask, graph, num_heads: int,
                          renorm: str = "l1"):
    """Plain PyTorch version of :func:`graph_attention_heads`: the attention
    output before the residual and the LayerNorm, (B, Tq, C) float32."""
    b, tq, c = q.shape
    tk = k.shape[1]
    dh = c // num_heads
    qh = q.float().reshape(b, tq, num_heads, dh).transpose(1, 2)
    kh = k.float().reshape(b, tk, num_heads, dh).transpose(1, 2)
    vh = v.reshape(b, tk, num_heads, dh).transpose(1, 2)
    scores = torch.matmul(qh, kh.transpose(-1, -2)) * (1.0 / dh ** 0.5)
    scores = scores.masked_fill(key_mask.reshape(b, 1, 1, tk) == 0, NEG_MASK_VALUE)
    att = torch.softmax(scores, dim=-1) * graph.float().unsqueeze(1)
    if renorm == "l1":
        att = att / att.abs().sum(dim=-1, keepdim=True).clamp_min(L1_NORM_EPS)
    elif renorm == "sum_eps":
        att = att / (att.sum(dim=-1, keepdim=True) + SUM_NORM_EPS)
    else:
        raise ValueError(f"unknown renorm mode: {renorm!r}")
    att = att * query_mask.float().reshape(b, 1, tq, 1)
    acc = torch.matmul(att.to(v.dtype).float(), vh.float())
    return acc.transpose(1, 2).reshape(b, tq, c)


def attention_ln_plain(o, residual, gamma, beta):
    """Plain PyTorch version of :func:`attention_ln`: ``LN(o + residual)``
    in f32, in the residual's dtype."""
    return layer_norm(o + residual.float(), gamma, beta).to(residual.dtype)


def graph_attention_ln_plain(q, k, v, key_mask, query_mask, graph, residual,
                             gamma, beta, num_heads: int, renorm: str = "l1"):
    """Plain PyTorch version of the kernel: (B, Tq, C) in q's dtype."""
    o = graph_attention_plain(q, k, v, key_mask, query_mask, graph, num_heads, renorm)
    return attention_ln_plain(o, residual.to(q.dtype), gamma, beta)


def _forward_parts(q, k, v, key_mask, query_mask, graph, num_heads: int, renorm: str):
    """The forward's pieces the backwards need, recomputed from the inputs:
    the heads of q, k, v, the softmax P, G = P graph, the renorm's divisor
    r and live rows, the weights A (rounded to V's dtype) and the masks."""
    if renorm not in RENORMS:
        raise ValueError(f"unknown renorm mode: {renorm!r}")
    b, tq, c = q.shape
    tk = k.shape[1]
    dh = c // num_heads

    def heads(x, t):
        return x.reshape(b, t, num_heads, dh).transpose(1, 2)

    f = dict(qh=heads(q.float(), tq), kh=heads(k.float(), tk), vh=heads(v, tk),
             key_fill=key_mask.reshape(b, 1, 1, tk) == 0,
             qcol=query_mask.float().reshape(b, 1, tq, 1), gr=graph.float().unsqueeze(1),
             scale=1.0 / dh ** 0.5, heads=heads)
    scores = torch.matmul(f["qh"], f["kh"].transpose(-1, -2)) * f["scale"]
    f["p"] = torch.softmax(scores.masked_fill(f["key_fill"], NEG_MASK_VALUE), dim=-1)
    f["g"] = f["p"] * f["gr"]
    rsum = f["g"].sum(dim=-1, keepdim=True)             # g >= 0: sum |g| == sum g
    if renorm == "l1":
        f["r"] = rsum.clamp_min(L1_NORM_EPS)
        f["live"] = (rsum > L1_NORM_EPS).float()
    else:
        f["r"] = rsum + SUM_NORM_EPS
        f["live"] = torch.ones_like(rsum)
    f["a"] = (f["g"] / f["r"] * f["qcol"]).to(v.dtype).float()
    return f


def _attention_bwd(f, dx, q, renorm: str):
    """dq, dk, dv in q's dtype from dO = ``dx`` (already in q's dtype)."""
    b, tq, c = q.shape
    tk = f["kh"].shape[2]

    def merge(x, t):
        return x.transpose(1, 2).reshape(b, t, c)

    do = f["heads"](dx.float(), tq)
    g, r, p = f["g"], f["r"], f["p"]
    dv = torch.matmul(f["a"].transpose(-1, -2), do)
    dn = torch.matmul(do, f["vh"].float().transpose(-1, -2)) * f["qcol"]
    inner = (dn * g).sum(dim=-1, keepdim=True)
    if renorm == "l1":
        dg = dn / r - f["live"] * torch.sign(g) * inner / (r * r)
    else:
        dg = dn / r - inner / (r * r)
    dp = dg * f["gr"]
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    ds = (ds.masked_fill(f["key_fill"], 0.0) * f["scale"]).to(q.dtype).float()
    dq = torch.matmul(ds, f["kh"])
    dk = torch.matmul(ds.transpose(-1, -2), f["qh"])
    dt = q.dtype
    return merge(dq, tq).to(dt), merge(dk, tk).to(dt), merge(dv, tk).to(dt)


def graph_attention_ln_bwd_plain(q, k, v, key_mask, query_mask, graph, residual,
                                 gamma, beta, dy, num_heads: int, renorm: str = "l1"):
    """Plain PyTorch version of the backward kernel.

    Returns ``(dq, dk, dv, dresidual, dgamma, dbeta)``: the first four in
    q's dtype, dgamma and dbeta float32. The formulas are the hand-derived
    ones of the TPU package's ``pallas_attention_bwd.py:53-163``: the
    forward is recomputed from the inputs, the LayerNorm backward gives dO,
    then per head dV = A^T dO, dA = dO V^T and the renorm and softmax
    backwards give dS (0 on masked keys).

    Every product takes its operands in q's dtype and sums in float32, as
    the tensor-core kernel does: the weights A are rounded to V's dtype once
    (for the recomputed output, as in the forward, and for dV alike), dO
    once after the LayerNorm backward (dresidual is that rounded value), and
    dS once after the softmax backward, before dQ = dS K and dK = dS^T Q. In
    float32 none of these roundings does anything.
    """
    b, tq, c = q.shape
    f = _forward_parts(q, k, v, key_mask, query_mask, graph, num_heads, renorm)
    x = (torch.matmul(f["a"], f["vh"].float()).transpose(1, 2).reshape(b, tq, c)
         + residual.float())
    dx, dgamma, dbeta = _ln_bwd(x, gamma, dy)
    dx = dx.to(q.dtype)
    dq, dk, dv = _attention_bwd(f, dx, q, renorm)
    return dq, dk, dv, dx, dgamma, dbeta


def _ln_bwd(x, gamma, dy):
    """The reference LayerNorm's backward at its input x (f32, eps on the
    unbiased std; no d-std term on constant rows): ``(dx, dgamma, dbeta)``,
    all float32."""
    c = x.shape[-1]
    xm = x - x.mean(dim=-1, keepdim=True)
    var = xm.square().sum(dim=-1, keepdim=True) / max(c - 1, 1)
    nonzero = var > 0.0
    s = torch.where(nonzero, torch.sqrt(torch.where(nonzero, var, torch.ones_like(var))),
                    torch.zeros_like(var))
    inv = 1.0 / (s + LN_EPS)
    dy32 = dy.float()
    dbeta = dy32.sum(dim=(0, 1))
    dgamma = (dy32 * (xm * inv)).sum(dim=(0, 1))
    dxh = dy32 * gamma.float()
    ssum = (dxh * xm).sum(dim=-1, keepdim=True)
    dx = (dxh - dxh.mean(dim=-1, keepdim=True)) * inv - torch.where(
        nonzero, xm * (ssum * inv * inv) / (max(c - 1, 1) * torch.where(nonzero, s, 1.0)),
        torch.zeros_like(xm))
    return dx, dgamma, dbeta


def graph_attention_ln_bwd_composed_plain(q, k, v, key_mask, query_mask, graph, residual,
                                          gamma, beta, dy, num_heads: int, renorm: str = "l1"):
    """Plain PyTorch version of K2's composed route (:func:`k2_path`
    "composed"), rounding where it rounds: K1's attention output o (f32,
    its weights rounded to V's dtype) and K4's row statistics m, z, b; the
    LayerNorm backward at ``o + residual``, its dO rounded to q's dtype
    (dresidual); then K5's and K6's plain versions from that dO, which
    round n and dS to q's dtype as the operands of the second products. In
    float32 nothing is rounded and it is :func:`graph_attention_ln_bwd_plain`
    up to the order of sums. Returns ``(dq, dk, dv, dresidual, dgamma,
    dbeta)`` as that function does."""
    from structured_alignment_vqa_tpu_torch.ops import flash_graph_attention as flash

    o = graph_attention_plain(q, k, v, key_mask, query_mask, graph, num_heads, renorm)
    _, m, z, bsum = flash.flash_graph_attention_plain(q, k, v, key_mask, query_mask, graph,
                                                      num_heads, renorm, "stats")
    dx, dgamma, dbeta = _ln_bwd(o + residual.float(), gamma, dy)
    dres = dx.to(q.dtype)
    d_out, delta = flash.masked_grad_and_delta(o, dres, query_mask, num_heads)
    args = (q, k, v, key_mask, graph, m, z, bsum, delta, d_out.to(q.dtype), num_heads, renorm)
    return (flash.flash_bwd_dq_plain(*args), *flash.flash_bwd_dkv_plain(*args), dres, dgamma,
            dbeta)


def graph_attention_bwd_plain(q, k, v, key_mask, query_mask, graph, do, num_heads: int,
                              renorm: str = "l1"):
    """Plain PyTorch version of :func:`graph_attention_heads`' backward:
    ``(dq, dk, dv)`` in q's dtype from ``do``, the gradient of its output,
    rounded to q's dtype first (as K2 rounds dO)."""
    f = _forward_parts(q, k, v, key_mask, query_mask, graph, num_heads, renorm)
    return _attention_bwd(f, do.to(q.dtype), q, renorm)


K1_PATHS = ("simt", "tensor-core", "f32")   # the C entries' path argument


def k1_path(dtype, head_dim: int, tk: "int | None" = None, c: "int | None" = None) -> str:
    """Which of K1's CUDA kernels a call takes: ``"tensor-core"`` for
    bfloat16 at head widths that are multiples of 16 up to K1's own limit
    ``K14_TC_MAX_HEAD_DIM`` (256; K2 keeps ``TC_MAX_HEAD_DIM``), ``"f32"``
    (the register-tiled FFMA kernel of ``csrc/simt_f32.cuh``) for float32 at
    head widths that are multiples of 4 up to ``TC_MAX_HEAD_DIM`` (128),
    ``"wide"`` above head width ``SIMT_MAX_HEAD_DIM`` or where one row of
    the first SIMT kernel does not fit a block (given ``tk`` and ``c``),
    else ``"simt"`` (the first SIMT kernel). A choice by shape, not a
    fallback: a launch that fails raises."""
    if dtype == torch.bfloat16 and head_dim % 16 == 0 and head_dim <= K14_TC_MAX_HEAD_DIM:
        return "tensor-core"
    if f32_tiled(dtype, head_dim):
        return "f32"
    if head_dim > SIMT_MAX_HEAD_DIM or (
            c is not None and _simt_smem(1, tk, c, head_dim) > SMEM_LIMIT):
        return "wide"
    return "simt"


def f32_plan(batch: int, num_heads: int, tq: int, tk: int) -> tuple:
    """``(q_tile, n_split, steps_per_split)`` of K1's float32 kernel: 64
    query rows a block up to 192 keys, 48 up to 320, 32 up to 512 (the most
    rows that leave two blocks an SM at head width 64 beside the score rows
    of their keys), 16 when
    ``tq <= 16``, and one shard of every 64-key step, whatever the batch and
    the head count: a split sized by the head count would sum a model
    rank's 4 heads otherwise than one process's 8."""
    del batch, num_heads   # the plan does not depend on them
    q_tile = 16 if tq <= 16 else 64 if tk <= 192 else 48 if tk <= 320 else 32
    return q_tile, 1, -(-tk // KEY_CHUNK)


def smem_bytes_f32(tq: int, tk: int, c: int, num_heads: int) -> int:
    """Dynamic shared memory of one block of K1's float32 kernel (must match
    ``f32_smem_floats`` in ``csrc/graph_attention.cu``): the Q tile, two
    stages of a K or V tile (64 keys) and the key mask, and the score rows
    (64 ceil(Tk / 64) + 8 floats a row); head widths rounded up to 32, 64
    or 128."""
    dh = c // num_heads
    width = next(w for w in (32, 64, 128) if dh <= w)
    rows = f32_plan(1, num_heads, tq, tk)[0]
    ld = -(-tk // KEY_CHUNK) * KEY_CHUNK + 8
    return 4 * (rows * width + 2 * (KEY_CHUNK * width + KEY_CHUNK) + rows * ld)


def o_scratch(q, num_heads: int, path: "str | None" = None):
    """The f32 (B, Tq, C) scratch of the attention output that K1's
    tensor-core and float32 paths (``path``, by default :func:`k1_path`'s)
    pass to their LayerNorm kernel, or None on the SIMT path, which keeps it
    in shared memory, and on the wide path, whose forward allocates it."""
    if (path or k1_path(q.dtype, q.shape[-1] // num_heads)) in ("simt", "wide"):
        return None
    return torch.empty(*q.shape, dtype=torch.float32, device=q.device)


def _simt_smem(rows: int, tk: int, c: int, dh: int) -> int:
    """Shared memory of a block of K1's first SIMT kernel of ``rows`` rows."""
    return 4 * (rows * c + rows * tk + rows * dh + KEY_CHUNK * (dh + 1))


def _fitting_rows(rows: int, need) -> int:
    """``rows``, halved (rounding down, at least 1) until ``need(rows)`` bytes
    of shared memory fit a block."""
    while rows > 1 and need(rows) > SMEM_LIMIT:
        rows //= 2
    return rows


def simt_rows(tq: int, tk: int, c: int, num_heads: int) -> int:
    """Query rows a block of K1's first SIMT kernel: ``min(16, tq)``, halved
    until its (rows, C) output, (rows, Tk) scores and K or V chunk fit the
    shared memory a block may use (C 2,048 at 8 heads and 512 keys: 8). A
    pure function of the shapes."""
    dh = c // num_heads
    return _fitting_rows(min(Q_TILE, tq), lambda rows: _simt_smem(rows, tk, c, dh))


def smem_bytes(tq: int, tk: int, c: int, num_heads: int) -> int:
    """Dynamic shared memory of one block of K1's first SIMT kernel (must
    match the kernel's layout), at :func:`simt_rows` rows."""
    return _simt_smem(simt_rows(tq, tk, c, num_heads), tk, c, c // num_heads)


def tc_warps(tq: int, head_dim: int) -> int:
    """Warps (16 query rows each) per block of K1's tensor-core kernel: one
    for the decoder's few queries, else four; eight above head width 128
    and 128 rows, where the rows share the block's K and V tiles (instance
    256 is one block an SM by shared memory either way; at C 2,048 with 8
    heads, B 8, L 512: 0.2532 against 0.3562 ms, at L 128 0.0469 against
    0.0432; ``scripts/head256_rows.py``)."""
    if tq <= 16:
        return 1
    return 8 if head_dim > 128 and tq > 128 else 4


def smem_bytes_tc(tq: int, tk: int, c: int, num_heads: int) -> int:
    """Dynamic shared memory of one block of K1's tensor-core kernel (must
    match ``launch_tc_dh`` in ``csrc/graph_attention.cu``): the Q tile and
    two stages of K and V (64 keys), bf16 rows of the padded head width +
    8, and two f32 key-mask rows."""
    dh = c // num_heads
    width = tc_width(dh) + 8
    steps = -(-tk // KEY_CHUNK)
    return 2 * (16 * tc_warps(tq, dh) + 4 * KEY_CHUNK) * width + 4 * 2 * steps * KEY_CHUNK


def _simt_bwd_smem(rows: int, tk: int, c: int, dh: int) -> int:
    """Shared memory of a block of K2's SIMT rows launch of ``rows`` rows."""
    return 4 * (rows * c + 2 * rows * tk + rows * dh + KEY_CHUNK * (dh + 1) + rows * N_STATS)


def simt_bwd_rows(tq: int, tk: int, c: int, num_heads: int) -> int:
    """Query rows a block of K2's SIMT rows launch: ``min(16, tq)``, halved
    until its (rows, C) tile and two (rows, Tk) tiles fit (C 2,048 at 8
    heads and 512 keys: 8). A pure function of the shapes."""
    dh = c // num_heads
    return _fitting_rows(min(Q_TILE, tq), lambda rows: _simt_bwd_smem(rows, tk, c, dh))


def smem_bytes_bwd(tq: int, tk: int, c: int, num_heads: int) -> int:
    """Dynamic shared memory of one block of K2's first SIMT launch (the
    larger), at :func:`simt_bwd_rows` rows."""
    return _simt_bwd_smem(simt_bwd_rows(tq, tk, c, num_heads), tk, c, c // num_heads)


K2_PATHS = ("simt", "tensor-core", "f32")   # the C entries' path argument


def k2_path(dtype, head_dim: int, tk: "int | None" = None, c: "int | None" = None,
            num_heads: "int | None" = None) -> str:
    """Which of K2's designs a call takes: ``"tensor-core"`` for bfloat16 at
    head widths that are multiples of 16 up to ``TC_MAX_HEAD_DIM`` whose
    rows launch fits (given ``tk``, ``c`` and ``num_heads``; at C 2,048 with
    16 heads, and C 4,096 with 32, its 32 rows of C + 8 f32 and bf16 do
    not), ``"f32"`` for float32 at head widths that are multiples of 4 up to
    ``TC_MAX_HEAD_DIM`` (any C), ``"composed"`` for every other call that
    K5's and K6's tiled kernels take (bfloat16 at multiples of 16 up to
    ``K56_TC_MAX_HEAD_DIM``, 256, float32 at multiples of 4 up to 256:
    :func:`composed_o`'s forward, the LayerNorm backward at any C, then K5
    and K6), ``"wide"`` above head width ``SIMT_MAX_HEAD_DIM`` or where one
    row of the SIMT rows launch does not fit, else ``"simt"``. A pure
    function of the shapes."""
    if kernel_path(dtype, head_dim) == "tensor-core" and (
            c is None or smem_bytes_bwd_tc(tk, c, num_heads) <= SMEM_LIMIT):
        return "tensor-core"
    if f32_tiled(dtype, head_dim):
        return "f32"
    if head_dim <= K56_TC_MAX_HEAD_DIM and head_dim % (16 if dtype == torch.bfloat16 else 4) == 0:
        return "composed"
    if head_dim > SIMT_MAX_HEAD_DIM or (
            c is not None and _simt_bwd_smem(1, tk, c, head_dim) > SMEM_LIMIT):
        return "wide"
    return "simt"


def bwd_row_tile(dtype, head_dim: int, tq: int, tk: "int | None" = None,
                 c: "int | None" = None, num_heads: "int | None" = None) -> int:
    """Query rows per dgamma/dbeta partial of K2 (per block of its rows
    launch or of its f32 LayerNorm backward), by :func:`k2_path` (given
    ``tk``, ``c`` and ``num_heads``; without them the SIMT rows launch is
    taken to fit 16 rows)."""
    path = k2_path(dtype, head_dim, tk, c, num_heads)
    if path == "tensor-core":
        return BWD_TC_ROWS
    if path in ("f32", "wide", "composed"):
        return BWD_F32_ROWS
    return min(Q_TILE, tq) if c is None else simt_bwd_rows(tq, tk, c, num_heads)


def smem_bytes_bwd_f32(tq: int, c: int, num_heads: int) -> int:
    """Dynamic shared memory of the largest block of K2's f32 kernels (must
    match ``csrc/graph_attention_bwd.cu``): the forward (K4's f32 body), dQ
    and dK/dV, head widths rounded up to 32, 64 or 128, 16 query rows a
    block when Tq <= 16 (else 64), and the LayerNorm backward's (8, 2, C)
    up to C ``F32_LN_MAX_C`` (above it the LayerNorm backward keeps nothing
    of size C on chip)."""
    dh = c // num_heads
    w = next(x for x in (32, 64, 128) if dh <= x)
    rows = 16 if tq <= 16 else 64
    fwd = rows * w + 2 * (2 * 64 * w + rows * 64 + 64)
    dq = 2 * rows * w + 2 * (2 * 32 * w + rows * 32 + 32)
    dkv = 2 * 64 * w + 4 * 32 * 16 + 2 * (2 * 32 * w + 32 * 64 + 32 * N_STATS)
    return 4 * max(fwd, dq, dkv, 2 * 8 * c if c <= F32_LN_MAX_C else 0)


def smem_bytes_bwd_tc(tk: int, c: int, num_heads: int) -> int:
    """Dynamic shared memory of one block of K2's tensor-core rows launch
    (must match ``launch_tc`` in ``csrc/graph_attention_bwd.cu``)."""
    dh = c // num_heads
    width = next(w for w in (16, 32, 64, 128) if dh <= w) + 8
    ring = 2 * 4 * KEY_CHUNK * width
    steps = -(-tk // KEY_CHUNK)
    x_bytes = -(-max(4 * BWD_TC_ROWS * (c + 8), ring) // 16) * 16
    y_bytes = -(-max(2 * BWD_TC_ROWS * (c + 8), ring) // 16) * 16
    return (x_bytes + y_bytes + 2 * BWD_TC_ROWS * width
            + 4 * (2 * steps * KEY_CHUNK + (num_heads + 1) * BWD_TC_ROWS * 4))


def _check(q, k, v, key_mask, query_mask, graph, residual, gamma, beta,
           num_heads: int, renorm: str, dy=None) -> None:
    if q.dtype not in _DTYPES:
        raise TypeError(f"q/k/v/residual must be float32 or bfloat16, got {q.dtype}")
    if renorm not in RENORMS:
        raise ValueError(f"unknown renorm mode: {renorm!r}")
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError("q, k, v must be (B, T, C)")
    b, tq, c = q.shape
    tk = k.shape[1]
    if tk > MAX_KEYS:
        raise NotImplementedError(
            f"{tk} keys > {MAX_KEYS}: long sequences go through the flash kernel "
            "(K4, ops/flash_graph_attention.py), as the attention modules send them")
    if c % num_heads:
        raise ValueError("C must be divisible by num_heads")
    want = {
        "q": (q, (b, tq, c), q.dtype), "k": (k, (b, tk, c), q.dtype),
        "v": (v, (b, tk, c), q.dtype), "residual": (residual, (b, tq, c), q.dtype),
        "key_mask": (key_mask, (b, tk), torch.float32),
        "query_mask": (query_mask, (b, tq), torch.float32),
        "graph": (graph, (b, tq, tk), torch.float32),
        "gamma": (gamma, (c,), torch.float32), "beta": (beta, (c,), torch.float32),
    }
    if dy is not None:
        want["dy"] = (dy, (b, tq, c), q.dtype)
    for name, (t, shape, dtype) in want.items():
        if t is None:   # the model axis's entries take no residual or LayerNorm
            continue
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    dh = c // num_heads
    path = k1_path(q.dtype, dh, tk, c) if dy is None else k2_path(q.dtype, dh, tk, c, num_heads)
    if path == "wide":
        from structured_alignment_vqa_tpu_torch.ops import flash_graph_attention as flash

        flash.check_wide_grid(dh, num_heads)
        kernels = ("K4",) if dy is None else ("K4", "K5", "K6")
        need = max(flash.smem_bytes_wide(kn) if dh > SIMT_MAX_HEAD_DIM
                   else flash.smem_bytes_simt(kn, dh) for kn in kernels)
    elif path == "composed":
        from structured_alignment_vqa_tpu_torch.ops import flash_graph_attention as flash

        if q.dtype == torch.bfloat16:
            need = [smem_bytes_tc(tq, tk, c, num_heads)] + [
                flash.smem_bytes_k56_tc(kn, dh) for kn in ("K5", "K6")]
        else:
            q_tile = flash.k4_f32_plan(dh, b, num_heads, tq, tk)[0]
            need = [flash.smem_bytes_f32(dh, q_tile), flash.smem_bytes_dkv_f32(dh),
                    flash.smem_bytes_dq_f32(dh, 16 if tq <= 16 else 64)]
        need = max(need)
    elif dy is None and path == "tensor-core":
        need = smem_bytes_tc(tq, tk, c, num_heads)
    elif dy is None and path == "f32":
        need = smem_bytes_f32(tq, tk, c, num_heads)
    elif dy is None:
        need = smem_bytes(tq, tk, c, num_heads)
    elif path == "tensor-core":
        need = smem_bytes_bwd_tc(tk, c, num_heads)
    elif path == "f32":
        need = smem_bytes_bwd_f32(tq, c, num_heads)
    else:
        need = smem_bytes_bwd(tq, tk, c, num_heads)
    if need > SMEM_LIMIT:
        raise ValueError(f"shapes need {need} bytes of shared memory")


def _q_tile(path: str, b: int, tq: int, tk: int, c: int, num_heads: int) -> int:
    """The C entries' ``q_tile`` on K1's ``path``: the SIMT kernel's
    :func:`simt_rows`, the tensor-core kernel's 16 :func:`tc_warps` rows,
    the f32 kernel's :func:`f32_plan` rows."""
    if path == "simt":
        return simt_rows(tq, tk, c, num_heads)
    if path == "tensor-core":
        return 16 * tc_warps(tq, c // num_heads)
    return f32_plan(b, num_heads, tq, tk)[0]


def _launch(q, k, v, key_mask, query_mask, graph, residual, gamma, beta,
            num_heads: int, renorm: str, path: "str | None" = None) -> torch.Tensor:
    """K1's launch; ``path`` as :func:`_launch_heads`'s."""
    _check(q, k, v, key_mask, query_mask, graph, residual, gamma, beta, num_heads, renorm)
    b, tq, c = q.shape
    tk = k.shape[1]
    path = path or k1_path(q.dtype, c // num_heads, tk, c)
    if path == "wide":
        out = _attention_ln_call(_wide_o(q, k, v, key_mask, query_mask, graph, num_heads, renorm),
                                 residual, gamma, beta)
        fused_graph_attention_ln.launches += 1
        fused_graph_attention_ln.paths[path] += 1
        return out
    lib = _build.library("graph_attention")
    fn = lib.savqa_graph_attention_ln
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
    out = torch.empty_like(q)
    # the attention output, f32, before the residual and the LayerNorm (the
    # second kernel's input on the tensor-core and f32 paths)
    o = o_scratch(q, num_heads, path)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(),
            query_mask.data_ptr(), graph.data_ptr(), residual.data_ptr(),
            gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
            None if o is None else o.data_ptr(),
            b, tq, tk, c, num_heads, RENORMS.index(renorm), _DTYPES[q.dtype],
            K1_PATHS.index(path), _q_tile(path, b, tq, tk, c, num_heads),
            1.0 / (c // num_heads) ** 0.5, stream,
        )
    _build.check(status, "graph_attention_ln kernel")
    fused_graph_attention_ln.launches += 1
    fused_graph_attention_ln.paths[path] += 1
    return out


def _wide_o(q, k, v, key_mask, query_mask, graph, num_heads: int, renorm: str,
            stats: bool = False):
    """The wide path's forward: K1's attention output o (B, Tq, C) f32 (and
    with ``stats`` its m, z, b) by the wide K4 kernel."""
    from structured_alignment_vqa_tpu_torch.ops import flash_graph_attention as flash

    return flash.attention_o(q, k, v, key_mask, query_mask, graph, num_heads, renorm, stats)


def _wide_attention_bwd(q, k, v, key_mask, query_mask, graph, o, m, z, bsum, d_o,
                        num_heads: int, renorm: str):
    """The wide path's attention backward: K5's and K6's kernels from the
    gradient ``d_o`` of o (in q's dtype)."""
    from structured_alignment_vqa_tpu_torch.ops import flash_graph_attention as flash

    return flash.attention_o_backward(q, k, v, key_mask, query_mask, graph, o, m, z, bsum, d_o,
                                      num_heads, renorm)


def composed_o(q, k, v, key_mask, query_mask, graph, num_heads: int, renorm: str):
    """The forward of K2's composed route: K1's attention output o (B, Tq,
    C) float32 and the row statistics m, z, b (B, H, Tq) of a tiled
    kernel. bfloat16: K1's tensor-core kernel (``savqa_graph_attention_stats``:
    o as K1 forms it, weights rounded to bf16, and its pass A's m, z, b);
    float32: K4's register-tiled kernel with ``emit="stats"`` (its output
    is o: nothing is rounded in float32). Counted by the caller."""
    from structured_alignment_vqa_tpu_torch.ops import flash_graph_attention as flash

    if q.dtype == torch.float32:
        return flash._forward_call(q, k, v, key_mask, query_mask, graph, num_heads, renorm,
                                   flash.EMITS.index("stats"), True)
    b, tq, c = q.shape
    tk = k.shape[1]
    o = torch.empty(b, tq, c, dtype=torch.float32, device=q.device)
    stats = torch.empty(3, b, num_heads, tq, dtype=torch.float32, device=q.device)
    fn = _build.library("graph_attention").savqa_graph_attention_stats
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(),
                    query_mask.data_ptr(), graph.data_ptr(), o.data_ptr(), stats.data_ptr(),
                    b, tq, tk, c, num_heads, RENORMS.index(renorm),
                    16 * tc_warps(tq, c // num_heads), 1.0 / (c // num_heads) ** 0.5, stream)
    _build.check(status, "graph_attention_stats kernel")
    return (o, *stats.unbind(0))


def _launch_bwd_wide(q, k, v, key_mask, query_mask, graph, residual, gamma, beta, dy,
                     num_heads: int, renorm: str, row_tile: int, forward):
    """K2's wide and composed paths: o and its statistics (``forward``:
    :func:`_wide_o` or :func:`composed_o`), the LayerNorm backward at any C
    (``savqa_attention_ln_bwd``: dresidual = dO and the dgamma / dbeta
    partials of ``row_tile`` rows), then K5 and K6."""
    b, tq, c = q.shape
    o, m, z, bsum = forward(q, k, v, key_mask, query_mask, graph, num_heads, renorm)
    dres = torch.empty_like(q)
    partials = torch.empty(b * -(-tq // row_tile), 2, c, dtype=torch.float32, device=q.device)
    fn = _build.library("graph_attention_bwd").savqa_attention_ln_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = fn(o.data_ptr(), residual.data_ptr(), gamma.data_ptr(), dy.data_ptr(),
                    dres.data_ptr(), partials.data_ptr(), b, tq, c, _DTYPES[q.dtype], row_tile,
                    stream)
    _build.check(status, "attention_ln_bwd kernel")
    dq, dk, dv = _wide_attention_bwd(q, k, v, key_mask, query_mask, graph, o, m, z, bsum, dres,
                                     num_heads, renorm)
    sums = partials.sum(dim=0)
    return dq, dk, dv, dres, sums[0], sums[1]


def _route_forward(path: str):
    """The forward of K2's ``path`` "wide" or "composed": o and m, z, b."""
    if path == "composed":
        return composed_o
    return lambda *args: _wide_o(*args, stats=True)


def _launch_bwd(q, k, v, key_mask, query_mask, graph, residual, gamma, beta, dy,
                num_heads: int, renorm: str):
    _check(q, k, v, key_mask, query_mask, graph, residual, gamma, beta, num_heads, renorm, dy)
    b, tq, c = q.shape
    tk = k.shape[1]
    dh = c // num_heads
    path = k2_path(q.dtype, dh, tk, c, num_heads)
    row_tile = bwd_row_tile(q.dtype, dh, tq, tk, c, num_heads)
    if path in ("wide", "composed"):
        grads = _launch_bwd_wide(q, k, v, key_mask, query_mask, graph, residual, gamma, beta, dy,
                                 num_heads, renorm, row_tile, _route_forward(path))
        fused_graph_attention_ln_bwd.launches += 1
        fused_graph_attention_ln_bwd.paths[path] += 1
        _count_parts(fused_graph_attention_ln_bwd.parts)
        return grads
    lib = _build.library("graph_attention_bwd")
    fn = lib.savqa_graph_attention_ln_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
    tiles = -(-tq // row_tile)
    dq, dres = torch.empty_like(q), torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    # scratch passed between the launches: per-(batch, head, row) softmax
    # and renorm constants and, but for the tensor-core kernels, an f32
    # (B, Tq, C): dO widened to f32 for the bf16 SIMT keys launch, the
    # forward's output O for the f32 kernels (the tensor-core keys launch
    # reads the bf16 dresidual, the f32 ones the f32 dresidual);
    # per-tile dgamma/dbeta partials, summed here
    partials = torch.empty(b * tiles, 2, c, dtype=torch.float32, device=q.device)
    do = None
    if path != "tensor-core":
        do = torch.empty(b, tq, c, dtype=torch.float32, device=q.device)
    stats = torch.empty(b, num_heads, tq, N_STATS, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(),
            query_mask.data_ptr(), graph.data_ptr(), residual.data_ptr(),
            gamma.data_ptr(), dy.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dres.data_ptr(),
            partials.data_ptr(), None if do is None else do.data_ptr(), stats.data_ptr(),
            b, tq, tk, c, num_heads, RENORMS.index(renorm), _DTYPES[q.dtype],
            K2_PATHS.index(path), row_tile, 1.0 / dh ** 0.5, stream,
        )
    _build.check(status, "graph_attention_ln_bwd kernel")
    fused_graph_attention_ln_bwd.launches += 1
    fused_graph_attention_ln_bwd.paths[path] += 1
    sums = partials.sum(dim=0)
    return dq, dk, dv, dres, sums[0], sums[1]


def _count_parts(parts) -> None:
    """Count the K5 and K6 kernels the last wide or composed K2 route
    launched (their C entries' own report) into ``parts``."""
    from structured_alignment_vqa_tpu_torch.ops import flash_graph_attention as flash

    for kernel in ("K5", "K6"):
        parts[f"{kernel} {flash.last_paths[kernel]}"] += 1


def fused_graph_attention_ln_bwd(q, k, v, key_mask, query_mask, graph, residual,
                                 gamma, beta, dy, num_heads: int, renorm: str = "l1"):
    """Backward of :func:`fused_graph_attention_ln` given ``dy``, the
    gradient of its output: ``(dq, dk, dv, dresidual, dgamma, dbeta)``.

    On CUDA tensors one call launches K2 (two kernels of
    ``csrc/graph_attention_bwd.cu``, or the kernels of its composed or wide
    route, counted once); on CPU tensors it runs
    :func:`graph_attention_ln_bwd_plain`.
    """
    if not use_kernel(q):
        return graph_attention_ln_bwd_plain(q, k, v, key_mask, query_mask, graph, residual,
                                            gamma, beta, dy, num_heads, renorm)
    return _launch_bwd(q, k, v, key_mask, query_mask, graph, residual, gamma, beta,
                       dy.contiguous(), num_heads, renorm)


fused_graph_attention_ln_bwd.launches = 0
fused_graph_attention_ln_bwd.paths = collections.Counter()   # launches by k2_path
# the K5 and K6 kernels the wide and composed routes launched ("K5 tensor-core", ...)
fused_graph_attention_ln_bwd.parts = collections.Counter()


class _FusedGraphAttentionLN(torch.autograd.Function):
    """K1 as an autograd node whose backward is K2.

    The forward saves its inputs only: the backward recomputes the forward,
    as the TPU kernel does, so nothing of size (B, H, Tq, Tk) is kept."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, query_mask, graph, residual, gamma, beta,
                num_heads, renorm):
        ctx.save_for_backward(q, k, v, key_mask, query_mask, graph, residual, gamma, beta)
        ctx.num_heads, ctx.renorm = num_heads, renorm
        if not use_kernel(q):
            return graph_attention_ln_plain(q, k, v, key_mask, query_mask, graph, residual,
                                            gamma, beta, num_heads, renorm)
        return _launch(q, k, v, key_mask, query_mask, graph, residual, gamma, beta,
                       num_heads, renorm)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, key_mask, query_mask, graph, residual, gamma, beta = ctx.saved_tensors
        dq, dk, dv, dres, dgamma, dbeta = fused_graph_attention_ln_bwd(
            q, k, v, key_mask, query_mask, graph, residual, gamma, beta, grad_out,
            ctx.num_heads, ctx.renorm)
        return dq, dk, dv, None, None, None, dres, dgamma, dbeta, None, None


def fused_graph_attention_ln(q, k, v, key_mask, query_mask, graph, residual,
                             gamma, beta, num_heads: int, renorm: str = "l1"):
    """Graph attention + residual + reference LayerNorm, differentiable.

    q: (B, Tq, C); k, v: (B, Tk, C); residual: (B, Tq, C), all one dtype;
    key_mask (B, Tk), query_mask (B, Tq), graph (B, Tq, Tk), gamma and beta
    (C,) float32. Returns (B, Tq, C) in q's dtype. The masks and the graph
    get no gradient.
    """
    return _FusedGraphAttentionLN.apply(q, k, v, key_mask, query_mask, graph, residual,
                                       gamma, beta, num_heads, renorm)


fused_graph_attention_ln.launches = 0
fused_graph_attention_ln.paths = collections.Counter()   # launches by k1_path


# ---- the model axis ----------------------------------------------------------

def _launch_heads(q, k, v, key_mask, query_mask, graph, num_heads: int,
                  renorm: str, path: "str | None" = None) -> torch.Tensor:
    """The attention-only entry's launch; ``path`` (one of ``K1_PATHS``)
    runs a kernel other than :func:`k1_path`'s where it takes the shape:
    "simt" takes every shape whose row fits, which lets a check hold the
    f32 kernel to the first SIMT kernel bit for bit."""
    _check(q, k, v, key_mask, query_mask, graph, None, None, None, num_heads, renorm)
    b, tq, c = q.shape
    tk = k.shape[1]
    dh = c // num_heads
    path = path or k1_path(q.dtype, dh, tk, c)
    if path == "wide":
        o = _wide_o(q, k, v, key_mask, query_mask, graph, num_heads, renorm)
        graph_attention_heads.launches += 1
        return o
    lib = _build.library("graph_attention")
    fn = lib.savqa_graph_attention
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
    o = torch.empty(b, tq, c, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(),
                    query_mask.data_ptr(), graph.data_ptr(), o.data_ptr(), b, tq, tk, c,
                    num_heads, RENORMS.index(renorm), _DTYPES[q.dtype], K1_PATHS.index(path),
                    _q_tile(path, b, tq, tk, c, num_heads), 1.0 / dh ** 0.5, stream)
    _build.check(status, "graph_attention kernel")
    graph_attention_heads.launches += 1
    return o


def _launch_heads_bwd(q, k, v, key_mask, query_mask, graph, do, num_heads: int,
                      renorm: str):
    _check(q, k, v, key_mask, query_mask, graph, None, None, None, num_heads, renorm, do)
    b, tq, c = q.shape
    tk = k.shape[1]
    dh = c // num_heads
    path = k2_path(q.dtype, dh, tk, c, num_heads)
    if path in ("wide", "composed"):
        o, m, z, bsum = _route_forward(path)(q, k, v, key_mask, query_mask, graph, num_heads,
                                             renorm)
        grads = _wide_attention_bwd(q, k, v, key_mask, query_mask, graph, o, m, z, bsum, do,
                                    num_heads, renorm)
        graph_attention_heads_bwd.launches += 1
        return grads
    lib = _build.library("graph_attention_bwd")
    fn = lib.savqa_graph_attention_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
    tensor_cores = path == "tensor-core"
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # scratch between the launches: the row constants and, but for the
    # tensor-core kernels, an f32 (B, Tq, C): dO widened to f32 for the bf16
    # SIMT kernels, the forward's output O for the f32 ones
    dout = None if tensor_cores else torch.empty(b, tq, c, dtype=torch.float32,
                                                 device=q.device)
    stats = torch.empty(b, num_heads, tq, N_STATS, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(),
                    query_mask.data_ptr(), graph.data_ptr(), do.data_ptr(), dq.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), None if dout is None else dout.data_ptr(),
                    stats.data_ptr(), b, tq, tk, c, num_heads, RENORMS.index(renorm),
                    _DTYPES[q.dtype], K2_PATHS.index(path),
                    bwd_row_tile(q.dtype, dh, tq, tk, c, num_heads), 1.0 / dh ** 0.5, stream)
    _build.check(status, "graph_attention_bwd kernel")
    graph_attention_heads_bwd.launches += 1
    return dq, dk, dv


def graph_attention_heads_bwd(q, k, v, key_mask, query_mask, graph, do, num_heads: int,
                              renorm: str = "l1"):
    """Backward of :func:`graph_attention_heads` given ``do``, the gradient
    of its output (rounded to q's dtype, as K2 rounds dO): ``(dq, dk,
    dv)``. One launch of K2's from-d(o) entry on CUDA tensors
    (``csrc/graph_attention_bwd.cu:savqa_graph_attention_bwd``)."""
    do = do.to(q.dtype).contiguous()
    if not use_kernel(q):
        return graph_attention_bwd_plain(q, k, v, key_mask, query_mask, graph, do, num_heads,
                                         renorm)
    return _launch_heads_bwd(q, k, v, key_mask, query_mask, graph, do, num_heads, renorm)


graph_attention_heads_bwd.launches = 0


class _GraphAttentionHeads(torch.autograd.Function):
    """K1's attention output of the heads given, whose backward is K2 from
    d(o); the inputs are saved and the forward recomputed, as in K2."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, query_mask, graph, num_heads, renorm):
        ctx.save_for_backward(q, k, v, key_mask, query_mask, graph)
        ctx.num_heads, ctx.renorm = num_heads, renorm
        if not use_kernel(q):
            return graph_attention_plain(q, k, v, key_mask, query_mask, graph, num_heads, renorm)
        return _launch_heads(q, k, v, key_mask, query_mask, graph, num_heads, renorm)

    @staticmethod
    def backward(ctx, grad_out):
        dq, dk, dv = graph_attention_heads_bwd(*ctx.saved_tensors, grad_out, ctx.num_heads,
                                               ctx.renorm)
        return dq, dk, dv, None, None, None, None, None


def graph_attention_heads(q, k, v, key_mask, query_mask, graph, num_heads: int,
                          renorm: str = "l1"):
    """The graph attention of ``num_heads`` heads, before any residual or
    LayerNorm: (B, Tq, C) float32, differentiable (shapes and dtypes as
    :func:`fused_graph_attention_ln`'s, no residual, gamma or beta). On the
    model axis C and the heads are this rank's. One launch of
    ``csrc/graph_attention.cu:savqa_graph_attention`` on CUDA tensors."""
    return _GraphAttentionHeads.apply(q, k, v, key_mask, query_mask, graph, num_heads, renorm)


graph_attention_heads.launches = 0


def _launch_attention_ln(o, residual, gamma, beta) -> torch.Tensor:
    c = residual.shape[-1]
    if residual.dtype not in _DTYPES:
        raise TypeError(f"residual must be float32 or bfloat16, got {residual.dtype}")
    for name, t, shape, dtype in (("o", o, tuple(residual.shape), torch.float32),
                                  ("gamma", gamma, (c,), torch.float32),
                                  ("beta", beta, (c,), torch.float32)):
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != residual.device:
            raise ValueError(f"{name}: expected {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
    out = _attention_ln_call(o, residual, gamma, beta)
    attention_ln.launches += 1
    return out


def _attention_ln_call(o, residual, gamma, beta) -> torch.Tensor:
    """One launch of K1's LayerNorm kernel (any C), counted by the caller."""
    c = residual.shape[-1]
    lib = _build.library("graph_attention")
    fn = lib.savqa_attention_ln
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    out = torch.empty_like(residual)
    with torch.cuda.device(residual.device):
        stream = torch.cuda.current_stream(residual.device).cuda_stream
        status = fn(o.data_ptr(), residual.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                    out.data_ptr(), residual.numel() // c, c, _DTYPES[residual.dtype], stream)
    _build.check(status, "attention_ln kernel")
    return out


class _AttentionLN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, o, residual, gamma, beta):
        ctx.save_for_backward(o, residual, gamma, beta)
        if not use_kernel(residual):
            return attention_ln_plain(o, residual, gamma, beta)
        return _launch_attention_ln(o, residual, gamma, beta)

    @staticmethod
    def backward(ctx, grad_out):
        return composite_backward(attention_ln_plain, ctx, grad_out)


def attention_ln(o, residual, gamma, beta):
    """``LN(o + residual)`` (the reference LayerNorm) in f32, in the
    residual's dtype, differentiable: o (..., C) f32, residual (..., C) f32
    or bf16, gamma and beta (C,) f32. One launch of K1's epilogue kernel
    (``csrc/graph_attention.cu:savqa_attention_ln``) on CUDA tensors."""
    return _AttentionLN.apply(o.contiguous(), residual.contiguous(), gamma, beta)


attention_ln.launches = 0
