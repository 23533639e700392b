"""Flash-style (K-blocked) graph-guided attention for long sequences: the
forward (K4) and its backward (K5: dQ, K6: dK and dV).

Counterpart of the TPU package's ``ops/pallas_flash_attention.py``
(``_kernel``, ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``, entry
``flash_graph_attention``). :func:`fused_graph_attention_ln` holds a whole
(rows, Tk) score tile on chip and takes at most 512 keys; the obj+rel
model's symbolic encoder runs at 1,536. Here the keys stream past a running
maximum m, and with

    e_j = exp(s_j - m),  z = sum e_j,  b = sum e_j g_j,  a = sum e_j g_j v_j

the softmax normaliser cancels between the weights and their renorm:

    l1:      out = a / max(b, 1e-12 z)
    sum_eps: out = a / (b + 1e-7 z)

so one pass suffices and no (Tq, Tk) tensor reaches device memory. The
backward recomputes score tiles from the saved per-row m, z, b (the formulas
are in :func:`flash_graph_attention_bwd_plain`). Residual and LayerNorm are
not part of these kernels; the attention module applies them.

On CUDA tensors the wrappers launch the kernels of
``csrc/flash_graph_attention.cu`` and ``csrc/flash_graph_attention_bwd.cu``;
on CPU tensors they run the plain PyTorch versions beside them, which round
where the kernels round. Keys are exactly the Tk given (the TPU wrapper pads
them to its tile with masked keys, which add to z on rows whose real keys
are all masked; ``out`` and the gradients are the same).

K4, K5 and K6 each have two kernels (:func:`k4_path`; K5's and K6's
:func:`k56_path`). bfloat16 with a head width that is a multiple of 16
(K4: any; K5 and K6: up to 256) runs on the tensor cores:
``mma.sync`` for every product on bf16 tiles that ``cp.async`` streams
through a two-stage ring, one warp per 16 query rows (K4, K5) or 16 keys
(K6), the weights or dS passed from one product to the next in registers
(K5 and K6 round dS and n to bf16 there; the plain versions round them
alike). When the query tiles do not fill the card (the decoder's one query
into 1,536 keys) K4 and K5 split the keys over more blocks
(:func:`key_split`); each block writes its raw ``(a, m, z, b)`` (K4) or its
f32 partial dQ (K5) to scratch and a second small kernel merges them
(:func:`merge_partials_plain` and :func:`sum_dq_shards_plain` are their
plain versions). One call counts as one launch whatever the split.
K4 in float32 runs FFMA on the CUDA cores in the tensor-core
kernel's shape: 64 query rows a block (16 when Tq <= 16), K, V, the graph
tile and the key mask through a two-stage ``cp.async`` ring, a 4 x 8 tile
of scores a lane, and a key split of four steps a shard when the blocks do
not fill the card (:func:`f32_plan`); an unsplit call gives the first f32
kernel's bits. K6 in float32 runs FFMA in the walk of K2's float32 dkv
kernel: 64 keys a block (16 a warp), the query rows 32 a step with Q, dO,
the graph tile and the rows' m, z, b, delta through a two-stage
``cp.async`` ring, S^T and dN^T as 4 x 4 tiles a lane, dV and dK through
the warp's transposed tile; it sums every score and every dK, dV entry in
the first f32 kernel's order and gives its bits. K5 in float32 runs FFMA
in the walk of K2's float32 dq kernel: 64 query rows a block (16 when Tq <=
16), Q and dO staged once, the keys 32 a step with K, V, the graph tile and
the key mask through a two-stage ``cp.async`` ring, S and dN as 4 x 4
tiles a lane, dQ through the warp's transposed tile; when the blocks do
not fill the card its keys split into shards of four steps
(:func:`dq_f32_plan`) whose f32 partials the shard-sum kernel adds. An
unsplit call sums every score and every dQ entry in the first f32 kernel's
order and gives its bits. Above head width 128 (instance 256) K5's and
K6's registers would not hold a warp's 16 x 256 accumulators beside its
operands, so two warps share the work of one (pairs of warps, the scores
passed between them through shared memory; ``csrc/flash_graph_attention_bwd.cu``):
bfloat16 K6 splits dV from dK, K5 splits dQ's channels; float32 K6 splits
dV from dK over 32 keys a block, and K5 in float32 takes 16-key steps. K4
above head width 128 keeps these designs:
bfloat16 in the tensor-core kernel's instance 256 (Q in a room of shared
memory of its own; 128 rows a block above 64 rows, :func:`tc_rows`),
float32 in instance 256 of its f32 kernel (32-key steps), and above 256
their chunked forms ("tc-chunked", "f32-chunked": a head's output channels
in chunks of ``WIDE_CHUNK`` over blocks, Q and K streamed through the ring
128 or 64 channels a unit, the scores computed once per chunk, 128 rows a
block). Every other call keeps the first SIMT kernels (f32 FMAs, no
split), in either dtype: bfloat16 at a head width that is no multiple of
16, float32 at a head width that is no multiple of 4 (:func:`k4_path`,
:func:`dq_kernel` and
:func:`dkv_kernel` name K4's, K5's and K6's kernel for a call). They stage rows of the head
width rounded up to 4, the columns past it zero, and take head widths up to
``SIMT_MAX_HEAD_DIM`` (256: K5's blocks and K6's steps then hold 32 query
rows, not 64, to fit their shared memory). TF32 products would not hold the
1e-4 the float32 path is checked to.

Head widths above 256 take the wide kernels ("wide", in either dtype; K4
only at widths its chunked kernels do not take): a head's output channels
are cut into chunks of ``WIDE_CHUNK`` (256) over
blocks, grid (tile, head x chunk, batch), and each block streams the whole
head width through shared memory 64 channels at a time for its scores and
dN, so the scores are recomputed ceil(dh / 256) times. The same wide forward
with ``emit`` 3 (:func:`attention_o`: K1's weights in a second pass over
the keys, K1's f32 output) and the wide K5 and K6
(:func:`attention_o_backward`) serve K1's and K2's wide path
(``ops/fused_graph_attention.py``). No kernel has an upper bound on C;
their C entries never had one.
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
    SM_COUNT,
    kernel_path,  # noqa: F401  (K2's; the module's callers read it here)
    tc_width,
    use_kernel,
)
from structured_alignment_vqa_tpu_torch.ops.fused_graph_attention import (
    L1_NORM_EPS,
    RENORMS,
    SUM_NORM_EPS,
)
from structured_alignment_vqa_tpu_torch.ops.layers import NEG_MASK_VALUE

EMITS = ("out", "stats", "partial")
# the C entry's kernels by code (savqa_flash_graph_attention_last_path)
C_PATHS = ("simt", "wide", "tensor-core", "tc-chunked", "f32", "f32-chunked")
# K5's and K6's entries' kernels by code (savqa_flash_graph_attention_bwd_last_path)
C_PATHS_K56 = ("simt", "wide", "tensor-core", "f32")
EMIT_O = 3           # the C entry's emit of the f32 output (the wide kernel, K1's and K2's wide path)
WIDE_CHUNK = 256     # output channels a block of the wide kernels
MAX_GRID_Y = 65535   # the wide kernels' blocks of (head x chunk) along the grid's y
KEY_STEP = 64        # keys a block walks per step (both K4 kernels)
TC_Q_TILE = 64       # query rows per block of the tensor-core kernel (kTcWarps x 16)
F32_SPLIT_STEPS = 4  # key steps a shard of the f32 kernel, when it splits
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _heads(x, num_heads: int):
    """(B, T, C) -> (B, H, T, C/H), head h owning channels [h*dh, (h+1)*dh)."""
    b, t, c = x.shape
    return x.reshape(b, t, num_heads, c // num_heads).transpose(1, 2)


def _merge(x):
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def _masked_scores(q, k, key_mask, num_heads: int):
    dh = q.shape[-1] // num_heads
    scores = torch.matmul(_heads(q.float(), num_heads),
                          _heads(k.float(), num_heads).transpose(-1, -2)) * (1.0 / dh ** 0.5)
    return scores.masked_fill(key_mask[:, None, None, :] == 0, NEG_MASK_VALUE)


def flash_graph_attention_plain(q, k, v, key_mask, query_mask, graph, num_heads: int,
                                renorm: str = "l1", emit: str = "out"):
    """Plain PyTorch version of K4.

    ``emit="out"``: out (B, Tq, C) in q's dtype. ``"stats"``: ``(out, m, z,
    b)`` with the per-row statistics (B, H, Tq) float32. ``"partial"``:
    ``(a, m, z, b)`` with the raw accumulator a (B, H, Tq, C/H) float32, no
    division and no query mask. The weights e*g are rounded to V's dtype
    before they meet V, as in the kernel; sums are float32.
    """
    if renorm not in RENORMS:
        raise ValueError(f"unknown renorm mode: {renorm!r}")
    if emit not in EMITS:
        raise ValueError(f"unknown emit mode: {emit!r}")
    scores = _masked_scores(q, k, key_mask, num_heads)
    m = scores.amax(dim=-1)
    e = torch.exp(scores - m[..., None])
    eg = e * graph.float()[:, None]
    z, bsum = e.sum(dim=-1), eg.sum(dim=-1)
    a = torch.matmul(eg.to(v.dtype).float(), _heads(v.float(), num_heads))
    if emit == "partial":
        return a, m, z, bsum
    out = _renormalise(a, z, bsum, query_mask, renorm, q.dtype)
    return out if emit == "out" else (out, m, z, bsum)


def _renormalise(a, z, bsum, query_mask, renorm: str, dtype):
    """out (B, Tq, C) from the raw accumulator and the row sums."""
    if renorm == "l1":
        denom = torch.maximum(bsum, L1_NORM_EPS * z)
    else:
        denom = bsum + SUM_NORM_EPS * z
    out = a / denom[..., None] * query_mask.float()[:, None, :, None]
    return _merge(out).to(dtype)


def merge_partials_plain(a, m, z, bsum):
    """Plain PyTorch version of the kernel that merges K4's key shards.

    ``a`` (S, B, H, Tq, dh) and ``m``, ``z``, ``bsum`` (S, B, H, Tq) hold the
    ``emit="partial"`` results of S shards of the keys; returns the
    ``(a, m, z, b)`` of all keys together: ``m = max m_i``, ``c_i = exp(m_i
    - m)``, sums of ``c_i (z_i, b_i, a_i)`` in shard order. A shard that saw
    no key has ``m_i = -inf`` and counts nothing.
    """
    m_all = m.amax(dim=0)
    c = torch.where(torch.isinf(m) & (m < 0), torch.zeros_like(m), torch.exp(m - m_all))
    return (a * c[..., None]).sum(dim=0), m_all, (z * c).sum(dim=0), (bsum * c).sum(dim=0)


def key_split(batch: int, num_heads: int, tq: int, tk: int, q_tile: int = TC_Q_TILE) -> tuple:
    """``(n_split, steps_per_split)`` of the tensor-core kernel: how many
    shards the ``ceil(tk / 64)`` key steps are cut into, and the steps of
    each. A pure function of the shapes: 1 shard when the (batch, head,
    ``q_tile``-row query tile) blocks alone cover the card's 132 SMs, else
    enough shards for about two blocks an SM, none of them empty."""
    blocks = batch * num_heads * -(-tq // q_tile)
    steps = -(-tk // KEY_STEP)
    if blocks >= SM_COUNT:
        return 1, steps
    want = min(steps, -(-2 * SM_COUNT // blocks))
    per = -(-steps // want)
    return -(-steps // per), per


def k4_path(dtype, head_dim: int) -> str:
    """Which of K4's kernels a call takes: ``"tensor-core"`` (bfloat16 at
    head widths that are multiples of 16 up to ``K14_TC_MAX_HEAD_DIM``,
    256), ``"tc-chunked"`` (bfloat16 at multiples of 16 above 256: the
    tensor-core kernel's chunked form, output channels in chunks of 256
    over blocks), ``"f32"`` (the register-tiled FFMA kernel: float32 at
    multiples of 4 up to 256), ``"f32-chunked"`` (float32 at multiples of 4
    above 256: its chunked form), ``"wide"`` (every other head width above
    ``SIMT_MAX_HEAD_DIM``, either dtype) or ``"simt"`` (the first SIMT
    kernel: every other call, either dtype). K5 and K6 keep their own limit
    (:func:`k56_path`)."""
    if dtype == torch.bfloat16 and head_dim % 16 == 0:
        return "tensor-core" if head_dim <= K14_TC_MAX_HEAD_DIM else "tc-chunked"
    if dtype == torch.float32 and head_dim % 4 == 0:
        return "f32" if head_dim <= K14_TC_MAX_HEAD_DIM else "f32-chunked"
    return "wide" if head_dim > SIMT_MAX_HEAD_DIM else "simt"


def k56_path(dtype, head_dim: int) -> str:
    """Which of K5's and K6's kernels a call takes: ``"tensor-core"``
    (bfloat16 at multiples of 16 up to ``K56_TC_MAX_HEAD_DIM``, 256; above
    128 the pair kernels of instance 256, head widths 144-240 with their
    upper channels staged as zeros), ``"f32"`` (float32 at multiples of 4
    up to 256, instance 256 above 128), ``"wide"`` above
    ``SIMT_MAX_HEAD_DIM``, else ``"simt"``."""
    if dtype == torch.bfloat16 and head_dim % 16 == 0 and head_dim <= K56_TC_MAX_HEAD_DIM:
        return "tensor-core"
    if dtype == torch.float32 and head_dim % 4 == 0 and head_dim <= K56_TC_MAX_HEAD_DIM:
        return "f32"
    return "wide" if head_dim > SIMT_MAX_HEAD_DIM else "simt"


F32_WIDTHS = (32, 64, 128, 256)      # the f32 kernel's instances
CHUNK_ROWS = 128    # query rows a block of the chunked kernels (8 warps)
CHUNK_DC = 128      # channels of Q and K a unit of the chunked tensor-core kernel stages
F32_CHUNK_DC = 64   # the same of the chunked f32 kernel


def smem_bytes_tc_chunked() -> int:
    """Dynamic shared memory of one block of K4's chunked tensor-core kernel
    (must match ``chunk_slot_bytes`` in ``csrc/flash_graph_attention.cu``),
    the same at every head width: two slots of V's chunk (64, 264) bf16, the
    key mask, and K's (64 keys) and Q's (128 rows) 128 channels (+ 8) bf16;
    the graph is read in fragments."""
    slot = (2 * KEY_STEP * (WIDE_CHUNK + 8) + 4 * KEY_STEP
            + 2 * (KEY_STEP + CHUNK_ROWS) * (CHUNK_DC + 8))
    return 2 * slot


def smem_bytes_f32_chunked() -> int:
    """Dynamic shared memory of one block of K4's chunked f32 kernel (must
    match ``f32_chunk_slot_floats`` in ``csrc/flash_graph_attention.cu``),
    the same at every head width: two slots of Q's and K's 64 channels (128
    rows, 32 keys), V's chunk (32 keys x 256), the (128, 32) graph tile and
    the key mask, f32."""
    step = KEY_STEP // 2
    slot = ((CHUNK_ROWS + step) * F32_CHUNK_DC + step * WIDE_CHUNK + CHUNK_ROWS * step
            + step)
    return 4 * 2 * slot


def smem_bytes_tc(head_dim: int, q_tile: int = TC_Q_TILE) -> int:
    """Dynamic shared memory of one block of K4's tensor-core kernel (must
    match ``tc_smem_bytes`` in ``csrc/flash_graph_attention.cu``): two
    stages of K and V (64 keys, bf16 rows of the instance's width + 8), the
    (q_tile, 72) f32 graph tile (none above width 128 at 128 rows: read in
    fragments) and the key mask; above width 128 the Q tile's own room."""
    w = tc_width(head_dim)
    graph = 0 if w > 128 and q_tile > TC_Q_TILE else q_tile * (KEY_STEP + 8)
    stage = 2 * 2 * KEY_STEP * (w + 8) + 4 * (graph + KEY_STEP)
    return 2 * stage + (2 * q_tile * (w + 8) if w > 128 else 0)


def f32_step(head_dim: int) -> int:
    """Keys a step of K4's float32 kernel: 64, 32 above head width 128
    (must match ``f32_step`` in ``csrc/flash_graph_attention.cu``)."""
    return KEY_STEP if head_dim <= 128 else KEY_STEP // 2


def wide_chunks(head_dim: int) -> int:
    """The chunks of ``WIDE_CHUNK`` output channels a head takes in the wide
    kernels: their scores are computed this many times."""
    return -(-head_dim // WIDE_CHUNK)


def smem_bytes_wide(kernel: str) -> int:
    """Dynamic shared memory of one block of the wide kernel of ``kernel``
    ("K4", "K5" or "K6"; must match ``wide_smem_bytes``,
    ``dq_wide_smem_bytes`` and ``dkv_wide_smem_bytes`` in ``csrc/``), the
    same at every head width: rows of 64 channels (+ 4) for the scores, of
    256 (+ 4) for the block's chunk. K4: Q, K (64 rows each), V's chunk, the
    weights (64, 68), the key mask; K5: Q, dO, K, V, K's chunk, dS, the key
    mask; K6: K, V (64 keys), Q, dO (32 rows), Q's and dO's chunks, n and dS
    (32, 68), the key mask, 20 bytes of row terms a row."""
    score, chunk, p = 4 * (KEY_STEP + 4), 4 * (WIDE_CHUNK + 4), 4 * (KEY_STEP + 4)
    if kernel == "K4":
        return 2 * 64 * score + 64 * chunk + 64 * p + 4 * KEY_STEP
    if kernel == "K5":
        return 4 * 64 * score + 64 * chunk + 64 * p + 4 * KEY_STEP
    rows = 32
    return (2 * 64 + 2 * rows) * score + 2 * rows * chunk + 2 * rows * p + 4 * KEY_STEP + 20 * rows


def simt_rows(head_dim: int) -> int:
    """Query rows of a block of K4's and K5's SIMT kernels and of a step of
    K6's: 64 at K4 (whatever the head width), 64 up to head width 128 and 32
    above at K5 and K6, whose four (rows, head width) tiles would pass the
    shared memory a block may use at 64."""
    return SIMT_Q_TILE if head_dim <= 128 else SIMT_Q_TILE // 2


def smem_bytes_simt(kernel: str, head_dim: int) -> int:
    """Dynamic shared memory of one block of the SIMT kernel of ``kernel``
    ("K4", "K5" or "K6"; must match ``launch_ndh``, ``launch_dq_ndh`` and
    ``launch_dkv_ndh``): rows of the head width rounded up to 4, plus 4.
    K4: Q (64 rows), K, V (64 keys), the weights (64, 68) and the key mask;
    K5: Q and dO (rows), K, V, dS (rows, 68) and the key mask; K6: K, V, Q
    and dO, n and dS (rows, 68), the key mask and 20 bytes of row terms a
    row."""
    ld = -(-head_dim // 4) * 4 + 4
    if kernel == "K4":
        return 4 * ((SIMT_Q_TILE + 2 * KEY_STEP) * ld + SIMT_Q_TILE * (KEY_STEP + 4) + KEY_STEP)
    rows = simt_rows(head_dim)
    if kernel == "K5":
        return 4 * ((2 * rows + 2 * KEY_STEP) * ld + rows * (KEY_STEP + 4) + KEY_STEP)
    return 4 * ((2 * rows + 2 * KEY_STEP) * ld + 2 * rows * (KEY_STEP + 4) + KEY_STEP) + 20 * rows


def f32_plan(batch: int, num_heads: int, tq: int, tk: int, step: int = KEY_STEP,
             rows: int = 64) -> tuple:
    """``(q_tile, n_split, steps_per_split)`` of K4's float32 kernel, a pure
    function of the shapes: ``rows`` query rows a block (64, 4 warps; 128, 8
    warps, on the chunked kernel; 16 rows, one warp, when ``tq <= 16``), and
    when the (head, query tile, batch) blocks do not cover the card's 132
    SMs the ``ceil(tk / step)`` key steps (``step``: :func:`f32_step`) cut
    into shards of ``F32_SPLIT_STEPS`` steps (fewer steps: one shard of them
    all). The shards do not depend on the head count, so a model rank's 4
    heads sum each head's keys as one process's 8 heads do."""
    q_tile = 16 if tq <= 16 else rows
    blocks = batch * num_heads * -(-tq // q_tile)
    steps = -(-tk // step)
    if blocks >= SM_COUNT:
        return q_tile, 1, steps
    per = min(F32_SPLIT_STEPS, steps)
    return q_tile, -(-steps // per), per


def smem_bytes_f32(head_dim: int, q_tile: int) -> int:
    """Dynamic shared memory of one block of K4's float32 kernel (must
    match ``savqa_f32::flash_smem_floats``): the Q tile, then two stages of
    K, V (:func:`f32_step` keys), the graph tile and the key mask, head
    widths rounded up to 32, 64, 128 or 256."""
    width = next(w for w in F32_WIDTHS if head_dim <= w)
    step = f32_step(width)
    stage = 2 * step * width + q_tile * step + step
    return 4 * (q_tile * width + 2 * stage)


DKV_F32_KEYS = 64   # keys a block of K6's float32 kernel, 16 a warp (32 at instance 256)
DKV_F32_ROWS = 32   # query rows a step


def dkv_kernel(dtype, head_dim: int) -> str:
    """Which of K6's kernels a call takes (:func:`k56_path`): the
    tensor-core, the register-tiled f32, the first SIMT or the wide
    kernel."""
    return k56_path(dtype, head_dim)


def smem_bytes_dkv_f32(head_dim: int) -> int:
    """Dynamic shared memory of one block of K6's float32 kernel (must
    match ``dkv_f32_smem_floats`` and, at instance 256,
    ``dkv_f32_pair_smem_floats`` in ``csrc/flash_graph_attention_bwd.cu``):
    K and V (64 keys; 32 at 256), the warps' transposed (32, 16) tiles (at
    256 also the two pairs' exchange of 32 lanes x 16 scores), then two
    stages of Q, dO (32 rows), the (32, keys) graph tile and the rows' m,
    z, b, delta; head widths rounded up to 32, 64, 128 or 256."""
    width = next(w for w in F32_WIDTHS if head_dim <= w)
    keys = DKV_F32_KEYS if width <= 128 else DKV_F32_KEYS // 2
    stage = 2 * DKV_F32_ROWS * width + DKV_F32_ROWS * keys + 4 * DKV_F32_ROWS
    exchange = 0 if width <= 128 else 2 * 32 * 16
    return 4 * (2 * keys * width + 4 * DKV_F32_ROWS * 16 + exchange + 2 * stage)


def smem_bytes_k56_tc(kernel: str, head_dim: int) -> int:
    """Dynamic shared memory of one block of K5's ("K5") or K6's ("K6")
    tensor-core kernel (must match ``dq_stage_bytes`` / ``dkv_stage_bytes``
    and, at instance 256, ``dq_pair_smem_bytes`` / ``dkv_pair_smem_bytes``
    in ``csrc/flash_graph_attention_bwd.cu``): two stages of bf16 (64,
    width + 8) tiles (K and V; Q and dO), the f32 graph tile (64 x 72;
    64 x 68) and the key mask or the rows' 32-byte terms; at 256 the pairs'
    exchange (8 warps x 32 lanes x 16 f32, twice; 4 pairs x 32 x 8,
    twice)."""
    width = tc_width(head_dim)
    bf16_tiles = 2 * 2 * KEY_STEP * (width + 8)
    if kernel == "K5":
        stage = bf16_tiles + 4 * (KEY_STEP * (KEY_STEP + 8) + KEY_STEP)
        exchange = 2 * 8 * 32 * 16 * 4
    else:
        stage = bf16_tiles + 4 * KEY_STEP * (KEY_STEP + 4) + 32 * KEY_STEP
        exchange = 2 * 4 * 32 * 8 * 4
    return 2 * stage + (exchange if width > 128 else 0)


DQ_PATHS = ("simt", "tensor-core", "f32", "wide")   # the C entry's path argument (K5)
DQ_F32_STEP = 32    # keys a step of K5's float32 kernel (16 at instance 256: dq_f32_step)
SIMT_Q_TILE = 64    # query rows a block of the first SIMT kernels


def dq_kernel(dtype, head_dim: int) -> str:
    """Which of K5's kernels a call takes (:func:`k56_path`)."""
    return k56_path(dtype, head_dim)


def dq_f32_step(head_dim: int) -> int:
    """Keys a step of K5's float32 kernel: 32, 16 above head width 128
    (must match ``dq_f32_step`` in ``csrc/flash_graph_attention_bwd.cu``)."""
    return DQ_F32_STEP if head_dim <= 128 else DQ_F32_STEP // 2


def dq_f32_plan(batch: int, num_heads: int, tq: int, tk: int, head_dim: int = 64) -> tuple:
    """``(q_tile, n_split, steps_per_split)`` of K5's float32 kernel, a pure
    function of the shapes: 64 query rows a block (4 warps; 16 rows, one
    warp, when ``tq <= 16``), and when the (head, query tile, batch) blocks
    do not cover the card's 132 SMs the ``ceil(tk / step)`` key steps
    (:func:`dq_f32_step`) cut into shards of 128 keys (``F32_SPLIT_STEPS``
    steps of 32; fewer steps: one shard of them all). The shards do not
    depend on the head count, so a model rank's 4 heads sum each head's
    keys as one process's 8 heads do."""
    q_tile = 16 if tq <= 16 else 64
    step = dq_f32_step(head_dim)
    blocks = batch * num_heads * -(-tq // q_tile)
    steps = -(-tk // step)
    if blocks >= SM_COUNT:
        return q_tile, 1, steps
    per = min(F32_SPLIT_STEPS * DQ_F32_STEP // step, steps)
    return q_tile, -(-steps // per), per


def smem_bytes_dq_f32(head_dim: int, q_tile: int) -> int:
    """Dynamic shared memory of one block of K5's float32 kernel (must
    match ``dq_f32_smem_floats`` in ``csrc/flash_graph_attention_bwd.cu``):
    Q and dO (q_tile rows), then two stages of K, V (:func:`dq_f32_step`
    keys), the (q_tile, step) graph tile and the key mask; head widths
    rounded up to 32, 64, 128 or 256."""
    width = next(w for w in F32_WIDTHS if head_dim <= w)
    step = dq_f32_step(width)
    stage = 2 * step * width + q_tile * step + step
    return 4 * (2 * q_tile * width + 2 * stage)


def kernel_key_split(dtype, head_dim: int, batch: int, num_heads: int, tq: int,
                     tk: int) -> tuple:
    """``(n_split, steps_per_split)`` a K4 call takes: :func:`f32_plan`'s on
    the float32 kernel (steps of :func:`f32_step` keys), :func:`key_split`
    on the tensor-core kernel (the chunked forms counting a block per head
    and chunk), one shard of every 64-key step on the SIMT and wide
    kernels."""
    path = k4_path(dtype, head_dim)
    if path in ("f32", "f32-chunked"):
        return k4_f32_plan(head_dim, batch, num_heads, tq, tk)[1:]
    if path in ("tensor-core", "tc-chunked"):   # the chunked: a block per (head x chunk)
        blocks_a_row = num_heads * (wide_chunks(head_dim) if path == "tc-chunked" else 1)
        return key_split(batch, blocks_a_row, tq, tk, tc_rows(dtype, head_dim, tq))
    return 1, -(-tk // KEY_STEP)


def k4_f32_plan(head_dim: int, batch: int, num_heads: int, tq: int, tk: int) -> tuple:
    """:func:`f32_plan` of the float32 kernel a K4 call at ``head_dim``
    takes: 32-key steps above head width 128 and, on the chunked kernel
    (above 256), a block per head and chunk of ``CHUNK_ROWS`` (128) rows
    whatever Tq (8 warps: 64 rows measured 1.33x slower at head widths 320
    and 512, ``scripts/k4_f32_head256_variants.py``)."""
    if head_dim <= K14_TC_MAX_HEAD_DIM:
        return f32_plan(batch, num_heads, tq, tk, f32_step(head_dim))
    plan = f32_plan(batch, num_heads * wide_chunks(head_dim), tq, tk, f32_step(head_dim),
                    CHUNK_ROWS)
    return (CHUNK_ROWS, *plan[1:])


def tc_rows(dtype, head_dim: int, tq: int) -> int:
    """Query rows a block of K4's tensor-core kernel: 64; 128 at instance
    256 (head widths 144-256) where more than 64 rows share the block's K
    and V tiles (8 warps; the graph then read in fragments); 128 on the
    chunked form (``CHUNK_ROWS``). ``scripts/head256_rows.py``: 0.4860
    against 0.5804 ms at head width 256 with B 4, L 1,536 (at B 2 0.3148
    against 0.3070: fewer blocks than two waves), 0.9093 against 1.5336 at
    320."""
    path = k4_path(dtype, head_dim)
    if path == "tc-chunked" or (path == "tensor-core" and head_dim > 128 and tq > TC_Q_TILE):
        return CHUNK_ROWS
    return TC_Q_TILE


def dq_key_split(dtype, head_dim: int, batch: int, num_heads: int, tq: int,
                 tk: int) -> tuple:
    """``(n_split, steps_per_split)`` a K5 call takes: :func:`key_split` on
    the tensor-core kernel (its blocks and steps are K4's: 64 query rows, 64
    keys; at instance 256 too), :func:`dq_f32_plan`'s on the float32 kernel
    (steps of 32 keys, 16 above head width 128), one shard of every 64-key
    step on the SIMT and wide kernels."""
    return _dq_plan(dq_kernel(dtype, head_dim), batch, num_heads, tq, tk, head_dim)[1:3]


def _dq_plan(path: str, batch: int, num_heads: int, tq: int, tk: int, head_dim: int) -> tuple:
    """``(q_tile, n_split, steps_per_split, keys a step)`` of K5's kernel
    ``path`` (one of ``DQ_PATHS``) at these shapes."""
    if path == "f32":
        return (*dq_f32_plan(batch, num_heads, tq, tk, head_dim), dq_f32_step(head_dim))
    if path == "tensor-core":
        return (TC_Q_TILE, *key_split(batch, num_heads, tq, tk), KEY_STEP)
    return SIMT_Q_TILE, 1, -(-tk // KEY_STEP), KEY_STEP   # the SIMT and wide kernels


def masked_grad_and_delta(out, dy, query_mask, num_heads: int):
    """What the backward kernels take in place of dy: ``dO = dy * query_mask``
    in float32, ``delta = sum_dh(dO * out)`` per (batch, head, row) from that
    float32 dO, and only then dO rounded to out's dtype."""
    d_out = dy.float() * query_mask.float()[:, :, None]
    delta = _heads(d_out * out.float(), num_heads).sum(dim=-1)
    return d_out.to(out.dtype).contiguous(), delta.contiguous()


def _ds_and_n(q, k, v, key_mask, graph, m, z, bsum, delta, d_out, num_heads: int, renorm: str):
    """The (B, H, Tq, Tk) tiles of the backward: dS (scaled, 0 on masked
    keys) and the renormalised weights n, from the saved statistics."""
    dh = q.shape[-1] // num_heads
    scores = _masked_scores(q, k, key_mask, num_heads)
    e = torch.exp(scores - m[..., None])
    zc, bc, dc = z[..., None], bsum[..., None], delta[..., None]
    p = e / zc
    g = graph.float()[:, None]
    dn = torch.matmul(_heads(d_out.float(), num_heads),
                      _heads(v.float(), num_heads).transpose(-1, -2))
    if renorm == "l1":
        # >= is max()'s tie: at b == eps*z the forward divides by b, so the row is live
        live = (bc >= L1_NORM_EPS * zc).float()
        n = e * g / torch.maximum(bc, L1_NORM_EPS * zc)
        ds = n * (dn - live * dc) - p * ((1.0 - live) * dc)
    else:
        denom = bc + SUM_NORM_EPS * zc
        n = e * g / denom
        ds = n * (dn - dc) - p * (dc * SUM_NORM_EPS * zc / denom)
    ds = ds.masked_fill(key_mask[:, None, None, :] == 0, 0.0) * (1.0 / dh ** 0.5)
    return ds, n


def flash_bwd_dq_plain(q, k, v, key_mask, graph, m, z, bsum, delta, d_out, num_heads: int,
                       renorm: str = "l1"):
    """Plain PyTorch version of K5: dQ = dS K, in q's dtype, with dS rounded
    to q's dtype first (the operand the kernels multiply)."""
    ds, _ = _ds_and_n(q, k, v, key_mask, graph, m, z, bsum, delta, d_out, num_heads, renorm)
    ds = ds.to(q.dtype).float()
    return _merge(torch.matmul(ds, _heads(k.float(), num_heads))).to(q.dtype)


def sum_dq_shards_plain(parts, dtype):
    """Plain PyTorch version of the kernel that sums K5's key shards: the
    f32 partials ``parts`` (S, B, Tq, C) added in shard order, then rounded
    to ``dtype``."""
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total.to(dtype)


def flash_bwd_dkv_plain(q, k, v, key_mask, graph, m, z, bsum, delta, d_out, num_heads: int,
                        renorm: str = "l1"):
    """Plain PyTorch version of K6: dK = dS^T Q and dV = N^T dO, in k's
    dtype, with dS and n rounded to q's dtype first."""
    ds, n = _ds_and_n(q, k, v, key_mask, graph, m, z, bsum, delta, d_out, num_heads, renorm)
    ds, n = ds.to(q.dtype).float(), n.to(q.dtype).float()
    dk = torch.matmul(ds.transpose(-1, -2), _heads(q.float(), num_heads))
    dv = torch.matmul(n.transpose(-1, -2), _heads(d_out.float(), num_heads))
    return _merge(dk).to(k.dtype), _merge(dv).to(v.dtype)


def flash_graph_attention_bwd_plain(q, k, v, key_mask, query_mask, graph, out, m, z, bsum, dy,
                                    num_heads: int, renorm: str = "l1"):
    """Plain PyTorch version of the whole backward: ``(dq, dk, dv)`` from the
    forward's ``emit="stats"`` results and ``dy``, the gradient of ``out``.

    The hand-derived formulas of the TPU package's ``_ds_tile``: with the
    final weights n = e*g/D, p = e/z and delta_i = dO_i . out_i,

        l1:      dS = n (dN - live*delta) - p (1 - live) delta,  live = [b >= 1e-12 z]
        sum_eps: dS = n (dN - delta) - p delta 1e-7 z / (b + 1e-7 z)

    with dN = dO V^T, dS zero on masked keys and scaled by 1/sqrt(dh) once;
    dQ = dS K, dK = dS^T Q, dV = N^T dO. dO, V, K and Q enter every product
    widened to float32; dS and n are rounded to q's dtype before the second
    products, as the kernels take them (in float32 that rounds nothing).
    """
    if renorm not in RENORMS:
        raise ValueError(f"unknown renorm mode: {renorm!r}")
    d_out, delta = masked_grad_and_delta(out, dy, query_mask, num_heads)
    args = (q, k, v, key_mask, graph, m, z, bsum, delta, d_out, num_heads, renorm)
    return (flash_bwd_dq_plain(*args), *flash_bwd_dkv_plain(*args))


def _check(q, k, v, key_mask, graph, num_heads: int, renorm: str, extra: dict) -> None:
    if q.dtype not in _DTYPES:
        raise TypeError(f"q/k/v must be float32 or bfloat16, got {q.dtype}")
    if renorm not in RENORMS:
        raise ValueError(f"unknown renorm mode: {renorm!r}")
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError("q, k, v must be (B, T, C)")
    b, tq, c = q.shape
    tk = k.shape[1]
    if c % num_heads:
        raise ValueError("C must be divisible by num_heads")
    check_wide_grid(c // num_heads, num_heads)
    want = {
        "q": (q, (b, tq, c), q.dtype), "k": (k, (b, tk, c), q.dtype),
        "v": (v, (b, tk, c), q.dtype),
        "key_mask": (key_mask, (b, tk), torch.float32),
        "graph": (graph, (b, tq, tk), torch.float32),
    }
    for name, t in extra.items():
        if name == "query_mask":
            want[name] = (t, (b, tq), torch.float32)
        elif name == "d_out":
            want[name] = (t, (b, tq, c), q.dtype)
        else:                                   # m, z, b, delta
            want[name] = (t, (b, num_heads, tq), torch.float32)
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_wide_grid(head_dim: int, num_heads: int) -> None:
    """Raise where the wide kernels' (head x chunk) blocks would pass the
    grid's y extent (``MAX_GRID_Y``): 65,535 heads of up to 256 channels."""
    if head_dim > SIMT_MAX_HEAD_DIM and num_heads * wide_chunks(head_dim) > MAX_GRID_Y:
        raise ValueError(f"{num_heads} heads x {wide_chunks(head_dim)} chunks of "
                         f"{WIDE_CHUNK} channels > {MAX_GRID_Y} blocks along the grid's y")


def _forward_call(q, k, v, key_mask, query_mask, graph, num_heads: int, renorm: str,
                  emit: int, stats: bool):
    """One call of K4's C entry, counted by none: ``emit`` its index (0-2 of
    ``EMITS``, or ``EMIT_O``), ``stats`` whether m, z, b are written.
    Returns ``out`` or ``(out, m, z, b)``."""
    fn = _build.library("flash_graph_attention").savqa_flash_graph_attention
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 11 + [ctypes.c_float, ctypes.c_void_p]
    b, tq, c = q.shape
    tk = k.shape[1]
    dev = q.device
    dh = c // num_heads
    if emit == EMIT_O:
        n_split, per, q_tile = 1, -(-tk // KEY_STEP), TC_Q_TILE   # the wide kernel, unsplit
    else:
        n_split, per = kernel_key_split(q.dtype, dh, b, num_heads, tq, tk)
        q_tile = (k4_f32_plan(dh, b, num_heads, tq, tk)[0] if q.dtype == torch.float32
                  else tc_rows(q.dtype, dh, tq))
    scratch = [None, None]
    if n_split > 1:    # the shards' raw a and m, z, b between the two kernels
        scratch = [torch.empty(n_split, b, num_heads, tq, dh, dtype=torch.float32, device=dev),
                   torch.empty(3, n_split, b, num_heads, tq, dtype=torch.float32, device=dev)]
    if emit == EMITS.index("partial"):
        out = torch.empty(b, num_heads, tq, c // num_heads, dtype=torch.float32, device=dev)
    elif emit == EMIT_O:
        out = torch.empty(b, tq, c, dtype=torch.float32, device=dev)
    else:
        out = torch.empty_like(q)
    row_stats = [None] * 3 if not stats else [
        torch.empty(b, num_heads, tq, dtype=torch.float32, device=dev) for _ in range(3)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(),
            query_mask.data_ptr(), graph.data_ptr(), out.data_ptr(),
            *(None if s is None else s.data_ptr() for s in row_stats + scratch),
            b, tq, tk, c, num_heads, RENORMS.index(renorm), emit,
            _DTYPES[q.dtype], n_split, per, q_tile, 1.0 / dh ** 0.5, stream,
        )
    _build.check(status, "flash_graph_attention kernel")
    return (out, *row_stats) if stats else out


def _launch_forward(q, k, v, key_mask, query_mask, graph, num_heads: int, renorm: str,
                    emit: str):
    if emit not in EMITS:
        raise ValueError(f"unknown emit mode: {emit!r}")
    _check(q, k, v, key_mask, graph, num_heads, renorm, {"query_mask": query_mask})
    result = _forward_call(q, k, v, key_mask, query_mask, graph, num_heads, renorm,
                           EMITS.index(emit), emit != "out")
    flash_graph_attention.launches += 1
    flash_graph_attention.paths[_taken_path(q.dtype, q.shape[-1] // num_heads)] += 1
    return result


def _taken_path(dtype, head_dim: int) -> str:
    """The kernel the C entry's last call on this thread launched, by
    :func:`k4_path`'s names; raises where it is not the one ``k4_path``
    planned the call for."""
    fn = _build.library("flash_graph_attention").savqa_flash_graph_attention_last_path
    fn.restype = ctypes.c_int
    fn.argtypes = []
    code = fn()
    taken = C_PATHS[code] if 0 <= code < len(C_PATHS) else f"code {code}"
    planned = k4_path(dtype, head_dim)
    if taken != planned:
        raise RuntimeError(f"flash_graph_attention: the C entry launched the {taken} kernel, "
                           f"the call was planned for the {planned} kernel")
    return taken


def attention_o(q, k, v, key_mask, query_mask, graph, num_heads: int, renorm: str,
                stats: bool = False):
    """K1's attention output ``o`` (B, Tq, C) float32 by the wide forward
    kernel (``emit`` 3), and with ``stats`` its m, z, b (B, H, Tq): K1's and
    K2's wide path (``ops/fused_graph_attention.py``), counted there. A
    first pass over the keys takes m, z and b, a second forms K1's weights
    from them, rounded where K1 rounds them (``(e / z) g / r qmask`` in V's
    dtype), and sums them times V."""
    _check(q, k, v, key_mask, graph, num_heads, renorm, {"query_mask": query_mask})
    return _forward_call(q, k, v, key_mask, query_mask, graph, num_heads, renorm, EMIT_O, stats)


def attention_o_backward(q, k, v, key_mask, query_mask, graph, o, m, z, bsum, d_o,
                         num_heads: int, renorm: str):
    """``(dq, dk, dv)`` of :func:`attention_o` from ``d_o``, the gradient of
    ``o`` in q's dtype: delta and the masked dO in torch, then K5's and K6's
    kernels (the wide ones above head width 256), counted by the caller."""
    d_out, delta = masked_grad_and_delta(o, d_o, query_mask, num_heads)
    args = (q, k, v, key_mask, graph, m, z, bsum, delta, d_out.to(q.dtype), num_heads, renorm)
    return (_launch_dq(*args), *_launch_dkv(*args))


def _call_backward(entry: str, outs: list, ints: list, q, k, v, key_mask, graph, m, z, bsum,
                   delta, d_out, num_heads: int, renorm: str) -> None:
    """One call of a C entry of ``flash_graph_attention_bwd.cu``: the ten
    inputs and ``outs`` (pointers, None for a null one), the shapes and
    ``ints``, the scale and the stream."""
    fn = getattr(_build.library("flash_graph_attention_bwd"), entry)
    pointers = [q, k, v, key_mask, graph, m, z, bsum, delta, d_out, *outs]
    b, tq, c = q.shape
    ints = [b, tq, k.shape[1], c, num_heads, RENORMS.index(renorm), _DTYPES[q.dtype], *ints]
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * len(pointers) + [ctypes.c_int] * len(ints)
                   + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = fn(*(None if t is None else t.data_ptr() for t in pointers), *ints,
                    1.0 / (c // num_heads) ** 0.5, stream)
    _build.check(status, f"{entry} kernel")


def _check_dq_scratch(scratch, n_split: int, per: int, q, tk: int,
                      step: int = KEY_STEP) -> None:
    """What K5's launch needs of its split: shards that cover the key steps
    (of ``step`` keys) with none empty, and with more than one shard an f32
    scratch of (n_split, B, Tq, C) on q's device for the partials."""
    steps = -(-tk // step)
    if n_split < 1 or per < 1 or not (n_split - 1) * per < steps <= n_split * per:
        raise ValueError(f"{n_split} shard(s) of {per} step(s) do not cover {steps} key steps")
    if n_split == 1:
        if scratch is not None:
            raise ValueError("one shard takes no scratch")
        return
    shape = (n_split, *q.shape)
    if (scratch is None or tuple(scratch.shape) != shape or scratch.dtype != torch.float32
            or scratch.device != q.device or not scratch.is_contiguous()):
        got = None if scratch is None else (tuple(scratch.shape), scratch.dtype, scratch.device)
        raise ValueError(f"scratch: expected {shape} float32 contiguous on {q.device}, got {got}")


def flash_bwd_dq(q, k, v, key_mask, graph, m, z, bsum, delta, d_out, num_heads: int,
                 renorm: str = "l1"):
    """K5: dQ (B, Tq, C) in q's dtype from the saved statistics, ``delta``
    and the masked, rounded ``d_out`` of :func:`masked_grad_and_delta`."""
    if not use_kernel(q):
        return flash_bwd_dq_plain(q, k, v, key_mask, graph, m, z, bsum, delta, d_out,
                                  num_heads, renorm)
    dq = _launch_dq(q, k, v, key_mask, graph, m, z, bsum, delta, d_out, num_heads, renorm)
    flash_bwd_dq.launches += 1
    flash_bwd_dq.paths[last_paths["K5"]] += 1
    return dq


flash_bwd_dq.launches = 0
flash_bwd_dq.paths = collections.Counter()   # launches by the kernel the C entry took


def _launch_dq(q, k, v, key_mask, graph, m, z, bsum, delta, d_out, num_heads: int,
               renorm: str, path: "str | None" = None):
    """K5's launch: :func:`dq_kernel`'s kernel with its key split, or the
    kernel ``path`` (one of ``DQ_PATHS``) names where it takes the shape:
    "simt" takes every head width up to 256, in one shard, which lets a
    check hold the float32 kernel to the first SIMT kernel bit for bit."""
    args = (q, k, v, key_mask, graph, m, z, bsum, delta, d_out, num_heads, renorm)
    _check(q, k, v, key_mask, graph, num_heads, renorm,
           {"m": m, "z": z, "b": bsum, "delta": delta, "d_out": d_out})
    b, tq, c = q.shape
    tk = k.shape[1]
    path = path or dq_kernel(q.dtype, c // num_heads)
    q_tile, n_split, per, step = _dq_plan(path, b, num_heads, tq, tk, c // num_heads)
    scratch = None   # the shards' f32 partial dQ between the two kernels
    if n_split > 1:
        scratch = torch.empty(n_split, b, tq, c, dtype=torch.float32, device=q.device)
    _check_dq_scratch(scratch, n_split, per, q, tk, step)
    dq = torch.empty_like(q)
    _call_backward("savqa_flash_graph_attention_bwd_dq", [dq, scratch],
                   [DQ_PATHS.index(path), q_tile, n_split, per], *args)
    _taken_k56("K5", path, c // num_heads)
    return dq


def flash_bwd_dkv(q, k, v, key_mask, graph, m, z, bsum, delta, d_out, num_heads: int,
                  renorm: str = "l1"):
    """K6: ``(dK, dV)`` (B, Tk, C) in k's dtype; arguments as :func:`flash_bwd_dq`."""
    if not use_kernel(q):
        return flash_bwd_dkv_plain(q, k, v, key_mask, graph, m, z, bsum, delta, d_out,
                                   num_heads, renorm)
    dk, dv = _launch_dkv(q, k, v, key_mask, graph, m, z, bsum, delta, d_out, num_heads, renorm)
    flash_bwd_dkv.launches += 1
    flash_bwd_dkv.paths[last_paths["K6"]] += 1
    return dk, dv


def _launch_dkv(q, k, v, key_mask, graph, m, z, bsum, delta, d_out, num_heads: int,
                renorm: str):
    """K6's launch (:func:`dkv_kernel`'s kernel), counted by the caller."""
    _check(q, k, v, key_mask, graph, num_heads, renorm,
           {"m": m, "z": z, "b": bsum, "delta": delta, "d_out": d_out})
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _call_backward("savqa_flash_graph_attention_bwd_dkv", [dk, dv], [], q, k, v, key_mask, graph,
                   m, z, bsum, delta, d_out, num_heads, renorm)
    head_dim = q.shape[-1] // num_heads
    _taken_k56("K6", dkv_kernel(q.dtype, head_dim), head_dim)
    return dk, dv


flash_bwd_dkv.launches = 0
flash_bwd_dkv.paths = collections.Counter()   # launches by the kernel the C entry took
# the kernel the last K5 and K6 launch on this process took (``_taken_k56``),
# read by their counters and by K2's composed and wide routes
last_paths = {"K5": None, "K6": None}


def k56_instance(path: str, head_dim: int) -> int:
    """The head-width instance of K5's or K6's kernel ``path`` that a head
    width runs in, as their C entries report it
    (``savqa_flash_graph_attention_bwd_last_width``): 0 for the wide
    kernels, which take any width; else the least of ``F32_WIDTHS`` (f32)
    or of ``TC_WIDTHS`` (tensor-core, simt) that holds it, 256 being the
    pair kernels."""
    if path == "wide":
        return 0
    return next(w for w in F32_WIDTHS if head_dim <= w) if path == "f32" else tc_width(head_dim)


def _taken_k56(kernel: str, planned: str, head_dim: int) -> None:
    """Record the kernel the last call of K5's ("K5") or K6's ("K6") C
    entry on this thread launched, by :func:`k56_path`'s names, in
    ``last_paths``. Its launcher notes the kernel and the instance it
    started; raises where either is not what the call was planned for
    (``planned`` at :func:`k56_instance`)."""
    lib = _build.library("flash_graph_attention_bwd")
    entry = 0 if kernel == "K5" else 1
    code, width = (_c_int_of(lib.savqa_flash_graph_attention_bwd_last_path, entry),
                   _c_int_of(lib.savqa_flash_graph_attention_bwd_last_width, entry))
    taken = C_PATHS_K56[code] if 0 <= code < len(C_PATHS_K56) else f"code {code}"
    want = k56_instance(planned, head_dim)
    if (taken, width) != (planned, want):
        raise RuntimeError(f"{kernel}: the C entry launched the {taken} kernel at instance "
                           f"{width}, the call was planned for the {planned} kernel at "
                           f"instance {want} (head width {head_dim})")
    last_paths[kernel] = taken


def _c_int_of(fn, entry: int) -> int:
    """``fn(entry)`` of a C function taking and returning an int."""
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int]
    return fn(entry)


def flash_graph_attention_bwd(q, k, v, key_mask, query_mask, graph, out, m, z, bsum, dy,
                              num_heads: int, renorm: str = "l1"):
    """``(dq, dk, dv)`` from the forward's ``emit="stats"`` results and
    ``dy``: delta and the masked dO in torch, then K5, then K6 (their plain
    versions on CPU tensors)."""
    d_out, delta = masked_grad_and_delta(out, dy, query_mask, num_heads)
    args = (q, k, v, key_mask, graph, m, z, bsum, delta, d_out, num_heads, renorm)
    return (flash_bwd_dq(*args), *flash_bwd_dkv(*args))


def _forward(q, k, v, key_mask, query_mask, graph, num_heads: int, renorm: str, emit: str):
    if not use_kernel(q):
        return flash_graph_attention_plain(q, k, v, key_mask, query_mask, graph, num_heads,
                                           renorm, emit)
    return _launch_forward(q, k, v, key_mask, query_mask, graph, num_heads, renorm, emit)


class _FlashGraphAttention(torch.autograd.Function):
    """K4 as an autograd node whose backward is K5 then K6.

    When a gradient is needed the forward emits the per-row statistics and
    saves them with its inputs and its output (nothing of size (Tq, Tk));
    otherwise it emits the output alone."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, query_mask, graph, num_heads, renorm):
        ctx.num_heads, ctx.renorm = num_heads, renorm
        if not any(ctx.needs_input_grad[:3]):
            return _forward(q, k, v, key_mask, query_mask, graph, num_heads, renorm, "out")
        out, m, z, bsum = _forward(q, k, v, key_mask, query_mask, graph, num_heads, renorm,
                                   "stats")
        ctx.save_for_backward(q, k, v, key_mask, query_mask, graph, out, m, z, bsum)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, key_mask, query_mask, graph, out, m, z, bsum = ctx.saved_tensors
        dq, dk, dv = flash_graph_attention_bwd(q, k, v, key_mask, query_mask, graph, out, m, z,
                                               bsum, grad_out, ctx.num_heads, ctx.renorm)
        return dq, dk, dv, None, None, None, None, None


def flash_graph_attention(q, k, v, key_mask, query_mask, graph, num_heads: int,
                          renorm: str = "l1", emit: str = "out"):
    """K-blocked graph attention without residual or LayerNorm.

    q (B, Tq, C); k, v (B, Tk, C), one dtype (float32 or bfloat16); key_mask
    (B, Tk), query_mask (B, Tq), graph (B, Tq, Tk) float32, all contiguous.
    ``emit="out"`` returns out (B, Tq, C) in q's dtype and is differentiable
    in q, k and v (the masks and the graph get no gradient). ``"stats"``
    returns ``(out, m, z, b)`` and ``"partial"`` the raw ``(a, m, z, b)``, as
    :func:`flash_graph_attention_plain`; neither records a gradient.
    """
    if emit == "out":
        return _FlashGraphAttention.apply(q, k, v, key_mask, query_mask, graph, num_heads,
                                          renorm)
    return _forward(q.detach(), k.detach(), v.detach(), key_mask, query_mask, graph, num_heads,
                    renorm, emit)


flash_graph_attention.launches = 0
flash_graph_attention.paths = collections.Counter()   # launches by the kernel the C entry took
