"""Fused position-wise FFN + residual + LayerNorm (K3).

Counterpart of the TPU package's ``ops/pallas_ffn.py`` (``_kernel``, entry
``fused_ffn``): ``LN(W2 relu(W1 x + b1) + b2 + x)`` over rows, with the
(rows, 4C) hidden activation kept on chip.

On CUDA tensors :func:`fused_ffn` launches the kernels of ``csrc/ffn.cu``;
:func:`ffn_path` says which design a call takes. Both are bound by
operations; what each does about it:

* ``"row-tile"``, bf16 at C 128, 256, 384 and 512 (``ROW_TILE_WIDTHS``)
  with a hidden width that is a multiple of 64: the TPU kernel's shape on
  the tensor cores (``mma.sync``), 64 rows a block, the hidden activation
  kept in shared memory; with few rows the hidden width is split over
  blocks by :func:`ffn_split` and a second kernel sums the shards.
* ``"products"``, float32 at every width and bf16 at every other width
  (C 2,048, 768, 300, 16, ...): two kernels
  shaped like GEMMs, ``relu(x W1^T + b1)`` into a hidden scratch of (rows,
  Hd) in x's dtype, then its product with ``W2^T`` into f32 partials of
  (n_split, rows, C), then the shard-sum kernel (``+ b2 + x`` and the
  LayerNorm). Tiles of 128 (f32 also 64) x 128 read each weight once per
  tile of rows, where the old fused f32 kernel streamed both weights
  through every 32-row block; f32 runs FFMA on the CUDA cores (TF32 would
  break the 1e-4 checks), bf16 ``mma.sync``. :func:`products_plan` picks
  the tile height and, in bf16 and at C 2,048, the shards of the second
  product's hidden width over blocks. In f32 at C up to 512 each output is
  one FMA chain over the whole hidden width and the LayerNorm sums in the
  old kernel's order: the results are the bits of the f32 kernel this path
  replaced. The hidden round trip costs about 8% of the f32 bound at
  16,384 rows. C and the hidden width are runtime extents: edge tiles
  zero-fill what lies past the operands, the LayerNorm leaves the columns
  past C out, and bf16 rows that are not 16-byte aligned (C or the hidden
  width no multiple of 8) are copied element by element.

The kernels take every C and every hidden width: above C ``LANE_MAX_C``
(2,048), where a warp's lanes can no longer hold a row, the residual and
LayerNorm run in a row kernel (one block a row, the row staged in shared
memory up to 57,344 columns and formed again from the partials in each of
its three passes above that), and the f32 products cut the hidden width
into at most four shards (:func:`f32_shard_chunks`). The f32 product kernel
counts its offsets in 32 bits from each tile's first row, so the wrapper
raises only where 128 rows of C or of the hidden width pass 2^31 elements
(``MAX_WIDTH``).

Every launch of either counts once. The wrapper allocates the scratch with
``torch.empty`` (:func:`_scratch`); the kernels allocate nothing. On CPU
tensors :func:`fused_ffn` runs :func:`ffn_ln_plain`, the same function in
plain PyTorch, rounding where the kernels round: the hidden activation is
cast to x's dtype before the second product and the residual is added in
f32. The backward on either device is autograd of
:func:`ffn_ln_composite`, whose products run in x's dtype, as the TPU
package's backward is the VJP of its ``_composite``: both pair a kernel
forward with a composite backward. Weights are in ``nn.Linear`` layout:
w1 (4C, C), w2 (C, 4C).

The model axis (``ops/layers.py:FeedForward`` with its hidden width split
over the model row) takes two more entries of the same kernels:
:func:`ffn_partial`, the f32 ``relu(x W1s^T + b1s) W2s^T`` of this rank's
hidden shard (bf16: the row-tile kernel, f32: the two products; either may
split its own shard over blocks, the partials summed in order by a second
kernel), and, after the sum over the ranks, :func:`ffn_epilogue`, the
shard-sum kernel with one partial: ``+ b2 + x`` and the LayerNorm. Their
backwards are autograd of :func:`ffn_partial_composite` (products in x's
dtype) and of :func:`ffn_epilogue_plain`.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from structured_alignment_vqa_tpu_torch.ops import _build
from structured_alignment_vqa_tpu_torch.ops.dispatch import (
    SM_COUNT,
    SMEM_LIMIT,
    composite_backward,
    use_kernel,
)
from structured_alignment_vqa_tpu_torch.ops.layers import layer_norm

WIDTHS = (128, 256, 512)   # the preset widths: f32 at these C sums in one shard
# C values of the bf16 row-tile kernel (its shared memory grows with C:
# 318,464 bytes at C 768); every other C takes the products path
ROW_TILE_WIDTHS = (128, 256, 384, 512)
LANE_MAX_C = 2048          # the shard-sum kernel's widest instance; wider rows take the row kernel
HIDDEN_CHUNK = 64          # hidden columns a chunk; the last chunk may be shorter
TC_ROWS = 64               # rows per block of the bf16 row-tile kernel
PRODUCT_TILE = 128         # columns (and at most rows) of a block's tile on the products path
MAX_WIDTH = (2 ** 31 - 1) // PRODUCT_TILE   # C and hidden width: a tile's 32-bit offsets
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def ffn_ln_plain(x, w1, b1, w2, b2, gamma, beta):
    """Plain PyTorch version of the kernel: same shape and dtype as ``x``."""
    h = torch.relu(F.linear(x.float(), w1.float(), b1.float())).to(x.dtype)
    y = F.linear(h.float(), w2.float(), b2.float())
    return layer_norm(y + x.float(), gamma, beta).to(x.dtype)


def ffn_ln_composite(x, w1, b1, w2, b2, gamma, beta):
    """The TPU package's ``pallas_ffn._composite``: both products and the
    residual in x's dtype (bf16 operands sum in f32 and round once), the
    LayerNorm in f32. In float32 it is :func:`ffn_ln_plain` operation for
    operation. K3's backward is autograd of this function."""
    h = torch.relu(F.linear(x, w1, b1))
    y = F.linear(h, w2, b2)
    return layer_norm(y + x, gamma, beta)


def ffn_path(dtype, c: int, hidden: "int | None" = None) -> str:
    """Which design of ``csrc/ffn.cu`` a call takes: ``"row-tile"`` (bf16 at
    C in ``ROW_TILE_WIDTHS`` with a hidden width, 4C unless given, that is a
    multiple of 64) or ``"products"`` (float32, and bf16 at every other C)."""
    hidden = 4 * c if hidden is None else hidden
    if dtype == torch.bfloat16 and c in ROW_TILE_WIDTHS and hidden % HIDDEN_CHUNK == 0:
        return "row-tile"
    return "products"


def _chunks(hidden: int) -> int:
    """The hidden width's chunks of 64 columns, the last one short if need be."""
    return -(-hidden // HIDDEN_CHUNK)


def _shards(tiles: int, chunks: int) -> tuple:
    """``(n_split, chunks_per_split)``: one shard when ``tiles`` blocks alone
    fill the card's 132 SMs, else as many as there are SMs per tile, none
    empty."""
    want = max(1, min(chunks, SM_COUNT // tiles))
    per = -(-chunks // want)
    return -(-chunks // per), per


def ffn_split(rows: int, c: int, hidden: int) -> tuple:
    """``(n_split, chunks_per_split)`` of the bf16 row-tile kernel: how many
    shards the ``hidden / 64`` hidden chunks are cut into, and the chunks of
    each. A pure function of the shapes (C does not change it: the row tile
    is 64 rows at every width)."""
    return _shards(-(-rows // TC_ROWS), hidden // HIDDEN_CHUNK)


# The products path's plan estimates its two products' time on the card:
# blocks (tiles x shards) run in waves of one block an SM (two resident
# blocks share an SM's FMA rate), each block taking CHUNK_S for every
# 64-deep chunk of k it multiplies; every shard's f32 partial is written and
# read once more at PARTIAL_BYTES_PER_S. Constants from
# scripts/k3_variants.py on an H100 SXM.
CHUNK_S = {(torch.float32, 128): 6.1e-6, (torch.float32, 64): 3.7e-6,
           (torch.bfloat16, 128): 0.9e-6}   # by (dtype, tile rows); tiles 128 wide
PARTIAL_BYTES_PER_S = 3e12
WIDE_SHARD_CHUNKS = 16   # f32 at C 2,048: a shard spans 1,024 hidden columns
MAX_WIDE_SHARDS = 4      # f32 above C 2,048: at most this many shards


def f32_shard_chunks(c: int, hidden: int) -> int:
    """The chunks of 64 hidden columns in one shard of an f32 call: at C up
    to 512 the whole hidden width, one FMA chain per output as in the f32
    kernel this path replaced, so that its results are that kernel's bits
    at the preset widths (and a row's output never depends on the rows
    beside it); above C 512 shards of 1,024 columns, which the SMs need at
    C 2,048; above C 2,048 at least 1,024 columns and at most
    ``MAX_WIDE_SHARDS`` shards, whose (shards, rows, C) f32 partials would
    otherwise outgrow the card (16 shards of 57,600 rows at C 4,096: 15
    GB). A function of C and the hidden width alone."""
    chunks = _chunks(hidden)
    if c <= max(WIDTHS):
        return chunks
    if c <= LANE_MAX_C:
        return min(WIDE_SHARD_CHUNKS, chunks)
    return min(chunks, max(WIDE_SHARD_CHUNKS, -(-chunks // MAX_WIDE_SHARDS)))


@functools.lru_cache(maxsize=None)
def products_plan(rows: int, c: int, hidden: int, dtype) -> tuple:
    """``(tile_rows, n_split, chunks_per_split)`` of the products path: a
    pure function of the shapes and the dtype. Its blocks own tiles of
    ``tile_rows`` x 128 (f32: 64 or 128 rows, bf16: 128); the second
    product cuts the ``hidden / 64`` chunks into ``n_split`` equal shards
    over blocks, summed in order by a second kernel. The shards of f32 are
    :func:`f32_shard_chunks` long, a function of C and the hidden width
    alone; the tiles, and the shards of bf16 (C 2,048 only), are the choice
    with the least estimated time: waves of blocks over the 132 SMs times
    the chunks a block multiplies, for both products, plus the partials'
    traffic (fewer shards, then taller tiles, on a tie)."""
    f32 = dtype == torch.float32
    chunks = _chunks(hidden)
    pers = [f32_shard_chunks(c, hidden)] if f32 else range(chunks, 0, -1)
    partial_s = 8 * rows * c / PARTIAL_BYTES_PER_S
    best, best_s = None, None
    for tile_rows in (128, 64) if f32 else (128,):
        chunk_s = CHUNK_S[dtype, tile_rows]
        m_tiles = -(-rows // tile_rows)
        hidden_s = -(-m_tiles * -(-hidden // PRODUCT_TILE) // SM_COUNT) * -(-c // 64) * chunk_s
        for per in pers:   # shards n = ceil(chunks / per), fewest first
            n = -(-chunks // per)
            t = (hidden_s + -(-m_tiles * -(-c // PRODUCT_TILE) * n // SM_COUNT) * per * chunk_s
                 + n * partial_s)
            if best_s is None or t < best_s:
                best, best_s = (tile_rows, -(-chunks // per), per), t
    return best


def kernel_ffn_split(dtype, rows: int, c: int, hidden: int) -> tuple:
    """The split a call takes: :func:`ffn_split` on the row-tile kernel,
    :func:`products_plan`'s on the products path."""
    if ffn_path(dtype, c, hidden) == "row-tile":
        return ffn_split(rows, c, hidden)
    return products_plan(rows, c, hidden, dtype)[1:]


def smem_bytes_products(dtype, tile_rows: int = PRODUCT_TILE) -> int:
    """Dynamic shared memory of one block of a products kernel (must match
    ``simt_smem`` and ``kMmaSmem`` in ``csrc/ffn.cu``): a ring of A and B
    slices; f32 two stages, k-major, 32 k a stage (16 with 64-row tiles), A
    ``tile_rows`` and B 128 rows, each padded by 4 floats a k; bf16 three
    stages of 64 k and 128 rows each, 8 elements of padding a row."""
    if dtype == torch.float32:
        depth = 16 if tile_rows == 64 else 32
        return 2 * depth * (tile_rows + 4 + PRODUCT_TILE + 4) * 4
    return 3 * 2 * PRODUCT_TILE * (64 + 8) * 2


def smem_bytes_tc(c: int) -> int:
    """Dynamic shared memory of one block of the bf16 kernel (must match
    ``TcSmem`` in ``csrc/ffn.cu``): the x tile and the W1 chunk (64 rows of
    C + 8), the W2 chunk (C rows of 72), the hidden chunk (64 x 72), all
    bf16, and 8 x 64 f32 row sums."""
    return 2 * (2 * TC_ROWS * (c + 8) + c * (HIDDEN_CHUNK + 8) + TC_ROWS * (HIDDEN_CHUNK + 8)) \
        + 4 * 8 * TC_ROWS


def ffn_epilogue_plain(y, x, b2, gamma, beta):
    """Plain PyTorch version of :func:`ffn_epilogue`: ``LN((y + b2) + x)``
    in f32 over the last axis (y f32), in x's dtype."""
    return layer_norm((y + b2.float()) + x.float(), gamma, beta).to(x.dtype)


def shard_sum_plain(partial, x, b2, gamma, beta):
    """Plain PyTorch version of the split path's second kernel: the shards'
    f32 partial ``h W2^T`` (n_split, rows, C) summed in shard order, ``+ b2
    + x`` in f32, then the LayerNorm; (rows, C) in x's dtype."""
    y = partial[0]
    for part in partial[1:]:
        y = y + part
    return ffn_epilogue_plain(y, x, b2, gamma, beta)


def ffn_partial_plain(x, w1, b1, w2):
    """Plain PyTorch version of :func:`ffn_partial`: ``relu(x W1^T + b1)``
    rounded to x's dtype, times ``W2^T``, f32 (..., C)."""
    h = torch.relu(F.linear(x.float(), w1.float(), b1.float())).to(x.dtype)
    return F.linear(h.float(), w2.float())


def ffn_partial_composite(x, w1, b1, w2):
    """:func:`ffn_partial` as ``ffn_ln_composite`` computes it, products in
    x's dtype; its backward is the partial entry's."""
    return F.linear(torch.relu(F.linear(x, w1, b1)), w2)


def _check_widths(c: int, hd: int) -> None:
    """Raise unless C and the hidden width are at least 1 and the f32
    product kernel's 32-bit offsets reach a tile of 128 rows of either."""
    for name, width in (("C", c), ("hidden width", hd)):
        if not 1 <= width <= MAX_WIDTH:
            raise ValueError(f"the FFN kernel takes a {name} from 1 to {MAX_WIDTH} (128 rows of "
                             f"it within 2^31 elements), got {width}")


def _check(x, w1, b1, w2, b2, gamma, beta) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    c = x.shape[-1]
    hd = w1.shape[0]
    _check_widths(c, hd)
    want = {
        "x": (x, tuple(x.shape), x.dtype),
        "w1": (w1, (hd, c), x.dtype), "b1": (b1, (hd,), x.dtype),
        "w2": (w2, (c, hd), x.dtype), "b2": (b2, (c,), x.dtype),
        "gamma": (gamma, (c,), torch.float32), "beta": (beta, (c,), torch.float32),
    }
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_aligned(*tensors) -> None:
    """The row-tile kernel copies its bf16 operands 16 bytes at a time
    (``cp.async``); the products path takes any alignment."""
    for t in tensors:
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError("bf16 operands of the FFN kernel must be 16-byte aligned")


def _scratch_shapes(x, hidden: int, n_split: int, entry: str) -> dict:
    """The scratch a launch takes, by name: shape and dtype. The products
    path writes the hidden activation (rows, Hd) in x's dtype; its LayerNorm
    entry (``entry="ln"``) always, and either entry's split path, write f32
    partials (n_split, rows, C)."""
    c = x.shape[-1]
    rows = x.numel() // c
    products = ffn_path(x.dtype, c, hidden) == "products"
    shapes = {}
    if products:
        shapes["hidden"] = ((rows, hidden), x.dtype)
    if n_split > 1 or (products and entry == "ln"):
        shapes["partial"] = ((n_split, rows, c), torch.float32)
    return shapes


def _scratch(x, hidden: int, n_split: int, entry: str) -> dict:
    return {name: torch.empty(shape, dtype=dtype, device=x.device)
            for name, (shape, dtype) in _scratch_shapes(x, hidden, n_split, entry).items()}


def _check_scratch(scratch: dict, x, hidden: int, n_split: int, entry: str) -> None:
    """Raise unless ``scratch`` holds exactly the buffers the launch writes,
    each of its shape and dtype, contiguous on x's device."""
    want = _scratch_shapes(x, hidden, n_split, entry)
    if set(scratch) != set(want):
        raise ValueError(f"scratch: expected {sorted(want)}, got {sorted(scratch)}")
    for name, (shape, dtype) in want.items():
        t = scratch[name]
        if (tuple(t.shape) != shape or t.dtype != dtype or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"{name} scratch: expected {shape} {dtype} contiguous on "
                             f"{x.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def _ptr(scratch: dict, name: str):
    t = scratch.get(name)
    return None if t is None else t.data_ptr()


def _launch(x, w1, b1, w2, b2, gamma, beta) -> torch.Tensor:
    _check(x, w1, b1, w2, b2, gamma, beta)
    if ffn_path(x.dtype, x.shape[-1], w1.shape[0]) == "row-tile":
        _check_aligned(x, w1, w2)
    lib = _build.library("ffn")
    fn = lib.savqa_ffn_ln
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    c = x.shape[-1]
    rows, hidden = x.numel() // c, w1.shape[0]
    n_split, per = kernel_ffn_split(x.dtype, rows, c, hidden)
    tile_rows = products_plan(rows, c, hidden, x.dtype)[0]
    out = torch.empty_like(x)
    scratch = _scratch(x, hidden, n_split, "ln")
    _check_scratch(scratch, x, hidden, n_split, "ln")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = fn(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), _ptr(scratch, "hidden"),
            _ptr(scratch, "partial"), rows, c, hidden, _DTYPES[x.dtype], n_split, per, tile_rows,
            stream,
        )
    _build.check(status, "ffn_ln kernel")
    fused_ffn.launches += 1
    return out


class _FusedFFN(torch.autograd.Function):
    """K3 as an autograd node.

    The forward launches the kernel on CUDA tensors (the plain version on
    CPU tensors) and saves only its inputs; it adds the residual in f32, as
    the TPU kernel does. The TPU package has no backward kernel for K3: its
    backward is the VJP of ``_composite`` (``ops/pallas_ffn.py:88-107``).
    So is this one: the backward recomputes :func:`ffn_ln_composite` on the
    saved inputs under ``torch.enable_grad()`` and takes
    ``torch.autograd.grad`` of it, its products running in x's dtype on
    cuBLAS as XLA's do. This is the backward pass, not a forward that falls
    back.
    """

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, gamma, beta):
        ctx.save_for_backward(x, w1, b1, w2, b2, gamma, beta)
        if not use_kernel(x):
            return ffn_ln_plain(x, w1, b1, w2, b2, gamma, beta)
        return _launch(x, w1, b1, w2, b2, gamma, beta)

    @staticmethod
    def backward(ctx, grad_out):
        return composite_backward(ffn_ln_composite, ctx, grad_out)


def fused_ffn(x, w1, b1, w2, b2, gamma, beta):
    """``LN(W2 relu(W1 x + b1) + b2 + x)`` over the last axis of ``x``,
    differentiable.

    x (..., C); w1 (H, C), b1 (H,), w2 (C, H), b2 (C,) in x's dtype; gamma
    and beta (C,) float32.
    """
    return _FusedFFN.apply(x, w1, b1, w2, b2, gamma, beta)


fused_ffn.launches = 0


# ---- the model axis ---------------------------------------------------------

def _check_partial(x, w1, b1, w2) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    c, hd = x.shape[-1], w1.shape[0]
    _check_widths(c, hd)
    for name, t, shape in (("x", x, tuple(x.shape)), ("w1", w1, (hd, c)), ("b1", b1, (hd,)),
                           ("w2", w2, (c, hd))):
        if tuple(t.shape) != shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name}: expected {shape} {x.dtype} on {x.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch_partial(x, w1, b1, w2) -> torch.Tensor:
    _check_partial(x, w1, b1, w2)
    if ffn_path(x.dtype, x.shape[-1], w1.shape[0]) == "row-tile":
        _check_aligned(x, w1, w2)
    lib = _build.library("ffn")
    fn = lib.savqa_ffn_partial
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    c = x.shape[-1]
    rows, hidden = x.numel() // c, w1.shape[0]
    n_split, per = kernel_ffn_split(x.dtype, rows, c, hidden)
    tile_rows = products_plan(rows, c, hidden, x.dtype)[0]
    out = torch.empty(*x.shape, dtype=torch.float32, device=x.device)
    scratch = _scratch(x, hidden, n_split, "partial")
    _check_scratch(scratch, x, hidden, n_split, "partial")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                    _ptr(scratch, "hidden"), _ptr(scratch, "partial"), out.data_ptr(),
                    rows, c, hidden, _DTYPES[x.dtype], n_split, per, tile_rows, stream)
    _build.check(status, "ffn_partial kernel")
    ffn_partial.launches += 1
    return out


def _check_epilogue(y, x, b2, gamma, beta) -> None:
    c = x.shape[-1]
    if x.dtype not in _DTYPES or c < 1:
        raise ValueError(f"the FFN epilogue takes a C of at least 1, f32 or bf16; got "
                         f"{c} {x.dtype}")
    for name, t, shape, dtype in (("y", y, tuple(x.shape), torch.float32),
                                  ("b2", b2, (c,), x.dtype), ("gamma", gamma, (c,), torch.float32),
                                  ("beta", beta, (c,), torch.float32)):
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != x.device:
            raise ValueError(f"{name}: expected {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")


def _launch_epilogue(y, x, b2, gamma, beta) -> torch.Tensor:
    _check_epilogue(y, x, b2, gamma, beta)
    c = x.shape[-1]
    lib = _build.library("ffn")
    fn = lib.savqa_ffn_epilogue
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = fn(y.data_ptr(), x.data_ptr(), b2.data_ptr(), gamma.data_ptr(),
                    beta.data_ptr(), out.data_ptr(), x.numel() // c, c, _DTYPES[x.dtype], stream)
    _build.check(status, "ffn_epilogue kernel")
    ffn_epilogue.launches += 1
    return out


class _FFNPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2):
        ctx.save_for_backward(x, w1, b1, w2)
        if not use_kernel(x):
            return ffn_partial_plain(x, w1, b1, w2)
        return _launch_partial(x, w1, b1, w2)

    @staticmethod
    def backward(ctx, grad_out):
        return composite_backward(ffn_partial_composite, ctx, grad_out)


class _FFNEpilogue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, x, b2, gamma, beta):
        ctx.save_for_backward(y, x, b2, gamma, beta)
        if not use_kernel(x):
            return ffn_epilogue_plain(y, x, b2, gamma, beta)
        return _launch_epilogue(y.contiguous(), x, b2, gamma, beta)

    @staticmethod
    def backward(ctx, grad_out):
        return composite_backward(ffn_epilogue_plain, ctx, grad_out)


def ffn_partial(x, w1, b1, w2):
    """``relu(x W1^T + b1) W2^T`` over the last axis of ``x``, f32 (...,
    C), differentiable: one rank's share of the FFN on the model axis, w1
    (Hs, C), b1 (Hs,), w2 (C, Hs) its hidden shard, in x's dtype. One
    launch of ``csrc/ffn.cu:savqa_ffn_partial`` on CUDA tensors."""
    return _FFNPartial.apply(x.contiguous(), w1.contiguous(), b1.contiguous(), w2.contiguous())


ffn_partial.launches = 0


def ffn_epilogue(y, x, b2, gamma, beta):
    """``LN((y + b2) + x)`` over the last axis, in x's dtype,
    differentiable: y f32, the ranks' :func:`ffn_partial` summed. One launch
    of ``csrc/ffn.cu:savqa_ffn_epilogue`` on CUDA tensors."""
    return _FFNEpilogue.apply(y, x.contiguous(), b2.contiguous(), gamma, beta)


ffn_epilogue.launches = 0
