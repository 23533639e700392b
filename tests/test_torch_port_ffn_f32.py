"""K3's products path (``ops/fused_ffn.py``: float32 at every width, bf16
at C 2,048) on the CPU: the C 2,048 plain version against the JAX package's
Pallas kernel in interpret mode, the plan (tile rows and hidden shards) as
a pure function of the shapes, the shards composed against the unsplit
call, the scratch guards, the shared memory of the products kernels, and
that CPU tensors launch nothing.

Tolerances: float32 1e-5 (the JAX package's own kernel tests); bf16 one
output ulp at |y| < 4 (2^-6), as ``tests/test_torch_port_ffn.py``.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import structured_alignment_vqa_tpu.ops.pallas_attention as pa
from structured_alignment_vqa_tpu.ops.pallas_ffn import fused_ffn as jax_fused_ffn
from structured_alignment_vqa_tpu_torch.ops import _build
from structured_alignment_vqa_tpu_torch.ops import fused_ffn as k3

WIDE = 2048
HIDDEN = 256   # a narrow hidden width keeps the interpret-mode kernel quick


@pytest.fixture(autouse=True)
def _setup():
    torch.set_num_threads(1)
    pa.INTERPRET_MODE = True
    yield
    pa.INTERPRET_MODE = False


def inputs(rng, rows: int, c: int, hidden: int):
    """numpy arrays in the JAX package's layout: w1 (C, H), w2 (H, C)."""
    x = rng.standard_normal((rows, c)).astype(np.float32)
    w1 = (rng.standard_normal((c, hidden)) / np.sqrt(c)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(hidden)).astype(np.float32)
    w2 = (rng.standard_normal((hidden, c)) / np.sqrt(hidden)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(c)).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, w1, b1, w2, b2, gamma, beta


def to_port(args, dtype):
    """The same arrays as the port takes them: nn.Linear layout, weights in
    x's dtype, gamma and beta f32."""
    x, w1, b1, w2, b2, gamma, beta = (torch.from_numpy(np.ascontiguousarray(a)) for a in args)
    return (x.to(dtype), w1.T.contiguous().to(dtype), b1.to(dtype), w2.T.contiguous().to(dtype),
            b2.to(dtype), gamma, beta)


@pytest.mark.parametrize("rows", [8, 13])
def test_wide_plain_matches_pallas_interpret_f32(rng, rows):
    """C 2,048 in f32: the plain version of the products path against the
    JAX kernel (13 rows: no multiple of a 64- or 128-row tile)."""
    args = inputs(rng, rows, WIDE, HIDDEN)
    want = jax_fused_ffn(*(jnp.asarray(a)[None] if i == 0 else jnp.asarray(a)
                           for i, a in enumerate(args)))[0]
    got = k3.ffn_ln_plain(*to_port(args, torch.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_wide_plain_matches_pallas_interpret_bf16(rng):
    """C 2,048 in bf16: the hidden activation rounded to bf16 before the
    second product, as the JAX kernel rounds it; within one output ulp."""
    args = inputs(rng, 16, WIDE, HIDDEN)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in args[:5]] + [jnp.asarray(a) for a in args[5:]]
    bf[0] = bf[0][None]
    want = np.asarray(jax_fused_ffn(*bf)[0], np.float32)
    got = k3.ffn_ln_plain(*to_port(args, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2 ** -6, rtol=0)


@pytest.mark.parametrize("rows,c,hidden,dtype,want", [
    (64, 512, 2048, torch.float32, (64, 1, 32)),       # a decoder token at bs 64: 64-row tiles
    (3136, 512, 2048, torch.float32, (128, 1, 32)),    # 49 regions at bs 64
    (6336, 512, 2048, torch.float32, (64, 1, 32)),
    (16384, 512, 2048, torch.float32, (128, 1, 32)),   # f32 at C <= 512: one chain, one shard
    (19200, 512, 2048, torch.float32, (128, 1, 32)),
    (16384, 512, 1024, torch.float32, (128, 1, 16)),   # the model axis's partial at model 2
    (3136, 2048, 8192, torch.float32, (128, 8, 16)),   # x2_fusion_dec_mil2's alignment FFN:
                                                       # shards of 1,024 columns
    (3136, 2048, 8192, torch.bfloat16, (128, 2, 64)),  # bf16: the cost model's shards
])
def test_products_plan_is_a_pure_function_of_the_shapes(rows, c, hidden, dtype, want):
    assert k3.products_plan(rows, c, hidden, dtype) == want
    assert k3.products_plan(rows, c, hidden, dtype) == want          # and says so twice
    assert k3.kernel_ffn_split(dtype, rows, c, hidden) == want[1:]


@pytest.mark.parametrize("c", [128, 256, 512, 2048])
def test_f32_shards_do_not_depend_on_the_rows(c):
    """f32: every row count cuts the hidden width into the same shards, so
    a row's output never depends on the rows beside it (a packed row's
    output is its samples' alone): one shard, the whole hidden width, at C
    up to 512 (the old f32 kernel's one chain), shards of 1,024 columns at
    C 2,048."""
    for hidden in (4 * c, 2 * c):   # one process, and a model-axis rank of two
        plans = {k3.products_plan(rows, c, hidden, torch.float32)[1:]
                 for rows in (1, 4, 64, 128, 264, 1000, 3136, 6336, 17920, 32768)}
        chunks = hidden // 64
        per = chunks if c <= 512 else 16
        assert plans == {(chunks // per, per)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [128, 512, 2048])
@pytest.mark.parametrize("rows", [1, 63, 64, 65, 1000, 3136, 20000])
def test_products_plan_leaves_no_shard_empty(rows, c, dtype):
    for hidden in (64, 192, 4 * c):
        tile_rows, n_split, per = k3.products_plan(rows, c, hidden, dtype)
        chunks = hidden // k3.HIDDEN_CHUNK
        assert tile_rows in ((64, 128) if dtype == torch.float32 else (128,))
        assert n_split >= 1 and per >= 1
        assert (n_split - 1) * per < chunks <= n_split * per      # the kernel's own guard


def test_the_row_tile_kernel_keeps_its_split():
    """bf16 at C <= 512 stays on the row-tile kernel and its split."""
    for rows in (4, 128, 264, 16384):
        assert k3.ffn_path(torch.bfloat16, 512) == "row-tile"
        assert k3.kernel_ffn_split(torch.bfloat16, rows, 512, 2048) == k3.ffn_split(rows, 512, 2048)
    assert k3.ffn_path(torch.float32, 512) == "products"
    assert k3.ffn_path(torch.bfloat16, WIDE) == "products"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_products_shards_compose_to_the_unsplit_call(rng, dtype):
    """The products path as its stages compute it, in the plan's shards: the
    hidden activation rounded to x's dtype, each shard's f32 partial, the
    shard sum's plain version; against the unsplit plain version. f32: 1e-5
    (sums in another order); bf16: one output ulp below 4."""
    rows, c, hidden = 40, WIDE, 4 * WIDE
    x, w1, b1, w2, b2, gamma, beta = to_port(inputs(rng, rows, c, hidden), dtype)
    _, n_split, per = k3.products_plan(rows, c, hidden, dtype)
    assert n_split > 1
    h = torch.relu(x.float() @ w1.float().T + b1.float()).to(dtype)
    parts = []
    for sp in range(n_split):
        lo, hi = 64 * per * sp, min(hidden, 64 * per * (sp + 1))
        parts.append(h[:, lo:hi].float() @ w2[:, lo:hi].float().T)
    got = k3.shard_sum_plain(torch.stack(parts), x, b2, gamma, beta)
    want = k3.ffn_ln_plain(x, w1, b1, w2, b2, gamma, beta)
    tol = 1e-5 if dtype == torch.float32 else 2 ** -6
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), atol=tol, rtol=0)


@pytest.mark.parametrize("dtype,c,entry,want", [
    (torch.float32, 512, "ln", {"hidden", "partial"}),    # one shard: y before the LayerNorm
    (torch.bfloat16, WIDE, "ln", {"hidden", "partial"}),
    (torch.float32, 512, "partial", {"hidden"}),        # 16,384 rows: one shard, out written
    (torch.bfloat16, 512, "ln", set()),                  # the row-tile kernel, unsplit
])
def test_scratch_is_what_the_launch_writes(dtype, c, entry, want):
    x = torch.zeros(16384, c, dtype=dtype)
    hidden = 1024 if entry == "partial" else 4 * c
    n_split = k3.kernel_ffn_split(dtype, 16384, c, hidden)[0]
    scratch = k3._scratch(x, hidden, n_split, entry)
    assert set(scratch) == want
    k3._check_scratch(scratch, x, hidden, n_split, entry)
    if "hidden" in want:
        assert tuple(scratch["hidden"].shape) == (16384, hidden)
        assert scratch["hidden"].dtype == dtype
    if "partial" in want:
        assert tuple(scratch["partial"].shape) == (n_split, 16384, c)
        assert scratch["partial"].dtype == torch.float32


def test_scratch_guards_refuse_what_the_launch_cannot_take():
    x = torch.zeros(64, WIDE)
    n_split = k3.kernel_ffn_split(torch.float32, 64, WIDE, 4 * WIDE)[0]
    good = k3._scratch(x, 4 * WIDE, n_split, "ln")
    assert tuple(good["partial"].shape) == (n_split, 64, WIDE) and n_split == 8
    bad = [
        {"partial": good["partial"]},                                        # no hidden
        {**good, "hidden": torch.zeros(64, 4096)},                           # wrong width
        {**good, "hidden": torch.zeros(64, 8192, dtype=torch.bfloat16)},     # wrong dtype
        {**good, "partial": torch.zeros(1, 64, WIDE)},                       # too few shards
        {**good, "partial": torch.zeros(64, WIDE, 8).permute(2, 0, 1)},     # not contiguous
        {**good, "extra": torch.zeros(1)},                                   # one buffer too many
    ]
    for scratch in bad:
        with pytest.raises(ValueError):
            k3._check_scratch(scratch, x, 4 * WIDE, n_split, "ln")
    # the partial entry at one shard writes its output directly: no partials
    x = torch.zeros(16384, 512)
    with pytest.raises(ValueError):
        k3._check_scratch({"hidden": torch.zeros(16384, 1024),
                           "partial": torch.zeros(1, 16384, 512)}, x, 1024, 1, "partial")


def test_products_shared_memory_leaves_two_blocks_an_sm():
    """Two blocks of each products kernel (8 warps, registers capped for
    two) share an SM's shared memory, each paying 1 KB of reserve."""
    sizes = {(torch.float32, 128): 67584, (torch.float32, 64): 25600,
             (torch.bfloat16, 128): 110592}
    for (dtype, tile_rows), want in sizes.items():
        got = k3.smem_bytes_products(dtype, tile_rows)
        assert got == want
        assert 2 * (got + 1024) <= k3.SMEM_LIMIT


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_launch_nothing(rng, dtype):
    """On CPU tensors the products path's entries run their plain versions:
    no build, no launch, the plain result bit for bit."""
    args = to_port(inputs(rng, 12, WIDE, HIDDEN), dtype)
    small = to_port(inputs(rng, 12, 512, 1024), dtype)
    counts = (k3.fused_ffn.launches, k3.ffn_partial.launches)
    with mock.patch.object(_build, "library", side_effect=AssertionError("built on the CPU")):
        got = k3.fused_ffn(*args)
        part = k3.ffn_partial(*small[:4])
    assert (k3.fused_ffn.launches, k3.ffn_partial.launches) == counts
    assert torch.equal(got, k3.ffn_ln_plain(*args))
    assert torch.equal(part, k3.ffn_partial_plain(*small[:4]))
