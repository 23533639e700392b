"""K1, K4, K5 and K6 above head width 128: the routing and the plans, on the CPU.

K1's tensor-core kernel takes bfloat16 at head widths that are multiples of
16 up to 256 (instance 256), K4's tensor-core kernel bfloat16 at every
multiple of 16 (instance 256 up to 256, the chunked kernel above) and its
register-tiled kernel float32 at every multiple of 4 (instance 256 in
32-key steps up to 256, the chunked f32 kernel above). K5 and K6 have a
limit of their own, 256 (``dispatch.K56_TC_MAX_HEAD_DIM``): their
tensor-core kernels take bfloat16 at multiples of 16 and their f32 kernels
float32 at multiples of 4 up to 256 (instance 256, pairs of warps), and K2
above 128 is composed of a tiled forward, its LayerNorm backward, K5 and
K6 (``k2_path`` "composed"). The shared memory and the key split of each
new instance are pure functions mirrored from ``csrc/`` and held to the
227 KB a block may use.
"""

import pathlib
import re

import pytest
import torch

from structured_alignment_vqa_tpu_torch.ops import flash_graph_attention as flash
from structured_alignment_vqa_tpu_torch.ops import fused_graph_attention as k1
from structured_alignment_vqa_tpu_torch.ops.dispatch import SMEM_LIMIT

HEADS = 8
LENGTHS = (1, 16, 128, 450, 512)
FLASH_L = 1536


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


# the paths K2, K5 and K6 take at these head widths (8 heads, C = 8 x the
# head width): K5 and K6 the tensor-core kernels in bf16 at multiples of 16
# and the f32 kernels in f32 at multiples of 4 up to 256, and K2 the
# composed route there; the SIMT kernels at a bf16 width no multiple of 16;
# the wide ones above 256, in either dtype
@pytest.mark.parametrize("dtype,head_dim,want,want_k2", [
    (torch.bfloat16, 136, "simt", "simt"), (torch.bfloat16, 144, "tensor-core", "composed"),
    (torch.bfloat16, 192, "tensor-core", "composed"),
    (torch.bfloat16, 256, "tensor-core", "composed"),
    (torch.bfloat16, 320, "wide", "wide"), (torch.bfloat16, 512, "wide", "wide"),
    (torch.float32, 136, "f32", "composed"), (torch.float32, 192, "f32", "composed"),
    (torch.float32, 256, "f32", "composed"), (torch.float32, 320, "wide", "wide"),
    (torch.float32, 512, "wide", "wide"),
], ids=str)
def test_k2_k5_k6_keep_their_paths_above_128(dtype, head_dim, want, want_k2):
    c = HEADS * head_dim
    assert flash.dq_kernel(dtype, head_dim) == want
    assert flash.dkv_kernel(dtype, head_dim) == want
    assert flash.kernel_path(dtype, head_dim) == "simt"   # K2's own tensor-core limit: 128
    for tk in LENGTHS:
        assert k1.k2_path(dtype, head_dim, tk, c, HEADS) == want_k2
    # K5's key split: K4's rule on the tensor-core kernel, the f32 plan (16-key
    # steps above 128) on the f32 kernel, one shard of every 64-key step else
    for tq in (1, FLASH_L):
        want_split = {"tensor-core": flash.key_split(4, HEADS, tq, FLASH_L),
                      "f32": flash.dq_f32_plan(4, HEADS, tq, FLASH_L, head_dim)[1:]}.get(
            want, (1, FLASH_L // 64))
        assert flash.dq_key_split(dtype, head_dim, 4, HEADS, tq, FLASH_L) == want_split


@pytest.mark.parametrize("head_dim", [144, 192, 256, 320, 512])
def test_k1_k4_new_instances_fit_and_plan(head_dim):
    """bf16 at a multiple of 16: K4's tensor-core kernel up to 256 (instance
    256, Q in shared memory, one block an SM) and K1's up to 256
    (instance 256, at every length K1 takes); f32 at a multiple of 4: K4's
    register-tiled kernel up to 256 (instance 256: 64 or 16 query rows, 32
    keys a step). Above 256 K4 takes the chunked tensor-core (bf16) and
    f32 kernels (their shared memory the same at every width), K1 the wide
    path, as before. Each key split covers the key steps with no shard
    empty, and splits only where the blocks (a block per head and chunk on
    the chunked kernel) do not cover the card."""
    c = HEADS * head_dim
    bf16, f32 = torch.bfloat16, torch.float32
    if head_dim <= 256:
        assert flash.k4_path(bf16, head_dim) == "tensor-core"
        assert flash.tc_width(head_dim) == 256
        for tq in (1, 64, 65, FLASH_L):
            rows = flash.tc_rows(bf16, head_dim, tq)
            assert rows == (128 if tq > 64 else 64)
            assert SMEM_LIMIT // (flash.smem_bytes_tc(head_dim, rows) + 1024) >= 1
        assert flash.k4_path(f32, head_dim) == "f32"
        for q_tile in (16, 64):
            assert SMEM_LIMIT // (flash.smem_bytes_f32(head_dim, q_tile) + 1024) >= 1
        assert flash.f32_step(head_dim) == 32
        assert k1.k1_path(bf16, head_dim) == "tensor-core"
        for tq in LENGTHS:
            for tk in LENGTHS:
                assert k1.k1_path(bf16, head_dim, tk, c) == "tensor-core"
                assert SMEM_LIMIT // (k1.smem_bytes_tc(tq, tk, c, HEADS) + 1024) >= 1
        assert k1.k1_path(f32, head_dim) == "simt"
    else:
        assert flash.k4_path(bf16, head_dim) == "tc-chunked"
        assert SMEM_LIMIT // (flash.smem_bytes_tc_chunked() + 1024) >= 1
        assert flash.k4_path(f32, head_dim) == "f32-chunked"
        for tq in (1, 16, 17, FLASH_L):
            assert flash.k4_f32_plan(head_dim, 4, HEADS, tq, FLASH_L)[0] == 128
            assert flash.tc_rows(bf16, head_dim, tq) == 128
        assert SMEM_LIMIT // (flash.smem_bytes_f32_chunked() + 1024) >= 1
        for dtype in (bf16, f32):
            assert k1.k1_path(dtype, head_dim) == "wide"
        assert flash.smem_bytes_wide("K4") <= SMEM_LIMIT
    for dtype in (bf16, f32):
        path = flash.k4_path(dtype, head_dim)
        step = flash.f32_step(head_dim) if path.startswith("f32") else flash.KEY_STEP
        steps = -(-FLASH_L // step)
        for batch, tq in ((4, 1), (4, FLASH_L), (2, FLASH_L), (4, 70)):
            n_split, per = flash.kernel_key_split(dtype, head_dim, batch, HEADS, tq, FLASH_L)
            assert n_split >= 1 and (n_split - 1) * per < steps <= n_split * per
            chunks = flash.wide_chunks(head_dim) if path.endswith("chunked") else 1
            rows = (flash.k4_f32_plan(head_dim, batch, HEADS, tq, FLASH_L)[0]
                    if path.startswith("f32") else flash.tc_rows(dtype, head_dim, tq))
            if batch * HEADS * chunks * -(-tq // rows) >= flash.SM_COUNT:
                assert n_split == 1


def test_k4_tensor_core_shared_memory_matches_the_kernel_layout():
    """``smem_bytes_tc`` as ``tc_smem_bytes`` lays it out: up to 128 two
    stages (Q in the last stage's room), above two stages and Q's own room;
    the chunked kernel's two slots as ``chunk_slot_bytes``."""
    stage = lambda w: 2 * 2 * 64 * (w + 8) + 4 * (64 * 72 + 64)
    assert flash.smem_bytes_tc(64) == 2 * stage(64)
    assert flash.smem_bytes_tc(128) == 2 * stage(128)
    assert flash.smem_bytes_tc(256) == 2 * stage(256) + 2 * 64 * 264 == 206336
    # 128 rows: no graph tile (read in fragments), Q's room twice as tall
    assert flash.smem_bytes_tc(256, 128) == 2 * (2 * 2 * 64 * 264 + 4 * 64) + 2 * 128 * 264
    assert flash.smem_bytes_tc(256, 128) <= SMEM_LIMIT
    assert flash.smem_bytes_tc(144) == flash.smem_bytes_tc(256)
    assert flash.smem_bytes_f32(256, 64) == 4 * (64 * 256 + 2 * (2 * 32 * 256 + 64 * 32 + 32))
    assert flash.smem_bytes_f32(132, 16) == flash.smem_bytes_f32(256, 16)
    slot = 2 * 64 * 264 + 4 * 64 + 2 * 192 * 136
    assert flash.smem_bytes_tc_chunked() == 2 * slot == 172544
    f32_slot = 160 * 64 + 32 * 256 + 128 * 32 + 32
    assert flash.smem_bytes_f32_chunked() == 8 * f32_slot == 180480


@pytest.mark.parametrize("batch,tq,tk,rows,want", [
    (4, 1, 1536, 64, (8, 3)),      # the decoder's one query at hidden 2,048: 32 blocks
    (2, 1536, 1536, 128, (1, 24)),  # B 2, L 1,536: 192 blocks of 128 rows cover the card
    (4, 70, 1536, 128, (8, 3)),     # one query tile of 128 rows: 32 blocks
    (4, 64, 1536, 64, (8, 3)),      # 64 rows: one tile of 64
])
def test_k4_head256_key_split(batch, tq, tk, rows, want):
    """K4 at head width 256 in bf16 splits its keys as at 64 (``key_split``:
    about two blocks an SM), counting blocks of its rows (``tc_rows``: 128
    above 64 query rows); in f32 its 32-key steps go four to a shard where
    the blocks do not cover the card."""
    assert flash.tc_rows(torch.bfloat16, 256, tq) == rows
    assert flash.kernel_key_split(torch.bfloat16, 256, batch, HEADS, tq, tk) == want
    assert flash.kernel_key_split(torch.bfloat16, 256, batch, HEADS, tq, tk) == flash.key_split(
        batch, HEADS, tq, tk, rows)
    q_tile, n_split, per = flash.f32_plan(batch, HEADS, tq, tk, 32)
    assert flash.kernel_key_split(torch.float32, 256, batch, HEADS, tq, tk) == (n_split, per)
    steps = -(-tk // 32)
    if batch * HEADS * -(-tq // q_tile) < flash.SM_COUNT:
        assert per == min(flash.F32_SPLIT_STEPS, steps)
    else:
        assert (n_split, per) == (1, steps)


def test_k4_path_codes_follow_the_c_entry():
    """The wrapper counts K4's launches by the kernel its C entry reports
    (``savqa_flash_graph_attention_last_path``): ``C_PATHS`` names the
    entry's codes in the order of its ``K4Path`` enum, and each name is one
    that ``k4_path`` returns."""
    src = (pathlib.Path(flash.__file__).parent.parent / "csrc"
           / "flash_graph_attention.cu").read_text()
    enum = re.search(r"enum K4Path \{([^}]*)\}", src).group(1)
    codes = [name.strip() for name in enum.split(",")]
    assert codes == ["kPathSimt", "kPathWide", "kPathTc", "kPathTcChunked", "kPathF32",
                     "kPathF32Chunked"]
    assert flash.C_PATHS == ("simt", "wide", "tensor-core", "tc-chunked", "f32", "f32-chunked")
    taken = {flash.k4_path(dtype, dh) for dtype in (torch.bfloat16, torch.float32)
             for dh in (8, 50, 64, 256, 258, 320)}
    assert taken == set(flash.C_PATHS)
