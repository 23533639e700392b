"""K5 and K6 at head widths 129-256 and K2 above 128, on the CPU.

K5's and K6's tensor-core kernels take bfloat16 at every multiple of 16 up
to 256 and their f32 kernels float32 at every multiple of 4 up to 256
(instance 256: pairs of warps; K5 in float32 in 16-key steps). K2 above
head width 128, and in bfloat16 wherever its tensor-core rows launch does
not fit, takes the composed route (``k2_path`` "composed"): a tiled
forward's o and m, z, b, the LayerNorm backward at any C, then K5 and K6.
Its plain version (``graph_attention_ln_bwd_composed_plain``) rounds where
the route rounds; it is held here to K2's plain version and to the JAX
package's backward kernel. A training step at 2 heads of 256 (on the CPU
K2's wrapper runs K2's plain version on every route) is held to the JAX
step.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import structured_alignment_vqa_tpu.ops.pallas_attention as pa
import test_torch_port_model as tm
from structured_alignment_vqa_tpu_torch.models import AttModelX3
from structured_alignment_vqa_tpu_torch.ops import flash_graph_attention as flash
from structured_alignment_vqa_tpu_torch.ops import fused_graph_attention as k1
from structured_alignment_vqa_tpu_torch.ops.dispatch import SMEM_LIMIT
from structured_alignment_vqa_tpu_torch.parallel.train_step import TrainState, adam, make_train_step
from test_torch_port_attention_bwd import NAMES, assert_close, jax_bwd, make_inputs
from test_torch_port_train_step import GRAD_RTOL, _assert_grads_match, _jax_loss
from variant_port_cases import random_params

HEADS = 8
FLASH_L = 1536
BF16_TOL = 2 ** -6   # the card's K2, K5, K6 limit: n and dS rounded to bf16 as operands
LOSS_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _setup():
    torch.set_num_threads(1)
    pa.INTERPRET_MODE = True
    yield
    pa.INTERPRET_MODE = False


def test_k5_k6_take_the_tiled_kernels_up_to_256():
    for head_dim in range(129, 257):
        bf16 = "tensor-core" if head_dim % 16 == 0 else "simt"
        f32 = "f32" if head_dim % 4 == 0 else "simt"
        for dtype, want in ((torch.bfloat16, bf16), (torch.float32, f32)):
            assert flash.k56_path(dtype, head_dim) == want
            assert flash.dq_kernel(dtype, head_dim) == flash.dkv_kernel(dtype, head_dim) == want
    for head_dim in (258, 272, 320, 512):
        for dtype in (torch.bfloat16, torch.float32):
            assert flash.k56_path(dtype, head_dim) == "wide"


@pytest.mark.parametrize("dtype,c,heads,want", [
    (torch.bfloat16, 2048, 8, "composed"), (torch.float32, 2048, 8, "composed"),
    (torch.bfloat16, 2048, 16, "composed"), (torch.float32, 2048, 16, "f32"),
    (torch.bfloat16, 4096, 32, "composed"), (torch.bfloat16, 512, 8, "tensor-core"),
    (torch.bfloat16, 1088, 8, "simt"), (torch.float32, 1056, 8, "composed"),
    (torch.float32, 2064, 8, "wide"),
], ids=str)
def test_k2_routes_above_128_through_k5_and_k6(dtype, c, heads, want):
    """C 2,048 with 8 heads of 256 in either dtype, and with 16 of 128 in
    bf16 (the tensor-core rows launch does not fit), take the composed
    route; f32 at 16 heads of 128 keeps its f32 kernels; a bf16 head of 136
    (no multiple of 16) keeps the SIMT kernels, 258 the wide path. The
    route's LayerNorm backward is the wide path's (64 rows a partial) and
    the shared memory of every kernel it launches fits a block."""
    for tq, tk in ((1, 450), (128, 128), (512, 512)):
        assert k1.k2_path(dtype, c // heads, tk, c, heads) == want
        if want == "composed":
            assert k1.bwd_row_tile(dtype, c // heads, tq, tk, c, heads) == k1.BWD_F32_ROWS
            t = torch.zeros(1, tq, c, dtype=dtype)
            kv = torch.zeros(1, tk, c, dtype=dtype)
            k1._check(t, kv, kv, torch.ones(1, tk), torch.ones(1, tq), torch.ones(1, tq, tk), t,
                      torch.ones(c), torch.zeros(c), heads, "l1", dy=t)


@pytest.mark.parametrize("dtype,tq,want", [
    (torch.bfloat16, 1, (8, 3)),        # the decoder's one query, B 4: 32 blocks
    (torch.bfloat16, 1536, (1, 24)),    # 192 blocks of 64 rows at B 4 / 8 heads cover the card
    (torch.float32, 1, (12, 8)),        # 96 16-key steps, 128 keys a shard
    (torch.float32, 1536, (1, 96)),
], ids=str)
def test_k5_key_split_at_256(dtype, tq, want):
    """K5 at head width 256 keeps its key split: on the tensor-core pair
    kernel K4's rule (64 rows, 64-key steps), on the f32 kernel shards of
    128 keys in 16-key steps where its blocks do not cover the card."""
    assert flash.dq_key_split(dtype, 256, 4, HEADS, tq, FLASH_L) == want
    if dtype == torch.float32:
        assert flash.dq_f32_step(256) == 16 and flash.dq_f32_step(128) == 32
        q_tile = flash.dq_f32_plan(4, HEADS, tq, FLASH_L, 256)[0]
        assert q_tile == (16 if tq <= 16 else 64)


def test_instance_256_shared_memory_matches_the_kernel_layouts_and_fits():
    """The mirrors of ``csrc/flash_graph_attention_bwd.cu``: the tensor-core
    kernels' two stages (K5: K, V (64, 264) bf16, the (64, 72) graph tile,
    the key mask; K6: Q, dO, the (64, 68) graph tile, 64 rows' 32-byte
    terms) and at 256 the pairs' exchange; the f32 kernels' at 256 (K6: 32
    keys, the pairs' exchange; K5: 16-key steps). One block each fits the
    227 KB a block may use."""
    k5_stage = 2 * 2 * 64 * 264 + 4 * (64 * 72 + 64)
    k6_stage = 2 * 2 * 64 * 264 + 4 * 64 * 68 + 32 * 64
    assert flash.smem_bytes_k56_tc("K5", 256) == 2 * k5_stage + 2 * 8 * 32 * 16 * 4 == 205312
    assert flash.smem_bytes_k56_tc("K6", 256) == 2 * k6_stage + 2 * 4 * 32 * 8 * 4 == 182272
    assert flash.smem_bytes_k56_tc("K5", 64) == 74240     # "74-76 KB a block" (3 an SM)
    assert flash.smem_bytes_k56_tc("K6", 64) == 75776
    assert flash.smem_bytes_k56_tc("K6", 144) == flash.smem_bytes_k56_tc("K6", 256)
    assert flash.smem_bytes_dkv_f32(256) == 4 * (2 * 32 * 256 + 4 * 32 * 16 + 2 * 32 * 16
                                                 + 2 * (2 * 32 * 256 + 32 * 32 + 4 * 32))
    assert flash.smem_bytes_dq_f32(256, 64) == 4 * (2 * 64 * 256
                                                    + 2 * (2 * 16 * 256 + 64 * 16 + 16))
    assert flash.smem_bytes_dkv_f32(132) == flash.smem_bytes_dkv_f32(256)
    for head_dim in range(132, 257, 4):
        need = [flash.smem_bytes_dkv_f32(head_dim), flash.smem_bytes_dq_f32(head_dim, 64),
                flash.smem_bytes_dq_f32(head_dim, 16)]
        if head_dim % 16 == 0:
            need += [flash.smem_bytes_k56_tc(kn, head_dim) for kn in ("K5", "K6")]
        assert max(need) + 1024 <= SMEM_LIMIT, (head_dim, need)


def test_k5_k6_path_codes_follow_the_c_entries():
    """K5's and K6's wrappers count launches by the kernel their C entries
    report (``savqa_flash_graph_attention_bwd_last_path``): ``C_PATHS_K56``
    names the codes in the order of the entries' ``K56Path`` enum, and every
    name is one ``k56_path`` returns."""
    src = (pathlib.Path(flash.__file__).parent.parent / "csrc"
           / "flash_graph_attention_bwd.cu").read_text()
    enum = re.search(r"enum K56Path \{([^}]*)\}", src).group(1)
    assert [n.strip() for n in enum.split(",")] == ["kK56Simt", "kK56Wide", "kK56Tc", "kK56F32"]
    assert flash.C_PATHS_K56 == ("simt", "wide", "tensor-core", "f32")
    taken = {flash.k56_path(dtype, dh) for dtype in (torch.bfloat16, torch.float32)
             for dh in (50, 64, 256, 258)}
    assert taken == set(flash.C_PATHS_K56)
    assert set(flash.DQ_PATHS) == set(flash.C_PATHS_K56)


@pytest.mark.parametrize("path,head_dim,want", [
    ("tensor-core", 64, 64), ("tensor-core", 144, 256), ("tensor-core", 256, 256),
    ("f32", 16, 32), ("f32", 132, 256), ("f32", 256, 256),
    ("simt", 8, 16), ("simt", 50, 64), ("simt", 136, 256), ("wide", 258, 0)])
def test_k5_k6_instance_of_a_head_width(path, head_dim, want):
    """The instance the wrappers hold K5's and K6's C entries to
    (``savqa_flash_graph_attention_bwd_last_width``): the pair kernels'
    256 from 129 up, the first SIMT kernels' 16 x NDH, none (0) for the
    wide kernels."""
    assert flash.k56_instance(path, head_dim) == want
    if path != "wide":
        assert flash.k56_path(torch.bfloat16 if path != "f32" else torch.float32,
                              head_dim) in (path, "simt")


def test_k5_k6_launchers_note_their_kernel_and_instance():
    """Every launcher of K5's and K6's kernels notes the kernel and the
    instance it starts (``started``) before its launch: 2 SIMT, 2 wide, 3
    f32 (K6's two, K5's one) and 4 tensor-core (K5's and K6's, at 16-128
    and the pairs at 256); each entry clears the note first."""
    src = (pathlib.Path(flash.__file__).parent.parent / "csrc"
           / "flash_graph_attention_bwd.cu").read_text()
    notes = re.findall(r"started\((kK56\w+), ([^)]*)\);", src)
    assert sorted(notes) == sorted(
        [("kK56Simt", "16 * NDH")] * 2 + [("kK56Wide", "0")] * 2 + [("kK56F32", "DH")] * 3
        + [("kK56Tc", "DH")] * 4 + [("kK56Simt", "-1")] * 2)


def _torch(args, dy, dtype):
    t = [torch.from_numpy(a) for a in args]
    for i in (0, 1, 2, 6):                            # q, k, v, residual in the working type
        t[i] = t[i].to(dtype)
    return t, torch.from_numpy(dy).to(dtype)


@pytest.mark.parametrize("renorm", ["l1", "sum_eps"])
@pytest.mark.parametrize("tq,tk", [(20, 20), (1, 40)], ids=["self", "one-query-cross"])
def test_composed_plain_matches_k2_plain(rng, renorm, tq, tk):
    """f32: within 1e-5 of K2's plain version (the same function, its sums
    in another order). bf16: within 2^-6 of each output's largest value,
    the composed route rounding n and dS (K5's and K6's operands) where K2
    rounds its weights A and dS; dresidual, dgamma and dbeta are the same
    LayerNorm backward's."""
    args, dy = make_inputs(rng, 2, tq, tk, 512)
    t, d = _torch(args, dy, torch.float32)
    got = k1.graph_attention_ln_bwd_composed_plain(*t, d, 2, renorm)
    want = k1.graph_attention_ln_bwd_plain(*t, d, 2, renorm)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32
        assert_close(g.numpy(), w.numpy(), name)
    t, d = _torch(args, dy, torch.bfloat16)
    got = k1.graph_attention_ln_bwd_composed_plain(*t, d, 2, renorm)
    want = k1.graph_attention_ln_bwd_plain(*t, d, 2, renorm)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype
        if name in ("dresidual", "dgamma", "dbeta"):
            assert torch.equal(g, w), name
            continue
        err = (g.float() - w.float()).abs().max().item() / w.float().abs().max().item()
        assert err <= BF16_TOL, (name, err)


@pytest.mark.parametrize("renorm", ["l1", "sum_eps"])
def test_composed_plain_matches_the_jax_kernel_at_2_heads_of_256(rng, renorm):
    """C 512 with 2 heads of 256, L 16, float32: the JAX package's
    ``_bwd_kernel`` in interpret mode, within 1e-5 row by row."""
    args, dy = make_inputs(rng, 2, 16, 16, 512)
    t, d = _torch(args, dy, torch.float32)
    got = k1.graph_attention_ln_bwd_composed_plain(*t, d, 2, renorm)
    want = jax_bwd(args, dy, 2, renorm)
    for name, g, w in zip(NAMES, got, want):
        assert_close(g.numpy(), np.asarray(w), name)


# hidden 512 with 2 heads of 256, 1 block, tiny otherwise (as
# test_torch_port_model_wide.py builds its width-512 / 2-head model)
HEAD256 = dict(tm.TINY, hidden_size=512, num_heads=2, num_blocks=1, stage1_blocks=1,
               stage2_blocks=1)


def _one_step(kw, arrays):
    """The JAX loss and gradients at random params and the port's train
    step from the same params: (JAX loss, JAX grads, port loss, model)."""
    jcfg = tm.JaxConfig(share_glove=False, use_pallas_attention=False, **kw)
    pcfg = tm.ModelConfig(share_glove=False, **kw)
    jb = tm.jax_batch(arrays)
    jmodel = tm.JaxModel(jcfg)
    params = random_params(jmodel, (jb,), {})
    loss, grads = jax.jit(jax.value_and_grad(_jax_loss(jmodel, kw.get("only_obj", True))))(
        jax.tree.map(jnp.asarray, params), jb)
    model = AttModelX3(pcfg, device="cpu")
    model.load_state_dict(tm.state_dict_from_jax(params, pcfg.num_blocks), strict=True)
    opt = adam(model.parameters())
    metrics = make_train_step(model, opt, pcfg)(TrainState(model, opt),
                                                tm.batch_from_arrays(arrays, "cpu"))
    return float(loss), grads, metrics["loss"].item(), model


def test_obj_only_step_at_2_heads_of_256_matches_jax():
    """One obj-only training step: the encoders' self-attention K2 at head
    width 256 runs the composed route's plain version; loss and every
    gradient within 1e-4 of the JAX step's (each gradient relative to its
    largest magnitude)."""
    pcfg = tm.ModelConfig(share_glove=False, **HEAD256)
    arrays = tm.synthetic_arrays(pcfg, 2, lv=4, lq=5, ls=10, seed=3)
    assert k1.k2_path(torch.float32, 256, 15, 512, 2) == "composed"
    jloss, jgrads, loss, model = _one_step(HEAD256, arrays)
    assert abs(loss - jloss) <= LOSS_ATOL, (loss, jloss)
    _assert_grads_match(model, jgrads, HEAD256["num_blocks"], GRAD_RTOL)


def test_obj_rel_step_at_2_heads_of_256_matches_jax():
    """One obj+rel training step at maxlen 600, bucket (4, 8, 520): the
    symbolic encoder's 528 keys take the flash path, whose backward is K5's
    and K6's plain versions at head width 256; loss and gradients within
    1e-4 of the JAX step's."""
    from test_torch_port_mil_nce_rel import rel_arrays

    kw = dict(HEAD256, only_obj=False, maxlen=600)
    pcfg = tm.ModelConfig(share_glove=False, **kw)
    arrays = rel_arrays(pcfg, 2, (4, 8, 520), seed=7)
    jloss, jgrads, loss, model = _one_step(kw, arrays)
    assert abs(loss - jloss) <= LOSS_ATOL, (loss, jloss)
    _assert_grads_match(model, jgrads, kw["num_blocks"], GRAD_RTOL)
