"""The port's AttModelX3 against the JAX package at production width, and
against the JAX model running its Pallas kernels (interpret mode).

Same weights and batches as test_torch_port_model.py; float32 on the CPU,
logits within 1e-4.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

import structured_alignment_vqa_tpu.ops.pallas_attention as pa
import structured_alignment_vqa_tpu.ops.pallas_flash_attention as pfa
import test_torch_port_model as tm
from structured_alignment_vqa_tpu_torch.ops import attention as port_attention
from test_torch_port_model import TINY, assert_forward_matches, build_pair
from variant_port_cases import random_params

# production widths (hidden 512, 8 heads, MIL 1024, 2048-d features), 2
# blocks, a small vocabulary
WIDE = dict(
    num_classes=40, vocab_size=300, hidden_size=512, num_heads=8, num_blocks=2,
    stage1_blocks=1, stage2_blocks=2, dropout_rate=0.0,
)


@pytest.fixture(autouse=True)
def _setup():
    torch.set_num_threads(1)
    pa.INTERPRET_MODE = True
    yield
    pa.INTERPRET_MODE = False


@pytest.mark.parametrize("share_glove", [False, True], ids=["tables", "shared"])
def test_tiny_forward_and_answers_match_jax_pallas(share_glove):
    assert_forward_matches(*build_pair(TINY, share_glove, True))


def test_width_512_forward_and_answers_match_jax():
    """bs 2 on the serving bucket (lv, lq, ls) = (36, 30, 98): the visual
    encoder runs at L 66, the symbolic at L 128."""
    assert_forward_matches(*build_pair(WIDE, True, False, batch=2, bucket=(36, 30, 98), seed=0))


def test_width_768_with_12_heads_forward_and_answers_match_jax_pallas():
    """Hidden 768 with 12 heads (head width 64: BERT-base's and LXMERT's
    width), 2 blocks, bs 2: logits within 1e-4 of the JAX model running its
    Pallas kernels in interpret mode (the K3 and K1 widths the port's
    kernels take since the presets' 512)."""
    kw = dict(WIDE, hidden_size=768, num_heads=12)
    assert_forward_matches(*build_pair(kw, True, True, batch=2, bucket=(6, 5, 12), seed=0))


def test_width_528_with_2_heads_forward_and_answers_match_jax_pallas():
    """Hidden 528 with 2 heads (head width 264, past the first SIMT
    kernels' 256: the wide path on the card), 1 block, tiny otherwise:
    logits within 1e-4 of the JAX model running its Pallas kernels in
    interpret mode. C above 2,048 at model level is held on the card
    (``chip_smoke.py --phases widths``): a CPU model that wide costs about
    65 C^2 parameters a block."""
    kw = dict(TINY, hidden_size=528, num_heads=2, num_blocks=1, stage1_blocks=1,
              stage2_blocks=1)
    jcfg = tm.JaxConfig(share_glove=True, use_pallas_attention=True, **kw)
    pcfg = tm.ModelConfig(share_glove=True, **kw)
    arrays = tm.synthetic_arrays(pcfg, 2, lv=4, lq=5, ls=10, seed=0)
    jb = tm.jax_batch(arrays)
    jmodel = tm.JaxModel(jcfg)
    # the params drawn at the init's shapes (jax.eval_shape): an eager init
    # at this width takes half a minute on the CPU
    params = random_params(jmodel, (jb,), {})
    model = tm.AttModelX3(pcfg, device="cpu")
    model.load_state_dict(tm.state_dict_from_jax(params, pcfg.num_blocks), strict=True)
    model.eval()
    assert_forward_matches(jmodel, jax.tree.map(jnp.asarray, params), jb, model,
                           tm.batch_from_arrays(arrays, "cpu"))


def test_obj_rel_width_512_with_2_heads_forward_matches_jax_pallas(monkeypatch):
    """obj+rel at hidden 512 with 2 heads (head width 256: Gemma-2B's heads,
    which K1's and K4's tensor-core kernels take on the card), 1 block,
    tiny otherwise, maxlen 600 at bucket (4, 8, 520): the symbolic encoder
    runs at L 528, past K1's 512 keys, so the flash path (K4's plain
    version here) serves it. Logits within 1e-4 of the JAX model running
    its Pallas kernels in interpret mode (its flash kernel's ``interpret``
    argument set here, as the JAX package's flash tests set it)."""
    from test_torch_port_mil_nce_rel import rel_arrays

    real = pfa.flash_graph_attention
    monkeypatch.setattr(pfa, "flash_graph_attention",
                        lambda *a, **k: real(*a, **dict(k, interpret=True)))
    widths = []   # the head widths of the port's flash calls
    port_flash = port_attention.flash_graph_attention
    monkeypatch.setattr(port_attention, "flash_graph_attention",
                        lambda *a: widths.append(a[0].shape[-1] // a[6]) or port_flash(*a))

    kw = dict(TINY, only_obj=False, maxlen=600, hidden_size=512, num_heads=2, num_blocks=1,
              stage1_blocks=1, stage2_blocks=1)
    jcfg = tm.JaxConfig(share_glove=True, use_pallas_attention=True, **kw)
    pcfg = tm.ModelConfig(share_glove=True, **kw)
    arrays = rel_arrays(pcfg, 2, (4, 8, 520), seed=7)
    jb = tm.jax_batch(arrays)
    jmodel = tm.JaxModel(jcfg)
    params = random_params(jmodel, (jb,), {})
    model = tm.AttModelX3(pcfg, device="cpu")
    model.load_state_dict(tm.state_dict_from_jax(params, pcfg.num_blocks), strict=True)
    model.eval()
    assert_forward_matches(jmodel, jax.tree.map(jnp.asarray, params), jb, model,
                           tm.batch_from_arrays(arrays, "cpu"))
    assert widths and set(widths) == {256}
