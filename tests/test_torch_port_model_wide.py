"""The port's AttModelX3 against the JAX package at production width, and
against the JAX model running its Pallas kernels (interpret mode).

Same weights and batches as test_torch_port_model.py; float32 on the CPU,
logits within 1e-4.
"""

import pytest
import torch

import structured_alignment_vqa_tpu.ops.pallas_attention as pa
from test_torch_port_model import TINY, assert_forward_matches, build_pair

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
