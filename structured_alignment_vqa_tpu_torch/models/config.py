"""Model configuration (counterpart of the TPU package's ``models/config.py``).

Same defaults and ``validate()`` as the reference dataclass, with a torch
``compute_dtype``. The TPU package's ``use_pallas_attention`` switch has no
counterpart: the port launches its kernels on every CUDA tensor and runs
their plain versions on CPU tensors. ``seq_axis`` and ``seq_impl`` make
the encoders' self-attention sequence-parallel (ring or Ulysses) over the
ambient mesh's axis of that name.

The port covers the model obj-only and obj+rel (``only_obj=False``, with
``remat_blocks``), packed batches (obj-only), the MCB head (``use_mcb``),
and int8 weight-only serving (``int8_serving``: the GloVe tables and the
heads hold int8 weights, ``ops/quant.py``; serving only, the params from
``quantize_state_dict``). Settings it does not cover raise
``NotImplementedError`` naming the ROADMAP item that ports them
(:meth:`ModelConfig.check_supported`).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Hyperparameters of the SA-VQA model family.

    Defaults follow the production cloud submission: hidden 512, 6 blocks,
    8 heads, maxlen 450 (obj-only), topN 5, hidden_size_mil 1024.
    """

    num_classes: int = 1000
    num_relations: int = 310

    vocab_size: int = 407000   # 400k GloVe rows + 7k specials
    glove_dim: int = 300
    vis_fea_dim: int = 2048

    hidden_size: int = 512
    hidden_size_mil: int = 1024
    num_blocks: int = 6
    num_heads: int = 8
    dropout_rate: float = 0.5
    dropout_rate_mcb: float = 0.1

    maxlen: int = 450
    maxlen_q: int = 40
    maxlen_v: int = 100
    topn: int = 5

    only_obj: bool = True
    use_dec_mask: bool = True
    use_mcb: bool = False        # the MCB fusion head instead of the concat head
    mcb_out: int = 16000

    # blocks [0, stage1) use graph_diag, [stage1, stage2) graph_cross,
    # [stage2, num_blocks) the full graph
    stage1_blocks: int = 2
    stage2_blocks: int = 4
    # False replicates the reference's in-place aliasing of graph_cross by
    # graph (its cross stage runs on the full graph)
    distinct_cross_stage: bool = False

    compute_dtype: torch.dtype = torch.float32
    share_glove: bool = False    # one GloVe table instead of three copies
    remat_blocks: bool = False   # recompute each encoder block in the backward
    # sequence-parallel encoder attention: the ambient mesh's axis to split
    # the encoder sequence over (``ops/attention.py``), and "ring" (K/V
    # rotate, graph row-sharded, any n dividing L) or "ulysses" (all-to-all
    # head sharding, graph whole on every rank, n must divide num_heads)
    seq_axis: "str | None" = None
    seq_impl: str = "ring"
    int8_serving: bool = False

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        if self.hidden_size % self.num_heads:
            raise ValueError("hidden_size must be divisible by num_heads")
        if not (0 < self.stage1_blocks <= self.stage2_blocks <= self.num_blocks):
            raise ValueError("stage boundaries must satisfy 0 < s1 <= s2 <= num_blocks")

    def check_supported(self) -> None:
        """Raise for the settings the port does not cover yet."""
        if self.compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, got {self.compute_dtype}")


def tiny_test_config(**kw) -> ModelConfig:
    """Small config for unit tests: tiny vocab, 2 heads, 3 blocks."""
    base = dict(
        num_classes=11,
        num_relations=7,
        vocab_size=50,
        glove_dim=12,
        vis_fea_dim=16,
        hidden_size=16,
        hidden_size_mil=8,
        num_blocks=3,
        num_heads=2,
        dropout_rate=0.0,
        maxlen=32,
        maxlen_q=8,
        maxlen_v=6,
        topn=2,
        stage1_blocks=1,
        stage2_blocks=2,
        mcb_out=24,
    )
    base.update(kw)
    return ModelConfig(**base)
