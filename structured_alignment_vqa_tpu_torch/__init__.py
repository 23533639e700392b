"""SA-VQA in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

A port of ``structured_alignment_vqa_tpu`` (JAX/Pallas, the reference).
It covers the unpacked ``AttModelX3``, obj-only and obj+rel: the serving
forward (``models.AttModelX3`` + ``train.predict.make_predict_step``), the
training and eval steps (``parallel.train_step``), the host data pipeline
(``data/``: tar index, graph builder, collate, bucketed loader, sample and
batch caches, fixtures; ``data/transfer.py`` moves batches to the card),
the training CLI (``python -m structured_alignment_vqa_tpu_torch.train.main``,
``train/loop.py``; the sparse GloVe-table optimizer of
``parallel/sparse_table.py``; data parallel over ranks and hosts,
``parallel/{mesh,context,sharding}.py``, ``.train.launch``) and the predict
and eval CLIs (``.train.predict``,
with int8 serving from ``ops/quant.py``, / ``.train.evaluate``; checkpoints
of ``utils.checkpoint``).
The TPU package's six
Pallas kernels are CUDA C++ sources under ``csrc/``, built with ``nvcc`` on
first use (``ops/_build.py``):

* ``ops/fused_graph_attention.py`` — graph attention + residual + LayerNorm
  up to 512 keys and its backward (``ops/pallas_attention.py:_kernel``,
  ``ops/pallas_attention_bwd.py:_bwd_kernel``);
* ``ops/fused_ffn.py`` — FFN + residual + LayerNorm
  (``ops/pallas_ffn.py:_kernel``);
* ``ops/flash_graph_attention.py`` — K-blocked graph attention for long
  sequences and its backward (``ops/pallas_flash_attention.py:_kernel``,
  ``_bwd_dq_kernel``, ``_bwd_dkv_kernel``).

Each wrapper launches its kernel on CUDA tensors and runs its plain PyTorch
version on CPU tensors. The package imports neither JAX nor the TPU package.
"""

from structured_alignment_vqa_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
