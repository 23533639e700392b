"""Compact bilinear pooling, the MCB fusion head (counterpart of the TPU
package's ``ops/mcb.py``; reference ``AttModel_x3.py:444-469``, which used
the legacy ``torch.rfft``/``torch.irfft``).

Both inputs are projected by a count sketch, multiplied in the frequency
domain (a circular convolution), then passed through a signed square root
and an L2 normalization. The FFTs are ``torch.fft`` (cuFFT on the card):
the TPU package computes them with ``jnp.fft`` outside any Pallas kernel, so
there is no TPU kernel here to port.

Quirks kept:

* the legacy ``torch.irfft`` divided by n and the reference multiplies by
  ``output_dim`` to undo it; ``torch.fft.irfft`` divides by n too, so the
  ``* output_dim`` stays;
* the L2 normalization runs over **dim 0**, the batch axis, padding rows
  included (``AttModel_x3.py:468``); under a mesh of several ranks
  (``parallel/context.py``) over the global batch, as in the TPU package's
  global-batch step: the sum of squares is summed over the ranks.
"""

from __future__ import annotations

import numpy as np
import torch

from structured_alignment_vqa_tpu_torch.parallel.context import distributed_mesh
from structured_alignment_vqa_tpu_torch.parallel.sharding import sum_over_ranks


def count_sketch_matrix(rng: np.random.Generator, input_dim: int, output_dim: int) -> np.ndarray:
    """Dense (input_dim, output_dim) float32 count sketch: one random +-1 per
    input row (a random column h(i), a random sign s(i)). It is frozen, not
    trained. Draws from ``rng`` exactly what the TPU package's copy draws."""
    h = rng.integers(0, output_dim, size=(input_dim,))
    s = 2 * rng.integers(0, 2, size=(input_dim,)) - 1
    m = np.zeros((input_dim, output_dim), dtype=np.float32)
    m[np.arange(input_dim), h] = s.astype(np.float32)
    return m


def compact_bilinear_pooling(x1: torch.Tensor, x2: torch.Tensor, sketch1: torch.Tensor,
                             sketch2: torch.Tensor, output_dim: int) -> torch.Tensor:
    """The circular convolution of the two sketched inputs, in float32.

    x1, x2: (..., D_in); sketches: (D_in, output_dim). Returns float32
    (..., output_dim), L2-normalized over dim 0 with the norm clamped at
    1e-12, as ``F.normalize`` does.
    """
    f1 = torch.fft.rfft(torch.matmul(x1.float(), sketch1.float()), dim=-1)
    f2 = torch.fft.rfft(torch.matmul(x2.float(), sketch2.float()), dim=-1)
    cbp = torch.fft.irfft(f1 * f2, n=output_dim, dim=-1) * output_dim
    signed_sqrt = torch.sqrt(torch.relu(cbp)) - torch.sqrt(torch.relu(-cbp))
    sum_sq = torch.sum(torch.square(signed_sqrt), dim=0, keepdim=True)
    mesh = distributed_mesh()
    if mesh is not None:
        sum_sq = sum_over_ranks(sum_sq, mesh)
    norm = torch.sqrt(sum_sq)
    return signed_sqrt / torch.clamp(norm, min=1e-12)
