#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of SA-VQA on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which must pass:

1. card: name and power limit (nvidia-smi);
2. build: every CUDA source under structured_alignment_vqa_tpu_torch/csrc
   with nvcc, one process per source, into build/;
3. K1 (graph attention + LayerNorm) against its plain PyTorch version on the
   card, bf16 and f32, at the serving shapes: B 128, C 512, 8 heads,
   self-attention at L 66 and 128, one-query cross-attention into 66 and
   128 keys, both renorms, and at the obj+rel shapes (B 4); each line says
   which kernel the shape took (tensor-core, f32 or SIMT); a bf16 shape
   with a head width of 8 and an f32 one with a head width of 10 must take
   the SIMT kernel, one with 65 keys checks the unaligned graph loads, one
   has a sample whose keys are all masked, one walks 300 keys in five steps
   (each in bf16 and f32); f32 also at the variants' shapes (B 64: self L 99
   and 300, one query into 99 and 300, 50 queries into 299), and at every
   f32 shape bit for bit: both entries against the first SIMT kernel on
   the same inputs, the 8-head entry against two 4-head attention-only
   halves and the LayerNorm entry; one f32 call under torch.profiler must
   run only the f32 and LayerNorm kernels of csrc/graph_attention.cu; and
   at the widths beyond the presets', timed beside their bounds: C 2,048 at
   8 heads of 256 (the SIMT kernel, 8 rows a block at 512 keys), L 128 and
   512, B 8, bf16 and f32, and a head of 33 (C 99) untimed; above that old
   domain, from a generator of their own (so every row before them sees the
   inputs it saw), at B 4, L 128 and 450, C 4,096 with 32 heads of 128 (the
   tensor-core and f32 kernels, the LayerNorm at C 4,096) and with 8 heads
   of 512, and C 2,560 with 8 heads of 320 (the wide path: the wide K4
   kernel and the LayerNorm kernel, alone under torch.profiler), timed;
4. K3 (FFN + LayerNorm) the same way at 16,384, 8,448 and 128 rows and at
   obj+rel's 6,144, 264 and 4 rows, at C 2,048 (3,136 rows), and in f32 at
   the variants' 64, 3,136, 6,336 and 19,200 rows and as the model axis's
   partial (16,384 rows, a hidden shard of 1,024); each line says which
   path the call took (the bf16 row-tile kernel or the products path) and
   into how many shards the hidden width was split; 1,000 and 1,001 rows
   check ragged last tiles; one f32 and the wide calls run under
   torch.profiler, which must see only kernels of csrc/ffn.cu (no library
   GEMM); at 16,384 rows of C 384 (the row-tile kernel in bf16), 768, 1,024,
   300 and 16 (the products path, its edge tiles and, at C 300, its bf16
   copies element by element) in both dtypes, timed, at C 33 (1,000 rows,
   odd widths everywhere) untimed, and the model axis's partial and
   epilogue at C 768; above the old domain (their own generator) at 4,096
   rows of C 2,056, 4,096 and 8,192 with hidden width 4C (the row kernel's
   LayerNorm; at C 4,096 under torch.profiler), timed, at C 4,100 and at
   64 rows of C 60,000 with hidden width 64 (the row kernel's unstaged
   passes) untimed, and the model axis's entries at C 4,096;
5. K2 (the backward of K1) against its plain PyTorch version at K1's
   shapes, bf16 and f32, both renorms, with all-zero graph rows and masked
   keys; in f32 also against torch.autograd of K1's plain version; each line
   says which kernels the shape took (tensor-core, f32 or SIMT), one bf16
   shape with a head width of 8 must take the SIMT kernels and still match,
   and one with 65 keys checks the tensor-core kernels' unaligned graph
   loads; f32 also at the variants' shapes (B 64, self L 99 and 300, one
   query into 99 and 300), and one f32 call under torch.profiler must run
   only the f32 kernels of csrc/graph_attention_bwd.cu; at K1's wide
   shapes (the SIMT kernels, bf16 and f32), at C 2,048 with 16 heads in bf16
   (the SIMT kernels: the tensor-core rows launch does not fit there), timed,
   and at a head of 33 untimed; at K1's shapes above the old domain: C
   4,096 with 32 heads (bf16 the SIMT kernels, f32 its f32 kernels with the
   LayerNorm backward that reads rows in chunks), 8 heads of 512 and C 2,560
   with 8 of 320 (the wide path), timed, one f32 call of each design under
   torch.profiler;
6. the serving forward at full width (hidden 512, 6 blocks, 8 heads, 1,843
   classes, 407,000-row shared GloVe table, bf16, random weights from a seed)
   on five requests of 128 questions, bucket (lv, lq, ls) = (36, 30, 98):
   every K1 and K3 launch counted, finite answers; then the same weights in
   f32 with the kernels and with the plain versions: logits within
   tolerance and identical answers;
7. training at the same width (bf16 compute, f32 params, dropout 0.5, Adam
   at lr 1e-4, bs 128): one warm-up step and five timed steps with every
   K1, K2 and K3 launch counted, finite losses, no skipped step and moved
   params; one f32 step with the kernels against one with the plain
   versions (same weights, same dropout masks): loss and every gradient
   within tolerance; ten steps on one batch without dropout, whose loss
   must fall; a batch with a NaN feature, which must be skipped leaving the
   params and the Adam state bitwise as they were; and the device-time
   breakdown of one bf16 step and of one f32 step (the training CLI's
   default compute), with the f32 step's rate;
8. K4 (the flash graph attention) against its plain PyTorch version, bf16
   and f32, both renorms, every ``emit``, at B 4, C 512, 8 heads:
   self-attention at L 1,536 with ragged valid lengths and at L 1,506 + 30
   with both parts' tails padded, one-query cross-attention into 1,536 keys
   and an odd shape (Tq 200, Tk 700); the inputs hold masked keys, a fully
   masked 64-key tile, all-zero graph rows and a fully masked sample; the
   one-query shape, the odd shape and Tq 70 into 1,536 keys (two query
   tiles) must go through the key split and its merge kernel in bf16 and in
   f32, and a bf16 shape with a head width of 8 through the SIMT kernel; an
   f32 call and a split one under torch.profiler must run only the f32
   kernel and the merge kernel; each line says
   which kernel and split the shape took; a bf16 shape with 701 keys checks
   the tensor-core kernel's unaligned graph copies; at head widths 256 (C
   2,048, 8 heads) and 50 (C 300, 6 heads), L 1,536, B 2, bf16 and f32 (the
   SIMT kernel), timed, and 33 (C 99, L 600) untimed; above the old domain
   (their own generator) at head widths 320 (C 2,560) and 512 (C 4,096), 8
   heads, the wide kernel, timed beside SDPA;
9. K5 and K6 (its backward: dQ, and dK with dV) on the same inputs against
   their plain versions; in f32 also against torch.autograd of the eager
   ``attention_core``; each line says which kernels the shape took and how
   many key shards K5 took (f32: K5's SIMT kernel, K6's f32 kernel, which
   one call under torch.profiler must run alone); the one-query shape must
   go through K5's key split and its sum kernel in bf16, a bf16 shape with
   a head width of 8 through the SIMT kernels, and a bf16 shape with 701
   keys checks the tensor-core kernels' unaligned graph copies; at K4's
   wide shapes (the SIMT kernels, 32 query rows a block or step at head
   width 256), timed, and at a head of 33 untimed; at K4's shapes above the
   old domain (the wide kernels), timed;
9a. the widths phase (``widths``, after K5 and K6: run before K4, its
   hidden-4,096 point was followed by torch.profiler sessions of K4-K6 at
   L 1,536 that saw no device kernel): the obj-only model at hidden 768 with 12
   heads (head width 64) and at hidden 4,096 with 32 heads (head width 128,
   K1's LayerNorm and K3 at C 4,096 with hidden width 16,384), full width
   otherwise: one bf16 request at bs 128 whose K1 and K3 launches must be
   the 512-wide request's (24 each), the same weights' f32 logits against
   the plain path (1e-3, the plain path taking the kernel path's
   decisions), one f32 training step at bs 32 against the plain path (3e-2
   of each gradient's norm; at hidden 4,096 at 2 blocks, whose f32 weights,
   gradients and Adam moments fit the card where 6 blocks' do not), the
   request's pairs/s and the step's steps/s as information;
10. the obj+rel model at full width (``only_obj=False``, maxlen 1600,
    hidden_size_mil 64, 310 relations, otherwise as above) serving five
    requests of 4 questions at bucket (lv, ls, lq) = (36, 1506, 30), the
    symbolic encoder at L 1,536: 12 K1 + 12 K4 + 24 K3 launches per forward
    counted, finite answers, f32 kernels against plain versions; one request
    of 8 as information;
11. obj+rel training (dropout 0.5, Adam at lr 1e-4, bs 4): one warm-up and
    five timed steps, 12 K1 + 12 K2 + 12 K4 + 12 K5 + 12 K6 + 24 K3 launches
    per step counted, finite losses, none skipped, ``MIL_NCE.R`` moved; one
    f32 step with the kernels against one with the plain versions; a step
    with ``remat_blocks`` against one without (same loss and gradients) and
    the peak memory of both; one step with the sparse GloVe-table optimizer
    (finite, the same launches); the device-time breakdown of a step, of an
    f32 step (with its rate) and of a request;
12. the predict and eval CLIs (``train.predict.main``, ``train.evaluate.main``)
    on a fixture tree written by the port's ``write_fixture`` (128 images,
    2,560 train and 640 val questions, 10-36 objects, 1,600 classes), the
    obj-only model at full width built from the CLI's own flags (bf16,
    random weights from a seed, the answer heads' biases shifted so that
    the answers spread over the classes, saved with ``save_checkpoint``):
    the checkpoint loads bitwise; the loader gives the same batches on
    threads and through both caches; the reference (the same batches moved
    synchronously) gives at least half of the classes as answers; the
    serving loop's log-softmax rows equal the reference's within 1e-4, which
    a row shifted by one would fail; the predict CLI on threads, on spawned
    processes, through the sample cache and through the batch cache writes
    one answer per valid sample, each equal to the reference's, with 24 K1
    and 24 K3 launches per batch; the side-stream copies give every field
    bitwise; K1 and K3 at every shape the CLIs gave them, on the model's own
    inputs, against their plain versions; the eval CLI's loss and correct
    count (above 0) equal the in-process ``make_eval_step`` sums within
    1e-5; as information the loader's
    samples/s alone, one batch's copy pinned and pageable, the CLI's
    pairs/s, the card's idle share over 3 batches, which tar index served;
13. the training CLI (``train.main.main``) on the same fixture tree at full
    obj-only width (bf16, shared table, ``--sparse_table``, MIL-NCE, bs 128,
    ``--cache_dir --batch_replay``): one epoch, whose launches must be 24
    K1 + 24 K2 + 24 K3 a step and 24 K1 + 24 K3 an eval batch, whose logged
    losses must equal an in-process loop of the same step on the same
    batches from the same weights and generator (within 1e-3 relative), and
    whose K1, K2 and K3 calls are held against their plain versions at
    every shape the CLI gave them; the first sparse step against a dense
    one (the touched rows within 1e-6, the rest bitwise); then
    ``--num_epochs 3 --checkpoint_every 2``, which must log ``resumed from
    epoch 1`` and device-resident batches; the predict CLI, float and
    ``--int8``, on the checkpoint and on a copy with its answers spread over
    the classes, with the in-process predict step's answers; as information
    the epochs' steps/s and samples/s, the CLI's idle share over 5 traced
    steps (``--profile_steps``), float against int8 serving (pairs/s, model
    bytes), and a dense against a sparse step at the training phase's
    shapes (device-time breakdown, named parts of "other", memory; f32 and
    bf16 moments);
14. packing and the MCB head (``packed``), on a new fixture tree like the
    cli phase's: (a) the training CLI as in 13 with ``--n_pack 4
    --pack_bucket 1`` (packed rows of bucket (lv, ls, lq) = (100, 216, 40):
    self-attention at L 140 and 256, the decoders' cross-attention at 4
    queries), one epoch whose launches must be 24 K1 + 24 K2 + 24 K3 a step
    and 24 K1 + 24 K3 an eval batch (val through the tight collate), whose
    logged losses must equal an in-process loop's (1e-3 relative), whose
    K1, K2 and K3 calls are held against their plain versions at every
    shape; the predict CLI on its checkpoint (answers spread); as
    information samples per row, the packed epoch's rates beside the
    unpacked train_cli epoch's, device busy of a packed and an unpacked
    step, the idle share of 5 in-process packed steps, and K1, K2 and K3
    timed at each packed shape beside their plain versions and bounds;
    (b) isolation: 126 rows of val samples packed first-fit, a row of
    padding only and a row holding one sample whose region features are
    all zero: in f32 each packed slot's logits equal its sample alone
    through the tight collate within 1e-4 and the answers are equal; in
    bf16 within 2^-4 of the largest logit, the plain path's error printed
    beside; (c) the obj-only model with the MCB head (mcb_out 16,000)
    serving five bs-128 requests (24 K1 + 24 K3 a forward, the FFT's device
    time as information), f32 kernels against plain versions, one unpacked
    and one packed bf16 training step (finite, ``cls_mcb`` moved, the
    sketches bitwise unchanged), and the predict CLI ``--mcb`` on a saved
    checkpoint against the in-process predict step.

15. data parallel (``dp``, ROADMAP item 15): two ranks on the one card over
    gloo with CUDA tensors (NCCL refuses two ranks on a device), worker
    processes of this script (``--dp-rank``), built kernels shared: at full
    width, f32 without dropout, one step on each half of a global batch
    held against this process's step on the whole batch (loss within 1e-5
    relative, every gradient within 1e-4 of its norm) for the obj-only
    model (bs 128 as 64 + 64), dense and with the sparse table, and the
    obj+rel model at maxlen 1600 (bs 4 as 2 + 2, through K4-K6); each
    rank's launches those of one rank at its rows; then 3 bf16 steps with
    dropout 0.5, dense and sparse, after which the ranks' parameters (and
    table moments) are bitwise equal; as information the bytes summed a
    step, the gradients' all-reduce over gloo on CUDA and over NCCL in a
    group of one, a rank's step and its device idle share; last the
    training CLI with ``--coordinator --num_processes 1`` (an NCCL group of
    one) on a 512-question tree of the cli phase's kind, whose logged losses
    must equal the run without those flags bitwise, one checkpoint written.
16. every card of a host and the reference's checkpoints (``host``, ROADMAP
    items 15c and 18): the serving point's model (bs 128) out through
    ``models/torch_export.save_pth`` and into a fresh model through
    ``models/torch_import.import_torch_state_dict``: nothing unmatched, the
    logits bitwise, int8 serving of both with equal answers, the file
    holding the shared table once (its MiB and the save and load seconds
    printed); two serving ranks on the one card over gloo (worker processes
    of this script, ``--host-rank``), each running ``predict_from_args`` on
    its stride of whole batches of a 512-question tree of the cli phase's
    kind through the batch cache, float and ``--mcb``, whose answers file
    must equal the one-process CLI's byte for byte (each rank's pairs/s as
    information); the training CLI without ``--coordinator``, which must
    take one rank and form no group, its logged losses bitwise those of
    its NCCL group of one.

17. the ablation variants (``variants``, ROADMAP item 17a): all 17 names of
    ``models/variants.VARIANTS`` through ``build_variant`` at the variant
    eval CLI's defaults (hidden 512, 6 blocks, 8 heads, 407,000 x 300 GloVe
    tables, f32, 1,843 classes, bs 64 at (lv, ls, lq) = (49, 250, 50), the
    masks of each family as that CLI builds them; relatt over 250
    vis-symbolic nodes; x3_ori at the obj+rel point), random weights from a
    seed, one model at a time: five forwards each, whose K1, K3 and K4
    launches and plain ``attention_core`` calls must equal the block plan's
    (``VARIANT_FORWARD``); the kernel path against the plain path (logits
    within 1e-3, equal answers, every K1/K3/K4 call at the model's own
    inputs within tolerance); one f32 backward of x2_dec and of x5_dec_mil
    (label-smoothed CE, plus the attention-MIL loss for x5) with the kernels
    against one with the plain versions (gradients within 3e-2 of their
    norms, K2 in it); as information the ms a request, pairs/s, bf16
    answers against f32 plain, and the device time of one request of each.

18. the variant eval CLI (``variant_cli``, ROADMAP item 17b): on a fixture
    tree of the cli phase's kind, ``train.evaluate_variants.main`` on the
    card at its defaults (f32, hidden 512, 6 blocks, 8 heads, 407,000 x 300
    tables, bs 64, maxlen 300 / 50 / 49, the val split's 640 questions)
    for each variant it can call: x, x2, x2_pre, x2_distill and the dec
    family on the ``itp_gt`` loader, x5, x6 and x7 on ``itp_bbox_q``, each
    from a checkpoint of random weights (``--weight_dir``): the CLI's loss
    within 1e-4 relative of the same model's in-process plain path over the
    same batches, its correct count equal where no logit margin is below
    1e-4, its K1 and K3 launches a batch the block plan's; as information
    pairs/s, ms a batch, the loader's cold samples/s and the idle share of
    3 batches (x, x2_dec, x5); every other loader preset through the loader
    alone;
19. ring and Ulysses sequence parallelism (``seq``, ROADMAP item 16): K4
    with ``emit="partial"``, K5 and K6 at the ring's shard shape (768
    queries into 768 keys, B 4, one sample's keys all masked) against their
    plain versions, timed; then two gloo ranks on the one card (worker
    processes of this script, ``--seq-rank``) as a (data 1, seq 2) mesh at
    the obj+rel point (B 4, L 1,536, C 512, 8 heads), bf16 and f32, both
    renorms: the ring's and Ulysses' out, dq, dk and dv against the
    one-process K4/K5/K6 and against their own loop on the plain versions,
    2 K4 + 2 K5 + 2 K6 launches a ring layer and 1 + 1 + 1 a Ulysses one;
    one obj+rel f32 step at ``seq_parallel`` 2 (every encoder block on the
    ring) against the one-process step, as the dp phase holds its ranks;
    as information the ms of a forward and a backward and the bytes
    rotated a layer;
20. the model axis (``model``, ROADMAP items 15b and 15d): K1's
    attention-only and LayerNorm entries, K2 from d(o) and K3's partial
    and epilogue against their plain versions at the main path's model-2
    shapes (B 128, L 128, 4 heads of 64; 16,384 rows of 512, a hidden
    shard of 1,024), and K4 on 4 heads of 64 at the obj+rel point (SDPA
    beside K1's attention-only entry and K4); then at the model-16 shapes,
    where each of the 8 heads spans two ranks and a rank computes one
    head: K1's attention-only entry and K2 from d(o) on 1 head of 64, K3's
    partial on a hidden shard
    of 128, K4, K5 and K6 on 1 head at the obj+rel point (their key
    splits); bf16 and f32, timed beside their bounds; then two gloo ranks
    on the one card (worker processes of this script, ``--model-rank``) as
    (data 1, model 2), and sixteen as (data 1, model 16), at full width,
    the 407,000 x 300 table split by rows at model 2 and whole at 16, 6
    blocks (3 in model 16's obj+rel step): the bf16 serving forward at bs
    128 against one process's (logits within 2^-4 of their max, answers
    equal where the margin is clear), an f32 obj-only
    step at bs 32 and an f32 obj+rel step (bs 4 at model 2, bs 2 at model
    16; K4, K5 and K6 on a rank's heads) against one process's, as the dp
    phase holds its ranks (one process taking the ranks' decisions, as
    below); each run's launches (every K1 and K3
    as the model axis's entries), as information a rank's parameter MiB
    against one process's, the bytes through the model row's collectives,
    a rank's seconds and the card's memory in use.

Every f32 check that pairs two paths (the f32 logits of serving, obj+rel
serving, the MCB head and the 17 variants, the training phases' f32 steps
and the variants' f32 backwards, kernels against plain versions; the
packed f32 isolation; the dp, seq and model f32 steps against one
process's) makes its reference take the tested path's decisions outside
the kernels: each ReLU's (input > 0) and each ``content_mask`` row's
(sum != 0), recorded as the tested path runs and joined into one
process's layout (a model row's columns, a data row's rows, a seq row's
rank 0, a packed sample's slot and offsets). Each decision taken against
the reference's own must have its input within 1e-5 of its call's largest
|input|, and at most 1e-5 of the run's decisions may be such; each such
call is printed ("... decision(s) pinned, the largest |x| ..."), and
each check prints a ``pair check: {...}`` line (its largest error, its
limit, the decisions pinned) that ``scripts/pair_checks_reordered.py``
reads. An FFN's hidden ReLU is taken where it runs outside K3: in K3's
backward, whose mask sets the gradient, and in its plain version.

``--phases a,b`` (of card, k1, k3, k2, serving, training, k4, k56,
objrel_serving, objrel_training, cli, train_cli, packed, dp, host, variants,
variant_cli, seq, model) runs only those, for work on one kernel,
and then prints no last line. It prints one JSON line of kernels, the card's line, and last
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero without
that last line; so does a machine without a CUDA device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12
# published dense peaks (NVIDIA H100 SXM data sheet): bf16 on tensor cores,
# float32 outside them (TF32 is off in every comparison here)
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 2 ** -4, torch.float32: 1e-4}   # max |kernel - plain| per output
# what a library GEMM's kernels are named (cuBLAS, CUTLASS, nvjet on Hopper)
LIBRARY_GEMM_MARKS = ("gemm", "cublas", "cutlass", "nvjet")
# K2, max |kernel - plain| over max |plain|, per output. bf16 outputs (dq,
# dk, dv, dresidual): both sides sum in f32 in different orders and round
# once to bf16, so an element can land one bf16 ulp (2^-7 of its binade)
# apart; 2^-6 allows two at the largest magnitude. f32 outputs (all of them
# in f32, dgamma and dbeta in both): 1e-4, f32 sums in another order.
K2_TOL = {torch.bfloat16: 2 ** -6, torch.float32: 1e-4}
K2_AUTOGRAD_TOL = 1e-4   # f32, the hand formulas against torch.autograd
LOGIT_TOL_F32 = 1e-3
# the full-width f32 training step, kernels against plain versions: the
# loss relative to its value (sums in another order: ~1e-6); each gradient
# by the norm of its difference over its own norm. A ReLU input within
# rounding of 0 can fall on the other side on the two paths (their forward
# activations differ by ~1e-6 relative); that changes one sample's term in
# every gradient upstream of it (seen: one flip in a decoder FFN moved
# those gradients by up to 5.1e-3 of their norm). 3e-2 admits a few such
# flips; a wrong or misrouted K2 output moves the gradients it feeds by
# O(1). K2 itself is held to 1e-4 above, input by input.
LOSS_TOL_F32 = 1e-5
GRAD_TOL_F32 = 3e-2
B, C, HEADS, HIDDEN = 128, 512, 8, 2048
REQUESTS = 5
TRAIN_STEPS = 5
OVERFIT_STEPS = 10
K1_PER_FORWARD = 24   # 6 blocks x 2 encoders self-attention + 6 x 2 decoder cross-attention
K3_PER_FORWARD = 24   # 6 x 2 encoder FFNs + 6 x 2 decoder FFNs
K2_PER_STEP = 24      # the backward of every K1 launch
# parameters that get no gradient: the macro embeddings are detached (as in
# the reference MIL_NCE), and the decoder's 1-token self-attention never
# reads its Q and K projections (softmax over one key is 1)
NO_GRAD_PARAMS = r"^MIL_NCE\.marco_mlp\.|\.dec_self_attention_\d+\.[QK]_proj\."
# parameters whose true gradient is 0: a K projection's bias shifts every
# key's score by one amount, which the softmax ignores
SHIFT_FREE_PARAMS = r"\.K_proj\.0\.bias$"
# the obj+rel point: bs 4, bucket (lv, ls, lq) = (36, 1506, 30). The visual
# encoder runs at L 66 (K1, K2), the symbolic one at L 1,536 (K4, K5, K6)
REL_B, REL_LV, REL_LS, REL_LQ = 4, 36, 1506, 30
REL_L = REL_LS + REL_LQ
REL_FORWARD = {"K1": 12, "K4": 12, "K3": 24, "K2": 0, "K5": 0, "K6": 0}
REL_STEP = {"K1": 12, "K2": 12, "K4": 12, "K5": 12, "K6": 12, "K3": 24}
# with remat_blocks each of the 12 encoder blocks runs its forward once more
REL_STEP_REMAT = {"K1": 18, "K2": 12, "K4": 18, "K5": 12, "K6": 12, "K3": 36}
# the variant eval CLI's defaults (train/evaluate_variants.py in the TPU
# package): bs 64, maxlen_v 49, maxlen 300 of which maxlen_q 50 question
# tokens and 250 scene-graph nodes
VARIANT_B, VARIANT_LV, VARIANT_LS, VARIANT_LQ = 64, 49, 250, 50
# the widths the kernels take beyond the presets': the widest head (C 2,048
# at 8 heads of 256; K2 also at 16 of 128, past its tensor-core rows
# launch), a head of 50 (C 300 at 6 heads), and K3 at other C
WIDE_HEADS, WIDE_B = 8, 8
K12_WIDE_SHAPES = (("C=2048 H=8 L=128 B=8", 128, 128, 8), ("C=2048 H=8 L=512 B=8", 512, 512, 8))
K2_WIDE16_SHAPES = (("C=2048 H=16 L=128 B=8", 128, 128, 16),
                    ("C=2048 H=16 L=512 B=8", 512, 512, 16))
FLASH_WIDE_B = 2
FLASH_WIDE_SHAPES = (("C=2048 H=8 L=1536 B=2", 2048, 8), ("C=300 H=6 L=1536 B=2", 300, 6))
K3_WIDE_CS = (384, 768, 1024, 300, 16)
# the widths above that domain (C 2,048, head width 256, FFN hidden 8,192):
# K1 and K2 at B 4, L 128 and 450, at C 4,096 with 32 heads of 128 (the
# hidden-4,096 point's: the tensor-core and f32 kernels per head, the
# LayerNorm at C 4,096), with 8 heads of 512 and at C 2,560 with 8 heads of
# 320 (the wide path); K4-K6 at B 2, L 1,536, head widths 320 and 512 (the
# wide kernels); K3 at 4,096 rows of C 2,056 (just past the old edge), 4,096
# and 8,192 with hidden width 4C, an odd C of 4,100 (checked, not timed) and
# 64 rows of C 60,000 with hidden width 64 (the row kernel past the row it
# stages in shared memory; checked, not timed)
BEYOND_B = 4
K12_BEYOND_SHAPES = tuple((f"C={c} H={h} L={t} B={BEYOND_B}", t, t, h, c)
                          for c, h in ((4096, 32), (4096, 8), (2560, 8)) for t in (128, 450))
FLASH_BEYOND_SHAPES = (("C=2560 H=8 L=1536 B=2", 2560, 8), ("C=4096 H=8 L=1536 B=2", 4096, 8))
K3_BEYOND_ROWS, K3_BEYOND_CS, K3_ODD_C = 4096, (2056, 4096, 8192), 4100
K3_UNSTAGED = (64, 60000, 64)   # rows, C, hidden width
# the widths phase: obj-only at hidden 768 with 12 heads (BERT-base's and
# LXMERT's width, arXiv 1908.07490), full width otherwise
WIDTHS_HIDDEN, WIDTHS_HEADS, WIDTHS_TRAIN_B = 768, 12, 32
# and at hidden 4,096 with 32 heads (LLaMA-7B's width and heads, arXiv
# 2302.13971 Table 2): 5.29 B parameters at 6 blocks, so its f32 training
# step runs at 2 blocks (stages 1 and 2), whose weights, gradients and
# Adam's two moments (31 GB) fit the card where 6 blocks' (85 GB) do not
WIDTHS_4K_HIDDEN, WIDTHS_4K_HEADS, WIDTHS_4K_TRAIN_BLOCKS = 4096, 32, 2
# and at hidden 2,048 with 8 heads of 256 (Gemma-2B's width and heads,
# arXiv 2403.08295 Table 1), obj-only and obj+rel: serving (K1's and K4's
# tensor-core kernels at head width 256) and training (K2 composed of K1's
# tensor-core or K4's f32 forward, its LayerNorm backward, K5 and K6; K5 and
# K6 on their tensor-core and f32 kernels' instance 256)
WIDTHS_2K_HIDDEN, WIDTHS_2K_HEADS = 2048, 8
# K1 and K4 at head width 256 beyond the widths rows (C 2,048, 8 heads):
# the decoder's one query into 450 keys (K1, B 8) and into 1,536 keys (K4,
# B 4: 32 blocks, so the keys are split); from a generator of their own
K1_HEAD256_SHAPE = ("C=2048 H=8 Tq=1 Lk=450 B=8", 1, 450)
K4_HEAD256_SHAPE = ("C=2048 H=8 Tq=1 Lk=1536 B=4", 1, REL_L)
# K4's other forms, from a generator of their own (k4_paths_gen): the wide
# kernel, which keeps head widths above 256 that are no multiple of 16
# (bf16) or of 4 (f32), at 8 heads of 258 in either dtype; instance 256 at
# 128 rows a block with its keys split, and the chunked kernels with theirs
# (100 queries into 1,536 keys at B 2: 16 and 32 blocks, short of the SMs)
K4_WIDE258_SHAPE = ("C=2064 H=8 L=1536 B=2", 2064, 8)
K4_SPLIT_TQ = 100
K4_SPLIT_SHAPES = (("C=2048 H=8 Tq=100 Lk=1536 B=2", 2048, 8),
                   ("C=2560 H=8 Tq=100 Lk=1536 B=2", 2560, 8))
# K5's and K6's instance 256 beyond the widths rows, from a generator of
# their own (k56_head256_gen): the decoder's one query into 1,536 keys at
# head width 256 (B 4: 32 blocks, so K5's keys are split), the padded widths
# (bf16 at 8 heads of 144, f32 at 8 heads of 132: instance 256, the upper
# channels staged as zeros), and the wide kernels at 8 heads of 258
K56_HEAD256_CROSS = ("C=2048 H=8 Tq=1 Lk=1536 B=4", 2048, 8)
K56_PADDED_SHAPES = {torch.bfloat16: ("C=1152 H=8 L=1536 B=2", 1152, 8),
                     torch.float32: ("C=1056 H=8 L=1536 B=2", 1056, 8)}
# K2's first SIMT kernels above head width 128, from a generator of their
# own (k2_simt_gen): 8 heads of 254 at C 2,032 (no multiple of 16 nor of
# 4, so both dtypes keep them), B 8, L 128 (16 rows a block of the rows
# launch) and 512 (8 rows), the keys launch's 16-key instance; the C 2,048
# rows that drove them before now take the composed route
K2_SIMT254_SHAPES = (("C=2032 H=8 L=128 B=8", 128, 128, 8, 2032),
                     ("C=2032 H=8 L=512 B=8", 512, 512, 8, 2032))
WIDE_C = 2048   # the region features' width: x2_fusion_dec_mil2's alignment blocks
# K1, K3 and K4 launches and plain attention_core calls (attention weights
# out, or no renorm: x2_mlp_dec's vanilla decoder cross-attention) of one
# forward of each variant, from its block plan at 6 blocks (stages 2 and 4).
# A 1-token self-attention computes no attention. x: 6 + 6 blocks; x2: 6 +
# 7 (the symbolic branch re-runs blocks 0-2); the dec line: 6 encoder + 6
# decoder cross-attentions a branch; x5: 6 + 6 self stacks, 6 alignment
# blocks with weights out, 6 decoder blocks; x6: 2 + 2 + 1 (question) + 2 x
# (6 + 6), 2 alignment blocks; x7: 2 + 2 + 3 joint + 2 question + 4 + 4, 3
# alignment blocks; fusion_dec_mil(2): the x2_fusion_dec body's 24 and 3
# alignment blocks (their FFNs 3 more K3, at C 2,048 in mil2); x3_ori: the
# obj+rel point's 12 K1 + 12 K4 + 24 K3
VARIANT_FORWARD = {
    "x": (12, 12, 0, 0), "x2": (13, 13, 0, 0), "x2_pre": (13, 13, 0, 0),
    "x2_distill": (13, 13, 0, 0), "x2_dec": (24, 24, 0, 0), "x2_dec_ori": (24, 24, 0, 0),
    "x2_mlp_dec": (12, 24, 0, 12), "x2_syb_dec": (24, 24, 0, 0),
    "x2_fusion_dec": (24, 24, 0, 0), "x2_fusion_dec_relatt": (24, 24, 0, 0),
    "x2_fusion_dec_mil": (24, 27, 0, 3), "x2_fusion_dec_mil2": (24, 27, 0, 3),
    "x3_ori": (12, 24, 12, 0), "x4_dec": (24, 24, 0, 0), "x5_dec_mil": (18, 24, 0, 6),
    "x6_dec_mil": (29, 31, 0, 2), "x7_dec_mil": (17, 20, 0, 3),
}
# the variants whose backward (phase variants, c) and bf16 forward (d) are run
VARIANT_STEPS = ("x2_dec", "x5_dec_mil")
# K4's statistics m, z, b (f32 on both sides, sums in another order), and a
# remat step against a plain one (the same kernels; only the embedding
# tables' gradients are summed with atomics, in an order that can change)
STATS_TOL = 1e-4
REMAT_TOL = 1e-5
# ms per launch of K4, K2, K5 and K6 (SIMT) and of K1 (SIMT) and K3 (the
# WMMA kernel) these shapes ran before their paths were redesigned (this
# script, H100 80GB HBM3 at 700 W), printed beside the new time; by
# (kernel, shape label, dtype)
PREVIOUS_MS = {
    ("K1", "self L=66", torch.bfloat16): 0.4282,
    ("K1", "self L=128", torch.bfloat16): 0.9538,
    ("K1", "cross Tq=1 Lk=66", torch.bfloat16): 0.0794,
    ("K1", "cross Tq=1 Lk=128", torch.bfloat16): 0.1364,
    ("K1", "self L=66 B=4", torch.bfloat16): 0.1493,
    ("K1", "cross Tq=1 Lk=66 B=4", torch.bfloat16): 0.0767,
    ("K3", "rows=16384", torch.bfloat16): 0.7532,
    ("K3", "rows=8448", torch.bfloat16): 0.3902,
    ("K3", "rows=128", torch.bfloat16): 0.1922,
    ("K3", "rows=6144", torch.bfloat16): 0.3851,
    ("K3", "rows=264", torch.bfloat16): 0.1992,
    ("K3", "rows=4", torch.bfloat16): 0.1836,
    # K3's f32 SIMT kernel and its wide kernel (C 2,048), before the products
    # path: PERF.md's "now" times, and the last run of this script with that
    # kernel for the f32 shapes PERF.md does not list
    ("K3", "rows=16384", torch.float32): 3.8742,
    ("K3", "rows=8448", torch.float32): 2.0497,
    ("K3", "rows=128", torch.float32): 1.2537,
    ("K3", "rows=6144", torch.float32): 1.8581,
    ("K3", "rows=264", torch.float32): 1.2537,
    ("K3", "rows=4", torch.float32): 1.2356,
    ("K3", "rows=64", torch.float32): 1.2503,
    ("K3", "rows=3136", torch.float32): 1.2660,
    ("K3", "rows=6336", torch.float32): 1.8528,
    ("K3", "rows=19200", torch.float32): 5.2220,
    ("K3", "partial rows=16384 hidden=1024", torch.float32): 1.9399,
    ("K3", "rows=3136 C=2048", torch.float32): 62.0351,
    ("K3", "rows=3136 C=2048", torch.bfloat16): 56.8247,
    ("K4", "self L=1536", torch.bfloat16): 1.1309,
    ("K4", "cross Tq=1 Lk=1536", torch.bfloat16): 0.2123,
    ("K4", "self L=1536", torch.float32): 1.1177,
    ("K2", "self L=128", torch.bfloat16): 3.6730,
    ("K2", "self L=66", torch.bfloat16): 1.6143,
    ("K2", "cross Tq=1 Lk=128", torch.bfloat16): 0.4108,
    ("K2", "cross Tq=1 Lk=66", torch.bfloat16): 0.2760,
    ("K2", "self L=66 B=4", torch.bfloat16): 0.4166,
    ("K2", "cross Tq=1 Lk=66 B=4", torch.bfloat16): 0.1863,
    ("K2", "self L=128", torch.float32): 3.7098,
    ("K5", "self L=1536", torch.bfloat16): 1.8865,
    ("K5", "cross Tq=1 Lk=1536", torch.bfloat16): 0.2748,
    ("K6", "self L=1536", torch.bfloat16): 2.4198,
    ("K6", "cross Tq=1 Lk=1536", torch.bfloat16): 0.1070,
    # K2's and K4's first f32 SIMT kernels, before their register-tiled
    # redesign, for the f32 rows above lacks: this script's k2 and k4 phases
    # and scripts/k24_f32_times.py on that tree, H100 80GB HBM3 at 700 W
    ("K2", "self L=66", torch.float32): 1.6028,
    ("K2", "cross Tq=1 Lk=128", torch.float32): 0.4593,
    ("K2", "cross Tq=1 Lk=66", torch.float32): 0.3142,
    ("K2", "self L=66 B=4", torch.float32): 0.4190,
    ("K2", "cross Tq=1 Lk=66 B=4", torch.float32): 0.1841,
    ("K2", "self L=99 B=64", torch.float32): 1.6996,
    ("K2", "self L=300 B=64", torch.float32): 11.2185,
    ("K2", "cross Tq=1 Lk=99 B=64", torch.float32): 0.3393,
    ("K2", "cross Tq=1 Lk=300 B=64", torch.float32): 0.9170,
    ("K2 from d(o)", "model", torch.float32): 1.3637,
    ("K4", "self L=1506+30", torch.float32): 1.1112,
    ("K4", "cross Tq=1 Lk=1536", torch.float32): 0.2055,
    ("K4", "odd Tq=200 Tk=700", torch.float32): 0.1215,
    ("K4", "split Tq=70 Tk=1536", torch.float32): 0.2541,
    ("K4", "ring shard", torch.float32): 0.3533,
    ("K4 heads", "model", torch.float32): 0.7290,
    # K1's and K6's first f32 SIMT kernels, before their register-tiled
    # redesign: the last full run of this script with them (the variants'
    # K1 shapes: scripts/variant_kernel_times.py, the kernel alone), H100
    # 80GB HBM3 at 700 W
    ("K1", "self L=66", torch.float32): 0.4266,
    ("K1", "self L=128", torch.float32): 0.9601,
    ("K1", "cross Tq=1 Lk=66", torch.float32): 0.1015,
    ("K1", "cross Tq=1 Lk=128", torch.float32): 0.1441,
    ("K1", "self L=66 B=4", torch.float32): 0.1527,
    ("K1", "cross Tq=1 Lk=66 B=4", torch.float32): 0.0800,
    ("K1", "self L=99 B=64", torch.float32): 0.4661,
    ("K1", "self L=300 B=64", torch.float32): 2.6512,
    ("K1", "cross Tq=1 Lk=99 B=64", torch.float32): 0.1038,
    ("K1", "cross Tq=1 Lk=300 B=64", torch.float32): 0.3361,
    ("K1", "x5 Tq=50 Lk=299 B=64", torch.float32): 0.6811,
    ("K1 heads", "model", torch.float32): 0.4370,
    ("K6", "self L=1536", torch.float32): 2.4323,
    ("K6", "self L=1506+30", torch.float32): 2.4221,
    ("K6", "cross Tq=1 Lk=1536", torch.float32): 0.1159,
    ("K6", "odd Tq=200 Tk=700", torch.float32): 0.2364,
    ("K6", "ring shard", torch.float32): 0.8054,
    ("K6", "ring shard Tq=768 Tk=768", torch.float32): 0.8054,
    ("K6", "self L=1536 4 heads", torch.float32): 1.5819,
    # K5's first f32 SIMT kernel, before its register-tiled redesign:
    # scripts/k5_f32_times.py on that tree (the ring rotation also phase
    # seq's "ring shard"), H100 80GB HBM3 at 700 W
    ("K5", "self L=1536", torch.float32): 2.0580,
    ("K5", "self L=1506+30", torch.float32): 2.0507,
    ("K5", "cross Tq=1 Lk=1536", torch.float32): 0.2989,
    ("K5", "odd Tq=200 Tk=700", torch.float32): 0.2300,
    ("K5", "ring shard Tq=768 Tk=768", torch.float32): 0.6672,
    ("K5", "ring shard", torch.float32): 0.6672,
    ("K5", "self L=1536 4 heads", torch.float32): 1.3752,
    # K2, K5 and K6 at head width 256 (and K2 at 16 and 32 heads of 128 in
    # bf16) on their first SIMT kernels, before K5's and K6's instance 256
    # and K2's composed route: PERF.md's widths and beyond rows (this
    # script on that tree, H100 80GB HBM3 at 700 W)
    ("K2", "C=2048 H=8 L=128 B=8", torch.bfloat16): 2.0844,
    ("K2", "C=2048 H=8 L=512 B=8", torch.bfloat16): 23.0514,
    ("K2", "C=2048 H=16 L=128 B=8", torch.bfloat16): 2.1857,
    ("K2", "C=2048 H=16 L=512 B=8", torch.bfloat16): 23.6589,
    ("K2", "C=2048 H=8 L=128 B=8", torch.float32): 2.2224,
    ("K2", "C=2048 H=8 L=512 B=8", torch.float32): 24.6217,
    ("K2", "C=4096 H=32 L=128 B=4", torch.bfloat16): 2.8034,
    ("K2", "C=4096 H=32 L=450 B=4", torch.bfloat16): 19.4788,
    ("K5", "C=2048 H=8 L=1536 B=2", torch.bfloat16): 6.6948,
    ("K5", "C=2048 H=8 L=1536 B=2", torch.float32): 6.9201,
    ("K6", "C=2048 H=8 L=1536 B=2", torch.bfloat16): 6.0631,
    ("K6", "C=2048 H=8 L=1536 B=2", torch.float32): 6.3532,
}

failures: list = []


def previous(kernel: str, label: str, dtype) -> str:
    ms = PREVIOUS_MS.get((kernel, label, dtype))
    return "" if ms is None else f" (previous_ms {ms:.4f})"


def check(ok: bool, what: str) -> None:
    print(("PASS " if ok else "FAIL ") + what, flush=True)
    if not ok:
        failures.append(what)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float, dtype) -> tuple:
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# (label, Tq, Tk, batch): the obj-only shapes at bs 128, then the obj+rel
# model's visual branch at bs 4 (20 blocks of K1 on 132 SMs)
K1_SHAPES = (("self L=66", 66, 66, B), ("self L=128", 128, 128, B),
             ("cross Tq=1 Lk=66", 1, 66, B), ("cross Tq=1 Lk=128", 1, 128, B),
             ("self L=66 B=4", 66, 66, REL_B), ("cross Tq=1 Lk=66 B=4", 1, 66, REL_B))


def k1_inputs(gen, tq: int, tk: int, dtype, B: int = B, all_masked: bool = False, c: int = C):
    """K1's arguments at (B, Tq, Tk, c): keys valid up to a ragged length per
    sample (with ``all_masked``, every key of sample 0 masked)."""
    dev = "cuda"
    n_keys = torch.randint(1, tk + 1, (B,), generator=gen, device=dev)
    key_mask = (torch.arange(tk, device=dev)[None] < n_keys[:, None]).float()
    if all_masked:
        key_mask[0] = 0.0
    query_mask = key_mask[:, :tq].contiguous() if tq == tk else torch.ones(B, tq, device=dev)
    graph = (torch.rand(B, tq, tk, generator=gen, device=dev) < 0.3).float()
    graph = graph * query_mask[:, :, None] * key_mask[:, None, :]
    q, k, v = (torch.relu(torch.randn(B, t, c, generator=gen, device=dev)).to(dtype)
               for t in (tq, tk, tk))
    res = torch.randn(B, tq, c, generator=gen, device=dev).to(dtype)
    gamma = 1 + 0.05 * torch.randn(c, generator=gen, device=dev)
    beta = 0.05 * torch.randn(c, generator=gen, device=dev)
    return q, k, v, key_mask, query_mask, graph, res, gamma, beta


def k1_against_plain(label: str, args, heads: int) -> float:
    """K1 against its plain version over both renorms: the largest error."""
    from structured_alignment_vqa_tpu_torch.ops import fused_graph_attention as k1

    dtype = args[0].dtype
    err = 0.0
    for renorm in ("l1", "sum_eps"):
        got = k1.fused_graph_attention_ln(*args, heads, renorm)
        want = k1.graph_attention_ln_plain(*args, heads, renorm)
        torch.cuda.synchronize()
        err = max(err, (got.float() - want.float()).abs().max().item())
        check(bool(torch.isfinite(got.float()).all()), f"K1 {label} {dtype} {renorm}: finite")
    check(err <= TOL[dtype], f"K1 {label} {dtype}: max|kernel-plain| {err:.3g} <= {TOL[dtype]:g}")
    return err


# K1's f32 rows at the variants' shapes (bs 64): the encoders'
# self-attention at L 99 and 300, the decoders' one query into 99 and 300
# keys, x5's 50 question tokens into 299
K1_VARIANT_SHAPES = (("self L=99 B=64", 99, 99, VARIANT_B), ("self L=300 B=64", 300, 300, VARIANT_B),
                     ("cross Tq=1 Lk=99 B=64", 1, 99, VARIANT_B),
                     ("cross Tq=1 Lk=300 B=64", 1, 300, VARIANT_B),
                     ("x5 Tq=50 Lk=299 B=64", 50, 299, VARIANT_B))
K1_F32_KERNELS = ("graph_attention_ln_f32_kernel", "graph_attention_ln_epilogue_kernel")


def k1_f32_bits(label: str, args) -> None:
    """K1's f32 kernel bit for bit, both renorms: each entry against the
    first SIMT kernel on the same inputs (the entries' "simt" path, which
    takes every shape), and the 8-head full entry against two 4-head halves
    of the attention-only entry followed by the LayerNorm entry (the model
    axis's path at model 2)."""
    from structured_alignment_vqa_tpu_torch.ops import fused_graph_attention as k1

    q, k, v, key_mask, query_mask, graph, res, gamma, beta = args
    half = C // 2
    for renorm in ("l1", "sum_eps"):
        o = k1.graph_attention_heads(q, k, v, key_mask, query_mask, graph, HEADS, renorm)
        o_simt = k1._launch_heads(q, k, v, key_mask, query_mask, graph, HEADS, renorm, "simt")
        full = k1.fused_graph_attention_ln(*args, HEADS, renorm)
        full_simt = k1._launch(*args, HEADS, renorm, "simt")
        halves = [k1.graph_attention_heads(*(t[..., cols].contiguous() for t in (q, k, v)),
                                           key_mask, query_mask, graph, HEADS // 2, renorm)
                  for cols in (slice(0, half), slice(half, C))]
        ln = k1.attention_ln(torch.cat(halves, dim=-1), res, gamma, beta)
        torch.cuda.synchronize()
        check(torch.equal(o, o_simt) and torch.equal(full, full_simt),
              f"K1 {label} f32 {renorm}: both entries equal the first SIMT kernel's bit for bit "
              f"(max|f32 - SIMT| {(full - full_simt).abs().max().item():.3g})")
        check(torch.equal(full, ln), f"K1 {label} f32 {renorm}: the 8-head entry equals two "
              "4-head attention-only halves and the LayerNorm entry bit for bit")


def k5_f32_bits(label: str, args, dy, heads: int) -> None:
    """K5's f32 kernel on an unsplit call, both renorms: its dQ against the
    first SIMT kernel's on the same inputs (the launch's "simt" path, which
    takes every shape in one shard), bit for bit."""
    from structured_alignment_vqa_tpu_torch.ops import flash_graph_attention as fl

    q, k, v, key_mask, query_mask, graph = args
    for renorm in ("l1", "sum_eps"):
        out, m, z, bsum = fl.flash_graph_attention(*args, heads, renorm, "stats")
        d_out, delta = fl.masked_grad_and_delta(out, dy, query_mask, heads)
        bwd = (q, k, v, key_mask, graph, m, z, bsum, delta, d_out, heads, renorm)
        got = fl.flash_bwd_dq(*bwd)
        simt = fl._launch_dq(*bwd, path="simt")
        torch.cuda.synchronize()
        check(torch.equal(got, simt),
              f"K5 {label} f32 {renorm}: equals the first SIMT kernel's dQ bit for bit "
              f"(max|f32 - SIMT| {(got - simt).abs().max().item():.3g})")


def k1_phase(gen) -> dict:
    from structured_alignment_vqa_tpu_torch.ops import fused_graph_attention as k1

    # a head width of 8 (64 heads) is no multiple of 16: bf16 takes the SIMT kernel
    path = k1.kernel_path(torch.bfloat16, C // 64)
    check(path == "simt", f"K1 self L=66 B=4 heads=64 bf16: head width {C // 64} takes the "
          f"{path} kernel")
    k1_against_plain("self L=66 B=4 heads=64", k1_inputs(gen, 66, 66, torch.bfloat16, REL_B), 64)
    # 65 keys: two adjacent graph entries are not 8-byte aligned, so the
    # tensor-core kernel loads them one by one; sample 0 has every key masked
    # (each key then weighs exp(0) = 1 in the softmax, as in the plain version)
    # (f32: 65 keys leave a last key step of one key in both passes over them)
    for dtype in (torch.bfloat16, torch.float32):
        k1_against_plain("self L=65 B=4", k1_inputs(gen, 65, 65, dtype, REL_B), HEADS)
        k1_against_plain("self L=128 B=4 all keys of sample 0 masked",
                         k1_inputs(gen, 128, 128, dtype, REL_B, all_masked=True), HEADS)
        k1_against_plain("cross Tq=1 Lk=300 B=4 (5 key steps)",
                         k1_inputs(gen, 1, 300, dtype, REL_B), HEADS)

    # f32 at a head width that is no multiple of 4 (12 heads of 10 at C
    # 120) keeps the first SIMT kernel
    path = k1.k1_path(torch.float32, 10)
    check(path == "simt", f"K1 self L=66 B=4 C=120 heads=12 f32: head width 10 takes the {path} "
          "kernel")
    q, k, v, key_mask, query_mask, graph, res, gamma, beta = k1_inputs(gen, 66, 66, torch.float32,
                                                                       REL_B)
    q, k, v, res = (t[..., :120].contiguous() for t in (q, k, v, res))
    k1_against_plain("self L=66 B=4 C=120 heads=12", (q, k, v, key_mask, query_mask, graph, res,
                                                      gamma[:120].contiguous(),
                                                      beta[:120].contiguous()), 12)

    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        shapes = K1_SHAPES + (K1_VARIANT_SHAPES if dtype == torch.float32 else ())
        for label, tq, tk, B in shapes:
            args = k1_inputs(gen, tq, tk, dtype, B)
            path = k1.k1_path(dtype, C // HEADS)
            want_path = "tensor-core" if dtype == torch.bfloat16 else "f32"
            check(path == want_path, f"K1 {label} {dtype}: takes the {path} kernel")
            err = k1_against_plain(label, args, HEADS)
            if dtype == torch.float32:
                k1_f32_bits(label, args)
            if dtype == torch.float32 and label in ("self L=128", "cross Tq=1 Lk=128"):
                device_kernels_only(lambda: k1.fused_graph_attention_ln(*args, HEADS, "l1"),
                                    f"K1 {label} {dtype}", K1_F32_KERNELS,
                                    "csrc/graph_attention.cu's f32 and LayerNorm kernels")
            ms = time_ms(lambda: k1.fused_graph_attention_ln(*args, HEADS, "l1"))
            plain_ms = time_ms(lambda: k1.graph_attention_ln_plain(*args, HEADS, "l1"))
            size = torch.finfo(dtype).bits // 8
            nbytes = (size * B * C * (3 * tq + 2 * tk) + 4 * B * (tq + tk + tq * tk) + 8 * C)
            bound_ms, bound_by = bound(nbytes, 4.0 * B * tq * tk * C, dtype)
            print(f"K1 {label} {dtype}: {path} kernel {ms:.4f} ms{previous('K1', label, dtype)}, "
                  f"plain {plain_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us ({bound_by})",
                  flush=True)
            rows.append(dict(label=label, dtype=dtype, err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by))
    for dtype in (torch.bfloat16, torch.float32):
        for label, tq, tk, heads in K12_WIDE_SHAPES:
            # head width 256: K1's tensor-core kernel in bf16, the SIMT kernel in f32
            want = "tensor-core" if dtype == torch.bfloat16 else "simt"
            rows.append(k1_wide_row(label, k1_inputs(gen, tq, tk, dtype, WIDE_B, c=WIDE_C),
                                    heads, want))
        k1_against_plain("self L=65 B=4 C=99 heads=3", k1_inputs(gen, 65, 65, dtype, REL_B, c=99),
                         3)
    beyond = beyond_gen()
    for dtype in (torch.bfloat16, torch.float32):
        for label, tq, tk, heads, c in K12_BEYOND_SHAPES:
            args = k1_inputs(beyond, tq, tk, dtype, BEYOND_B, c=c)
            want = k1_beyond_path(dtype, c // heads)
            rows.append(k1_wide_row(label, args, heads, want))
            if dtype == torch.float32 and (c // heads, tq) == (512, 128):
                device_kernels_only(lambda: k1.fused_graph_attention_ln(*args, heads, "l1"),
                                    f"K1 {label} {dtype}", K1_WIDE_KERNELS,
                                    "the wide K4 kernel and K1's LayerNorm kernel")
            del args
            torch.cuda.empty_cache()
    head256 = head256_gen()
    label, tq, tk = K1_HEAD256_SHAPE
    rows.append(k1_wide_row(label, k1_inputs(head256, tq, tk, torch.bfloat16, WIDE_B, c=WIDE_C),
                            WIDE_HEADS, "tensor-core"))
    # the attention-only entry (the model axis's) takes the same kernel
    for label, tq, tk in (("C=2048 H=8 L=512 B=8", 512, 512), K1_HEAD256_SHAPE):
        args = k1_inputs(head256, tq, tk, torch.bfloat16, WIDE_B, c=WIDE_C)[:6]
        err = 0.0
        for renorm in ("l1", "sum_eps"):
            got = k1.graph_attention_heads(*args, WIDE_HEADS, renorm)
            want = k1.graph_attention_plain(*args, WIDE_HEADS, renorm)
            torch.cuda.synchronize()
            err = max(err, (got - want).abs().max().item())
        path = k1.k1_path(torch.bfloat16, WIDE_C // WIDE_HEADS, tk, WIDE_C)
        check(path == "tensor-core" and err <= TOL[torch.bfloat16],
              f"K1 heads {label} {torch.bfloat16}: the {path} kernel, max|kernel-plain| "
              f"{err:.3g} <= {TOL[torch.bfloat16]:g}")
    del args
    torch.cuda.empty_cache()
    return {r["label"] + str(r["dtype"]): r for r in rows}


# the wide path of K1: the wide K4 kernel (emit 3), then K1's LayerNorm kernel
K1_WIDE_KERNELS = ("flash_graph_attention_wide_kernel", "graph_attention_ln_epilogue_kernel")


def k1_beyond_path(dtype, head_dim: int) -> str:
    """The K1 path a shape above the old domain must take: the tensor-core
    (bf16) or f32 kernel at head width 128, else the wide path."""
    if head_dim == 128:
        return "tensor-core" if dtype == torch.bfloat16 else "f32"
    return "wide"


def k1_wide_row(label: str, args, heads: int, want: str = "simt") -> dict:
    """K1 at a width beyond the presets': its kernel (the path ``want``
    names) against the plain version, timed beside its bound."""
    from structured_alignment_vqa_tpu_torch.ops import fused_graph_attention as k1

    q, k = args[0], args[1]
    b, tq, c = q.shape
    tk, dtype = k.shape[1], q.dtype
    path = k1.k1_path(dtype, c // heads, tk, c)
    check(path == want, f"K1 {label} {dtype}: head width {c // heads} takes the {path} kernel")
    err = k1_against_plain(label, args, heads)
    ms = time_ms(lambda: k1.fused_graph_attention_ln(*args, heads, "l1"))
    plain_ms = time_ms(lambda: k1.graph_attention_ln_plain(*args, heads, "l1"), iters=5)
    size = torch.finfo(dtype).bits // 8
    nbytes = size * b * c * (3 * tq + 2 * tk) + 4 * b * (tq + tk + tq * tk) + 8 * c
    bound_ms, bound_by = bound(nbytes, 4.0 * b * tq * tk * c, dtype)
    how = {"simt": f"{k1.simt_rows(tq, tk, c, heads)} rows a block",
           "wide": f"scores computed {-(-(c // heads) // 256)} time(s)"}.get(path, "per head")
    print(f"K1 {label} {dtype}: {path} kernel ({how}), "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us ({bound_by})",
          flush=True)
    return dict(label=label, dtype=dtype, err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, wide=True)


# the variants' f32 rows of K3 at C 512 (scripts/variant_kernel_times.py):
# a decoder token, 49 regions, 99 and 300 tokens a sample of bs 64
VARIANT_K3_ROWS = (64, 3136, 6336, 19200)


def k3_inputs(gen, n: int, c: int, dtype, hidden: int = 0) -> tuple:
    """K3's arguments at n rows of C (hidden 4C unless given)."""
    dev = "cuda"
    hidden = hidden or 4 * c
    x = torch.randn(n, c, generator=gen, device=dev).to(dtype)
    w1 = (torch.randn(hidden, c, generator=gen, device=dev) / c ** 0.5).to(dtype)
    b1 = (0.05 * torch.randn(hidden, generator=gen, device=dev)).to(dtype)
    w2 = (torch.randn(c, hidden, generator=gen, device=dev) / hidden ** 0.5).to(dtype)
    b2 = (0.05 * torch.randn(c, generator=gen, device=dev)).to(dtype)
    gamma = 1 + 0.05 * torch.randn(c, generator=gen, device=dev)
    beta = 0.05 * torch.randn(c, generator=gen, device=dev)
    return x, w1, b1, w2, b2, gamma, beta


def k3_path(dtype, n: int, c: int, hidden: int = 0) -> str:
    """Which of K3's designs a call of n rows takes, and its tiles."""
    from structured_alignment_vqa_tpu_torch.ops import fused_ffn as k3

    if k3.ffn_path(dtype, c, hidden or 4 * c) == "row-tile":
        return "row-tile tensor-core kernel"
    tile_rows = k3.products_plan(n, c, hidden or 4 * c, dtype)[0]
    return (f"products {'SIMT' if dtype == torch.float32 else 'mma'} kernels, "
            f"tiles of {tile_rows} x 128")


def device_kernels_only(fn, what: str, mine: tuple, source: str) -> None:
    """Check that calls of ``fn`` under torch.profiler launch only kernels
    whose names hold one of ``mine`` (the kernels of ``source``) and no
    library GEMM. Three calls: after an earlier profile in the process the
    profiler has been seen to miss the first kernels of a session; a
    session that saw no device kernel at all is profiled again, a second
    later, four times at most (on one slow machine it missed all three
    calls; in one run after the head-width-256 rows of phase k4, K6's f32
    check saw none in all three sessions it then had and K5's none in its
    first; in whole runs with CUPTI kept set up between sessions two of
    K4's, K5's and K6's f32 checks at L 1,536 none in all five, while for
    tens of seconds a session saw any kernel, a torch op's too, one time in
    four or five: ``main`` has CUPTI torn down after each session since).
    Each check's sessions are kept in
    ``sessions`` and summed up at the end of the run
    (:func:`profiler_sessions_line`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(5):
        if attempt:
            time.sleep(1.0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        names = sorted({e.name for e in prof.events()
                        if e.device_type == DeviceType.CUDA and not e.is_user_annotation})
        if names:
            break
        print(f"{what}: the profiler saw no device kernel in session {attempt + 1}",
              flush=True)
    device_kernels_only.sessions.append((what, attempt + 1))
    foreign = [n for n in names if not any(m in n for m in mine)
               or any(mark in n.lower() for mark in LIBRARY_GEMM_MARKS)]
    check(bool(names) and not foreign,
          f"{what}: the device ran {len(names)} kernel(s), all of {source} "
          f"({', '.join(n[:60] for n in names)}); foreign {foreign}")


device_kernels_only.sessions = []   # (what, sessions it took) of each check, in order


def profiler_sessions_line() -> str:
    """How many profiler sessions the run's device_kernels_only checks
    took: those that needed more than one, by name."""
    runs = device_kernels_only.sessions
    more = {what: n for what, n in runs if n > 1}
    return (f"profiler checks: {len(runs)}, sessions {sum(n for _, n in runs)}, "
            f"those that took more than one {more or 'none'}")


def k3_device_kernels(fn, what: str) -> None:
    """Check that one call of ``fn`` launches only kernels of csrc/ffn.cu."""
    device_kernels_only(fn, f"K3 {what}", ("ffn_ln_", "ffn_partial_sum"), "csrc/ffn.cu")


def k3_phase(gen) -> dict:
    from structured_alignment_vqa_tpu_torch.ops import fused_ffn as k3

    rows = []
    # (rows, C, dtypes): 1,000 rows are no multiple of a 64- or 128-row tile;
    # C 2,048 is x2_fusion_dec_mil2's alignment FFN at the variant eval's bs
    # 64 x 49 regions, 1,001 rows ragged there; the variants' f32 rows
    both = (torch.bfloat16, torch.float32)
    shapes = [(n, C, both) for n in (16384, 8448, 128, REL_B * REL_L, REL_B * (REL_LV + REL_LQ),
                                     REL_B, 1000)]
    shapes += [(VARIANT_B * VARIANT_LV, WIDE_C, both), (1001, WIDE_C, both)]
    shapes += [(n, C, (torch.float32,)) for n in VARIANT_K3_ROWS]
    shapes += [(16384, c, both) for c in K3_WIDE_CS] + [(1000, 33, both)]

    def run(gen, n: int, c: int, dtype) -> None:
        """K3 at n rows of C (hidden 4C) against its plain version; timed
        and kept in ``rows`` unless the rows are ragged or C odd."""
        hidden = 4 * c
        args = k3_inputs(gen, n, c, dtype)
        got = k3.fused_ffn(*args)
        want = k3.ffn_ln_plain(*args)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        n_split = k3.kernel_ffn_split(dtype, n, c, hidden)[0]
        path = k3_path(dtype, n, c)
        label = f"rows={n}" if c == C else f"rows={n} C={c}"
        check(err <= TOL[dtype] and bool(torch.isfinite(got.float()).all()),
              f"K3 {label} {dtype}: {path}, hidden width in {n_split} shard(s), "
              f"max|kernel-plain| {err:.3g} <= {TOL[dtype]:g}")
        if n in (1000, 1001):   # ragged tiles and odd widths: checked, not timed
            return
        if (n, c) in ((16384, C), (VARIANT_B * VARIANT_LV, WIDE_C), (K3_BEYOND_ROWS, 4096)) and (
                dtype == torch.float32 or c != C):
            k3_device_kernels(lambda: k3.fused_ffn(*args), f"{label} {dtype}")
        ms = time_ms(lambda: k3.fused_ffn(*args))
        plain_ms = time_ms(lambda: k3.ffn_ln_plain(*args))
        size = torch.finfo(dtype).bits // 8
        nbytes = size * (2 * n * c + 2 * c * hidden + hidden + c) + 8 * c
        bound_ms, bound_by = bound(nbytes, 4.0 * n * c * hidden, dtype)
        print(f"K3 {label} {dtype}: {path}, {n_split} shard(s), {ms:.4f} ms"
              f"{previous('K3', label, dtype)}, plain {plain_ms:.4f} ms, "
              f"bound {bound_ms * 1e3:.2f} us ({bound_by})", flush=True)
        rows.append(dict(label=label, dtype=dtype, err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         wide=c in K3_WIDE_CS + K3_BEYOND_CS))

    for dtype in both:
        for n, c, dtypes in shapes:
            if dtype in dtypes:
                run(gen, n, c, dtype)

    # the model axis's entries at a width beyond the presets': C 768, a
    # model-2 rank's hidden shard of 1,536, both dtypes (not timed; C 4,096
    # with a shard of 8,192 below)
    for dtype in both:
        k3_model_axis(gen, 768, 1536, dtype)

    # the model axis's f32 partial of a hidden shard: 16,384 rows, shard 1,024
    dtype, n, hidden = torch.float32, MODEL_ROWS, MODEL_HIDDEN
    x, w1, b1, w2 = k3_inputs(gen, n, C, dtype, hidden)[:4]
    got, want = k3.ffn_partial(x, w1, b1, w2), k3.ffn_partial_plain(x, w1, b1, w2)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    n_split = k3.kernel_ffn_split(dtype, n, C, hidden)[0]
    label = f"partial rows={n} hidden={hidden}"
    check(err <= TOL[dtype] and bool(torch.isfinite(got).all()),
          f"K3 {label} {dtype}: {k3_path(dtype, n, C, hidden)}, hidden shard in {n_split} block "
          f"shard(s), max|kernel-plain| {err:.3g} <= {TOL[dtype]:g}")
    ms = time_ms(lambda: k3.ffn_partial(x, w1, b1, w2))
    plain_ms = time_ms(lambda: k3.ffn_partial_plain(x, w1, b1, w2))
    bound_ms, bound_by = bound(4 * (2 * n * C + 2 * C * hidden + hidden), 4.0 * n * C * hidden,
                               dtype)
    print(f"K3 {label} {dtype}: {k3_path(dtype, n, C, hidden)}, {n_split} shard(s), {ms:.4f} ms"
          f"{previous('K3', label, dtype)}, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms * 1e3:.2f} us ({bound_by})", flush=True)
    rows.append(dict(label=label, dtype=dtype, err=err, ms=ms, plain_ms=plain_ms,
                     bound_ms=bound_ms, bound_by=bound_by))
    del x, w1, b1, w2, got, want

    # above the old domain, from a generator of their own (the rows above
    # see the inputs they saw before these were added)
    beyond = beyond_gen()
    for dtype in both:
        for n, c in [(K3_BEYOND_ROWS, c) for c in K3_BEYOND_CS] + [(1000, K3_ODD_C)]:
            run(beyond, n, c, dtype)
            torch.cuda.empty_cache()
    for dtype in both:
        k3_model_axis(beyond, 4096, 8192, dtype)
    # C 60,000 with a hidden width of 64: the row kernel's rows pass what it
    # stages in shared memory, so each of its passes forms them again
    n, c, hidden = K3_UNSTAGED
    for dtype in both:
        args = k3_inputs(beyond, n, c, dtype, hidden)
        got, want = k3.fused_ffn(*args), k3.ffn_ln_plain(*args)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(err <= TOL[dtype] and bool(torch.isfinite(got.float()).all()),
              f"K3 rows={n} C={c} hidden={hidden} {dtype}: {k3_path(dtype, n, c, hidden)}, "
              f"max|kernel-plain| {err:.3g} <= {TOL[dtype]:g}")
    return {r["label"] + str(r["dtype"]): r for r in rows}


def k3_model_axis(gen, c: int, hidden: int, dtype) -> None:
    """The model axis's K3 entries at 3,000 rows of C with a rank's hidden
    shard: the partial against its plain version, then the epilogue on it."""
    from structured_alignment_vqa_tpu_torch.ops import fused_ffn as k3

    x, w1, b1, w2, b2, gamma, beta = k3_inputs(gen, 3000, c, dtype, hidden)
    part, part_plain = k3.ffn_partial(x, w1, b1, w2), k3.ffn_partial_plain(x, w1, b1, w2)
    out = k3.ffn_epilogue(part, x, b2, gamma, beta)
    out_plain = k3.ffn_epilogue_plain(part, x, b2, gamma, beta)
    torch.cuda.synchronize()
    e_part = rel_err(part, part_plain)
    e_out = (out.float() - out_plain.float()).abs().max().item()
    check(e_part <= K2_TOL[dtype] and e_out <= TOL[dtype]
          and bool(torch.isfinite(out.float()).all()),
          f"K3 partial + epilogue rows=3000 C={c} hidden={hidden} {dtype}: "
          f"{k3_path(dtype, 3000, c, hidden)}, partial max|kernel-plain|/max|plain| "
          f"{e_part:.3g} <= {K2_TOL[dtype]:g}, epilogue max|kernel-plain| {e_out:.3g} <= "
          f"{TOL[dtype]:g}")


def beyond_gen() -> torch.Generator:
    """The generator of a kernel phase's rows above the old domain, apart
    from the one its other rows draw from."""
    return torch.Generator(device="cuda").manual_seed(4321)


def head256_gen() -> torch.Generator:
    """The generator of a kernel phase's rows at head width 256 added with
    K1's and K4's tensor-core kernels there, apart from the others."""
    return torch.Generator(device="cuda").manual_seed(2562)


def k4_paths_gen() -> torch.Generator:
    """The generator of K4's rows of the wide kernel at head width 258 and
    of the split head-256 and chunked kernels, apart from the others."""
    return torch.Generator(device="cuda").manual_seed(2583)


def k2_simt_gen() -> torch.Generator:
    """The generator of K2's rows of its first SIMT kernels above head
    width 128 (``K2_SIMT254_SHAPES``), apart from the others."""
    return torch.Generator(device="cuda").manual_seed(2541)


def k56_head256_gen() -> torch.Generator:
    """The generator of K5's and K6's rows of instance 256 beyond the
    widths rows (the split one-query call, the padded widths) and of their
    wide kernels at head width 258, apart from the others."""
    return torch.Generator(device="cuda").manual_seed(2564)


def k2_inputs(gen, tq: int, tk: int, dtype, B: int = B, c: int = C):
    """K1's arguments (``k1_inputs``) and a dy; for self-attention the first
    third of the rows get an all-zero graph (as the encoder's stage-1 graph
    on its modality rows)."""
    args = k1_inputs(gen, tq, tk, dtype, B, c=c)
    if tq == tk:
        args[5][:, : tq // 3] = 0.0
    dy = torch.randn(B, tq, c, generator=gen, device="cuda").to(dtype)
    return args, dy


def rel_err(got, want) -> float:
    """max |got - want| over max |want| (absolute where want is all 0)."""
    scale = want.float().abs().max().item()
    return (got.float() - want.float()).abs().max().item() / (scale if scale > 0 else 1.0)


def k2_plain(args, heads: int):
    """K2's plain version for the route the call takes: the composed
    route's (which rounds n and dS where K5 and K6 round them) or K2's."""
    from structured_alignment_vqa_tpu_torch.ops import fused_graph_attention as k1

    q, k = args[0], args[1]
    c = q.shape[-1]
    if k1.k2_path(q.dtype, c // heads, k.shape[1], c, heads) == "composed":
        return k1.graph_attention_ln_bwd_composed_plain
    return k1.graph_attention_ln_bwd_plain


def k2_against_plain(label: str, args, dy, heads: int, renorm: str) -> tuple:
    """K2 against the plain version of its route (``k2_plain``), output by
    output: (kernel outputs, the largest relative and the largest absolute
    error)."""
    from structured_alignment_vqa_tpu_torch.ops import fused_graph_attention as k1

    dtype = args[0].dtype
    got = k1.fused_graph_attention_ln_bwd(*args, dy, heads, renorm)
    want = k2_plain(args, heads)(*args, dy, heads, renorm)
    torch.cuda.synchronize()
    rel = err = 0.0
    for name, g, w in zip(("dq", "dk", "dv", "dresidual", "dgamma", "dbeta"), got, want):
        e = rel_err(g, w)
        tol = K2_TOL[dtype] if g.dtype == torch.bfloat16 else K2_TOL[torch.float32]
        check(e <= tol and bool(torch.isfinite(g).all()),
              f"K2 {label} {dtype} {renorm} {name}: max|kernel-plain|/max|plain| "
              f"{e:.3g} <= {tol:g}")
        rel = max(rel, e)
        err = max(err, (g.float() - w.float()).abs().max().item())
    return got, rel, err


# K2's f32 rows at the variants' shapes (x2_dec's and x5_dec_mil's
# backwards, bs 64): the encoders' self-attention at L 99 and 300, the
# decoders' one query into 99 and 300 keys
K2_VARIANT_SHAPES = (("self L=99 B=64", 99, 99, VARIANT_B), ("self L=300 B=64", 300, 300, VARIANT_B),
                     ("cross Tq=1 Lk=99 B=64", 1, 99, VARIANT_B),
                     ("cross Tq=1 Lk=300 B=64", 1, 300, VARIANT_B))
K2_F32_KERNELS = ("graph_attention_ln_bwd_fwd_f32_kernel", "graph_attention_ln_bwd_ln_f32_kernel",
                  "graph_attention_ln_bwd_dq_f32_kernel", "graph_attention_ln_bwd_dkv_f32_kernel")


def k2_kernels(dtype, head_dim: int) -> str:
    """Which of K2's designs a call takes."""
    from structured_alignment_vqa_tpu_torch.ops import fused_graph_attention as k1

    if k1.kernel_path(dtype, head_dim) == "tensor-core":
        return "tensor-core kernels"
    return "f32 kernels" if dtype == torch.float32 else "SIMT kernels"


def k2_phase(gen) -> dict:
    from structured_alignment_vqa_tpu_torch.ops import fused_graph_attention as k1

    # a head width of 8 (64 heads) is no multiple of 16: bf16 takes the SIMT kernels
    args, dy = k2_inputs(gen, 66, 66, torch.bfloat16, REL_B)
    path = k1.kernel_path(torch.bfloat16, C // 64)
    check(path == "simt", f"K2 self L=66 B=4 heads=64 bf16: head width {C // 64} takes the "
          f"{path} kernels")
    for renorm in ("l1", "sum_eps"):
        k2_against_plain("self L=66 B=4 heads=64", args, dy, 64, renorm)

    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        shapes = K1_SHAPES + (K2_VARIANT_SHAPES if dtype == torch.float32 else ())
        for label, tq, tk, B in shapes:
            args, dy = k2_inputs(gen, tq, tk, dtype, B)
            path = k2_kernels(dtype, C // HEADS)
            want_path = "tensor-core kernels" if dtype == torch.bfloat16 else "f32 kernels"
            check(path == want_path, f"K2 {label} {dtype}: takes the {path}")
            err = rel = 0.0
            for renorm in ("l1", "sum_eps"):
                got, r, e = k2_against_plain(label, args, dy, HEADS, renorm)
                rel, err = max(rel, r), max(err, e)
                if dtype == torch.float32:
                    leaves = [a.detach().clone().requires_grad_(i in (0, 1, 2, 6, 7, 8))
                              for i, a in enumerate(args)]
                    out = k1.graph_attention_ln_plain(*leaves, HEADS, renorm)
                    auto = torch.autograd.grad(out, [leaves[i] for i in (0, 1, 2, 6, 7, 8)], dy)
                    e = max(rel_err(g, a) for g, a in zip(got, auto))
                    check(e <= K2_AUTOGRAD_TOL,
                          f"K2 {label} f32 {renorm}: max|kernel-autograd|/max|autograd| "
                          f"{e:.3g} <= {K2_AUTOGRAD_TOL:g}")
            if dtype == torch.float32 and label in ("self L=128", "cross Tq=1 Lk=128"):
                device_kernels_only(
                    lambda: k1.fused_graph_attention_ln_bwd(*args, dy, HEADS, "l1"),
                    f"K2 {label} {dtype}", K2_F32_KERNELS + ("elementwise", "reduce"),
                    "csrc/graph_attention_bwd.cu's f32 kernels (and the sum of the partials)")
            ms = time_ms(lambda: k1.fused_graph_attention_ln_bwd(*args, dy, HEADS, "l1"))
            plain_ms = time_ms(lambda: k1.graph_attention_ln_bwd_plain(*args, dy, HEADS, "l1"))
            size = torch.finfo(dtype).bits // 8
            # reads q, k, v, residual, dy, the masks, the f32 graph and gamma;
            # writes dq, dk, dv, dresidual, dgamma and dbeta
            nbytes = (size * B * C * (5 * tq + 4 * tk) + 4 * B * (tq + tk + tq * tk) + 12 * C)
            # recomputed QK^T and AV, then dV, dA, dQ and dK: 6 products of 2 B Tq Tk C
            bound_ms, bound_by = bound(nbytes, 12.0 * B * tq * tk * C, dtype)
            print(f"K2 {label} {dtype}: {path} {ms:.4f} ms{previous('K2', label, dtype)}, "
                  f"plain {plain_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us ({bound_by})",
                  flush=True)
            rows.append(dict(label=label, dtype=dtype, err=err, rel_err=rel, ms=ms,
                             plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by))
    # 65 keys: two adjacent graph entries are not 8-byte aligned, so the
    # tensor-core kernels load them one by one
    args, dy = k2_inputs(gen, 65, 65, torch.bfloat16, REL_B)
    for renorm in ("l1", "sum_eps"):
        k2_against_plain("self L=65 B=4", args, dy, HEADS, renorm)
    for dtype in (torch.bfloat16, torch.float32):
        shapes = K12_WIDE_SHAPES + (K2_WIDE16_SHAPES if dtype == torch.bfloat16 else ())
        for label, tq, tk, heads in shapes:
            args, dy = k2_inputs(gen, tq, tk, dtype, WIDE_B, c=WIDE_C)
            rows.append(k2_wide_row(label, args, dy, heads, "composed"))
            del args, dy
            torch.cuda.empty_cache()
        args, dy = k2_inputs(gen, 65, 65, dtype, REL_B, c=99)
        for renorm in ("l1", "sum_eps"):
            k2_against_plain("self L=65 B=4 C=99 heads=3", args, dy, 3, renorm)
    beyond = beyond_gen()
    for dtype in (torch.bfloat16, torch.float32):
        for label, tq, tk, heads, c in K12_BEYOND_SHAPES:
            args, dy = k2_inputs(beyond, tq, tk, dtype, BEYOND_B, c=c)
            want = {"tensor-core": "composed"}.get(k1_beyond_path(dtype, c // heads),
                                                   k1_beyond_path(dtype, c // heads))
            rows.append(k2_wide_row(label, args, dy, heads, want))
            if dtype == torch.float32 and (c // heads, tq) in ((512, 128), (128, 128)):
                kernels = K2_WIDE_KERNELS if c // heads == 512 else K2_F32_WIDE_C_KERNELS
                device_kernels_only(
                    lambda: k1.fused_graph_attention_ln_bwd(*args, dy, heads, "l1"),
                    f"K2 {label} {dtype}", kernels + ("elementwise", "reduce"),
                    "K2's kernels for this width (and torch's sums of the partials and of "
                    "dO . o)")
            del args, dy
            torch.cuda.empty_cache()
    simt = k2_simt_gen()
    for dtype in (torch.bfloat16, torch.float32):
        for label, tq, tk, heads, c in K2_SIMT254_SHAPES:
            args, dy = k2_inputs(simt, tq, tk, dtype, WIDE_B, c=c)
            rows.append(k2_wide_row(label, args, dy, heads, "simt"))
            del args, dy
            torch.cuda.empty_cache()
    return {r["label"] + str(r["dtype"]): r for r in rows}


# K2's wide path: the wide K4 kernel (o and its statistics), the LayerNorm
# backward that reads rows in chunks, the wide K5 and K6
K2_WIDE_KERNELS = ("flash_graph_attention_wide_kernel", "graph_attention_ln_bwd_ln_wide_kernel",
                   "flash_graph_attention_bwd_dq_wide_kernel",
                   "flash_graph_attention_bwd_dkv_wide_kernel")
# K2's f32 kernels above C 2,048: the LayerNorm backward is the wide one
K2_F32_WIDE_C_KERNELS = ("graph_attention_ln_bwd_fwd_f32_kernel",
                         "graph_attention_ln_bwd_ln_wide_kernel",
                         "graph_attention_ln_bwd_dq_f32_kernel",
                         "graph_attention_ln_bwd_dkv_f32_kernel")


TILED_PARTS = {"K5 tensor-core", "K6 tensor-core", "K5 f32", "K6 f32"}


def k2_wide_row(label: str, args, dy, heads: int, want: str = "simt") -> dict:
    """K2 at a width beyond the presets': its design (the one ``want``
    names) against the plain version of its route in both renorms, timed
    beside its bound. On the composed route every K5 and K6 it launches
    must take a tiled kernel (their C entries' report)."""
    from structured_alignment_vqa_tpu_torch.ops import fused_graph_attention as k1

    q, k = args[0], args[1]
    b, tq, c = q.shape
    tk, dtype = k.shape[1], q.dtype
    path = k1.k2_path(dtype, c // heads, tk, c, heads)
    check(path == want, f"K2 {label} {dtype}: head width {c // heads} takes the {path} kernels")
    k1.fused_graph_attention_ln_bwd.parts.clear()
    err = rel = 0.0
    for renorm in ("l1", "sum_eps"):
        _, r, e = k2_against_plain(label, args, dy, heads, renorm)
        rel, err = max(rel, r), max(err, e)
    if path == "composed":
        parts = dict(k1.fused_graph_attention_ln_bwd.parts)
        check(set(parts) <= TILED_PARTS and sum(parts.values()) == 4,
              f"K2 {label} {dtype}: the composed route's K5 and K6 launches by kernel {parts} "
              "(all on the tensor-core or f32 kernels)")
    ms = time_ms(lambda: k1.fused_graph_attention_ln_bwd(*args, dy, heads, "l1"), iters=5)
    plain = k2_plain(args, heads)
    plain_ms = time_ms(lambda: plain(*args, dy, heads, "l1"), iters=3)
    size = torch.finfo(dtype).bits // 8
    nbytes = size * b * c * (5 * tq + 4 * tk) + 4 * b * (tq + tk + tq * tk) + 12 * c
    bound_ms, bound_by = bound(nbytes, 12.0 * b * tq * tk * c, dtype)
    print(f"K2 {label} {dtype}: {path} kernels "
          f"({k1.bwd_row_tile(dtype, c // heads, tq, tk, c, heads)} rows a block), {ms:.4f} ms"
          f"{previous('K2', label, dtype)}, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms * 1e3:.2f} us ({bound_by})", flush=True)
    return dict(label=label, dtype=dtype, err=err, rel_err=rel, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, wide=True)


# (label, Tq, Tk): the symbolic encoder's self-attention, the decoder's one
# query into it, and a shape that fills no tile
FLASH_SHAPES = (("self L=1536", REL_L, REL_L), ("self L=1506+30", REL_L, REL_L),
                ("cross Tq=1 Lk=1536", 1, REL_L), ("odd Tq=200 Tk=700", 200, 700))
# K4 only: two query tiles that do not fill the card, so the keys are split
K4_SPLIT_SHAPE = ("split Tq=70 Tk=1536", 70, REL_L)
# K5 and K6 in f32 only, (label, Tq, Tk, heads): a ring rank's 768 queries
# against a 768-key block (phase seq's rotation), a model rank's 4 heads of
# 64 (phase model)
K56_F32_SHAPES = (("ring shard Tq=768 Tk=768", REL_L // 2, REL_L // 2, HEADS),
                  ("self L=1536 4 heads", REL_L, REL_L, HEADS // 2))
# bf16 shapes whose blocks do not fill the card: the key split and its merge
# kernel must take them
K4_SPLIT_LABELS = ("cross Tq=1 Lk=1536", "odd Tq=200 Tk=700", K4_SPLIT_SHAPE[0])


def flash_inputs(gen, label: str, tq: int, tk: int, dtype, c: int = C, b: int = REL_B):
    """K4's arguments at (b, Tq, Tk, c), as the model makes them: keys
    valid up to a ragged length per sample ("1506+30": both the modality
    part and the question part end in padding), keys 64-127 of sample 1
    masked as a whole tile, every key (and query) of the last sample masked,
    and the first third of the self-attention rows with an all-zero graph
    (the encoder's stage-1 graph on its modality rows)."""
    dev = "cuda"
    pos = torch.arange(tk, device=dev)[None]
    if label == "self L=1506+30":
        n_mod = torch.randint(REL_LS * 3 // 5, REL_LS + 1, (b, 1), generator=gen, device=dev)
        n_q = torch.randint(1, REL_LQ + 1, (b, 1), generator=gen, device=dev)
        key_mask = ((pos < n_mod) | ((pos >= REL_LS) & (pos < REL_LS + n_q))).float()
    else:
        n_keys = torch.randint(tk // 2, tk + 1, (b, 1), generator=gen, device=dev)
        key_mask = (pos < n_keys).float()
    key_mask[1, 64:128] = 0.0
    key_mask[b - 1] = 0.0
    query_mask = key_mask.clone() if tq == tk else torch.ones(b, tq, device=dev)
    graph = (torch.rand(b, tq, tk, generator=gen, device=dev) < 0.3).float()
    if tq == tk:
        graph[:, : tq // 3] = 0.0
    q, k, v = (torch.relu(torch.randn(b, t, c, generator=gen, device=dev)).to(dtype)
               for t in (tq, tk, tk))
    # padding rows of the model are relu(bias), not 0: nothing is zeroed here
    return q, k, v, key_mask, query_mask, graph


def k4_against_plain(label: str, args, heads: int) -> float:
    """K4 against its plain version over both renorms and every emit; the
    largest absolute error of ``out``."""
    from structured_alignment_vqa_tpu_torch.ops import flash_graph_attention as fl

    dtype = args[0].dtype
    err = 0.0
    for renorm in ("l1", "sum_eps"):
        for emit in fl.EMITS:
            got = fl.flash_graph_attention(*args, heads, renorm, emit)
            want = fl.flash_graph_attention_plain(*args, heads, renorm, emit)
            torch.cuda.synchronize()
            if emit == "out":
                got, want = (got,), (want,)
            names = ("a" if emit == "partial" else "out", "m", "z", "b")
            for name, g, w in zip(names, got, want):
                finite = bool(torch.isfinite(g.float()).all())
                if name == "out":
                    e = (g.float() - w.float()).abs().max().item()
                    err = max(err, e)
                    ok, tol, how = e <= TOL[dtype], TOL[dtype], "max|kernel-plain|"
                elif name == "m":   # the fill value on fully masked rows, else O(10)
                    e = (g - w).abs().max().item()
                    ok, tol, how = e <= 1e-3, 1e-3, "max|kernel-plain|"
                else:   # f32 outputs; a carries weights rounded to V's dtype
                    e = rel_err(g, w)
                    tol = K2_TOL[dtype] if name == "a" else STATS_TOL
                    ok, how = e <= tol, "max|kernel-plain|/max|plain|"
                check(ok and finite, f"K4 {label} {dtype} {renorm} emit={emit} {name}: "
                      f"{how} {e:.3g} <= {tol:g}")
    return err


def k4_kernel(dtype, head_dim: int) -> str:
    """Which of K4's kernels a call takes: tensor-core, f32 or SIMT."""
    from structured_alignment_vqa_tpu_torch.ops import flash_graph_attention as fl

    if fl.kernel_path(dtype, head_dim) == "tensor-core":
        return "tensor-core"
    return "f32" if dtype == torch.float32 else "SIMT"


def k4_phase(gen) -> dict:
    from structured_alignment_vqa_tpu_torch.ops import flash_graph_attention as fl

    # a head width of 8 (64 heads) is no multiple of 16: bf16 takes the SIMT kernel
    label, tq, tk = FLASH_SHAPES[3]
    path = fl.kernel_path(torch.bfloat16, C // 64)
    check(path == "simt", f"K4 {label} heads=64 bf16: head width {C // 64} takes the {path} kernel")
    k4_against_plain(f"{label} heads=64", flash_inputs(gen, label, tq, tk, torch.bfloat16), 64)

    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for label, tq, tk in FLASH_SHAPES + (K4_SPLIT_SHAPE,):
            args = flash_inputs(gen, label, tq, tk, dtype)
            path = k4_kernel(dtype, C // HEADS)
            n_split = fl.kernel_key_split(dtype, C // HEADS, REL_B, HEADS, tq, tk)[0]
            check(path == ("tensor-core" if dtype == torch.bfloat16 else "f32")
                  and (n_split > 1) == (label in K4_SPLIT_LABELS),
                  f"K4 {label} {dtype}: takes the {path} kernel, keys in {n_split} shard(s)")
            err = k4_against_plain(label, args, HEADS)
            if dtype == torch.float32 and label in ("self L=1536", "cross Tq=1 Lk=1536"):
                device_kernels_only(lambda: fl.flash_graph_attention(*args, HEADS, "l1"),
                                    f"K4 {label} {dtype}",
                                    ("flash_graph_attention_f32_kernel", "merge_partials_kernel"),
                                    "csrc/flash_graph_attention.cu's f32 and merge kernels")
            ms = time_ms(lambda: fl.flash_graph_attention(*args, HEADS, "l1"))
            stats_ms = time_ms(lambda: fl.flash_graph_attention(*args, HEADS, "l1", "stats"))
            plain_ms = time_ms(lambda: fl.flash_graph_attention_plain(*args, HEADS, "l1"), iters=5)
            # reads q (Tq), k and v (Tk); writes out (Tq)
            size = torch.finfo(dtype).bits // 8
            nbytes = size * REL_B * C * (2 * tq + 2 * tk) + 4 * REL_B * (tq * tk + tq + tk)
            bound_ms, bound_by = bound(nbytes, 4.0 * REL_B * tq * tk * C, dtype)
            library_ms, library_err = sdpa_yardstick(args)
            print(f"K4 {label} {dtype}: {path} kernel, {n_split} key shard(s), {ms:.4f} ms"
                  f"{previous('K4', label, dtype)} (emit=stats {stats_ms:.4f}), plain "
                  f"{plain_ms:.4f} ms, SDPA with the graph as a boolean mask {library_ms:.4f} ms "
                  f"(max|K4 - SDPA| on rows with a neighbour {library_err:.3g}), bound "
                  f"{bound_ms * 1e3:.2f} us ({bound_by})", flush=True)
            rows.append(dict(label=label, dtype=dtype, err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms))
            del args
            torch.cuda.empty_cache()
    # 701 keys: the graph's rows are not 16-byte aligned, so the tensor-core
    # kernel copies its tiles 4 bytes at a time
    k4_against_plain("odd keys Tq=70 Tk=701",
                     flash_inputs(gen, "odd keys", 70, 701, torch.bfloat16), HEADS)
    def wide_row(g, label: str, c: int, heads: int, dtype, want: str, tq: int = REL_L,
                 b: int = FLASH_WIDE_B, split: "bool | None" = None) -> None:
        """A row at B ``b``, ``tq`` queries into 1,536 keys: the kernel
        ``want`` (and with ``split`` given, keys split or not), held
        through every emit and both renorms, timed beside its plain
        version, SDPA and its bound; kept in ``wide_rows``."""
        t = REL_L
        args = flash_inputs(g, "self L=1536" if tq == t else label, tq, t, dtype, c, b)
        path = fl.k4_path(dtype, c // heads)
        n_split = fl.kernel_key_split(dtype, c // heads, b, heads, tq, t)[0]
        if split is None:
            check(path == want, f"K4 {label} {dtype}: head width {c // heads} takes the "
                  f"{path} kernel")
        else:
            check(path == want and (n_split > 1) == split,
                  f"K4 {label} {dtype}: head width {c // heads} takes the {path} kernel, "
                  f"keys in {n_split} shard(s)")
        err = k4_against_plain(label, args, heads)
        ms = time_ms(lambda: fl.flash_graph_attention(*args, heads, "l1"), iters=5)
        plain_ms = time_ms(lambda: fl.flash_graph_attention_plain(*args, heads, "l1"),
                           iters=3)
        size = torch.finfo(dtype).bits // 8
        nbytes = size * b * c * 2 * (tq + t) + 4 * b * (tq * t + tq + t)
        bound_ms, bound_by = bound(nbytes, 4.0 * b * tq * t * c, dtype)
        library_ms, library_err = sdpa_yardstick(args, heads)
        recompute = ""
        if path == "wide":
            recompute = f", scores computed {fl.wide_chunks(c // heads)} times"
        elif path in ("tc-chunked", "f32-chunked"):
            block_rows = (fl.tc_rows(dtype, c // heads, tq) if path == "tc-chunked"
                          else fl.k4_f32_plan(c // heads, b, heads, tq, t)[0])
            recompute = (f", scores computed {fl.wide_chunks(c // heads)} times "
                         f"({'on the tensor cores' if path == 'tc-chunked' else 'FFMA'}), "
                         f"{block_rows} rows a block, {n_split} key shard(s)")
        elif path == "tensor-core":
            recompute = (f" (instance {fl.tc_width(c // heads)}, "
                         f"{fl.tc_rows(dtype, c // heads, tq)} rows a block, "
                         f"{n_split} key shard(s))")
        elif path == "f32":
            recompute = f" ({fl.f32_step(c // heads)}-key steps, {n_split} key shard(s))"
        print(f"K4 {label} {dtype}: {path} kernel{recompute}, {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, "
              f"SDPA with the graph as a boolean mask {library_ms:.4f} ms (max|K4 - SDPA| on "
              f"rows with a neighbour {library_err:.3g}), bound {bound_ms * 1e3:.2f} us "
              f"({bound_by})", flush=True)
        rows.append(dict(label=label, dtype=dtype, err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                         wide=True))

    for dtype in (torch.bfloat16, torch.float32):
        for label, c, heads in FLASH_WIDE_SHAPES:
            # head width 256: the tensor-core (bf16) and f32 kernels; 50 the SIMT kernel
            tiled = "tensor-core" if dtype == torch.bfloat16 else "f32"
            wide_row(gen, label, c, heads, dtype, "simt" if c // heads == 50 else tiled)
            torch.cuda.empty_cache()
        k4_against_plain("self L=600 C=99 heads=3",
                         flash_inputs(gen, "self L=600", 600, 600, dtype, 99, FLASH_WIDE_B), 3)
    beyond = beyond_gen()
    for dtype in (torch.bfloat16, torch.float32):
        for label, c, heads in FLASH_BEYOND_SHAPES:
            # head widths 320 and 512: the chunked tensor-core (bf16) and f32 kernels
            wide_row(beyond, label, c, heads, dtype,
                     "tc-chunked" if dtype == torch.bfloat16 else "f32-chunked")
            torch.cuda.empty_cache()
    head256 = head256_gen()
    label, tq, tk = K4_HEAD256_SHAPE
    for dtype in (torch.bfloat16, torch.float32):
        wide_row(head256, label, WIDE_C, WIDE_HEADS, dtype,
                 "tensor-core" if dtype == torch.bfloat16 else "f32", tq, REL_B)
        torch.cuda.empty_cache()
    more = k4_paths_gen()
    label, c, heads = K4_WIDE258_SHAPE
    for dtype in (torch.bfloat16, torch.float32):
        wide_row(more, label, c, heads, dtype, "wide", split=False)
        torch.cuda.empty_cache()
    for label, c, heads in K4_SPLIT_SHAPES:
        chunked = c // heads > 256
        for dtype in (torch.bfloat16, torch.float32) if chunked else (torch.bfloat16,):
            want = ("tc-chunked" if dtype == torch.bfloat16 else "f32-chunked") if chunked \
                else "tensor-core"
            wide_row(more, label, c, heads, dtype, want, K4_SPLIT_TQ, split=True)
            torch.cuda.empty_cache()
    return {r["label"] + str(r["dtype"]): r for r in rows}


def sdpa_yardstick(args, heads: int = HEADS, ours=None) -> tuple:
    """One library call beside K4 (or ``ours()``, another kernel's
    attention without a LayerNorm: K1's attention-only entry), timed and
    used nowhere in the port: ``scaled_dot_product_attention`` with
    ``graph > 0 and key unmasked`` as a boolean mask. For a 0/1 graph it is
    the l1 output on every row that has an unmasked neighbour (the renorm
    of softmax x graph is the softmax over the neighbours); on other rows
    it gives NaN where the kernels give 0 or the fill-value average.
    Returns (ms, max |kernel - SDPA| over the rows both define)."""
    import torch.nn.functional as F

    from structured_alignment_vqa_tpu_torch.ops import flash_graph_attention as fl

    q, k, v, key_mask, query_mask, graph = args
    b, tq, c = q.shape
    dh = c // heads
    qh, kh, vh = (t.reshape(b, t.shape[1], heads, dh).transpose(1, 2) for t in (q, k, v))
    mask = ((graph > 0) & (key_mask[:, None, :] > 0))[:, None]
    call = lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    ms = time_ms(call)
    lib = call().transpose(1, 2).reshape(b, tq, c).float()
    ours = (ours or (lambda: fl.flash_graph_attention(*args, heads, "l1")))().float()
    rows = mask[:, 0].any(dim=-1) & (query_mask > 0)
    err = (lib - ours)[rows].abs().max().item() if bool(rows.any()) else 0.0
    return ms, err


def k56_against_plain(label: str, args, dy, heads: int) -> tuple:
    """K5 and K6 against their plain versions over both renorms, and in f32
    against torch.autograd of the eager ``attention_core``: the largest
    relative and absolute error of each, and the l1 arguments of the
    backward for timing."""
    from structured_alignment_vqa_tpu_torch.ops import attention
    from structured_alignment_vqa_tpu_torch.ops import flash_graph_attention as fl

    q, k, v, key_mask, query_mask, graph = args
    dtype = q.dtype
    errs = {"K5": 0.0, "K6": 0.0}
    abs_errs = {"K5": 0.0, "K6": 0.0}
    for renorm in ("sum_eps", "l1"):      # l1 last: the timings use its inputs
        out, m, z, bsum = fl.flash_graph_attention(*args, heads, renorm, "stats")
        d_out, delta = fl.masked_grad_and_delta(out, dy, query_mask, heads)
        bwd = (q, k, v, key_mask, graph, m, z, bsum, delta, d_out, heads, renorm)
        got = (fl.flash_bwd_dq(*bwd), *fl.flash_bwd_dkv(*bwd))
        want = (fl.flash_bwd_dq_plain(*bwd), *fl.flash_bwd_dkv_plain(*bwd))
        torch.cuda.synchronize()
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            e = rel_err(g, w)
            key = "K5" if name == "dq" else "K6"
            errs[key] = max(errs[key], e)
            abs_errs[key] = max(abs_errs[key], (g.float() - w.float()).abs().max().item())
            check(e <= K2_TOL[dtype] and bool(torch.isfinite(g.float()).all()),
                  f"{key} {label} {dtype} {renorm} {name}: max|kernel-plain|/max|plain| "
                  f"{e:.3g} <= {K2_TOL[dtype]:g}")
        del want
        if dtype == torch.float32:
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            ref, _ = attention.attention_core(*leaves, key_mask, query_mask, heads, graph=graph,
                                              renorm=renorm)
            auto = torch.autograd.grad(ref, leaves, dy)
            e = max(rel_err(g, a) for g, a in zip(got, auto))
            check(e <= K2_AUTOGRAD_TOL,
                  f"K5/K6 {label} f32 {renorm}: max|kernel-autograd|/max|autograd| "
                  f"{e:.3g} <= {K2_AUTOGRAD_TOL:g}")
            del leaves, ref, auto
    return errs, abs_errs, bwd


def k56_phase(gen) -> dict:
    from structured_alignment_vqa_tpu_torch.ops import flash_graph_attention as fl

    # a head width of 8 (64 heads) is no multiple of 16: bf16 takes the SIMT kernels
    label, tq, tk = FLASH_SHAPES[3]
    path = fl.kernel_path(torch.bfloat16, C // 64)
    check(path == "simt", f"K5/K6 {label} heads=64 bf16: head width {C // 64} takes the {path} "
          "kernels")
    args = flash_inputs(gen, label, tq, tk, torch.bfloat16)
    dy = torch.randn(REL_B, tq, C, generator=gen, device="cuda").to(torch.bfloat16)
    k56_against_plain(f"{label} heads=64", args, dy, 64)

    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        shapes = tuple((label, tq, tk, HEADS) for label, tq, tk in FLASH_SHAPES)
        for label, tq, tk, heads in shapes + (K56_F32_SHAPES if dtype == torch.float32 else ()):
            args = flash_inputs(gen, label.split(" 4 heads")[0], tq, tk, dtype)
            width = C * heads // HEADS   # a model rank's columns on 4 heads
            args = tuple(t[..., :width].contiguous() for t in args[:3]) + args[3:]
            dy = torch.randn(REL_B, tq, width, generator=gen, device="cuda").to(dtype)
            path = fl.dq_kernel(dtype, C // HEADS)
            dkv_path = fl.dkv_kernel(dtype, C // HEADS)
            n_split = fl.dq_key_split(dtype, C // HEADS, REL_B, heads, tq, tk)[0]
            plan_split = (fl.dq_f32_plan(REL_B, heads, tq, tk)[1] if dtype == torch.float32
                          else fl.key_split(REL_B, heads, tq, tk)[0])
            kind = "tensor-core" if dtype == torch.bfloat16 else "f32"
            check(path == kind and dkv_path == kind and n_split == plan_split
                  and (n_split > 1) == (label in K4_SPLIT_LABELS),
                  f"K5/K6 {label} {dtype}: K5 takes the {path} kernel, its keys in {n_split} "
                  f"shard(s), K6 the {dkv_path} kernel")
            errs, abs_errs, bwd = k56_against_plain(label, args, dy, heads)
            if dtype == torch.float32 and n_split == 1:
                k5_f32_bits(label, args, dy, heads)
            if dtype == torch.float32 and label == "self L=1536":
                device_kernels_only(lambda: fl.flash_bwd_dkv(*bwd), f"K6 {label} {dtype}",
                                    ("flash_graph_attention_bwd_dkv_f32_kernel",),
                                    "csrc/flash_graph_attention_bwd.cu's K6 f32 kernel")
                device_kernels_only(lambda: fl.flash_bwd_dq(*bwd), f"K5 {label} {dtype}",
                                    ("flash_graph_attention_bwd_dq_f32_kernel",),
                                    "csrc/flash_graph_attention_bwd.cu's K5 f32 kernel")
            if dtype == torch.float32 and label == "cross Tq=1 Lk=1536":
                device_kernels_only(lambda: fl.flash_bwd_dq(*bwd), f"K5 {label} {dtype}",
                                    ("flash_graph_attention_bwd_dq_f32_kernel",
                                     "flash_graph_attention_bwd_dq_sum_kernel"),
                                    "csrc/flash_graph_attention_bwd.cu's K5 f32 and shard-sum "
                                    "kernels")
            size = torch.finfo(dtype).bits // 8
            stats_bytes = 4 * REL_B * (tq * tk + tk + 4 * heads * tq)
            for key, fn, plain, n_products, nbytes in (
                # K5 reads q, dO (Tq), k, v (Tk), writes dq (Tq); three products
                ("K5", fl.flash_bwd_dq, fl.flash_bwd_dq_plain, 3,
                 size * REL_B * width * (3 * tq + 2 * tk) + stats_bytes),
                # K6 reads the same, writes dk and dv (Tk); four products
                ("K6", fl.flash_bwd_dkv, fl.flash_bwd_dkv_plain, 4,
                 size * REL_B * width * (2 * tq + 4 * tk) + stats_bytes),
            ):
                ms = time_ms(lambda: fn(*bwd))
                plain_ms = time_ms(lambda: plain(*bwd), iters=5)
                bound_ms, bound_by = bound(nbytes, 2.0 * n_products * REL_B * tq * tk * width,
                                           dtype)
                shards = f", {n_split} key shard(s)" if key == "K5" else ""
                print(f"{key} {label} {dtype}: {path if key == 'K5' else dkv_path} "
                      f"kernel{shards}, {ms:.4f} ms"
                      f"{previous(key, label, dtype)}, plain {plain_ms:.4f} ms, bound "
                      f"{bound_ms * 1e3:.2f} us ({bound_by})", flush=True)
                rows.append(dict(kernel=key, label=label, dtype=dtype, err=abs_errs[key],
                                 rel_err=errs[key], ms=ms,
                                 plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by))
            del args, bwd
            torch.cuda.empty_cache()
    # 701 keys: the graph's rows are not 16-byte aligned, so the tensor-core
    # kernels copy their graph tiles 4 bytes at a time
    args = flash_inputs(gen, "odd keys", 70, 701, torch.bfloat16)
    dy = torch.randn(REL_B, 70, C, generator=gen, device="cuda").to(torch.bfloat16)
    k56_against_plain("odd keys Tq=70 Tk=701", args, dy, HEADS)
    def wide_row(g, label: str, c: int, heads: int, dtype, want: str, b: int = FLASH_WIDE_B,
                 tq: int = REL_L) -> None:
        t = REL_L
        args = flash_inputs(g, "self L=1536" if tq == t else "cross", tq, t, dtype, c, b)
        dy = torch.randn(b, tq, c, generator=g, device="cuda").to(dtype)
        paths = (fl.dq_kernel(dtype, c // heads), fl.dkv_kernel(dtype, c // heads))
        check(paths == (want, want), f"K5/K6 {label} {dtype}: head width {c // heads} "
              f"takes the {paths[0]} kernels")
        fl.flash_bwd_dq.paths.clear()
        fl.flash_bwd_dkv.paths.clear()
        errs, abs_errs, bwd = k56_against_plain(label, args, dy, heads)
        taken = (dict(fl.flash_bwd_dq.paths), dict(fl.flash_bwd_dkv.paths))
        check(taken == ({want: 2}, {want: 2}), f"K5/K6 {label} {dtype}: launches by the kernel "
              f"their C entries report {taken} (want 2 each on the {want} kernel)")
        size = torch.finfo(dtype).bits // 8
        stats_bytes = 4 * b * (tq * t + t + 4 * heads * tq)
        for key, fn, plain, n_products, nbytes in (
            ("K5", fl.flash_bwd_dq, fl.flash_bwd_dq_plain, 3,
             size * b * c * (3 * tq + 2 * t) + stats_bytes),
            ("K6", fl.flash_bwd_dkv, fl.flash_bwd_dkv_plain, 4,
             size * b * c * (2 * tq + 4 * t) + stats_bytes),
        ):
            ms = time_ms(lambda: fn(*bwd), iters=5)
            plain_ms = time_ms(lambda: plain(*bwd), iters=3)
            bound_ms, bound_by = bound(nbytes, 2.0 * n_products * b * tq * t * c, dtype)
            if want == "wide":
                how = (f"wide kernel (scores and dN computed {fl.wide_chunks(c // heads)} "
                       f"times)")
            elif want == "simt":
                how = (f"simt kernel ({fl.simt_rows(c // heads)} query rows a "
                       f"{'block' if key == 'K5' else 'step'})")
            else:
                how = f"{want} kernel, instance {'256' if c // heads > 128 else '<= 128'}"
            if key == "K5":
                how += f", {fl.dq_key_split(dtype, c // heads, b, heads, tq, t)[0]} key shard(s)"
            print(f"{key} {label} {dtype}: {how}, {ms:.4f} ms{previous(key, label, dtype)}, "
                  f"plain {plain_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us ({bound_by})",
                  flush=True)
            rows.append(dict(kernel=key, label=label, dtype=dtype, err=abs_errs[key],
                             rel_err=errs[key], ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, wide=True))

    for dtype in (torch.bfloat16, torch.float32):
        for label, c, heads in FLASH_WIDE_SHAPES:
            wide_row(gen, label, c, heads, dtype, fl.k56_path(dtype, c // heads))
            torch.cuda.empty_cache()
        args = flash_inputs(gen, "self L=600", 600, 600, dtype, 99, FLASH_WIDE_B)
        dy = torch.randn(FLASH_WIDE_B, 600, 99, generator=gen, device="cuda").to(dtype)
        k56_against_plain("self L=600 C=99 heads=3", args, dy, 3)
    beyond = beyond_gen()
    for dtype in (torch.bfloat16, torch.float32):
        for label, c, heads in FLASH_BEYOND_SHAPES:
            wide_row(beyond, label, c, heads, dtype, "wide")
            torch.cuda.empty_cache()
    # instance 256 beyond the widths rows: the split one-query call, the
    # padded widths; then the wide kernels just past 256 (no multiple of 16
    # or 4 there, and above the instance)
    more = k56_head256_gen()
    kind = {torch.bfloat16: "tensor-core", torch.float32: "f32"}
    for dtype in (torch.bfloat16, torch.float32):
        label, c, heads = K56_HEAD256_CROSS
        wide_row(more, label, c, heads, dtype, kind[dtype], b=REL_B, tq=1)
        label, c, heads = K56_PADDED_SHAPES[dtype]
        wide_row(more, label, c, heads, dtype, kind[dtype])
        label, c, heads = K4_WIDE258_SHAPE
        wide_row(more, label, c, heads, dtype, "wide")
        torch.cuda.empty_cache()
    return {r["kernel"] + r["label"] + str(r["dtype"]): r for r in rows}


@contextlib.contextmanager
def plain_path():
    """Replace each kernel wrapper, where the model calls it, by its plain
    PyTorch version: the same model then runs without a kernel on the same
    CUDA tensors, and autograd of the plain graph attentions takes the place
    of K2, K5 and K6 in the backward. The package has no such switch; only
    this comparison does."""
    from structured_alignment_vqa_tpu_torch.ops import attention, fused_ffn
    from structured_alignment_vqa_tpu_torch.ops.flash_graph_attention import (
        flash_graph_attention_plain,
    )
    from structured_alignment_vqa_tpu_torch.ops.fused_graph_attention import (
        graph_attention_ln_plain,
    )

    with mock.patch.object(attention, "fused_graph_attention_ln", graph_attention_ln_plain), \
            mock.patch.object(attention, "flash_graph_attention", flash_graph_attention_plain), \
            mock.patch.object(fused_ffn, "fused_ffn", fused_ffn.ffn_ln_plain):
        yield


def counted_wrappers() -> dict:
    """The wrapper that counts each kernel's launches."""
    from structured_alignment_vqa_tpu_torch.ops import flash_graph_attention as fl
    from structured_alignment_vqa_tpu_torch.ops import fused_ffn, fused_graph_attention as k1

    return {"K1": k1.fused_graph_attention_ln, "K2": k1.fused_graph_attention_ln_bwd,
            "K3": fused_ffn.fused_ffn, "K4": fl.flash_graph_attention, "K5": fl.flash_bwd_dq,
            "K6": fl.flash_bwd_dkv}


def launch_counts() -> dict:
    return {key: fn.launches for key, fn in counted_wrappers().items()}


def reset_launch_counts() -> None:
    for fn in counted_wrappers().values():
        fn.launches = 0
        for counter in ("paths", "parts"):
            if hasattr(fn, counter):
                getattr(fn, counter).clear()


def path_counts() -> dict:
    """K1's, K2's, K4's, K5's and K6's launches by the kernel or route each
    took (their wrappers' ``paths``, counted beside ``launches``; K4's, K5's
    and K6's as their C entries report it), and under "K2 parts" the K5
    and K6 kernels K2's composed and wide routes launched."""
    wrappers = counted_wrappers()
    counts = {key: dict(wrappers[key].paths) for key in ("K1", "K2", "K4", "K5", "K6")}
    counts["K2 parts"] = dict(wrappers["K2"].parts)
    return counts


def profile_device(fn, what: str, host_top: int = 0) -> dict:
    """Device time by kernel over one call of ``fn`` (torch.profiler), and
    the device's idle share of its wall time (with ``host_top``, also the
    ops that took the most host time themselves); returns {kernel name:
    (calls, us)}. Information only."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    if not kernels:
        print("profile: the profiler saw no device kernels; breakdown not measured")
        return {}
    by_name: dict = {}
    for e in kernels:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy = sum(us for _, us in by_name.values())
    markers = (("K2 graph_attention_ln_bwd", "graph_attention_ln_bwd_"),
               ("K1 graph_attention_ln", "graph_attention_ln_kernel"),
               ("K1 graph_attention_ln", "graph_attention_ln_tc_kernel"),
               ("K1 graph_attention_ln", "graph_attention_ln_epilogue_kernel"),
               ("K1 graph_attention_ln", "graph_attention_ln_f32_kernel"),
               ("K3 ffn_ln", "ffn_ln_"),
               ("K5 flash_graph_attention_bwd_dq", "flash_graph_attention_bwd_dq"),
               ("K6 flash_graph_attention_bwd_dkv", "flash_graph_attention_bwd_dkv"),
               ("K4 flash_graph_attention", "flash_graph_attention_kernel"),
               ("K4 flash_graph_attention", "flash_graph_attention_f32_kernel"),
               ("K4 flash_graph_attention", "flash_graph_attention_tc_kernel"),
               ("K4 flash_graph_attention", "merge_partials_kernel"))
    groups = {key: 0.0 for key, _ in markers}
    groups.update(gemm=0.0, other=0.0)
    def is_gemm(name: str) -> bool:   # cuBLAS's bf16 kernels on Hopper may be nvjet_*
        return any(mark in name.lower() for mark in LIBRARY_GEMM_MARKS)

    for name, (_, us) in by_name.items():
        key = next((key for key, mark in markers if mark in name),
                   "gemm" if is_gemm(name) else "other")
        groups[key] += us
    print(f"profile: {what}, wall {wall_us / 1e3:.3f} ms (profiler on), device busy "
          f"{busy / 1e3:.3f} ms, idle share {1 - busy / wall_us:.3f}, {len(kernels)} kernels")
    for key, us in groups.items():
        print(f"  {key}: {us / 1e3:.3f} ms ({us / busy:.3f} of device time)")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
        print(f"  {us / 1e3:9.3f} ms  x{n:<4d} {name[:110]}")
    if host_top:
        for e in sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:host_top]:
            print(f"  host {e.self_cpu_time_total / 1e3:9.3f} ms self x{e.count:<5d} {e.key[:100]}")
    return by_name


# ---- the decisions of the f32 pair checks (ROADMAP Queue 3) ---------------

# A check that pairs two f32 paths (ranks against one process, kernels
# against their plain versions, a packed slot against its sample alone)
# holds them near f32 rounding. A decision taken outside the kernels whose
# input lies within rounding of its threshold can fall the other way on one
# side and move a gradient or a logit by a whole term: the sign of a ReLU's
# input, and whether a row that ops/attention.py:content_mask reads sums to
# 0. So the path under test records its decisions, a join puts them into
# one process's layout, and the reference takes them: both sides then
# compute one function. Each decision the reference takes against its own
# must be a knife edge, its input within KNIFE_EDGE of its call's largest
# |input|, and at most KNIFE_EDGES of the run's decisions may be such: a
# fault that moves decisions is refused, not copied.
KNIFE_EDGE = 1e-5
KNIFE_EDGES = 1e-5
# the site of content_mask's decisions (a ReLU's site is its module's name)
CONTENT_MASK = "content_mask"
RELU = "ReLU"


def relu_sites(model) -> dict:
    """name -> (the layer before it, the ReLU) of every ``nn.ReLU`` of
    ``model``; each follows its Linear in a Sequential (``linear_relu``,
    the heads, the variants' MLPs). An FFN's ``conv1`` ReLU is not run as
    a module: see :func:`ffn_relus`."""
    before = {id(m): seq[i - 1] for seq in model.modules()
              if isinstance(seq, torch.nn.Sequential) for i, m in enumerate(seq) if i}
    return {name: (before.get(id(m)), m) for name, m in model.named_modules()
            if isinstance(m, torch.nn.ReLU)}


@contextlib.contextmanager
def ffn_relus(model, relu):
    """Route the FFNs' hidden ReLU, where it runs outside K3, through
    ``relu(site, x)``, the site the name of the FFN's ``conv1`` ReLU module:
    in the backward's recomputation (``ffn_ln_composite``,
    ``ffn_partial_composite``), whose mask sets the gradient, and in the
    plain version (``ffn_ln_plain``). K3's forward takes the decision
    inside the kernel, where only the output's value, continuous in the
    input, depends on it. An FFN is known by its ``conv1`` weight, which
    an f32 call passes as it is: ``F.linear`` of it names the site that
    the ``torch.relu`` after it takes."""
    from structured_alignment_vqa_tpu_torch.ops import fused_ffn
    from structured_alignment_vqa_tpu_torch.ops.layers import FeedForward

    sites = {m.conv1[0].weight.data_ptr(): f"{name}.conv1.1"
             for name, m in model.named_modules() if isinstance(m, FeedForward)}
    last = [None]

    class Functional:   # fused_ffn's F: linear notes the FFN of its weight
        def __getattr__(self, name):
            return getattr(torch.nn.functional, name)

        @staticmethod
        def linear(x, w, b=None):
            last[0] = sites.get(w.data_ptr())
            return torch.nn.functional.linear(x, w, b)

    class Torch:        # fused_ffn's torch: relu takes that FFN's site
        def __getattr__(self, name):
            return getattr(torch, name)

        @staticmethod
        def relu(x):
            site, last[0] = last[0], None
            return torch.relu(x) if site is None else relu(site, x)

    with mock.patch.object(fused_ffn, "F", Functional()), \
            mock.patch.object(fused_ffn, "torch", Torch()):
        yield


@contextlib.contextmanager
def recorded_decisions(model):
    """Record the decisions ``model`` takes while the block runs: every
    ReLU's (input > 0, a bool tensor a call) and every ``content_mask``
    call's (its rows' |sum| in float32; the decision is != 0). Yields
    ``{"calls": {site: [a call's record]}, "widths": {site: the width of
    the ReLU's input in one process}}``: on a model rank a column-split
    layer's ReLU sees this rank's columns only."""
    from structured_alignment_vqa_tpu_torch.ops import attention

    calls, widths, hooks = {}, {}, []
    for name, (before, relu) in relu_sites(model).items():
        widths[name] = getattr(before, "out_features", None)
        calls[name] = []
        hooks.append(relu.register_forward_hook(
            lambda _m, inputs, _out, mine=calls[name]: mine.append(inputs[0].detach() > 0)))
    calls[CONTENT_MASK] = []
    real = attention.content_mask

    def content_mask(x):
        calls[CONTENT_MASK].append(x.detach().float().sum(dim=-1).abs())
        return real(x)

    def ffn_relu(site, x):
        calls[site].append(x.detach() > 0)
        return torch.relu(x)

    try:
        with mock.patch.object(attention, "content_mask", content_mask), \
                ffn_relus(model, ffn_relu):
            yield {"calls": calls, "widths": widths}
    finally:
        for h in hooks:
            h.remove()


def decisions_to_cpu(records: dict) -> dict:
    return {"calls": {site: [c.cpu() for c in calls] for site, calls in records["calls"].items()},
            "widths": records["widths"]}


def join_model(parts: list) -> dict:
    """One process's decisions from a model row's (a record a rank, in
    model order): a column-split layer's columns concatenated; what every
    rank of the row computes whole (the rows content_mask reads, a gathered
    layer's ReLU) taken from rank 0."""
    widths = parts[0]["widths"]
    return {"calls": {site: [
        torch.cat([p["calls"][site][i] for p in parts], -1)
        if site != CONTENT_MASK and call.shape[-1] != widths[site] else call
        for i, call in enumerate(calls)] for site, calls in parts[0]["calls"].items()}}


def join_rows(parts: list) -> dict:
    """One process's decisions from a data row's (a record a rank, in rank
    order), each rank's batch rows the rank-major slice ``batch_rows`` cuts:
    every call's records concatenated along the batch."""
    return {"calls": {site: [torch.cat([p["calls"][site][i] for p in parts], 0)
                             for i in range(len(calls))]
                      for site, calls in parts[0]["calls"].items()}}


def join_replicated(parts: list) -> tuple:
    """(rank 0's decisions, whether every rank's equal them) of a seq row:
    ring and Ulysses take the whole (B, L, C) tensors on every rank of the
    row and return the whole output on each, so every decision outside the
    kernels is taken on whole tensors, alike on every rank."""
    first = parts[0]["calls"]
    same = all(len(p["calls"][site]) == len(calls)
               and all(torch.equal(a, b) for a, b in zip(p["calls"][site], calls))
               for p in parts[1:] for site, calls in first.items())
    return {"calls": first}, same


class Pins:
    """Decisions recorded on the path under test and joined into one
    process's layout (``{"calls": {site: [a call's record]}}``; a record
    may be a pair (record, defined) where only part of the call has a
    counterpart, the rest taking its own), for a reference run to take
    (:func:`pinned_decisions`); and what that run took: its decisions by
    kind, each call where some differed from its own (kind, site, call, how
    many, their largest |input|, that over the call's largest |input|), and
    any call whose count or shape did not match."""

    def __init__(self, records: dict):
        self.calls = records["calls"]
        self.taken = dict.fromkeys(self.calls, 0)
        self.decisions = {RELU: 0, CONTENT_MASK: 0}
        self.flips = []
        self.mismatches = []

    def differ(self, kind: str) -> int:
        return sum(f[3] for f in self.flips if f[0] == kind)

    @property
    def pinned(self) -> int:
        return sum(f[3] for f in self.flips)

    @property
    def worst(self) -> float:
        return max((f[5] for f in self.flips), default=0.0)

    @property
    def largest(self) -> float:
        return max((f[4] for f in self.flips), default=0.0)

    def knife_edges_only(self) -> bool:
        """Every call matched; every decision taken against the run's own
        within rounding of its threshold, and few of all the run took."""
        return (not self.mismatches and self.worst <= KNIFE_EDGE
                and self.pinned <= KNIFE_EDGES * sum(self.decisions.values()))

    def finish(self) -> None:
        """Count a site whose recorded calls the run did not all take (once,
        after the run)."""
        for site, calls in self.calls.items():
            if self.taken.get(site, 0) != len(calls):
                self.mismatches.append(f"{site}: {len(calls)} calls recorded, "
                                       f"{self.taken.get(site, 0)} taken")

    def _next(self, site: str, shape):
        calls = self.calls.get(site, ())
        if not calls:   # the path under test took these inside a kernel
            return None
        i = self.taken[site]
        self.taken[site] = i + 1
        if i >= len(calls):
            return None
        rec, defined = calls[i] if isinstance(calls[i], tuple) else (calls[i], None)
        if tuple(rec.shape) != tuple(shape):
            self.mismatches.append(f"{site} call {i}: recorded {tuple(rec.shape)}, "
                                   f"run {tuple(shape)}")
            return None
        return i, rec, defined

    def _count(self, kind, site, i, flip, magnitude, scale, defined) -> None:
        self.decisions[kind] += flip.numel() if defined is None else int(
            defined.expand_as(flip).sum())
        if bool(flip.any()):
            edge = magnitude[flip].max().item()
            self.flips.append((kind, site, i, int(flip.sum()), edge,
                               edge / max(scale.max().item(), 1e-30)))

    def relu(self, site: str, x: torch.Tensor) -> torch.Tensor:
        """The decisions a ReLU of input ``x`` takes: the recorded ones."""
        own = x > 0
        got = self._next(site, x.shape)
        if got is None:
            return own
        i, keep, defined = got
        keep = keep.to(x.device)
        if defined is not None:
            defined = defined.to(x.device)
            keep = torch.where(defined, keep, own)
        size = x.detach().abs()
        self._count(RELU, site, i, keep != own, size, size, defined)
        return keep

    def content_mask(self, x: torch.Tensor) -> torch.Tensor:
        """The rows of ``x`` content_mask keeps: the recorded ones. The mask,
        not only a derivative, is taken, so a row kept on one side only must
        sum to within rounding of 0 on both: its |input| is the larger of
        the two sides' |sum|."""
        size = x.detach().float().sum(dim=-1).abs()
        got = self._next(CONTENT_MASK, size.shape)
        if got is None:
            return size != 0
        i, rec, defined = got
        rec = rec.to(size.device)
        if defined is not None:
            defined = defined.to(size.device)
            rec = torch.where(defined, rec, size)
        keep = rec != 0
        self._count(CONTENT_MASK, CONTENT_MASK, i, keep != (size != 0),
                    torch.maximum(size, rec), size, defined)
        return keep


@contextlib.contextmanager
def pinned_decisions(model, pins: Pins):
    """Make ``model``, while the block runs, take the decisions ``pins``
    holds, call by call: a ReLU's output is its input where the recorded
    decision is set, else 0, and so is its gradient; content_mask keeps
    the recorded rows. ``pins`` counts the decisions that differ from the
    model's own and how far their inputs lie from the threshold."""
    from structured_alignment_vqa_tpu_torch.ops import attention

    def relu(name, x):
        return torch.where(pins.relu(name, x), x, torch.zeros((), dtype=x.dtype, device=x.device))

    hooks = [m.register_forward_hook(lambda _m, inputs, _out, name=name: relu(name, inputs[0]))
             for name, (_, m) in relu_sites(model).items()]
    try:
        with mock.patch.object(attention, "content_mask",
                               lambda x: pins.content_mask(x).float()), \
                ffn_relus(model, relu):
            yield pins
    finally:
        for h in hooks:
            h.remove()


@contextlib.contextmanager
def decisions_taken(model, pins: "Pins | None" = None, record: "dict | None" = None):
    """:func:`pinned_decisions` of ``pins``, or :func:`recorded_decisions`
    into ``record``, or neither."""
    if pins is not None:
        with pinned_decisions(model, pins):
            yield
    elif record is not None:
        with recorded_decisions(model) as decisions:
            yield
        record.update(decisions)
    else:
        yield


def pins_hold(what: str, pins: Pins) -> None:
    """Print each call where ``pins``' run took a decision against its own
    (site, call, count, the largest |input| and its share of the call's
    largest) and check the gate (:meth:`Pins.knife_edges_only`)."""
    pins.finish()
    for kind, site, call, count, edge, share in pins.flips:
        print(f"{what}: {site} call {call}: {count} {kind} decision(s) pinned, the largest "
              f"|x| {edge:.3g}, {share:.3g} of the call's max|x|", flush=True)
    for line in pins.mismatches:
        print(f"{what}: the runs' calls do not match: {line}", flush=True)
    check(pins.knife_edges_only(),
          f"{what} took the tested path's decisions: ReLU {pins.differ(RELU)} of "
          f"{pins.decisions[RELU]} differed, content_mask rows {pins.differ(CONTENT_MASK)} of "
          f"{pins.decisions[CONTENT_MASK]} (<= {KNIFE_EDGES:g} of all), "
          f"each input within {pins.worst:.3g} <= {KNIFE_EDGE:g} of its call's max|x|, "
          f"{len(pins.mismatches)} calls unmatched")


def pair_line(check_name: str, err: float, limit: float, pins: list, what: str = "") -> None:
    """One machine-readable line of an f32 pair check (read by
    scripts/pair_checks_reordered.py): its largest error beside its limit
    and the decisions its reference runs took against their own."""
    print("pair check: " + json.dumps(dict(
        check=check_name, err=err, limit=limit, what=what,
        pinned=sum(p.pinned for p in pins),
        decisions=sum(sum(p.decisions.values()) for p in pins),
        content_mask_pinned=sum(p.differ(CONTENT_MASK) for p in pins),
        largest_x=max((p.largest for p in pins), default=0.0),
        largest_share=max((p.worst for p in pins), default=0.0),
        gate=all(p.knife_edges_only() for p in pins))), flush=True)


def full_config(**kw):
    """The production obj-only point: ``ModelConfig`` defaults, 1,843
    classes, one shared 407,000 x 300 GloVe table, bf16 compute."""
    from structured_alignment_vqa_tpu_torch.models import ModelConfig

    base = dict(num_classes=1843, num_relations=310, only_obj=True,
                compute_dtype=torch.bfloat16, share_glove=True, dropout_rate=0.5)
    base.update(kw)
    return ModelConfig(**base)


def random_model(cfg, seed: int = 0):
    from structured_alignment_vqa_tpu_torch.models import AttModelX3, init_random_

    model = AttModelX3(cfg)
    init_random_(model, torch.Generator(device="cuda").manual_seed(seed))
    return model


def full_batches(cfg, n: int):
    from structured_alignment_vqa_tpu_torch.data.synthetic import synthetic_batch

    return [synthetic_batch(cfg, B, lv=36, lq=30, ls=98, seed=s) for s in range(n)]


def serving_phase(card: str) -> dict:
    from structured_alignment_vqa_tpu_torch.train.predict import make_predict_step

    cfg = full_config()
    model = random_model(cfg)
    batches = full_batches(cfg, REQUESTS)
    predict = make_predict_step(model)
    predict(batches[0])          # warm-up request: cuBLAS handles, allocator
    torch.cuda.synchronize()

    reset_launch_counts()
    t0 = time.perf_counter()
    answers = [predict(b) for b in batches]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    for key, per in (("K1", K1_PER_FORWARD), ("K3", K3_PER_FORWARD), ("K2", 0), ("K4", 0),
                     ("K5", 0), ("K6", 0)):
        check(launches[key] == per * REQUESTS,
              f"serving: {key} launched {launches[key]} times in {REQUESTS} forwards "
              f"(want {per} each)")
    ok = all(a.shape == (B,) and int(a.min()) >= 0 and int(a.max()) < cfg.num_classes
             for a in answers)
    check(ok, f"serving: {REQUESTS} x {B} answers in [0, {cfg.num_classes})")
    pairs_per_s = REQUESTS * B / seconds
    print(f"serving bf16 bs {B}: {REQUESTS} requests in {seconds:.4f} s = "
          f"{pairs_per_s:.1f} pairs/s on {card} (information only)", flush=True)

    profile_device(lambda: predict(batches[0]), f"one bs-{B} request")

    with torch.inference_mode():
        lc, lv, ls, mil_obj, _ = model(batches[0])
    check(all(torch.isfinite(t.float()).all().item() for t in (lc, lv, ls, mil_obj))
          and lc.shape == (B, cfg.num_classes),
          f"serving bf16: finite logits of shape ({B}, {cfg.num_classes})")

    # the same weights in f32: kernels against plain versions, both on the card
    model32 = random_model(cfg.replace(compute_dtype=torch.float32))
    model32.load_state_dict(model.state_dict())
    predict32 = make_predict_step(model32)
    # the plain path takes the kernel path's decisions (pinned_decisions)
    with torch.inference_mode():
        with recorded_decisions(model32) as decisions:
            kernel_logits = model32.eval()(batches[0])[:3]
        kernel_answers = predict32(batches[0])
        before = launch_counts()
        pins = [Pins(decisions), Pins(decisions)]
        with plain_path():
            with pinned_decisions(model32, pins[0]):
                plain_logits = model32(batches[0])[:3]
            with pinned_decisions(model32, pins[1]):
                plain_answers = predict32(batches[0])
            plain_bf16_answers = predict(batches[0])
        check(before == launch_counts(), "serving: the plain path launched no kernel")
    for taken in pins:
        pins_hold("serving f32: the plain path", taken)
    diff = max((a - b).abs().max().item() for a, b in zip(kernel_logits, plain_logits))
    finite = all(torch.isfinite(t).all().item() for t in kernel_logits)
    check(finite and diff <= LOGIT_TOL_F32,
          f"serving f32: max|logits kernel - plain| {diff:.3g} <= {LOGIT_TOL_F32:g}")
    pair_line("serving f32 logits", diff, LOGIT_TOL_F32, pins)
    same = (kernel_answers == plain_answers).float().mean().item()
    check(same == 1.0, f"serving f32: answers kernel == plain for {same:.4f} of {B}")
    agree_bf16 = (answers[0] == plain_answers).float().mean().item()
    agree_bf16_plain = (answers[0] == plain_bf16_answers).float().mean().item()
    print(f"serving bf16 kernel answers agree with f32 plain on {agree_bf16:.4f} and with "
          f"bf16 plain on {agree_bf16_plain:.4f} of {B} (information only)", flush=True)
    return launches


def snapshot(model, optimizer) -> list:
    """Copies of every parameter and every tensor of the optimizer's state."""
    state = optimizer.state_dict()
    tensors = [p.detach().clone() for p in model.parameters()]
    for per_param in state["state"].values():
        tensors += [t.clone() for t in per_param.values() if torch.is_tensor(t)]
    return tensors + [repr(state["param_groups"])]


def same_snapshot(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        torch.equal(x, y) if torch.is_tensor(x) else x == y for x, y in zip(a, b))


def one_step(cfg, batch, plain: bool = False, seed: int = 3, sparse: bool = False,
             pins: "Pins | None" = None, record: "dict | None" = None) -> tuple:
    """One training step from the weights of ``seed`` and a fixed dropout
    generator (with the sparse GloVe-table optimizer when ``sparse``, the
    decisions of ``pins`` when given, see :func:`pinned_decisions`; the
    decisions it takes recorded into ``record`` when given): (loss, {name:
    gradient}, launches by kernel)."""
    from structured_alignment_vqa_tpu_torch.parallel.train_step import (
        create_train_state,
        make_train_step,
    )

    model = random_model(cfg, seed=seed)
    state = create_train_state(model, 1e-4, sparse_table=sparse)
    step = make_train_step(model, state.optimizer, cfg, sparse_table=sparse)
    gen = torch.Generator(device="cuda").manual_seed(11)
    before = launch_counts()
    with plain_path() if plain else contextlib.nullcontext(), \
            decisions_taken(model, pins, record):
        metrics = step(state, batch, gen)
    torch.cuda.synchronize()
    moved = {k: launch_counts()[k] - before[k] for k in before}
    return metrics["loss"].item(), {n: p.grad for n, p in model.named_parameters()}, moved


def steady_step_memory(cfg, batch) -> tuple:
    """:func:`step_memory` of a fresh dense training step's state."""
    from structured_alignment_vqa_tpu_torch.parallel.train_step import (
        create_train_state,
        make_train_step,
    )

    model = random_model(cfg, seed=3)
    state = create_train_state(model, 1e-4)
    step = make_train_step(model, state.optimizer, cfg)
    gen = torch.Generator(device="cuda").manual_seed(11)
    step(state, batch, gen)
    return step_memory(state, step, batch, gen)


def step_memory(state, step, batch, gen) -> tuple:
    """Memory of a training step once Adam's moments exist (``state`` has
    taken a step): (bytes held between steps: the parameters and the
    moments, the sparse table's too; peak bytes the next step allocates on
    top of them: gradients and activations)."""
    state.optimizer.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    kept = sum(p.numel() * p.element_size() for p in state.model.parameters())
    kept += sum(t.numel() * t.element_size() for per_param in state.optimizer.state.values()
                for t in per_param.values() if torch.is_tensor(t))
    if state.table_opt is not None:
        kept += sum(t.numel() * t.element_size() for t in (state.table_opt.mu, state.table_opt.nu))
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    step(state, batch, gen)
    torch.cuda.synchronize()
    return kept, torch.cuda.max_memory_allocated() - held


def grad_errors(a: tuple, b: tuple, shift_free: bool = False) -> dict:
    """{name: (norm-relative, max-relative difference, finite)} of step
    ``a``'s gradients against step ``b``'s (``compare_steps``); under the
    key None the names with a gradient on one side only."""
    errs = {None: []}
    joint = sum(w.float().norm().item() ** 2 for w in b[1].values() if w is not None) ** 0.5
    for name, g in a[1].items():
        w = b[1][name]
        if g is None or w is None:
            if (g is None) != (w is None):
                errs[None].append(name)
            continue
        norm = joint if shift_free and re.search(SHIFT_FREE_PARAMS, name) else \
            w.float().norm().item()
        diff = (g - w).float().norm().item()
        errs[name] = (diff / norm if norm > 0 else diff, rel_err(g, w),
                      bool(torch.isfinite(g).all()))
    return errs


def compare_steps(what: str, a: tuple, b: tuple, loss_tol: float, grad_tol,
                  shift_free: bool = False) -> tuple:
    """The loss of step ``a`` relative to step ``b``'s, and each gradient by
    the norm of its difference over its own norm, within ``grad_tol``: one
    limit for every gradient, or a dict of limits by name. With ``shift_free`` the
    K projections' biases, whose true gradient is 0 (the softmax ignores a
    shift all keys share, so each side holds rounding noise alone), are
    held by the norm of their difference over the norm of all of ``b``'s
    gradients together. Returns the gradient nearest its limit: (its
    error, its limit, its name)."""
    err_loss = abs(a[0] - b[0]) / abs(b[0])
    check(err_loss <= loss_tol, f"{what}: loss {a[0]:.7g} against {b[0]:.7g}, "
          f"relative difference {err_loss:.3g} <= {loss_tol:g}")
    errs = grad_errors(a, b, shift_free)
    for name in errs.pop(None, []):
        check(False, f"{what}: {name} has a gradient on one path only")
    limit = grad_tol if isinstance(grad_tol, dict) else dict.fromkeys(errs, grad_tol)
    worst = max(errs, key=lambda n: errs[n][0] / limit[n])
    check(all(e[2] for e in errs.values()) and all(errs[n][0] <= limit[n] for n in errs),
          f"{what}: {len(errs)} finite gradients, nearest its limit |difference|/|gradient| "
          f"{errs[worst][0]:.3g} ({worst}) <= {limit[worst]:.3g}")
    for name in sorted(errs, key=lambda n: -errs[n][0])[:4]:
        print(f"  {name}: norm-relative {errs[name][0]:.3g}, max-relative {errs[name][1]:.3g}",
              flush=True)
    return errs[worst][0], limit[worst], worst


def f32_step_against_plain(cfg, batch, want: dict, what: str = "train f32") -> None:
    """One f32 training step at full width with the kernels and one with the
    plain versions, from the same weights and the same generator seed (so
    the same dropout masks): the loss and every parameter's gradient."""
    decisions = {}
    kernel = one_step(cfg, batch, record=decisions)
    check(kernel[2] == {**{k: 0 for k in kernel[2]}, **want},
          f"{what} kernel step: launches {kernel[2]} == {want}")
    pins = Pins(decisions)   # the plain path takes the kernel path's decisions
    plain = one_step(cfg, batch, plain=True, pins=pins)
    check(not any(plain[2].values()), f"{what} plain step: launched no kernel ({plain[2]})")
    pins_hold(f"{what}: the plain path", pins)
    err, limit, worst = compare_steps(f"{what}, kernels against plain versions", kernel, plain,
                                      LOSS_TOL_F32, GRAD_TOL_F32)
    pair_line(what, err, limit, [pins], worst)


def f32_step_profile(cfg, batches: list, bs: int, what: str, card: str,
                     host_top: int = 0) -> None:
    """The f32 training step, the training CLI's default compute: steps/s
    over ``batches`` after a warm-up step, and the device time by kernel and
    idle share of one step (information only; ``host_top``: as
    :func:`profile_device`)."""
    from structured_alignment_vqa_tpu_torch.parallel.train_step import (
        TrainState,
        adam,
        make_train_step,
    )

    model = random_model(cfg)
    opt = adam(model.parameters(), lr=1e-4)
    state = TrainState(model, opt)
    step = make_train_step(model, opt, cfg)
    gen = torch.Generator(device="cuda").manual_seed(7)
    step(state, batches[0], gen)           # warm-up step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        step(state, b, gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    print(f"{what} train f32 bs {bs}: {len(batches)} steps in {seconds:.4f} s = "
          f"{len(batches) / seconds:.3f} steps/s, {len(batches) * bs / seconds:.1f} samples/s "
          f"on {card} (information only)", flush=True)
    profile_device(lambda: step(state, batches[0], gen), f"one {what} f32 bs-{bs} training step",
                   host_top)
    del model, opt, state, step
    torch.cuda.empty_cache()


def training_phase(card: str) -> dict:
    from structured_alignment_vqa_tpu_torch.parallel.train_step import (
        TrainState,
        adam,
        make_train_step,
    )

    cfg = full_config()
    model = random_model(cfg)
    opt = adam(model.parameters(), lr=1e-4)
    state = TrainState(model, opt)
    step = make_train_step(model, opt, cfg)
    batches = full_batches(cfg, TRAIN_STEPS)
    gen = torch.Generator(device="cuda").manual_seed(7)
    step(state, batches[0], gen)           # warm-up step: cuBLAS handles, allocator
    torch.cuda.synchronize()
    before = [p.detach().clone() for p in model.parameters()]

    reset_launch_counts()
    t0 = time.perf_counter()
    metrics = [step(state, b, gen) for b in batches]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    for key, per in (("K1", K1_PER_FORWARD), ("K2", K2_PER_STEP), ("K3", K3_PER_FORWARD),
                     ("K4", 0), ("K5", 0), ("K6", 0)):
        check(launches[key] == per * TRAIN_STEPS,
              f"train: {key} launched {launches[key]} times in {TRAIN_STEPS} steps "
              f"(want {per} each)")
    losses = [m["loss"].item() for m in metrics]
    skipped = sum(m["skipped"].item() for m in metrics)
    check(all(torch.isfinite(torch.tensor(losses))) and skipped == 0,
          f"train bf16: losses {['%.5f' % x for x in losses]} finite, {skipped:g} skipped")
    still = sorted(n for (n, p), a in zip(model.named_parameters(), before) if torch.equal(a, p))
    no_grad = sorted(n for n, p in model.named_parameters() if p.grad is None)
    check(still == no_grad and all(re.search(NO_GRAD_PARAMS, n) for n in still),
          f"train bf16: every parameter with a gradient moved; the {len(still)} without one "
          f"are the detached MIL_NCE.marco_mlp and the decoder's unused 1-token Q/K projections")
    del before
    print(f"train bf16 bs {B}: {TRAIN_STEPS} steps in {seconds:.4f} s = "
          f"{TRAIN_STEPS / seconds:.3f} steps/s, {TRAIN_STEPS * B / seconds:.1f} samples/s "
          f"on {card} (information only)", flush=True)
    profile_device(lambda: step(state, batches[0], gen), f"one bs-{B} training step")
    del model, opt, state, step
    torch.cuda.empty_cache()

    cfg32 = full_config(compute_dtype=torch.float32)
    f32_step_against_plain(cfg32, full_batches(cfg32, 1)[0],
                           {"K1": K1_PER_FORWARD, "K2": K2_PER_STEP, "K3": K3_PER_FORWARD})
    torch.cuda.empty_cache()
    f32_step_profile(cfg32, full_batches(cfg32, TRAIN_STEPS), B, "obj-only", card)

    # overfit one batch without dropout; then a poisoned batch is skipped
    cfg0 = full_config(dropout_rate=0.0)
    model = random_model(cfg0, seed=5)
    opt = adam(model.parameters(), lr=1e-4)
    state = TrainState(model, opt)
    step = make_train_step(model, opt, cfg0)
    batch = full_batches(cfg0, 1)[0]
    fit = [step(state, batch, None)["loss"].item() for _ in range(OVERFIT_STEPS)]
    check(fit[-1] < fit[0], f"train overfit bf16, {OVERFIT_STEPS} steps, no dropout: loss "
          f"{fit[0]:.5f} -> {fit[-1]:.5f} falls")
    vis = batch.vis_fea.clone()
    vis[0, 0, 0] = float("nan")
    poisoned = dataclasses.replace(batch, vis_fea=vis)
    kept = snapshot(model, opt)
    m = step(state, poisoned, None)
    torch.cuda.synchronize()
    check(m["skipped"].item() == 1.0 and same_snapshot(kept, snapshot(model, opt)),
          f"train: a NaN feature gives skipped {m['skipped'].item():g} and leaves the params "
          "and the Adam state bitwise unchanged")
    return launches


def widths_phase(card: str) -> dict:
    """The obj-only model at hidden 768 with 12 heads (head width 64), at
    hidden 4,096 with 32 heads (head width 128; K1's and K2's LayerNorm and
    K3 at C 4,096 with hidden width 16,384, above the old domain) and at
    hidden 2,048 with 8 heads (head width 256: K1's tensor-core kernel, K3
    at hidden width 8,192, K2's composed route; a bf16 step too),
    ``full_config`` otherwise (hidden_size_mil 1,024, 6 blocks, maxlen 450,
    the 407,000 x 300 table, seeded weights): :func:`widths_point` at each;
    then the obj+rel model at hidden 2,048 with 8 heads
    (:func:`widths_rel_point`: K4's tensor-core kernel, K5 and K6 at head
    width 256, serving and training). Returns the hidden-4,096 request's
    launches."""
    widths_point(card, WIDTHS_HIDDEN, WIDTHS_HEADS)
    gc.collect()
    torch.cuda.empty_cache()
    launches = widths_point(card, WIDTHS_4K_HIDDEN, WIDTHS_4K_HEADS,
                            train_blocks=WIDTHS_4K_TRAIN_BLOCKS)
    gc.collect()
    torch.cuda.empty_cache()
    widths_point(card, WIDTHS_2K_HIDDEN, WIDTHS_2K_HEADS, bf16_step=True)
    gc.collect()
    torch.cuda.empty_cache()
    widths_rel_point(card, WIDTHS_2K_HIDDEN, WIDTHS_2K_HEADS)
    return launches


def widths_point(card: str, hidden: int, heads: int, train_blocks: int = 0,
                 bf16_step: bool = False) -> dict:
    """One bf16 request at bs 128 whose launches must be the 512-wide
    request's (24 K1, 24 K3: no FFN or attention left the kernels; every K1
    on its tensor-core kernel), the same weights' f32 logits against the
    plain path, and one f32 training step at bs 32 (at ``train_blocks``
    blocks, stages 1 and 2, where given) against the plain path, each at
    the limits of the serving and training phases, every K2 of the step on
    its f32 kernels or its composed route (whose K5 and K6 take their f32
    kernels); with ``bf16_step`` one bf16 step at bs 32 as well
    (:func:`bf16_step_checks`); the request's pairs/s and a step's steps/s
    as information. Where the step is cut to fewer blocks the f32 model is
    built after the bf16 one is freed, from the same seed (the same f32
    weights: the parameters are f32 at either compute dtype), and checked
    to hold them."""
    from structured_alignment_vqa_tpu_torch.data.synthetic import synthetic_batch
    from structured_alignment_vqa_tpu_torch.parallel.train_step import (
        TrainState,
        adam,
        make_train_step,
    )
    from structured_alignment_vqa_tpu_torch.train.predict import make_predict_step

    what = f"widths hidden {hidden} heads {heads}"
    cfg = full_config(hidden_size=hidden, num_heads=heads)
    model = random_model(cfg)
    batches = full_batches(cfg, 2)
    predict = make_predict_step(model)
    predict(batches[0])          # warm-up request
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    answers = predict(batches[1])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    for key, per in (("K1", K1_PER_FORWARD), ("K3", K3_PER_FORWARD), ("K2", 0), ("K4", 0),
                     ("K5", 0), ("K6", 0)):
        check(launches[key] == per, f"{what}: {key} launched {launches[key]} times in one bf16 "
              f"bs-{B} request (want {per}, as at hidden {C})")
    paths = path_counts()["K1"]
    check(paths == {"tensor-core": K1_PER_FORWARD},
          f"{what}: K1's launches by kernel {paths} (want all {K1_PER_FORWARD} on the "
          "tensor-core kernel)")
    check(answers.shape == (B,) and int(answers.min()) >= 0
          and int(answers.max()) < cfg.num_classes,
          f"{what}: {B} answers in [0, {cfg.num_classes})")
    print(f"{what} serving bf16 bs {B}: one request in {seconds:.4f} s = {B / seconds:.1f} "
          f"pairs/s on {card} (information only)", flush=True)

    if train_blocks:
        held = [p.detach().flatten()[:64].clone() for p in model.parameters()]
        del model, predict
        gc.collect()
        torch.cuda.empty_cache()
        model32 = random_model(cfg.replace(compute_dtype=torch.float32))
        same = all(torch.equal(p.detach().flatten()[:64], h)
                   for p, h in zip(model32.parameters(), held))
        check(same and len(held) == len(list(model32.parameters())),
              f"{what}: the f32 model built from the same seed holds the bf16 model's weights")
        del held
    else:
        model32 = random_model(cfg.replace(compute_dtype=torch.float32))
        model32.load_state_dict(model.state_dict())
        del model, predict
    with torch.inference_mode():
        with recorded_decisions(model32) as decisions:
            kernel_logits = model32.eval()(batches[1])[:3]
        before = launch_counts()
        pins = Pins(decisions)
        with plain_path(), pinned_decisions(model32, pins):
            plain_logits = model32(batches[1])[:3]
        check(before == launch_counts(), f"{what}: the plain path launched no kernel")
    pins_hold(f"{what} serving f32: the plain path", pins)
    diff = max((a - b).abs().max().item() for a, b in zip(kernel_logits, plain_logits))
    finite = all(torch.isfinite(t).all().item() for t in kernel_logits)
    check(finite and diff <= LOGIT_TOL_F32,
          f"{what} serving f32: max|logits kernel - plain| {diff:.3g} <= {LOGIT_TOL_F32:g}")
    pair_line(f"{what} serving f32 logits", diff, LOGIT_TOL_F32, [pins])
    del model32, kernel_logits, plain_logits, decisions, pins
    gc.collect()
    torch.cuda.empty_cache()

    cfg32 = cfg.replace(compute_dtype=torch.float32)
    per_block = K1_PER_FORWARD // cfg.num_blocks   # 2 encoders' and 2 decoders' calls a block
    tag = f"train f32 bs {WIDTHS_TRAIN_B}"
    if train_blocks:
        cfg32 = cfg32.replace(num_blocks=train_blocks, stage1_blocks=1, stage2_blocks=2)
        tag += f" at {train_blocks} blocks"
    batch = synthetic_batch(cfg32, WIDTHS_TRAIN_B, lv=36, lq=30, ls=98, seed=0)
    n = per_block * cfg32.num_blocks
    reset_launch_counts()
    f32_step_against_plain(cfg32, batch, {"K1": n, "K2": n, "K3": n}, f"{what} {tag}")
    k2_paths_tiled(f"{what} {tag}", {"K2": n}, torch.float32)
    gc.collect()
    torch.cuda.empty_cache()
    model = random_model(cfg32)
    opt = adam(model.parameters(), lr=1e-4)
    state = TrainState(model, opt)
    step = make_train_step(model, opt, cfg32)
    gen = torch.Generator(device="cuda").manual_seed(7)
    step(state, batch, gen)           # warm-up step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(state, batch, gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    print(f"{what} {tag}: one step in {seconds:.4f} s = "
          f"{1 / seconds:.3f} steps/s on {card} (information only)", flush=True)
    del model, opt, state, step
    torch.cuda.empty_cache()
    if bf16_step:
        gc.collect()
        bf16_step_checks(card, cfg, synthetic_batch(cfg, WIDTHS_TRAIN_B, lv=36, lq=30, ls=98,
                                                    seed=0),
                         {**dict.fromkeys(("K4", "K5", "K6"), 0), "K1": K1_PER_FORWARD,
                          "K2": K2_PER_STEP, "K3": K3_PER_FORWARD}, what, WIDTHS_TRAIN_B)
    return launches


def k2_paths_tiled(what: str, want: dict, dtype) -> None:
    """Every K2, K5 and K6 launch since the counts were last reset on a
    tiled kernel, by the kernels the C entries report: K2 (``want["K2"]``
    launches) on its tensor-core or f32 kernels or its composed route, and
    every K5 and K6 of that route, and each direct K5 and K6 launch
    (``want`` "K5", "K6"), on the tensor-core (bf16) or f32 kernels; none
    on the SIMT or wide kernels."""
    paths = path_counts()
    kind = "tensor-core" if dtype == torch.bfloat16 else "f32"
    k2 = paths["K2"]
    composed = k2.get("composed", 0)
    check(sum(k2.values()) == want["K2"] and set(k2) <= {"tensor-core", "f32", "composed"},
          f"{what}: K2's launches by route {k2} (want all {want['K2']} on its tensor-core or "
          "f32 kernels or its composed route)")
    parts = paths["K2 parts"]
    check(parts == ({f"K5 {kind}": composed, f"K6 {kind}": composed} if composed else {}),
          f"{what}: the composed K2 route's K5 and K6 launches by kernel {parts} (want "
          f"{composed} each on the {kind} kernels)")
    for key in ("K5", "K6"):
        got = paths[key]
        n = want.get(key, 0)
        check(got == ({kind: n} if n else {}),
              f"{what}: {key}'s launches by kernel {got} (want all {n} on the {kind} kernel)")


def bf16_step_checks(card: str, cfg, batch, want: dict, what: str, bs: int) -> None:
    """One bf16 training step at ``cfg``'s width from seeded weights, after
    a warm-up step: launches ``want`` by kernel, every K2, K5 and K6 on a
    tiled kernel (:func:`k2_paths_tiled`), a finite loss, not skipped, and
    every parameter with a gradient moved (the detached MIL_NCE.marco_mlp
    and the decoder's unused 1-token Q/K projections have none), as the
    training phases check; steps/s as information."""
    from structured_alignment_vqa_tpu_torch.parallel.train_step import (
        TrainState,
        adam,
        make_train_step,
    )

    model = random_model(cfg)
    opt = adam(model.parameters(), lr=1e-4)
    state = TrainState(model, opt)
    step = make_train_step(model, opt, cfg)
    gen = torch.Generator(device="cuda").manual_seed(7)
    step(state, batch, gen)           # warm-up step
    torch.cuda.synchronize()
    before = [p.detach().clone() for p in model.parameters()]
    reset_launch_counts()
    t0 = time.perf_counter()
    m = step(state, batch, gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    check(launches == want, f"{what} train bf16 bs {bs}: launches {launches} == {want}")
    k2_paths_tiled(f"{what} train bf16 bs {bs}", want, torch.bfloat16)
    loss = m["loss"].item()
    check(math.isfinite(loss) and m["skipped"].item() == 0,
          f"{what} train bf16 bs {bs}: loss {loss:.5f} finite, not skipped")
    still = sorted(n for (n, p), a in zip(model.named_parameters(), before) if torch.equal(a, p))
    no_grad = sorted(n for n, p in model.named_parameters() if p.grad is None)
    check(still == no_grad and all(re.search(NO_GRAD_PARAMS, n) for n in still),
          f"{what} train bf16 bs {bs}: every parameter with a gradient moved; the "
          f"{len(still)} without one are the detached MIL_NCE.marco_mlp and the decoder's "
          "unused 1-token Q/K projections")
    print(f"{what} train bf16 bs {bs}: one step in {seconds:.4f} s = {1 / seconds:.3f} "
          f"steps/s on {card} (information only)", flush=True)
    del model, opt, state, step, before
    gc.collect()
    torch.cuda.empty_cache()


def widths_rel_point(card: str, hidden: int, heads: int) -> dict:
    """The obj+rel model (``rel_config``: maxlen 1,600, hidden_size_mil 64)
    at ``hidden`` and ``heads``: one bf16 request at bs 4 whose launches
    must be the 512-wide request's (``REL_FORWARD``), every K1 and K4 on its
    tensor-core kernel, then the same weights' f32 logits against the plain
    path with its decisions pinned, at the serving phases' limit; then one
    f32 training step at bs 4 against the plain path at the training
    limits, its decisions pinned, and one bf16 step (:func:`bf16_step_checks`),
    every K2, K5 and K6 of each on a tiled kernel; the request's pairs/s
    and the steps' steps/s as information."""
    from structured_alignment_vqa_tpu_torch.parallel.train_step import (
        TrainState,
        adam,
        make_train_step,
    )
    from structured_alignment_vqa_tpu_torch.train.predict import make_predict_step

    what = f"widths obj+rel hidden {hidden} heads {heads}"
    cfg = rel_config(hidden_size=hidden, num_heads=heads)
    model = random_model(cfg)
    batches = rel_batches(cfg, 2)
    predict = make_predict_step(model)
    predict(batches[0])          # warm-up request
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    answers = predict(batches[1])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, paths = launch_counts(), path_counts()
    for key, per in REL_FORWARD.items():
        check(launches[key] == per, f"{what}: {key} launched {launches[key]} times in one bf16 "
              f"bs-{REL_B} request (want {per}, as at hidden {C})")
    for key in ("K1", "K4"):
        check(paths[key] == {"tensor-core": REL_FORWARD[key]},
              f"{what}: {key}'s launches by kernel {paths[key]} (want all "
              f"{REL_FORWARD[key]} on the tensor-core kernel)")
    check(answers.shape == (REL_B,) and int(answers.min()) >= 0
          and int(answers.max()) < cfg.num_classes,
          f"{what}: {REL_B} answers in [0, {cfg.num_classes})")
    print(f"{what} serving bf16 bs {REL_B}: one request in {seconds:.4f} s = "
          f"{REL_B / seconds:.1f} pairs/s on {card} (information only)", flush=True)

    model32 = random_model(cfg.replace(compute_dtype=torch.float32))
    model32.load_state_dict(model.state_dict())
    del model, predict
    with torch.inference_mode():
        with recorded_decisions(model32) as decisions:
            kernel_out = model32.eval()(batches[1])
        before = launch_counts()
        pins = Pins(decisions)
        with plain_path(), pinned_decisions(model32, pins):
            plain_out = model32(batches[1])
        check(before == launch_counts(), f"{what}: the plain path launched no kernel")
    pins_hold(f"{what} serving f32: the plain path", pins)
    diff = max((a - b).abs().max().item() for a, b in zip(kernel_out[:3], plain_out[:3]))
    finite = all(torch.isfinite(t).all().item() for t in kernel_out)
    check(finite and diff <= LOGIT_TOL_F32,
          f"{what} serving f32: max|logits kernel - plain| {diff:.3g} <= {LOGIT_TOL_F32:g}")
    pair_line(f"{what} serving f32 logits", diff, LOGIT_TOL_F32, [pins])
    del model32, kernel_out, plain_out, decisions, pins
    gc.collect()
    torch.cuda.empty_cache()

    cfg32 = cfg.replace(compute_dtype=torch.float32)
    reset_launch_counts()
    f32_step_against_plain(cfg32, batches[0], REL_STEP, f"{what} train f32 bs {REL_B}")
    k2_paths_tiled(f"{what} train f32 bs {REL_B}", REL_STEP, torch.float32)
    gc.collect()
    torch.cuda.empty_cache()
    model = random_model(cfg32)
    opt = adam(model.parameters(), lr=1e-4)
    state = TrainState(model, opt)
    step = make_train_step(model, opt, cfg32)
    gen = torch.Generator(device="cuda").manual_seed(7)
    step(state, batches[0], gen)           # warm-up step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(state, batches[1], gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    print(f"{what} train f32 bs {REL_B}: one step in {seconds:.4f} s = {1 / seconds:.3f} "
          f"steps/s on {card} (information only)", flush=True)
    del model, opt, state, step
    gc.collect()
    torch.cuda.empty_cache()
    bf16_step_checks(card, cfg, batches[0], REL_STEP, what, REL_B)
    del batches
    return launches


def rel_config(**kw):
    """The production obj+rel point: ``only_obj=False``, maxlen 1600,
    hidden_size_mil 64, 310 relation categories; the rest as ``full_config``."""
    return full_config(only_obj=False, maxlen=1600, hidden_size_mil=64, **kw)


def rel_batches(cfg, n: int, batch: int = REL_B):
    """Synthetic obj+rel batches at bucket (lv, ls, lq) = (36, 1506, 30).
    ``synthetic_arrays`` gives each sample at most 74 macro nodes; a scene
    graph with relations has many more, so each sample's macro nodes are
    extended to 900-1,506 (ids, validity square and a sparse adjacency,
    from the seed) and the relation records stay as drawn (32 slots)."""
    import numpy as np

    from structured_alignment_vqa_tpu_torch.data.synthetic import (
        batch_from_arrays,
        synthetic_arrays,
    )

    out = []
    for seed in range(n):
        arrays = synthetic_arrays(cfg, batch, lv=REL_LV, lq=REL_LQ, ls=REL_LS, n_rel=32, seed=seed)
        rng = np.random.default_rng(1000 + seed)
        for i in range(batch):
            had = int(arrays["macro_mask"][i, :, 0].sum())
            n_macro = int(rng.integers(REL_LS * 3 // 5, REL_LS + 1))
            arrays["macro_ipt"][i, had:n_macro] = rng.integers(1, cfg.vocab_size - 4,
                                                               size=n_macro - had)
            arrays["macro_mask"][i, :n_macro, :n_macro] = 1
            arrays["macro_graph"][i, :n_macro, :n_macro] = rng.random((n_macro, n_macro)) < 0.02
        out.append(batch_from_arrays(arrays))
    return out


def rel_serving_phase(card: str) -> dict:
    from structured_alignment_vqa_tpu_torch.train.predict import make_predict_step

    cfg = rel_config()
    model = random_model(cfg)
    batches = rel_batches(cfg, REQUESTS)
    predict = make_predict_step(model)
    predict(batches[0])          # warm-up request
    torch.cuda.synchronize()

    reset_launch_counts()
    t0 = time.perf_counter()
    answers = [predict(b) for b in batches]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    for key, per in REL_FORWARD.items():
        check(launches[key] == per * REQUESTS,
              f"obj+rel serving: {key} launched {launches[key]} times in {REQUESTS} forwards "
              f"(want {per} each)")
    ok = all(a.shape == (REL_B,) and int(a.min()) >= 0 and int(a.max()) < cfg.num_classes
             for a in answers)
    check(ok, f"obj+rel serving: {REQUESTS} x {REL_B} answers in [0, {cfg.num_classes})")
    print(f"obj+rel serving bf16 bs {REL_B}: {REQUESTS} requests in {seconds:.4f} s = "
          f"{REQUESTS * REL_B / seconds:.1f} pairs/s, {seconds / REQUESTS * 1e3:.2f} ms per "
          f"request on {card} (information only)", flush=True)
    profile_device(lambda: predict(batches[0]), f"one obj+rel bs-{REL_B} request")

    with torch.inference_mode():
        lc, lv, ls, mil_obj, mil_rel = model(batches[0])
    check(all(torch.isfinite(t.float()).all().item() for t in (lc, lv, ls, mil_obj, mil_rel))
          and lc.shape == (REL_B, cfg.num_classes) and mil_rel.item() != 0.0,
          f"obj+rel serving bf16: finite logits of shape ({REL_B}, {cfg.num_classes}), "
          f"mil_rel {mil_rel.item():.5f}")

    wide = rel_batches(cfg, 1, batch=2 * REL_B)[0]
    predict(wide)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REQUESTS):
        predict(wide)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    print(f"obj+rel serving bf16 bs {2 * REL_B}: {REQUESTS} requests in {seconds:.4f} s = "
          f"{REQUESTS * 2 * REL_B / seconds:.1f} pairs/s on {card} (information only)", flush=True)
    del wide

    # the same weights in f32: kernels against plain versions, both on the card
    model32 = random_model(cfg.replace(compute_dtype=torch.float32))
    model32.load_state_dict(model.state_dict())
    predict32 = make_predict_step(model32)
    # the plain path takes the kernel path's decisions (pinned_decisions)
    with torch.inference_mode():
        with recorded_decisions(model32) as decisions:
            kernel_out = model32.eval()(batches[0])
        kernel_answers = predict32(batches[0])
        before = launch_counts()
        pins = [Pins(decisions), Pins(decisions)]
        with plain_path():
            with pinned_decisions(model32, pins[0]):
                plain_out = model32(batches[0])
            with pinned_decisions(model32, pins[1]):
                plain_answers = predict32(batches[0])
        check(before == launch_counts(), "obj+rel serving: the plain path launched no kernel")
    for taken in pins:
        pins_hold("obj+rel serving f32: the plain path", taken)
    diff = max((a - b).abs().max().item() for a, b in zip(kernel_out[:3], plain_out[:3]))
    finite = all(torch.isfinite(t).all().item() for t in kernel_out)
    check(finite and diff <= LOGIT_TOL_F32,
          f"obj+rel serving f32: max|logits kernel - plain| {diff:.3g} <= {LOGIT_TOL_F32:g}")
    pair_line("obj+rel serving f32 logits", diff, LOGIT_TOL_F32, pins)
    same = (kernel_answers == plain_answers).float().mean().item()
    check(same == 1.0, f"obj+rel serving f32: answers kernel == plain for {same:.4f} of {REL_B}")
    return launches


def rel_training_phase(card: str) -> dict:
    from structured_alignment_vqa_tpu_torch.parallel.train_step import (
        TrainState,
        adam,
        make_train_step,
    )

    cfg = rel_config()
    model = random_model(cfg)
    opt = adam(model.parameters(), lr=1e-4)
    state = TrainState(model, opt)
    step = make_train_step(model, opt, cfg)
    batches = rel_batches(cfg, TRAIN_STEPS)
    gen = torch.Generator(device="cuda").manual_seed(7)
    step(state, batches[0], gen)           # warm-up step
    torch.cuda.synchronize()
    before = [p.detach().clone() for p in model.parameters()]

    reset_launch_counts()
    t0 = time.perf_counter()
    metrics = [step(state, b, gen) for b in batches]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    for key, per in REL_STEP.items():
        check(launches[key] == per * TRAIN_STEPS,
              f"obj+rel train: {key} launched {launches[key]} times in {TRAIN_STEPS} steps "
              f"(want {per} each)")
    losses = [m["loss"].item() for m in metrics]
    skipped = sum(m["skipped"].item() for m in metrics)
    check(all(torch.isfinite(torch.tensor(losses))) and skipped == 0,
          f"obj+rel train bf16: losses {['%.5f' % x for x in losses]} finite, {skipped:g} skipped")
    still = sorted(n for (n, p), a in zip(model.named_parameters(), before) if torch.equal(a, p))
    no_grad = sorted(n for n, p in model.named_parameters() if p.grad is None)
    check(still == no_grad and all(re.search(NO_GRAD_PARAMS, n) for n in still)
          and "MIL_NCE.R" not in still,
          f"obj+rel train bf16: every parameter with a gradient moved, MIL_NCE.R among them; "
          f"the {len(still)} without one are the detached MIL_NCE.marco_mlp and the decoder's "
          "unused 1-token Q/K projections")
    del before
    print(f"obj+rel train bf16 bs {REL_B}: {TRAIN_STEPS} steps in {seconds:.4f} s = "
          f"{TRAIN_STEPS / seconds:.3f} steps/s, {TRAIN_STEPS * REL_B / seconds:.1f} samples/s "
          f"on {card} (information only)", flush=True)
    profile_device(lambda: step(state, batches[0], gen), f"one obj+rel bs-{REL_B} training step")
    del model, opt, state, step
    torch.cuda.empty_cache()

    cfg32 = rel_config(compute_dtype=torch.float32)
    batch = batches[0]
    f32_step_against_plain(cfg32, batch, REL_STEP, "obj+rel train f32")
    torch.cuda.empty_cache()
    f32_step_profile(cfg32, rel_batches(cfg32, TRAIN_STEPS), REL_B, "obj+rel", card)

    # remat_blocks: the same step, each encoder block's forward run again in
    # the backward; bf16, as training runs
    plain_step = one_step(cfg, batch)
    remat_step = one_step(cfg.replace(remat_blocks=True), batch)
    check(remat_step[2] == REL_STEP_REMAT,
          f"obj+rel train remat: launches {remat_step[2]} == {REL_STEP_REMAT}")
    compare_steps("obj+rel train bf16, remat_blocks against none", remat_step, plain_step,
                  REMAT_TOL, REMAT_TOL)
    same = all(g is None or torch.equal(g, plain_step[1][n]) for n, g in remat_step[1].items())
    print(f"obj+rel train bf16 bs {REL_B}: remat gradients bitwise equal to those without: "
          f"{same} (information only)", flush=True)
    del plain_step, remat_step
    torch.cuda.empty_cache()
    # one step with the sparse GloVe-table optimizer through the flash path
    from structured_alignment_vqa_tpu_torch.parallel.train_step import create_train_state

    model = random_model(cfg)
    state = create_train_state(model, 1e-4, sparse_table=True)
    step = make_train_step(model, state.optimizer, cfg, sparse_table=True)
    before = launch_counts()
    m = step(state, batch, torch.Generator(device="cuda").manual_seed(7))
    torch.cuda.synchronize()
    moved = {k: launch_counts()[k] - before[k] for k in before}
    check(moved == REL_STEP and bool(torch.isfinite(m["loss"])) and m["skipped"].item() == 0
          and int(state.table_opt.count) == 1,
          f"obj+rel train bf16, sparse table: loss {m['loss'].item():.5f} finite, not "
          f"skipped, the table's count 1, launches {moved} == {REL_STEP}")
    del model, state, step
    torch.cuda.empty_cache()
    mib = 2.0 ** 20
    for what, c in (("no remat", cfg), ("remat_blocks", cfg.replace(remat_blocks=True))):
        held, extra = steady_step_memory(c, batch)
        print(f"obj+rel train bf16 bs {REL_B}, {what}: {held / mib:.1f} MiB held between steps "
              f"(parameters and Adam's moments), a step's peak {extra / mib:.1f} MiB on top "
              f"(gradients and activations) on {card} (information only)", flush=True)
        torch.cuda.empty_cache()
    return launches


# the cli phase: a fixture tree at the GQA-realistic ranges of the TPU
# package's end-to-end serving script, and the obj-only model at full width
# through the CLI's own flags (only the head is narrower: the fixture's
# answer vocabulary)
CLI_FIXTURE = dict(n_images=128, n_questions=2560, n_obj_range=(10, 36),
                   n_words_range=(3, 15), n_classes=1600, class_feature_sigma=0.5,
                   p_detector_correct=0.8, seed=0)
CLI_FLAGS = ["--hidden_size", "512", "--num_blocks", "6", "--num_heads", "8",
             "--hidden_size_mil", "1024", "--maxlen", "450", "--maxlen_q", "40",
             "--maxlen_v", "100", "--topN", "5", "--vocab_size", "407000", "--glove_dim", "300",
             "--bf16", "--share_glove", "--only_obj", "--decMask", "--with_loc",
             "--with_MILNCE_loss", "--pred_rel", "--batch_size", str(B)]
CLI_WORKERS = 8
EVAL_REL_TOL = 1e-5
# max |serving loop - synchronous reference| of the ensemble log-softmax: the
# same kernels on the same bf16 inputs, so nothing but a wrong row shows
LOGSM_TOL = 1e-4


def loader_pass(loader, read=None) -> tuple:
    """Iterate ``loader`` once, calling ``read`` on each batch: (its
    batches, valid samples, seconds)."""
    t0 = time.perf_counter()
    batches = []
    for b in loader:
        if read is not None:
            read(b)
        batches.append(b)
    seconds = time.perf_counter() - t0
    return batches, sum(int(b.sample_valid.sum()) for b in batches), seconds


def same_batches(a: list, b: list) -> bool:
    import numpy as np

    return len(a) == len(b) and all(
        all(np.array_equal(getattr(x, f.name), getattr(y, f.name))
            for f in dataclasses.fields(x) if getattr(x, f.name) is not None)
        for x, y in zip(a, b))


def spread_answers_(model, batch) -> None:
    """Shift each answer head's output bias by minus its mean logits over
    ``batch``. With random weights one class otherwise takes nearly every
    answer (the heads' ReLU layer has a positive mean that every sample
    shares), and an answer check then passes whatever row a sample gets."""
    from structured_alignment_vqa_tpu_torch.models.att_model_x3 import _Head

    heads = [m for m in model.modules() if isinstance(m, _Head)]
    outs = {}
    hooks = [m.register_forward_hook(lambda m, _, out: outs.__setitem__(m, out.float()))
             for m in heads]
    try:
        with torch.inference_mode():
            model.eval()(batch)
    finally:
        for h in hooks:
            h.remove()
    with torch.no_grad():
        for m in heads:
            m[-1].bias.sub_(outs[m].reshape(-1, outs[m].shape[-1]).mean(0))


@contextlib.contextmanager
def recorded_kernel_inputs(seen: dict, counts: "dict | None" = None):
    """Pass every launch of K1, K2, K3 and K4 on to the kernel, keeping a
    copy of the first arguments at each distinct shape (and renorm) in
    ``seen``, keyed by kernel and shapes, and the number of launches at each
    in ``counts`` when given."""
    from structured_alignment_vqa_tpu_torch.ops import flash_graph_attention as fl
    from structured_alignment_vqa_tpu_torch.ops import fused_ffn as k3
    from structured_alignment_vqa_tpu_torch.ops import fused_graph_attention as k1

    def recorder(key, launch):
        def call(*args):
            sig = tuple(tuple(a.shape) if torch.is_tensor(a) else a for a in args)
            if (key, sig) not in seen:
                seen[key, sig] = tuple(a.clone() if torch.is_tensor(a) else a for a in args)
            if counts is not None:
                counts[key, sig] = counts.get((key, sig), 0) + 1
            return launch(*args)
        return call

    with mock.patch.object(k1, "_launch", recorder("K1", k1._launch)), \
            mock.patch.object(k1, "_launch_bwd", recorder("K2", k1._launch_bwd)), \
            mock.patch.object(k3, "_launch", recorder("K3", k3._launch)), \
            mock.patch.object(fl, "_launch_forward", recorder("K4", fl._launch_forward)):
        yield


def cli_kernels_against_plain(seen: dict, what: str = "cli") -> None:
    """K1, K2, K3 and K4 at every shape the CLIs (or a phase's model) gave
    them, on the model's own inputs, against their plain versions (K2 output
    by output, relative to each output's max; K4's output)."""
    from structured_alignment_vqa_tpu_torch.ops import flash_graph_attention as fl
    from structured_alignment_vqa_tpu_torch.ops import fused_ffn as k3
    from structured_alignment_vqa_tpu_torch.ops import fused_graph_attention as k1

    for (key, _), args in sorted(seen.items(), key=lambda kv: str(kv[0])):
        x = args[0]
        if key == "K2":
            k2_against_plain(f"{what}, at the CLI's shape B {x.shape[0]} Tq {x.shape[1]} Tk "
                             f"{args[1].shape[1]} (the model's own inputs)",
                             args[:9], args[9], args[10], args[11])
            continue
        with torch.inference_mode():
            if key == "K1":
                got = k1.fused_graph_attention_ln(*args)
                want = k1.graph_attention_ln_plain(*args)
                shape = f"B {x.shape[0]} Tq {x.shape[1]} Tk {args[1].shape[1]} {args[-1]}"
            elif key == "K4":   # args: ..., num_heads, renorm, emit
                got = fl._launch_forward(*args)
                want = fl.flash_graph_attention_plain(*args)
                if args[-1] != "out":
                    got, want = got[0], want[0]
                shape = f"B {x.shape[0]} Tq {x.shape[1]} Tk {args[1].shape[1]} {args[-2]}"
            else:
                got, want = k3.fused_ffn(*args), k3.ffn_ln_plain(*args)
                shape = f"rows {x.numel() // x.shape[-1]} C {x.shape[-1]}"
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = TOL[x.dtype]
        check(bool(torch.isfinite(got.float()).all()) and err <= tol,
              f"{what} {key} at the CLI's shape {shape} {x.dtype} (the model's own inputs): "
              f"max|kernel-plain| {err:.3g} <= {tol:g}")


def cli_rate(output_dir: str) -> str:
    """The predict CLI's own throughput line from its log."""
    import os

    with open(os.path.join(output_dir, "training.log")) as f:
        lines = [line.strip() for line in f if "predicted" in line]
    return lines[-1].split("INFO", 1)[-1].strip() if lines else "no throughput line logged"


def cli_phase(card: str) -> dict:
    """The predict and eval CLIs at full obj-only width on a fixture tree,
    against the in-process steps on the same batches."""
    import json as _json
    import os
    import tempfile
    from itertools import islice

    import numpy as np

    from structured_alignment_vqa_tpu_torch.data.dataset import BatchLoader, GQASuperNodeDataset
    from structured_alignment_vqa_tpu_torch.data.fixtures import write_fixture
    from structured_alignment_vqa_tpu_torch.data.transfer import BatchMover, host_tensors, shipped
    from structured_alignment_vqa_tpu_torch.models import AttModelX3, init_random_
    from structured_alignment_vqa_tpu_torch.parallel.train_step import (
        TrainState,
        adam,
        make_eval_step,
    )
    from structured_alignment_vqa_tpu_torch.train import evaluate, predict as predict_cli
    from structured_alignment_vqa_tpu_torch.train.main import build_parser, configs_from_args
    from structured_alignment_vqa_tpu_torch.train.predict import (
        ensemble_log_softmax,
        make_predict_step,
        numbered,
        serve,
    )
    from structured_alignment_vqa_tpu_torch.utils.checkpoint import (
        load_params_for_eval,
        save_checkpoint,
    )

    with tempfile.TemporaryDirectory() as tmp:
        data, out, ckpt = (os.path.join(tmp, d) for d in ("data", "out", "ckpt"))
        t0 = time.perf_counter()
        write_fixture(data, **CLI_FIXTURE)
        print(f"cli: fixture tree ({CLI_FIXTURE['n_questions']} train questions, "
              f"{CLI_FIXTURE['n_images']} images) written in {time.perf_counter() - t0:.1f} s",
              flush=True)
        argv = ["--data_dir_azure", data, "--output_dir", out] + CLI_FLAGS
        cfg, train_dc, val_dc, _ = configs_from_args(build_parser().parse_args(argv))
        print(f"cli: num_classes {cfg.num_classes} (the fixture's answer vocabulary + 1; "
              f"hidden {cfg.hidden_size}, {cfg.num_blocks} blocks, {cfg.num_heads} heads, "
              f"vocab {cfg.vocab_size} x {cfg.glove_dim}, {cfg.compute_dtype})", flush=True)

        model = AttModelX3(cfg)
        init_random_(model, torch.Generator(device="cuda").manual_seed(0))
        t0 = time.perf_counter()

        # the loader alone, in samples/s: cold on threads (a new dataset, so
        # its image cache is cold too) and on spawned processes, warm through
        # the sample cache, and the batch cache's second pass
        def dataset():
            return GQASuperNodeDataset("train", train_dc)

        def loader(**kw):
            return BatchLoader(dataset(), B, shuffle=False, drop_last=False, **kw)

        host_batches, n_valid, sec = loader_pass(loader(num_threads=CLI_WORKERS))
        rates = {"cold, threads": n_valid / sec}
        _, n_procs, sec = loader_pass(loader(num_procs=CLI_WORKERS))
        rates["cold, processes"] = n_procs / sec
        sample_cache = os.path.join(tmp, "cache")
        loader_pass(loader(num_threads=CLI_WORKERS, cache_dir=f"{sample_cache}/train"))
        warm, _, sec = loader_pass(loader(cache_dir=f"{sample_cache}/train"))
        rates["warm, sample cache"] = n_valid / sec
        batch_cache = os.path.join(tmp, "batches")
        loader_pass(loader(num_threads=CLI_WORKERS, batch_cache_dir=batch_cache))
        # the batch cache's batches are mmap views: read each one's pages
        # as the mover does, by the cast of its features to bf16
        cached, _, sec = loader_pass(loader(batch_cache_dir=batch_cache),
                                     read=lambda b: host_tensors(b, True))
        rates["batch cache, second pass, each batch read (features cast to bf16)"] = (
            n_valid / sec)
        check(n_procs == n_valid and same_batches(warm, host_batches)
              and same_batches(cached, host_batches),
              f"cli: the loader gives the same {len(host_batches)} batches ({n_valid} valid "
              "samples) on threads, through the sample cache and through the batch cache")
        del warm, cached
        spread_answers_(model, host_tensors(host_batches[0]).to("cuda"))
        save_checkpoint(ckpt, TrainState(model, adam(model.parameters())), 1)
        loaded = AttModelX3(cfg)
        load_params_for_eval(ckpt, loaded)
        same = all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                    loaded.state_dict().values()))
        tied = loaded.att_syb.syb_emb.weight is loaded.MIL_NCE.syb_emb.weight
        check(same and tied, "cli: the checkpoint's params load bitwise equal to the saved "
                             "ones, the shared GloVe table tied")
        del loaded
        index_kind = dataset().q_tar.indexed_by
        for what, rate in rates.items():
            print(f"cli: loader alone, {what}: {rate:.1f} samples/s ({CLI_WORKERS} workers) "
                  f"on {card} (information only)", flush=True)
        print(f"cli: tar index served by the {index_kind} indexer; model, checkpoint and "
              f"six loader passes in {time.perf_counter() - t0:.1f} s", flush=True)

        # the in-process reference: the same batches moved synchronously
        # (pageable copies, float32 features), their ensemble log-softmax
        # and its argmax as make_predict_step takes it; K1's and K3's inputs
        # are kept at each shape the batches give them
        predict = make_predict_step(model)
        want, want_rows, base, seen = {}, {}, 0, {}
        with recorded_kernel_inputs(seen), torch.inference_mode():
            for b in host_batches:
                rows = ensemble_log_softmax(model.eval(), host_tensors(b).to("cuda"))
                answers, rows = torch.argmax(rows, dim=-1).cpu().numpy(), rows.cpu().numpy()
                for j, ok in enumerate(b.sample_valid):
                    if ok:
                        want[base + j], want_rows[base + j] = int(answers[j]), rows[j]
                base += len(b.sample_valid)
        n_distinct = len(set(want.values()))
        check(n_distinct >= cfg.num_classes // 2,
              f"cli: the reference gives {n_distinct} distinct answer ids among {len(want)} "
              f"(at least half of the {cfg.num_classes} classes)")

        # the serving loop the predict CLI runs (pinned copies on the side
        # stream two batches ahead, answers read back four batches later),
        # here returning each sample's log-softmax row, against the
        # reference; fed from the batch cache, whose batches are mmap views
        mover = BatchMover("cuda", bf16_features=True)
        got_rows = {}
        serve(torch.inference_mode()(lambda batch: ensemble_log_softmax(model, batch)),
              numbered(enumerate(loader(batch_cache_dir=batch_cache)), mover),
              lambda i, row: got_rows.__setitem__(i, np.array(row)), pipeline_depth=4)
        order = sorted(want_rows)
        ref = np.stack([want_rows[i] for i in order])
        diff = (max(np.abs(got_rows[i] - want_rows[i]).max() for i in order)
                if sorted(got_rows) == order else float("inf"))
        shifted = np.median(np.abs(ref - np.roll(ref, 1, axis=0)).max(axis=1))
        check(diff <= LOGSM_TOL and shifted > 100 * LOGSM_TOL,
              f"cli: the serving loop's log-softmax rows equal the reference's within "
              f"{diff:.3g} <= {LOGSM_TOL:g} for all {len(order)} samples (a row shifted by "
              f"one would differ by a median {shifted:.3g} > {100 * LOGSM_TOL:g})")

        t0 = time.perf_counter()
        runs = (("threads", ["--num_workers", str(CLI_WORKERS)]),
                ("processes", ["--num_procs", str(CLI_WORKERS)]),
                ("sample cache, warm", ["--cache_dir", sample_cache]),
                ("batch cache", ["--batch_cache_dir", batch_cache]))
        n_batches = len(host_batches)
        launches = {}
        for what, extra in runs:
            answers_file = os.path.join(tmp, "answers.jsonl")
            reset_launch_counts()
            n_out = predict_cli.main(argv + ["--weight_dir", ckpt, "--split", "train",
                                             "--out", answers_file, "--pipeline_depth", "4",
                                             "--warmup_batches", "2"] + extra)
            counts = launch_counts()
            launches = launches or counts    # the first run's, on threads
            with open(answers_file) as f:
                got = {r["index"]: r["answer_id"] for r in map(_json.loads, f)}
            check(n_out == len(got) == len(want) == n_valid,
                  f"cli predict ({what}): {len(got)} answer lines, one per valid sample "
                  f"({n_valid})")
            agree = sum(got.get(i) == a for i, a in want.items())
            check(agree == len(want),
                  f"cli predict ({what}): {agree} of {len(want)} answer ids equal the "
                  "in-process step's on synchronously moved batches")
            per = {k: counts[k] / n_batches for k in counts}
            check(per["K1"] == K1_PER_FORWARD and per["K3"] == K3_PER_FORWARD
                  and all(per[k] == 0 for k in ("K2", "K4", "K5", "K6")),
                  f"cli predict ({what}): launches per batch {per} (want {K1_PER_FORWARD} K1, "
                  f"{K3_PER_FORWARD} K3)")
            print(f"cli predict ({what}): {cli_rate(out)} on {card} (information only)",
                  flush=True)

        print(f"cli: reference answers and four predict CLI runs in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        # the CLI's copies (pinned buffers, the side stream, two batches
        # ahead of the compute) give every field of every batch bitwise
        moved_ok = True
        for host, ship in shipped(loader(batch_cache_dir=batch_cache), mover):
            dev, ref = ship.ready(), host_tensors(host, True)
            moved_ok &= all(torch.equal(getattr(dev, f.name).cpu(), getattr(ref, f.name))
                            for f in dataclasses.fields(ref) if getattr(ref, f.name) is not None)
        check(moved_ok, f"cli: {n_batches} batches shipped on the side stream equal their host "
                        "arrays bitwise (features as bf16, masks int8, ids int32)")

        # the copy of one batch: pinned on the side stream against pageable
        b = host_batches[0]
        for _ in range(2):
            mover.ship(b).event.synchronize()
            host_tensors(b, True).to("cuda")
        torch.cuda.synchronize()
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            ship = mover.ship(b)
            ship.event.synchronize()
        pinned_ms = (time.perf_counter() - t0) / reps * 1e3
        t0 = time.perf_counter()
        for _ in range(reps):
            host_tensors(b, True).to("cuda")
            torch.cuda.synchronize()
        pageable_ms = (time.perf_counter() - t0) / reps * 1e3
        print(f"cli: one batch (lv {b.vis_fea.shape[1]}, ls {b.macro_ipt.shape[1]}, lq "
              f"{b.q_ipt.shape[1]}) of {ship.nbytes / 2 ** 20:.1f} MiB with bf16 features: "
              f"{pinned_ms:.3f} ms pinned on the side stream, {pageable_ms:.3f} ms pageable "
              f"(host clock, numpy to device) on {card} (information only)", flush=True)

        # the card's idle share over 3 batches of the CLI's serving loop,
        # fed from the batch cache
        cached_loader = loader(batch_cache_dir=batch_cache)
        profile_device(lambda: serve(predict,
                                     islice(numbered(enumerate(cached_loader), mover), 3),
                                     lambda i, a: None, pipeline_depth=4),
                       f"3 bs-{B} batches of the predict CLI's serving loop, batch cache")

        # the eval CLI against the in-process eval step over the same batches
        eval_step = make_eval_step(model, cfg, with_milnce=True)
        state = TrainState(model, optimizer=None)
        sums = {"loss_sum": 0.0, "n_correct": 0.0, "n": 0.0}
        val = BatchLoader(GQASuperNodeDataset("val", val_dc), B, shuffle=False)
        with recorded_kernel_inputs(seen):
            for vb in val:
                m = eval_step(state, host_tensors(vb).to("cuda"))
                for k in sums:
                    sums[k] += float(m[k])
        cli_kernels_against_plain(seen)
        loss, acc = evaluate.main(argv + ["--weight_dir", ckpt, "--split", "val"])
        want_loss = sums["loss_sum"] / max(sums["n"], 1.0)
        got_correct = acc * sums["n"]
        check(sums["n_correct"] > 0 and abs(loss - want_loss) <= EVAL_REL_TOL * abs(want_loss)
              and abs(got_correct - sums["n_correct"]) <= EVAL_REL_TOL * max(sums["n_correct"], 1),
              f"cli eval: loss {loss:.6f} and n_correct {got_correct:.1f} of {sums['n']:g} equal "
              f"the in-process sums {want_loss:.6f} and {sums['n_correct']:.1f} within "
              f"{EVAL_REL_TOL:g} relative")
    return launches


# the train_cli phase: the training CLI at full obj-only width on the cli
# phase's fixture tree, with the sparse table, batch replay and bf16
TRAIN_CLI_FLAGS = CLI_FLAGS + ["--sparse_table", "--batch_replay", "--lr", "1e-4",
                               "--seed", "0", "--log_steps", "1", "--log_steps_val", "100",
                               "--num_workers", str(CLI_WORKERS)]
# the CLI's logged losses against an in-process loop of the same step on the
# same batches, relative to each loss: the same kernels, weights and dropout
# masks; only sums the card reorders (atomics in a backward) could differ,
# by f32 rounding that bf16 compute may round one bf16 ulp the other way
TRAIN_CLI_LOSS_RTOL = 1e-3
# the first sparse step against the dense one on the rows it touched: Adam's
# first update is lr * g / (|g| + eps), the same g summed in another order
# moves it by rounding; 1e-6 is 1% of one step at lr 1e-4
FIRST_STEP_ATOL = 1e-6
PROFILE_STEPS = 5


def logged_step_losses(output_dir: str) -> list:
    """(epoch, step, loss) of every step line of the training CLI's log."""
    import os

    pattern = re.compile(r"Epoch \[(\d+)/\d+\], Step \[(\d+)\], Loss: ([^,]+), MIL NCE Loss")
    with open(os.path.join(output_dir, "training.log")) as f:
        return [(int(e), int(i), float(v)) for e, i, v in pattern.findall(f.read())]


def log_lines(output_dir: str, mark: str) -> list:
    import os

    with open(os.path.join(output_dir, "training.log")) as f:
        return [line.split("INFO", 1)[-1].strip() for line in f if mark in line]


def trace_idle_share(path: str) -> tuple:
    """(device busy ms, window ms, idle share) of a Chrome trace written by
    ``utils/profiling.py``: kernel time summed over the span of all events."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if "ts" in e and "dur" in e]
    busy = sum(e["dur"] for e in events if e.get("cat") == "kernel")
    span = max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)
    return busy / 1e3, span / 1e3, 1 - busy / span


def model_bytes(model) -> int:
    """Bytes of the model's parameters and buffers on the card (a tensor
    several names share counted once)."""
    seen = {}
    for t in list(model.parameters()) + list(model.buffers()):
        seen[t.data_ptr()] = t.numel() * t.element_size()
    return sum(seen.values())


def dense_against_sparse_step(cfg, batch, card: str) -> None:
    """One dense and one sparse step from the same weights and dropout masks:
    the same loss, the touched table rows within FIRST_STEP_ATOL, the
    untouched rows bitwise unchanged, every other parameter as the dense
    step left it."""
    from structured_alignment_vqa_tpu_torch.parallel.train_step import (
        create_train_state,
        make_train_step,
    )
    from structured_alignment_vqa_tpu_torch.parallel.sparse_table import TABLE_NAME, remap_batch
    from structured_alignment_vqa_tpu_torch.train.loop import new_model

    after = {}
    for sparse in (False, True):
        model = new_model(cfg, 0, "cuda")
        state = create_train_state(model, 1e-4, sparse_table=sparse)
        step = make_train_step(model, state.optimizer, cfg, sparse_table=sparse)
        table0 = model.get_parameter(TABLE_NAME).detach().clone()
        m = step(state, batch, torch.Generator(device="cuda").manual_seed(1))
        after[sparse] = (m["loss"].item(), {n: p.detach().clone()
                                            for n, p in model.named_parameters()})
        del model, state, step
        torch.cuda.empty_cache()
    _, uids, valid = remap_batch(batch, cfg)
    touched = uids[valid]
    dense, sparse = after[False][1].pop(TABLE_NAME), after[True][1].pop(TABLE_NAME)
    untouched = torch.ones(dense.shape[0], dtype=torch.bool, device="cuda")
    untouched[touched] = False
    err = (sparse[touched] - dense[touched]).abs().max().item()
    moved = (sparse[touched] - table0[touched]).abs().max().item()
    check(after[False][0] == after[True][0] and err <= FIRST_STEP_ATOL and moved > 0
          and torch.equal(sparse[untouched], table0[untouched])
          and torch.equal(dense[untouched], table0[untouched]),
          f"train_cli: the first sparse step's loss {after[True][0]:.7g} equals the dense "
          f"step's {after[False][0]:.7g}; its {len(touched)} touched rows (of "
          f"{len(uids)} id slots) within {err:.3g} <= {FIRST_STEP_ATOL:g} of the dense "
          f"step's (moved up to {moved:.3g}), the {int(untouched.sum())} untouched rows "
          "bitwise unchanged")
    rest = max((after[True][1][n] - p).abs().max().item() for n, p in after[False][1].items())
    check(rest <= FIRST_STEP_ATOL, f"train_cli: every other parameter after the first sparse "
          f"step within {rest:.3g} <= {FIRST_STEP_ATOL:g} of the dense step's")


# named parts of a training step's "other" device time, by kernel name
OTHER_PARTS = (("foreach Adam", ("multi_tensor_apply",)),
               ("index_add_ (the sparse update's write-back)", ("indexFunc",)),
               ("embedding backward", ("embedding", "grad_weight", "krn_partial",
                                       "sum_and_scatter")),
               ("the finite check's reductions", ("ReduceOp<bool",)))


def table_other_breakdown(card: str) -> None:
    """The device-time breakdown and the memory of one dense and one sparse
    bf16 step at full width (1,843 classes, bs 128, bucket (36, 30, 98)):
    how much of "other" the table's dense Adam takes. Information only."""
    from structured_alignment_vqa_tpu_torch.parallel.train_step import (
        create_train_state,
        make_train_step,
    )

    cfg = full_config()
    batch = full_batches(cfg, 1)[0]
    mib = 2.0 ** 20
    for what, sparse, moments in (("dense", False, torch.float32),
                                  ("sparse, f32 moments", True, torch.float32),
                                  ("sparse, bf16 moments", True, torch.bfloat16)):
        model = random_model(cfg)
        state = create_train_state(model, 1e-4, sparse_table=sparse, table_moments_dtype=moments)
        step = make_train_step(model, state.optimizer, cfg, sparse_table=sparse)
        gen = torch.Generator(device="cuda").manual_seed(7)
        step(state, batch, gen)
        held, extra = step_memory(state, step, batch, gen)
        print(f"train_cli: {what} bf16 bs {B}: {held / mib:.1f} MiB held between steps "
              f"(parameters and Adam's moments), a step's peak {extra / mib:.1f} MiB on top "
              f"(gradients and activations) on {card} (information only)", flush=True)
        by_name = profile_device(lambda: step(state, batch, gen),
                                 f"one {what} bs-{B} training step")
        for part, marks in OTHER_PARTS:
            n = sum(c for k, (c, _) in by_name.items() if any(m in k for m in marks))
            us = sum(t for k, (_, t) in by_name.items() if any(m in k for m in marks))
            print(f"  of which {part}: {us / 1e3:.3f} ms, {n} kernels", flush=True)
        del model, state, step
        torch.cuda.empty_cache()


def train_cli_phase(card: str) -> dict:
    """The training CLI at full obj-only width on a fixture tree: one epoch,
    then a resumed second, against an in-process loop of its step; the
    predict CLI (float and --int8) on the checkpoint it wrote."""
    import os
    import tempfile

    from structured_alignment_vqa_tpu_torch.data.dataset import BatchLoader, GQASuperNodeDataset
    from structured_alignment_vqa_tpu_torch.data.fixtures import write_fixture
    from structured_alignment_vqa_tpu_torch.data.transfer import host_tensors
    from structured_alignment_vqa_tpu_torch.models import AttModelX3
    from structured_alignment_vqa_tpu_torch.ops.quant import quantize_state_dict
    from structured_alignment_vqa_tpu_torch.parallel.train_step import (
        TrainState,
        adam,
        create_train_state,
        make_train_step,
    )
    from structured_alignment_vqa_tpu_torch.train import main as train_main
    from structured_alignment_vqa_tpu_torch.train import predict as predict_cli
    from structured_alignment_vqa_tpu_torch.train.loop import new_model
    from structured_alignment_vqa_tpu_torch.train.predict import make_predict_step
    from structured_alignment_vqa_tpu_torch.utils.checkpoint import (
        checkpoint_path,
        load_params_for_eval,
        save_checkpoint,
    )

    with tempfile.TemporaryDirectory() as tmp:
        data, out, cache = (os.path.join(tmp, d) for d in ("data", "out", "cache"))
        t0 = time.perf_counter()
        write_fixture(data, **CLI_FIXTURE)
        argv = (["--data_dir_azure", data, "--output_dir", out, "--cache_dir", cache]
                + TRAIN_CLI_FLAGS)
        cfg, train_dc, val_dc, tc = train_main.configs_from_args(
            train_main.build_parser().parse_args(argv))
        cfg = cfg.replace(topn=train_dc.topn, only_obj=train_dc.only_obj)
        print(f"train_cli: fixture tree written in {time.perf_counter() - t0:.1f} s; "
              f"{cfg.num_classes} classes, hidden {cfg.hidden_size}, {cfg.num_blocks} blocks, "
              f"vocab {cfg.vocab_size} x {cfg.glove_dim}, {cfg.compute_dtype}, bs {B}",
              flush=True)

        # epoch 1: every K1, K2, K3 launch counted and its inputs kept
        seen = {}
        reset_launch_counts()
        t0 = time.perf_counter()
        with recorded_kernel_inputs(seen):
            state = train_main.main(argv + ["--num_epochs", "1"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launch_counts()
        n_steps = state.step
        logged = logged_step_losses(out)
        for line in log_lines(out, "trained") + log_lines(out, "accuracy"):
            print(f"train_cli: epoch 1: {line}", flush=True)
        EPOCH_LINES["train_cli"] = log_lines(out, "trained")[-1]
        n_val = len(BatchLoader(GQASuperNodeDataset("val", val_dc), B, shuffle=False,
                                batch_cache_dir=f"{cache}/val_batches").replay_cache())
        forwards = 2 * n_steps + n_val     # the steps, then eval on train and on val
        want = {"K1": K1_PER_FORWARD * forwards, "K2": K2_PER_STEP * n_steps,
                "K3": K3_PER_FORWARD * forwards, "K4": 0, "K5": 0, "K6": 0}
        check(launches == want and len(logged) == n_steps > 0
              and int(state.table_opt.count) == n_steps,
              f"train_cli: epoch 1 took {n_steps} sparse steps and eval over {n_steps} train "
              f"and {n_val} val batches: launches {launches} == {want} (24 K1, 24 K2 and 24 "
              "K3 a step, 24 K1 and 24 K3 an eval batch)")
        check(all(np.isfinite(v) for _, _, v in logged),
              f"train_cli: {len(logged)} finite step losses logged, from {logged[0][2]:.5f} to "
              f"{logged[-1][2]:.5f}")
        size = os.path.getsize(checkpoint_path(f"{out}/checkpoints", 1))
        print(f"train_cli: epoch 1 (cold loader, {n_steps} steps, eval, checkpoint of "
              f"{size / 2 ** 30:.2f} GiB) in {seconds:.1f} s on {card}", flush=True)
        cli_kernels_against_plain(seen, "train_cli")
        del state, seen
        torch.cuda.empty_cache()

        # the same step in-process over the same batches (the first epoch was
        # the replay cache's build pass: the loader's shuffled epoch-0 order),
        # from the weights and the generator the CLI starts from
        model = new_model(cfg, tc.seed, "cuda")
        hand = create_train_state(model, tc.lr, tc.warmup_steps, sparse_table=True)
        step = make_train_step(model, hand.optimizer, cfg, with_milnce=tc.with_milnce,
                               sparse_table=True)
        gen = torch.Generator(device="cuda").manual_seed(tc.seed + 1)
        loader = BatchLoader(GQASuperNodeDataset("train", train_dc), B, shuffle=True,
                             seed=tc.seed, cache_dir=f"{cache}/train")
        batches = [host_tensors(b, True).to("cuda") for b in loader]
        mine = [step(hand, batch, gen)["loss"].item() for batch in batches]
        diffs = [abs(a - c) / abs(c) for (_, _, a), c in zip(logged, mine)]
        check(len(mine) == len(logged) and max(diffs) <= TRAIN_CLI_LOSS_RTOL,
              f"train_cli: the {len(logged)} logged losses equal an in-process loop's within "
              f"{max(diffs):.3g} <= {TRAIN_CLI_LOSS_RTOL:g} relative (bitwise: "
              f"{sum(d == 0 for d in diffs)} of {len(diffs)})")
        del model, hand, step
        torch.cuda.empty_cache()
        dense_against_sparse_step(cfg, batches[0], card)
        del batches

        # resumed: epochs 2 and 3 from device-resident batches, a checkpoint
        # after epoch 2 only (two in all); the profile window in epoch 2, so
        # that epoch 3's rate is free of it
        t0 = time.perf_counter()
        reset_launch_counts()
        state = train_main.main(argv + ["--num_epochs", "3", "--checkpoint_every", "2",
                                        "--profile_steps", str(PROFILE_STEPS)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        resumed = log_lines(out, "resumed from epoch 1")
        resident = log_lines(out, "device-resident")
        per = launch_counts()["K2"] / max(state.step - n_steps, 1)
        check(len(resumed) == 1 and len(resident) == 2 and per == K2_PER_STEP
              and state.step == 3 * n_steps,
              f"train_cli: the resumed run logs '{resumed[0] if resumed else 'nothing'}' and "
              f"'{resident[0] if resident else 'no device-resident batches'}', takes "
              f"{state.step - n_steps} steps with {per:g} K2 launches each")
        for line in log_lines(out, "trained") + log_lines(out, "accuracy"):
            print(f"train_cli: epochs 2-3: {line}", flush=True)
        traces = os.listdir(f"{out}/profile")
        check(len(traces) == 1, f"train_cli: --profile_steps wrote {traces}")
        busy, window, idle = trace_idle_share(f"{out}/profile/{traces[0]}")
        print(f"train_cli: {PROFILE_STEPS} steps of the CLI's epoch 2 (--profile_steps, "
              f"resident batches): window {window:.3f} ms, device busy {busy:.3f} ms, idle "
              f"share {idle:.3f} on {card} (information only)", flush=True)
        print(f"train_cli: epochs 2-3 (resume, resident batches, {state.step - n_steps} steps, "
              f"eval, a checkpoint) in {seconds:.1f} s", flush=True)
        del state
        torch.cuda.empty_cache()

        # the predict CLI, float and --int8, against the in-process predict
        # step on the same val batches: on the checkpoint the CLI wrote, and
        # on a copy whose answer heads' biases are shifted so that the
        # answers spread over the classes (trained this briefly, the model
        # gives every question one answer, which any row would match)
        ckpt = f"{out}/checkpoints"
        model = AttModelX3(cfg)
        load_params_for_eval(ckpt, model)
        val = [host_tensors(b).to("cuda") for b in BatchLoader(
            GQASuperNodeDataset("val", val_dc), B, shuffle=False, drop_last=False)]
        spread = AttModelX3(cfg)
        spread.load_state_dict(model.state_dict())
        spread_answers_(spread, val[0])
        save_checkpoint(f"{tmp}/spread", TrainState(spread, adam(spread.parameters())), 2)
        for name, m, weights in (("trained", model, ckpt), ("spread", spread, f"{tmp}/spread")):
            qmodel = AttModelX3(cfg.replace(int8_serving=True))
            qmodel.load_state_dict(quantize_state_dict(m.state_dict()))
            written = []
            for what, mm, extra in (("float", m, []), ("int8", qmodel, ["--int8"])):
                predict = make_predict_step(mm)
                ref = [int(a) for b in val
                       for a, ok in zip(predict(b).cpu(), b.sample_valid.cpu()) if ok]
                answers = os.path.join(tmp, f"answers_{name}_{what}.jsonl")
                logs = os.path.join(tmp, f"predict_{name}_{what}")
                reset_launch_counts()
                n_out = predict_cli.main(argv + ["--weight_dir", weights, "--split", "val",
                                                 "--out", answers, "--output_dir", logs] + extra)
                counts = launch_counts()
                with open(answers) as f:
                    got = [json.loads(line)["answer_id"] for line in f]
                written.append(got)
                check(n_out == len(got) == len(ref) > 0 and got == ref
                      and counts["K1"] == counts["K3"] == K1_PER_FORWARD * len(val),
                      f"train_cli: predict CLI ({what}) on the {name} checkpoint: {len(got)} "
                      f"answers equal the in-process predict step's ({len(set(got))} "
                      f"distinct), {counts['K1']} K1 and {counts['K3']} K3 launches over "
                      f"{len(val)} batches")
                if name == "trained":
                    rate = log_lines(logs, "predicted")
                    batches = full_batches(cfg, REQUESTS)
                    predict(batches[0])
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for b in batches:
                        predict(b)
                    torch.cuda.synchronize()
                    pairs = REQUESTS * B / (time.perf_counter() - t0)
                    print(f"train_cli: {what} serving: model {model_bytes(mm) / 2 ** 20:.1f} MiB "
                          f"on the card; {pairs:.1f} pairs/s over {REQUESTS} synthetic bs-{B} "
                          f"requests; the predict CLI: {rate[-1] if rate else 'no rate logged'} "
                          f"on {card} (information only)", flush=True)
            agree = sum(a == b for a, b in zip(*written))
            print(f"train_cli: {name} checkpoint: int8 answers equal float answers on {agree} "
                  f"of {len(written[0])} val questions (information only)", flush=True)
            del qmodel
        del model, spread, val
        torch.cuda.empty_cache()
    table_other_breakdown(card)
    return launches


# the packed phase: the training CLI with --n_pack 4 into bucket 1 of the
# default buckets at maxlen 450, (lv, ls, lq) = (100, 216, 40): the visual
# encoder at L 140, the symbolic one at L 256, the decoders at 4 queries
PACK_FLAGS = ["--n_pack", "4", "--pack_bucket", "1"]
PACK_SHAPE = (100, 216, 40)
N_PACK = 4
# a packed slot against its sample collated alone, f32 with the kernels on
# both sides: the same model, only the softmax normalizer (the other
# segments' keys, weighed 0 after the graph multiply) and the kernels' tile
# order differ
ISOLATION_TOL_F32 = 1e-4
# the same in bf16, relative to the largest |logit|: one bf16 rounding of
# the attention probabilities can land the other way (2^-8) and 6 blocks of
# two encoders carry it on; a key of another segment leaking in moves a
# logit by O(1)
ISOLATION_RTOL_BF16 = 2 ** -4
# the training CLI's epoch lines, by phase, to set the packed epoch beside
# the unpacked one
EPOCH_LINES: dict = {}


def packed_rows(samples, n_rows: int):
    """First-fit (the loader's rule) of ``samples`` into at most ``n_rows``
    rows of PACK_SHAPE with N_PACK slots; returns the groups."""
    from structured_alignment_vqa_tpu_torch.data.dataset import BatchShape
    from structured_alignment_vqa_tpu_torch.data.packing import PackedRow

    shape = BatchShape(*PACK_SHAPE)
    rows = []
    for s in samples:
        if s is None or not shape.fits(s):
            continue
        row = next((r for r in rows if r.fits(s)), None)
        if row is None:
            if len(rows) == n_rows:
                break
            row = PackedRow(shape, N_PACK)
            rows.append(row)
        row.add(s)
    return [r.samples for r in rows]


def join_packed(records: dict, groups) -> tuple:
    """The decisions of each run of :func:`slot_logits`' samples alone (B
    a run, in group order) from the packed run's: a sample's tokens sit at
    its slot's offsets in its packed row (as ``packed_rows`` and
    ``collate_packed`` place them) and at 0 alone, on the visual, macro and
    question axes and on the encoders' (modality ++ question); its decoder
    token and head rows at its slot (the decoder's self-attention runs at
    (B * N_PACK, 1, C)). The rest of a row alone is padding, whose
    decisions it takes as its own. Returns ([a run's records, each call a
    pair (records, defined)], the calls whose axis was not found)."""
    lv, ls, lq = PACK_SHAPE
    places = []   # (row, slot, (offset, length) on the visual, macro and question axes)
    for i, g in enumerate(groups):
        vo = mo = qo = 0
        for k, s in enumerate(g or []):
            no, nm, nq = s.vis_fea.shape[0], len(s.macro_ids), len(s.q_ids)
            places.append((i, k, (vo, no), (mo, nm), (qo, nq)))
            vo, mo, qo = vo + no, mo + nm, qo + nq
    # a token axis by its length: its segments (start alone and packed, axis)
    axes = {lv: [(0, 2)], ls: [(0, 3)], lq: [(0, 4)], lv + lq: [(0, 2), (lv, 4)],
            ls + lq: [(0, 3), (ls, 4)]}
    rows = len(groups)

    def source(chunk, shape):
        """Each place of a run alone: its flat index into the packed call's
        first two axes, -1 where it has none; None for another layout."""
        if tuple(shape[:2]) in ((rows * N_PACK, 1), (rows, N_PACK)):   # slots
            return torch.tensor([[p[0] * N_PACK + p[1]] for p in chunk])
        if shape[0] != rows or shape[1] not in axes:
            return None
        src = torch.full((len(chunk), shape[1]), -1, dtype=torch.long)
        for t, p in enumerate(chunk):
            for start, axis in axes[shape[1]]:
                off, n = p[axis]
                src[t, start:start + n] = p[0] * shape[1] + start + off + torch.arange(n)
        return src

    runs, unmapped = [], []
    for c in range(0, len(places), B):
        chunk = places[c:c + B]
        calls = {}
        for site, recorded in records["calls"].items():
            calls[site] = []
            for i, rec in enumerate(recorded):
                src = source(chunk, rec.shape)
                if src is None:
                    unmapped.append(f"{site} call {i} {tuple(rec.shape)}")
                    src = torch.full((len(chunk), 1), -1, dtype=torch.long)
                src = src.to(rec.device)
                flat = rec.reshape(-1, *rec.shape[2:])
                keep = flat[src.clamp_min(0)]
                defined = (src >= 0).reshape(*src.shape, *[1] * (rec.dim() - 2))
                calls[site].append((keep, defined))
        runs.append({"calls": calls})
    return runs, unmapped


def slot_logits(model, groups, topn: int, bf16_features: bool, pins: "list | None" = None):
    """The model's three logits on ``groups`` packed into rows of PACK_SHAPE
    (B, N_PACK, C), and on each of their samples alone through the tight
    collate at the same shape (n, C), in group order. Given a list
    ``pins``, the runs alone take the packed run's decisions
    (:func:`join_packed`; a Pins a run appended to it)."""
    from structured_alignment_vqa_tpu_torch.data.dataset import BatchShape
    from structured_alignment_vqa_tpu_torch.data.packing import collate_packed
    from structured_alignment_vqa_tpu_torch.data.transfer import host_tensors

    shape = BatchShape(*PACK_SHAPE)

    def run(gs, n_pack, taking=None):
        batch = host_tensors(collate_packed(gs, shape, topn, n_pack), bf16_features).to("cuda")
        with torch.inference_mode(), \
                pinned_decisions(model, taking) if taking else contextlib.nullcontext():
            return [t.float() for t in model.eval()(batch)[:3]]

    alone = [s for g in groups for s in (g or [])]
    if pins is None:
        packed = run(groups, N_PACK)
        tight = [run([[s] for s in alone[i:i + B]], 1) for i in range(0, len(alone), B)]
    else:
        with recorded_decisions(model) as decisions:
            packed = run(groups, N_PACK)
        with torch.inference_mode():
            joined, unmapped = join_packed(decisions, groups)
        check(not unmapped, f"packed: every call's axis of the packed run found ({unmapped})")
        taking = [Pins(d) for d in joined]
        pins += taking
        tight = [run([[s] for s in alone[i:i + B]], 1, p)
                 for i, p in zip(range(0, len(alone), B), taking)]
    tight = [torch.cat([t[h][:, 0] for t in tight]) for h in range(3)]
    valid = torch.tensor([[k < len(g or []) for k in range(N_PACK)] for g in groups],
                         device="cuda")
    return [p[valid] for p in packed], tight


def isolation_err(packed, tight, relative: bool) -> tuple:
    """(max |packed slot - its sample alone| over the three heads, divided
    by the largest |logit| when ``relative``; the share of equal answers)."""
    err = max((p - t).abs().max().item() / (t.abs().max().item() if relative else 1.0)
              for p, t in zip(packed, tight))

    def answers(logits):
        return torch.stack([torch.log_softmax(x, -1) for x in logits]).sum(0).argmax(-1)

    return err, (answers(packed) == answers(tight)).float().mean().item()


def packed_kernel_times(seen: dict, counts: dict, what: str) -> None:
    """K1, K2 and K3 at each bf16 shape the packed CLI gave them, on the
    model's own inputs: kernel and plain time, bound, and the launches at
    that shape in ``what``. Information only."""
    from structured_alignment_vqa_tpu_torch.ops import fused_ffn as k3
    from structured_alignment_vqa_tpu_torch.ops import fused_graph_attention as k1

    for (key, sig), args in sorted(seen.items(), key=lambda kv: str(kv[0])):
        x = args[0]
        if x.dtype != torch.bfloat16:
            continue
        n = counts[key, sig]
        if key == "K3":
            rows = x.numel() // x.shape[-1]
            ms = time_ms(lambda: k3.fused_ffn(*args))
            plain_ms = time_ms(lambda: k3.ffn_ln_plain(*args))
            nbytes = 2 * (2 * rows * C + 2 * C * HIDDEN + HIDDEN + C) + 8 * C
            bnd = bound(nbytes, 4.0 * rows * C * HIDDEN, x.dtype)
            label = f"rows={rows}"
        else:
            b, tq, tk = x.shape[0], x.shape[1], args[1].shape[1]
            if key == "K1":
                ms = time_ms(lambda: k1.fused_graph_attention_ln(*args))
                plain_ms = time_ms(lambda: k1.graph_attention_ln_plain(*args))
                nbytes = 2 * b * C * (3 * tq + 2 * tk) + 4 * b * (tq + tk + tq * tk) + 8 * C
                bnd = bound(nbytes, 4.0 * b * tq * tk * C, x.dtype)
            else:
                ms = time_ms(lambda: k1.fused_graph_attention_ln_bwd(*args))
                plain_ms = time_ms(lambda: k1.graph_attention_ln_bwd_plain(*args))
                nbytes = 2 * b * C * (5 * tq + 4 * tk) + 4 * b * (tq + tk + tq * tk) + 12 * C
                bnd = bound(nbytes, 12.0 * b * tq * tk * C, x.dtype)
            label = f"{'self' if tq == tk else 'cross'} B={b} Tq={tq} Tk={tk}"
        print(f"packed: {key} {label} bf16: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bnd[0] * 1e3:.2f} us ({bnd[1]}), {n} launches in {what} on the card "
              "(information only)", flush=True)


def packed_phase(card: str) -> dict:
    """Packed training through the training CLI at full obj-only width, tight
    eval and the predict CLI on its checkpoint; isolation of packed samples
    on the card; the MCB head serving, training and through the predict
    CLI."""
    import os
    import tempfile

    from structured_alignment_vqa_tpu_torch.data.dataset import (
        BatchLoader,
        BatchShape,
        GQASuperNodeDataset,
    )
    from structured_alignment_vqa_tpu_torch.data.fixtures import write_fixture
    from structured_alignment_vqa_tpu_torch.data.packing import collate_packed
    from structured_alignment_vqa_tpu_torch.data.transfer import host_tensors
    from structured_alignment_vqa_tpu_torch.models import AttModelX3
    from structured_alignment_vqa_tpu_torch.parallel.train_step import (
        TrainState,
        adam,
        create_train_state,
        make_train_step,
    )
    from structured_alignment_vqa_tpu_torch.train import main as train_main
    from structured_alignment_vqa_tpu_torch.train import predict as predict_cli
    from structured_alignment_vqa_tpu_torch.train.loop import new_model
    from structured_alignment_vqa_tpu_torch.train.predict import make_predict_step
    from structured_alignment_vqa_tpu_torch.utils.checkpoint import (
        load_params_for_eval,
        save_checkpoint,
    )
    from structured_alignment_vqa_tpu_torch.utils.profiling import start_trace, stop_trace

    def predict_cli_check(what, argv, weights, model, val, extra=()):
        """The predict CLI on ``weights`` against the in-process predict step
        of ``model`` on the same val batches."""
        predict = make_predict_step(model)
        ref = [int(a) for b in val for a, ok in zip(predict(b).cpu(), b.sample_valid.cpu())
               if ok]
        answers = os.path.join(tmp, f"answers_{what}.jsonl")
        reset_launch_counts()
        n_out = predict_cli.main(argv + ["--weight_dir", weights, "--split", "val", "--out",
                                         answers, "--output_dir", os.path.join(tmp, what)]
                                 + list(extra))
        counts = launch_counts()
        with open(answers) as f:
            got = [json.loads(line)["answer_id"] for line in f]
        check(n_out == len(got) == len(ref) > 0 and got == ref
              and counts["K1"] == counts["K3"] == K1_PER_FORWARD * len(val),
              f"packed: predict CLI ({what}): {len(got)} answers equal the in-process predict "
              f"step's ({len(set(got))} distinct), {counts['K1']} K1 and {counts['K3']} K3 "
              f"launches over {len(val)} batches")

    with tempfile.TemporaryDirectory() as tmp:
        data, out, cache = (os.path.join(tmp, d) for d in ("data", "out", "cache"))
        write_fixture(data, **CLI_FIXTURE)
        argv = (["--data_dir_azure", data, "--output_dir", out, "--cache_dir", cache]
                + TRAIN_CLI_FLAGS + PACK_FLAGS)
        cfg, train_dc, val_dc, tc = train_main.configs_from_args(
            train_main.build_parser().parse_args(argv))
        cfg = cfg.replace(topn=train_dc.topn, only_obj=train_dc.only_obj)

        # (a) one packed epoch of the training CLI, every K1, K2, K3 launch
        # counted and its inputs kept
        seen, counts = {}, {}
        reset_launch_counts()
        t0 = time.perf_counter()
        with recorded_kernel_inputs(seen, counts):
            state = train_main.main(argv + ["--num_epochs", "1"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launch_counts()
        n_steps = state.step
        logged = logged_step_losses(out)
        n_val = len(BatchLoader(GQASuperNodeDataset("val", val_dc), B, shuffle=False,
                                tight=True, batch_cache_dir=f"{cache}/val_batches"
                                ).replay_cache())
        forwards = 2 * n_steps + n_val     # the steps, then eval on train and on val
        want = {"K1": K1_PER_FORWARD * forwards, "K2": K2_PER_STEP * n_steps,
                "K3": K3_PER_FORWARD * forwards, "K4": 0, "K5": 0, "K6": 0}
        check(launches == want and len(logged) == n_steps > 0
              and int(state.table_opt.count) == n_steps,
              f"packed: epoch 1 took {n_steps} packed sparse steps and eval over {n_steps} "
              f"packed train and {n_val} tight val batches: launches {launches} == {want} (24 "
              "K1, 24 K2 and 24 K3 a step, 24 K1 and 24 K3 an eval batch)")
        shapes = sorted({(k, sig[0], sig[1]) for k, sig in seen if k == "K1"})
        check({s[1][1:] for s in shapes} >= {(140, C), (256, C), (N_PACK, C)},
              f"packed: K1 ran at {[(s[1], s[2]) for s in shapes]}: self-attention at L 140 "
              f"and 256, the decoders' cross-attention at Tq {N_PACK}")
        for line in log_lines(out, "trained") + log_lines(out, "accuracy"):
            print(f"packed: epoch 1: {line}", flush=True)
        print(f"packed: epoch 1 (cold loader, {n_steps} steps, eval, checkpoint) in "
              f"{seconds:.1f} s on {card}", flush=True)
        cli_kernels_against_plain(seen, "packed")
        del state
        torch.cuda.empty_cache()

        # the same step in-process over the same batches, from the weights
        # and the generator the CLI starts from
        model = new_model(cfg, tc.seed, "cuda")
        hand = create_train_state(model, tc.lr, tc.warmup_steps, sparse_table=True)
        step = make_train_step(model, hand.optimizer, cfg, with_milnce=tc.with_milnce,
                               sparse_table=True)
        gen = torch.Generator(device="cuda").manual_seed(tc.seed + 1)
        loader = BatchLoader(GQASuperNodeDataset("train", train_dc), B, shuffle=True,
                             seed=tc.seed, n_pack=N_PACK, pack_bucket=tc.pack_bucket,
                             cache_dir=f"{cache}/train")
        host = list(loader)
        batches = [host_tensors(b, True).to("cuda") for b in host]
        mine = [step(hand, batch, gen)["loss"].item() for batch in batches]
        diffs = [abs(a - c) / abs(c) for (_, _, a), c in zip(logged, mine)]
        check(len(mine) == len(logged) and max(diffs) <= TRAIN_CLI_LOSS_RTOL,
              f"packed: the {len(logged)} logged losses equal an in-process loop's within "
              f"{max(diffs):.3g} <= {TRAIN_CLI_LOSS_RTOL:g} relative (bitwise: "
              f"{sum(d == 0 for d in diffs)} of {len(diffs)})")
        valid = sum(int(b.sample_valid.sum()) for b in host)
        rows = sum(b.sample_valid.shape[0] for b in host)
        print(f"packed: {valid} samples in {rows} rows, {valid / rows:.3f} samples a row "
              f"(bucket {PACK_SHAPE}, up to {N_PACK}); the packed epoch: "
              f"{log_lines(out, 'trained')[-1]}; the unpacked train_cli epoch: "
              f"{EPOCH_LINES.get('train_cli', 'not run in this call')} on {card} "
              "(information only)", flush=True)
        # device busy of one packed step against one unpacked step at the
        # training phase's bucket (36, 30, 98), then the idle share of 5
        # in-process packed steps (the batches already on the card)
        busy = {}
        for what, batch, n in (("packed", batches[0], int(host[0].sample_valid.sum())),
                               ("unpacked (36, 30, 98)", full_batches(cfg, 1)[0], B)):
            by_name = profile_device(lambda: step(hand, batch, gen),
                                     f"one {what} bs-{B} sparse training step")
            busy[what] = sum(us for _, us in by_name.values()) / 1e3
            if busy[what] > 0:
                print(f"packed: {what} step: device busy {busy[what]:.3f} ms for {n} samples, "
                      f"{n / busy[what]:.3f} samples per device-ms on {card} "
                      "(information only)", flush=True)
        torch.cuda.synchronize()
        tracing = start_trace()
        for batch in batches[:PROFILE_STEPS]:
            step(hand, batch, gen)
        torch.cuda.synchronize()
        trace = stop_trace(tracing, os.path.join(tmp, "profile"))
        busy_ms, window, idle = trace_idle_share(trace)
        print(f"packed: {PROFILE_STEPS} in-process packed steps: window {window:.3f} ms, device "
              f"busy {busy_ms:.3f} ms, idle share {idle:.3f} on {card} (information only)",
              flush=True)
        packed_kernel_times(seen, counts, f"the epoch ({n_steps} steps, {forwards} forwards)")
        del model, hand, step, batches, seen
        torch.cuda.empty_cache()

        # tight eval already ran in the epoch; the predict CLI on the packed
        # run's checkpoint, its answers spread over the classes
        val = [host_tensors(b).to("cuda") for b in BatchLoader(
            GQASuperNodeDataset("val", val_dc), B, shuffle=False, drop_last=False)]
        model = AttModelX3(cfg)
        load_params_for_eval(f"{out}/checkpoints", model)
        spread_answers_(model, val[0])
        save_checkpoint(f"{tmp}/spread", TrainState(model, adam(model.parameters())), 1)
        predict_cli_check("packed-trained, spread", argv, f"{tmp}/spread", model, val)
        del model
        torch.cuda.empty_cache()

        # (b) isolation on the card: B rows of val samples packed first-fit,
        # then a row of padding only and a row holding one sample whose
        # region features are all zero (its visual keys all masked) and
        # three empty slots
        ds = GQASuperNodeDataset("val", val_dc)
        samples = [ds.sample(i) for i in range(len(ds))]
        groups = packed_rows(samples, B - 2)
        blank = next(s for s in samples if s is not None)
        blank = dataclasses.replace(blank, vis_fea=np.zeros_like(blank.vis_fea))
        groups += [None, [blank]]
        n_slots = sum(len(g or []) for g in groups)
        # the samples alone take the packed run's decisions (join_packed)
        model = random_model(cfg.replace(compute_dtype=torch.float32))
        pins = []
        err, same = isolation_err(*slot_logits(model, groups, cfg.topn, False, pins),
                                  relative=False)
        for r, taken in enumerate(pins):
            pins_hold(f"packed: isolation f32, run alone {r}", taken)
        check(err <= ISOLATION_TOL_F32 and same == 1.0,
              f"packed: isolation f32 with the kernels, {n_slots} samples in {len(groups)} rows "
              f"of {PACK_SHAPE}: max|packed slot - the sample alone (tight)| {err:.3g} <= "
              f"{ISOLATION_TOL_F32:g}, answers equal for {same:.4f}")
        pair_line("packed isolation f32", err, ISOLATION_TOL_F32, pins)
        del pins
        model16 = random_model(cfg)
        model16.load_state_dict(model.state_dict())
        errs = {}
        for what in ("kernels", "plain"):
            with plain_path() if what == "plain" else contextlib.nullcontext():
                errs[what] = isolation_err(*slot_logits(model16, groups, cfg.topn, True),
                                           relative=True)
        check(errs["kernels"][0] <= ISOLATION_RTOL_BF16,
              f"packed: isolation bf16, kernels: max|packed slot - alone| / max|logit| "
              f"{errs['kernels'][0]:.3g} <= {ISOLATION_RTOL_BF16:g} (answers equal for "
              f"{errs['kernels'][1]:.4f}); the plain path: {errs['plain'][0]:.3g} (answers "
              f"{errs['plain'][1]:.4f})")
        packed16 = host_tensors(collate_packed(groups, BatchShape(*PACK_SHAPE), cfg.topn,
                                               N_PACK), True).to("cuda")
        del model, model16
        torch.cuda.empty_cache()

        # (c) the MCB head at full width
        mcfg = full_config(use_mcb=True)
        model = random_model(mcfg)
        requests = full_batches(mcfg, REQUESTS)
        predict = make_predict_step(model)
        predict(requests[0])
        reset_launch_counts()
        answers = [predict(b) for b in requests]
        torch.cuda.synchronize()
        mcb_launches = launch_counts()
        check(all(a.shape == (B,) and 0 <= int(a.min()) and int(a.max()) < mcfg.num_classes
                  for a in answers)
              and mcb_launches["K1"] == mcb_launches["K3"] == K1_PER_FORWARD * REQUESTS,
              f"packed: MCB serving bf16: {REQUESTS} x {B} answers in range, launches "
              f"{mcb_launches} ({K1_PER_FORWARD} K1 and {K3_PER_FORWARD} K3 a forward)")
        by_name = profile_device(lambda: predict(requests[0]), f"one MCB bs-{B} request")
        fft_us = sum(us for k, (_, us) in by_name.items() if "fft" in k.lower())
        print(f"packed: MCB request: FFT kernels {fft_us / 1e3:.3f} ms of "
              f"{sum(us for _, us in by_name.values()) / 1e3:.3f} ms device busy on {card} "
              "(information only)", flush=True)
        model32 = random_model(mcfg.replace(compute_dtype=torch.float32))
        model32.load_state_dict(model.state_dict())
        predict32 = make_predict_step(model32)
        with torch.inference_mode():
            with recorded_decisions(model32) as decisions:
                kernel = [t.float() for t in model32.eval()(requests[0])[:3]]
            kernel_answers = predict32(requests[0])
            pins = [Pins(decisions), Pins(decisions)]
            with plain_path():
                with pinned_decisions(model32, pins[0]):
                    plain = [t.float() for t in model32(requests[0])[:3]]
                with pinned_decisions(model32, pins[1]):
                    plain_answers = predict32(requests[0])
        for taken in pins:
            pins_hold("packed: MCB f32: the plain path", taken)
        diff = max((a - b).abs().max().item() for a, b in zip(kernel, plain))
        check(diff <= LOGIT_TOL_F32 and bool(torch.equal(kernel_answers, plain_answers)),
              f"packed: MCB f32: max|logits kernel - plain| {diff:.3g} <= {LOGIT_TOL_F32:g}, "
              "answers identical")
        pair_line("MCB f32 logits", diff, LOGIT_TOL_F32, pins)
        del decisions, pins
        del model32
        sketches = [model.mcb.sketch1.clone(), model.mcb.sketch2.clone()]
        head = model.cls_mcb[0].weight.detach().clone()
        opt = adam(model.parameters(), lr=1e-4)
        mstep = make_train_step(model, opt, mcfg)
        gen = torch.Generator(device="cuda").manual_seed(5)
        for what, batch in (("unpacked", requests[0]), ("packed", None)):
            if batch is None:   # the isolation rows, with this model's classes
                batch = dataclasses.replace(packed16, answer=packed16.answer % mcfg.num_classes)
            reset_launch_counts()
            m = mstep(TrainState(model, opt), batch, gen)
            torch.cuda.synchronize()
            counts_step = launch_counts()
            check(np.isfinite(m["loss"].item()) and m["skipped"].item() == 0
                  and counts_step["K2"] == K2_PER_STEP
                  and not torch.equal(model.cls_mcb[0].weight, head)
                  and torch.equal(model.mcb.sketch1, sketches[0])
                  and torch.equal(model.mcb.sketch2, sketches[1]),
                  f"packed: one {what} MCB bf16 training step: loss {m['loss'].item():.5f} "
                  f"finite, not skipped, {counts_step['K2']} K2 launches, cls_mcb moved, "
                  "the sketches bitwise unchanged")
        del model, opt, mstep, requests
        torch.cuda.empty_cache()

        # the predict CLI --mcb on a saved checkpoint of the CLI's own
        # configuration (the fixture's classes), answers spread
        margv = argv + ["--mcb"]
        ccfg, _, _, _ = train_main.configs_from_args(train_main.build_parser().parse_args(margv))
        model = random_model(ccfg.replace(topn=train_dc.topn))
        spread_answers_(model, val[0])
        save_checkpoint(f"{tmp}/mcb", TrainState(model, adam(model.parameters())), 1)
        predict_cli_check("mcb", margv, f"{tmp}/mcb", model, val)
        del model, val
        torch.cuda.empty_cache()
    return launches


# the dp phase: two ranks on the one card over gloo with CUDA tensors (NCCL
# refuses two ranks on one device), each a worker process running this
# script with --dp-rank; the parent holds their f32 steps against its own
# single-process step on the whole batch
DP_WORLD = 2
DP_BF16_STEPS = 3
DP_LOSS_TOL = 1e-5
# each gradient by the norm of its difference over its own norm; a wrong
# reduction (a share counted world times, or missing) moves it by O(1)
DP_GRAD_TOL = 1e-4
# obj+rel at bs 4 only: a gradient may exceed DP_GRAD_TOL up to
# DP_SPREAD_MULT times its own spread in the one process (the same
# gradient from its plain path against its kernels: the same function
# summed in other orders), and never above DP_GRAD_CAP; the phase prints
# each of the largest errors beside that gradient's spread
DP_SPREAD_MULT = 4
DP_GRAD_CAP = 5e-3
# the NCCL group of one: the training CLI on a tree of the cli phase's
# kind, cut to 4 bs-128 steps an epoch so that two runs fit the phase
DP_CLI_FIXTURE = dict(CLI_FIXTURE, n_questions=512, n_images=32)


def batch_rows(batch, rank: int, world: int):
    """Rank ``rank``'s rows of a global batch (rank-major halves)."""
    n = batch.batch_size // world
    return dataclasses.replace(batch, **{
        f.name: getattr(batch, f.name)[rank * n:(rank + 1) * n]
        for f in dataclasses.fields(batch) if getattr(batch, f.name) is not None})


def state_digest(state) -> str:
    """sha256 of every parameter and of the sparse table's Adam state."""
    import hashlib

    h = hashlib.sha256()
    tensors = list(state.model.parameters())
    if state.table_opt is not None:
        tensors += [state.table_opt.count, state.table_opt.mu, state.table_opt.nu]
    for t in tensors:
        h.update(t.detach().reshape(-1).contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def dp_cases() -> list:
    """(name, config, global batch, sparse) of the f32 steps held against
    the single process: dropout 0, so that no mask is drawn."""
    cfg = full_config(compute_dtype=torch.float32, dropout_rate=0.0)
    rel = rel_config(compute_dtype=torch.float32, dropout_rate=0.0)
    return [("obj-only f32", cfg, lambda: full_batches(cfg, 1)[0], False),
            ("obj-only f32 sparse", cfg, lambda: full_batches(cfg, 1)[0], True),
            ("obj+rel f32", rel, lambda: rel_batches(rel, 1)[0], False)]


def dp_worker(rank: int, coordinator: str, out: str) -> int:
    """One rank of the dp phase: the f32 steps (rank 0 saves its summed
    gradients, every rank the decisions it took), then bf16 steps with dropout, dense and sparse, with their
    digests, launches, times and the reduction's bytes and time."""
    from structured_alignment_vqa_tpu_torch.parallel.mesh import init_distributed, shutdown
    from structured_alignment_vqa_tpu_torch.parallel.sharding import all_reduce_grads
    from structured_alignment_vqa_tpu_torch.parallel.train_step import (
        create_train_state,
        make_train_step,
        shard_state,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = init_distributed(coordinator, DP_WORLD, rank, backend="gloo", device="cuda:0")
    results = {}
    try:
        for name, cfg, make_batch, sparse in dp_cases():
            model = random_model(cfg, seed=3)
            state = shard_state(create_train_state(model, 1e-4, sparse_table=sparse), mesh)
            step = make_train_step(model, state.optimizer, cfg, sparse_table=sparse, mesh=mesh)
            batch = batch_rows(make_batch(), rank, DP_WORLD)
            reset_launch_counts()
            with recorded_decisions(model) as decisions:
                m = step(state, batch, torch.Generator(device="cuda").manual_seed(11))
            torch.cuda.synchronize()
            results[name] = {"loss": m["loss"].item(), "n": m["n"].item(),
                             "launches": launch_counts(), "digest": state_digest(state),
                             "reduced_bytes": step.reduced_bytes}
            if rank == 0:
                torch.save({n: p.grad.cpu() for n, p in model.named_parameters()
                            if p.grad is not None}, f"{out}/grads_{len(results)}.pt")
            torch.save(decisions_to_cpu(decisions), f"{out}/decisions_{len(results)}_{rank}.pt")
            del model, state, step, batch, decisions
            torch.cuda.empty_cache()

        for sparse in (False, True):
            name = "obj-only bf16" + (" sparse" if sparse else "")
            cfg = full_config()
            model = random_model(cfg, seed=3)
            state = shard_state(create_train_state(model, 1e-4, sparse_table=sparse), mesh)
            step = make_train_step(model, state.optimizer, cfg, sparse_table=sparse, mesh=mesh)
            gen = torch.Generator(device="cuda").manual_seed(7 + (rank << 32))
            batches = [batch_rows(b, rank, DP_WORLD) for b in full_batches(cfg, DP_BF16_STEPS)]
            step(state, batches[0], gen)            # warm-up step
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            metrics = [step(state, b, gen) for b in batches[1:]]
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = {k: v / len(metrics) for k, v in launch_counts().items()}
            grads = [p.grad for p in model.parameters() if p.grad is not None]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            all_reduce_grads(grads, mesh)           # the dense gradients alone, again
            torch.cuda.synchronize()
            reduce_dense_s = time.perf_counter() - t0
            results[name] = {
                "losses": [m["loss"].item() for m in metrics],
                "skipped": sum(m["skipped"].item() for m in metrics),
                "digest": state_digest(state), "launches_per_step": launches,
                "step_s": seconds / len(metrics), "reduced_bytes": step.reduced_bytes,
                "reduce_s": reduce_dense_s,
                "reduce_bytes": sum(g.numel() * g.element_size() for g in grads)}
            if rank == 0:
                by_name = profile_device(lambda: step(state, batches[0], gen),
                                         f"dp rank 0, one {name} step (gloo on CUDA)")
                results[name]["profiled"] = bool(by_name)
            else:
                step(state, batches[0], gen)        # the profiled step's partner
            torch.cuda.synchronize()
            del model, state, step, batches, grads
            torch.cuda.empty_cache()
    finally:
        shutdown(mesh)
    torch.save(results, f"{out}/rank{rank}.pt")
    return 0


def nccl_one_rank_ms(nbytes: list) -> dict:
    """ms of an all-reduce of each size in ``nbytes`` over NCCL in a group
    of this process alone (CUDA events, 5 calls each)."""
    import torch.distributed as dist

    from structured_alignment_vqa_tpu_torch.parallel.dryrun import free_ports
    from structured_alignment_vqa_tpu_torch.parallel.mesh import init_distributed, shutdown

    mesh = init_distributed(f"127.0.0.1:{free_ports()[0]}", 1, 0, device="cuda:0")
    try:
        out = {}
        for n in nbytes:
            buf = torch.ones(n // 4, dtype=torch.float32, device="cuda")
            out[n] = time_ms(lambda: dist.all_reduce(buf, group=mesh.group), iters=5, warmup=2)
            del buf
        return out
    finally:
        shutdown(mesh)


def dp_against_spread(what: str, dp: tuple, single: tuple, plain: tuple) -> tuple:
    """The ranks' step ``dp`` against the one process's ``single``, each
    gradient held to the larger of DP_GRAD_TOL and DP_SPREAD_MULT times
    that gradient's own spread (``plain`` against ``single``), capped at
    DP_GRAD_CAP; prints the largest errors beside their spreads and returns
    :func:`compare_steps`' nearest gradient."""
    spread = grad_errors(plain, single, True)
    limit = {n: min(DP_GRAD_CAP, max(DP_GRAD_TOL, DP_SPREAD_MULT * spread[n][0]))
             if n in spread else DP_GRAD_TOL for n in single[1]}
    nearest = compare_steps(what, dp, single, DP_LOSS_TOL, limit, shift_free=True)
    errs = grad_errors(dp, single, True)
    errs.pop(None)
    above = [n for n in errs if errs[n][0] > DP_GRAD_TOL]
    print(f"  {len(above)} of {len(errs)} gradients above {DP_GRAD_TOL:g}; the largest, each "
          "beside its own spread in the one process (plain path against kernels):", flush=True)
    for n in sorted(errs, key=lambda n: -errs[n][0])[:6]:
        own = spread[n][0] if n in spread else float("nan")
        print(f"  {n}: ranks {errs[n][0]:.3g}, spread {own:.3g}, limit {limit[n]:.3g}",
              flush=True)
    return nearest


def dp_phase(card: str) -> dict:
    """Data parallel (ROADMAP item 15) on the card: two gloo ranks against
    one process at full width, bf16 ranks bitwise equal, the reduction's
    bytes and times, and the training CLI in an NCCL group of one."""
    import os
    import tempfile

    from structured_alignment_vqa_tpu_torch.data.fixtures import write_fixture
    from structured_alignment_vqa_tpu_torch.parallel.dryrun import free_ports, launch_local
    from structured_alignment_vqa_tpu_torch.train import main as train_main
    from structured_alignment_vqa_tpu_torch.utils.checkpoint import saved_epochs

    torch.cuda.empty_cache()
    mib = 2.0 ** 20
    with tempfile.TemporaryDirectory() as tmp:
        coordinator = f"127.0.0.1:{free_ports()[0]}"
        t0 = time.perf_counter()
        outs = launch_local([[sys.executable, os.path.abspath(__file__), "--dp-rank", str(r),
                              coordinator, tmp] for r in range(DP_WORLD)], timeout=600)
        print(f"dp: {DP_WORLD} ranks on cuda:0 over gloo ran in {time.perf_counter() - t0:.1f} s",
              flush=True)
        for r, text in enumerate(outs):
            for line in text.splitlines():
                print(f"dp rank {r}: {line}", flush=True)
        ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=True) for r in range(DP_WORLD)]
        for i, (name, cfg, make_batch, sparse) in enumerate(dp_cases(), 1):
            got = ranks[0][name]
            same = all(r[name]["digest"] == got["digest"] and r[name]["loss"] == got["loss"]
                       for r in ranks)
            want_launches = REL_STEP if "rel" in name else {
                "K1": K1_PER_FORWARD, "K2": K2_PER_STEP, "K3": K3_PER_FORWARD}
            want_launches = {**{k: 0 for k in got["launches"]}, **want_launches}
            check(same and all(r[name]["launches"] == want_launches for r in ranks),
                  f"dp {name}: {DP_WORLD} ranks hold bitwise-equal parameters and one global "
                  f"loss {got['loss']:.7g} over n {got['n']:g}; launches a rank {got['launches']}"
                  f" == {want_launches} (a single rank's at its rows)")
            grads = torch.load(f"{tmp}/grads_{i}.pt", weights_only=True)
            dp = (got["loss"], {n: g.to("cuda") for n, g in grads.items()}, got["launches"])
            # one process's steps take the ranks' decisions, their rows joined
            decisions = join_rows([torch.load(f"{tmp}/decisions_{i}_{r}.pt", weights_only=True)
                                   for r in range(DP_WORLD)])
            pins = {"kernel": Pins(decisions)}
            single = one_step(cfg, make_batch(), sparse=sparse, pins=pins["kernel"])
            for n in single[1]:
                dp[1].setdefault(n, None)
            what = f"dp {name}, {DP_WORLD} ranks against one process on the whole batch"
            if "rel" in name:
                pins["plain"] = Pins(decisions)
                nearest = dp_against_spread(what, dp, single, one_step(
                    cfg, make_batch(), sparse=sparse, plain=True, pins=pins["plain"]))
            else:
                nearest = compare_steps(what, dp, single, DP_LOSS_TOL, DP_GRAD_TOL,
                                        shift_free=True)
            for route, taken in pins.items():
                pins_hold(f"dp {name}: one process's {route} path", taken)
            pair_line(f"dp {name}", nearest[0], nearest[1], list(pins.values()), nearest[2])
            print(f"dp {name}: {got['reduced_bytes'] / mib:.1f} MiB of gradient summed a step",
                  flush=True)
            del grads, dp, single, decisions, pins
            torch.cuda.empty_cache()
        for name in ("obj-only bf16", "obj-only bf16 sparse"):
            got = ranks[0][name]
            want = {"K1": K1_PER_FORWARD, "K2": K2_PER_STEP, "K3": K3_PER_FORWARD,
                    "K4": 0, "K5": 0, "K6": 0}
            check(all(r[name]["digest"] == got["digest"] for r in ranks)
                  and all(np.isfinite(got["losses"])) and got["skipped"] == 0
                  and got["launches_per_step"] == want,
                  f"dp {name}: {DP_BF16_STEPS} steps with dropout 0.5 (a generator a rank), "
                  f"losses {['%.5f' % x for x in got['losses']]} finite, none skipped, the ranks "
                  f"bitwise equal, launches a step a rank {got['launches_per_step']}")
            print(f"dp {name}: {got['reduced_bytes'] / mib:.1f} MiB summed a step; a step "
                  f"{got['step_s'] * 1e3:.1f} ms a rank; the dense gradients "
                  f"({got['reduce_bytes'] / mib:.1f} MiB) summed over gloo on CUDA in "
                  f"{got['reduce_s'] * 1e3:.1f} ms ({got['reduce_bytes'] / got['reduce_s'] / 1e9:.3f} "
                  f"GB/s) on {card} (information only: loopback TCP through the host, not "
                  "NVLink)", flush=True)
        sizes = [ranks[0]["obj-only bf16"]["reduced_bytes"],
                 ranks[0]["obj-only bf16 sparse"]["reduced_bytes"]]
    nccl = nccl_one_rank_ms(sizes)
    for n, ms in nccl.items():
        print(f"dp: all-reduce of {n / mib:.1f} MiB over NCCL in a group of one: {ms:.4f} ms on "
              f"{card} (information only: one rank moves nothing between cards)", flush=True)

    # the training CLI in an NCCL group of one against the same run without
    # --coordinator, which takes run_ranks' one-card branch: one rank
    # (local_ranks), no group (init_distributed never called)
    calls = {"init_distributed": 0, "local_ranks": []}
    real_init, real_local = train_main.init_distributed, train_main.local_ranks

    def counted_init(*a, **k):
        calls["init_distributed"] += 1
        return real_init(*a, **k)

    def recorded_local(args):
        calls["local_ranks"].append(real_local(args))
        return calls["local_ranks"][-1]

    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        write_fixture(data, **DP_CLI_FIXTURE)
        logged = {}
        for name, extra in (("alone", []),
                            ("nccl", ["--coordinator", f"127.0.0.1:{free_ports()[0]}",
                                      "--num_processes", "1"])):
            out = os.path.join(tmp, name)
            argv = (["--data_dir_azure", data, "--output_dir", out, "--num_epochs", "1",
                     "--cache_dir", os.path.join(tmp, f"{name}_cache")] + TRAIN_CLI_FLAGS + extra)
            reset_launch_counts()
            with mock.patch.object(train_main, "init_distributed", counted_init), \
                    mock.patch.object(train_main, "local_ranks", recorded_local):
                state = train_main.main(argv)
            torch.cuda.synchronize()
            launches = launch_counts()
            if name == "alone":
                alone = (calls["init_distributed"], list(calls["local_ranks"]),
                         torch.distributed.is_initialized())
            logged[name] = [v for _, _, v in logged_step_losses(out)]
            epochs = saved_epochs(os.path.join(out, "checkpoints"))
            print(f"dp: training CLI ({name}): {log_lines(out, 'mesh:')[0]}; "
                  f"{log_lines(out, 'trained')[-1]}", flush=True)
            del state
            torch.cuda.empty_cache()
        check(logged["nccl"] == logged["alone"] and len(logged["nccl"]) > 0 and epochs == [1]
              and launches["K2"] == K2_PER_STEP * len(logged["nccl"]),
              f"dp: the training CLI in an NCCL group of one logs the {len(logged['nccl'])} "
              f"losses of the run without --coordinator bitwise, writes its checkpoint once "
              f"({epochs}), {launches['K2']} K2 launches")
        check(alone == (0, [1], False) and calls["init_distributed"] == 1,
              f"dp: the training CLI without --coordinator takes one rank and forms no group "
              f"(init_distributed {alone[0]} times, local_ranks {alone[1]}, a group formed: "
              f"{alone[2]})")
    return launches


# the host phase: the reference .pth round trip at full width; two serving
# ranks on the one card over gloo (worker processes of this script,
# --host-rank), float and MCB, on a tree of the dp phase's size
HOST_WORLD = 2


def host_rank(rank: int, coordinator: str, argv_file: str) -> int:
    """One serving rank of the host phase: ``predict_from_args`` on its
    stride of the batches in a gloo group on cuda:0; prints its answers
    and launches."""
    from structured_alignment_vqa_tpu_torch.parallel.mesh import init_distributed, shutdown
    from structured_alignment_vqa_tpu_torch.train import predict as predict_cli

    with open(argv_file) as f:
        args = predict_cli.build_predict_parser().parse_args(json.load(f))
    mesh = init_distributed(coordinator, HOST_WORLD, rank, backend="gloo", device="cuda:0")
    try:
        reset_launch_counts()
        n = predict_cli.predict_from_args(args, mesh)
        torch.cuda.synchronize()
        print("HOST_RANK " + json.dumps({"rank": rank, "answers": n,
                                         "launches": launch_counts()}), flush=True)
    finally:
        shutdown(mesh)
    return 0


def pth_round_trip(card: str) -> None:
    """The seeded full-width model out to a reference .pth and into a fresh
    model: nothing unmatched, the logits bitwise, int8 answers equal, the
    shared table written once."""
    import os
    import tempfile

    from structured_alignment_vqa_tpu_torch.models import AttModelX3
    from structured_alignment_vqa_tpu_torch.models.torch_export import export_state_dict, save_pth
    from structured_alignment_vqa_tpu_torch.models.torch_import import import_torch_state_dict
    from structured_alignment_vqa_tpu_torch.ops.quant import quantize_state_dict
    from structured_alignment_vqa_tpu_torch.train.predict import make_predict_step

    mib = 2.0 ** 20
    cfg = full_config()
    model = random_model(cfg, seed=5).eval()
    batch = full_batches(cfg, 1)[0]
    with torch.inference_mode():
        want = model(batch)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model_0.pth")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_pth(path, model)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        fresh = random_model(cfg, seed=6).eval()
        t0 = time.perf_counter()
        unmatched = import_torch_state_dict(torch.load(path, weights_only=True), fresh)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    with torch.inference_mode():
        got = fresh(batch)
    same = all(torch.equal(g, w) for g, w in zip(got, want) if w is not None)
    table = cfg.vocab_size * cfg.glove_dim * 4
    exported = export_state_dict(model)
    besides = sum(t.numel() * 4 for k, t in exported.items() if not k.endswith("syb_emb.weight"))
    check(unmatched == [] and same and size < table + besides + 16 * mib,
          f"host: .pth round trip on the card: {len(exported)} keys, nothing unmatched "
          f"({unmatched[:3]}), the bs-{B} logits bitwise; the file {size / mib:.1f} MiB "
          f"holds the {table / mib:.1f} MiB table once beside {besides / mib:.1f} MiB of other "
          f"tensors (three copies would be {(3 * table + besides) / mib:.1f}); saved in "
          f"{save_s:.2f} s, loaded and imported in {load_s:.2f} s on {card}")
    answers = []
    for m in (model, fresh):
        q = AttModelX3(cfg.replace(int8_serving=True))
        q.load_state_dict(quantize_state_dict(m.state_dict()))
        answers.append(make_predict_step(q)(batch))
        del q
    check(torch.equal(answers[0], answers[1]),
          f"host: int8 serving of the loaded model answers as int8 of the original "
          f"({int(answers[0].unique().numel())} distinct answers of {B})")
    del model, fresh, exported, answers, want, got
    torch.cuda.empty_cache()


def host_phase(card: str) -> dict:
    """Every card of a host and the reference's checkpoints (ROADMAP items
    15c and 18) on the one card: the .pth round trip, and two serving ranks
    against one process byte for byte (float and MCB), each rank launching
    K1 and K3 for every batch it served. The path's launches are those of
    the float run's two ranks, summed (each rank zeroes its counts just
    before it serves). The training CLI without --coordinator is phase
    dp's run "alone"."""
    import os
    import tempfile

    from structured_alignment_vqa_tpu_torch.data.dataset import BatchLoader, GQASuperNodeDataset
    from structured_alignment_vqa_tpu_torch.data.fixtures import write_fixture
    from structured_alignment_vqa_tpu_torch.data.transfer import host_tensors
    from structured_alignment_vqa_tpu_torch.models import AttModelX3, init_random_
    from structured_alignment_vqa_tpu_torch.parallel.dryrun import launch_local
    from structured_alignment_vqa_tpu_torch.parallel.mesh import free_ports
    from structured_alignment_vqa_tpu_torch.parallel.train_step import TrainState, adam
    from structured_alignment_vqa_tpu_torch.train import main as train_main
    from structured_alignment_vqa_tpu_torch.train import predict as predict_cli
    from structured_alignment_vqa_tpu_torch.utils.checkpoint import save_checkpoint

    torch.cuda.empty_cache()
    pth_round_trip(card)
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        write_fixture(data, **DP_CLI_FIXTURE)

        # two serving ranks against one process, float and MCB, the ranks
        # reading the batch cache the one-process run wrote
        commands, files = [], {}
        ports = free_ports(2)
        for (head, extra), port in zip((("float", []), ("mcb", ["--mcb"])), ports):
            argv = (["--data_dir_azure", data, "--split", "train", "--num_workers",
                     str(CLI_WORKERS), "--batch_cache_dir", os.path.join(tmp, "batches"),
                     "--weight_dir", os.path.join(tmp, f"ckpt_{head}")] + CLI_FLAGS + extra)
            cfg, train_dc, _, _ = train_main.configs_from_args(
                predict_cli.build_predict_parser().parse_args(argv))
            model = AttModelX3(cfg)
            init_random_(model, torch.Generator(device="cuda").manual_seed(2))
            first = next(iter(BatchLoader(GQASuperNodeDataset("train", train_dc), B,
                                          shuffle=False)))
            spread_answers_(model, host_tensors(first).to("cuda"))
            save_checkpoint(os.path.join(tmp, f"ckpt_{head}"),
                            TrainState(model, adam(model.parameters())), 1)
            del model
            torch.cuda.empty_cache()
            one, two = (os.path.join(tmp, f"{head}_{n}") for n in ("one", "two"))
            predict_cli.main(argv + ["--output_dir", one, "--out", f"{one}.jsonl"])
            torch.cuda.empty_cache()
            with open(f"{tmp}/{head}_argv.json", "w") as f:
                json.dump(argv + ["--output_dir", two, "--out", f"{two}.jsonl"], f)
            commands += [[sys.executable, os.path.abspath(__file__), "--host-rank", str(r),
                          f"127.0.0.1:{port}", f"{tmp}/{head}_argv.json"]
                         for r in range(HOST_WORLD)]
            files[head] = (one, two)
        t0 = time.perf_counter()
        outs = launch_local(commands, timeout=600)
        print(f"host: {len(commands)} serving ranks (2 groups of {HOST_WORLD}) on cuda:0 over "
              f"gloo ran in {time.perf_counter() - t0:.1f} s", flush=True)
        ranks = [json.loads(line[len("HOST_RANK "):]) for text in outs
                 for line in text.splitlines() if line.startswith("HOST_RANK ")]
        path = None
        for i, (head, (one, two)) in enumerate(files.items()):
            with open(f"{one}.jsonl", "rb") as f:
                want = f.read()
            with open(f"{two}.jsonl", "rb") as f:
                got = f.read()
            mine = ranks[i * HOST_WORLD:(i + 1) * HOST_WORLD]
            answers = [json.loads(line) for line in want.decode().splitlines()]
            # the one-process stream's batches: the last holds its last answer
            n_batches = max(a["index"] for a in answers) // B + 1 if answers else 0
            served = [len(range(r, n_batches, HOST_WORLD)) for r in range(HOST_WORLD)]
            wants = [{**{k: 0 for k in counted_wrappers()}, "K1": K1_PER_FORWARD * n,
                      "K3": K3_PER_FORWARD * n} for n in served]
            ids = [a["answer_id"] for a in answers]
            check(got == want and len(answers) > 0 and [r["rank"] for r in mine] == [0, 1]
                  and [r["launches"] for r in mine] == wants,
                  f"host: {HOST_WORLD} serving ranks ({head}), each its stride of whole "
                  f"batches, write the one-process answers file byte for byte ({len(answers)} "
                  f"answers, {len(set(ids))} distinct); launches a rank "
                  f"{[r['launches'] for r in mine]} == {wants}: {K1_PER_FORWARD} K1 and "
                  f"{K3_PER_FORWARD} K3 for each of the {served} batches a rank served of "
                  f"the stream's {n_batches}")
            if path is None:
                path = {k: sum(r["launches"][k] for r in mine) for k in counted_wrappers()}
            for line in log_lines(two, "predicted") + log_lines(two, "served"):
                print(f"host: {head}, {HOST_WORLD} ranks: {line} (information only: two ranks "
                      f"share {card})", flush=True)
            print(f"host: {head}, one process: {log_lines(one, 'predicted')[0]}", flush=True)
    return path


# ------------------------------------------------------------------ variants


def variant_config(name: str, dtype=torch.float32):
    """The variant eval CLI's model config (hidden 512, 6 blocks, 8 heads,
    407,000 x 300 GloVe tables, maxlen 300 / 50 / 49, dropout 0, 1,843
    classes); x3_ori at the obj+rel point (``rel_config``, dropout 0, its
    own tables)."""
    from structured_alignment_vqa_tpu_torch.models import ModelConfig

    if name == "x3_ori":
        return rel_config(compute_dtype=dtype, dropout_rate=0.0, share_glove=False)
    return ModelConfig(num_classes=1843, num_relations=310, vocab_size=407000, glove_dim=300,
                       hidden_size=512, num_blocks=6, num_heads=8, dropout_rate=0.0,
                       maxlen=300, maxlen_q=50, maxlen_v=49, stage1_blocks=2,
                       stage2_blocks=4, compute_dtype=dtype)


def variant_inputs(name: str, seed: int) -> tuple:
    """The positional inputs of ``name``'s forward on the card, with the
    masks of its family as the variant eval CLI builds them (square for the
    dec family, fusion_dec_mil(2) and x2_dec_ori, 1-D for the others; the
    visual rows all valid): bs 64, (lv, ls, lq) = (49, 250, 50), questions
    of 8-50 tokens, scene graphs of 49-250 nodes at 5% density, x6's object
    slots on distinct node rows (-1 padded), relatt's 250 vis-symbolic node
    rows of which up to 49 link a region. x3_ori: bs 4 at the obj+rel
    bucket (36, 1506, 30) (``rel_batches``), relation rows for its 1,260
    object pairs (-1 where none) and 4 candidates a pair (10% PAD)."""
    rng = np.random.default_rng(seed)
    dev = "cuda"

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    if name == "x3_ori":
        from structured_alignment_vqa_tpu_torch.models.variants import PAD_ID

        cfg = variant_config(name)
        bt = rel_batches(cfg, 1)[0]
        b, o = bt.vis_fea.shape[:2]
        pairs = o * (o - 1)
        n_macro = bt.macro_mask.sum(dim=2).gt(0).sum(dim=1).cpu().numpy()
        rel_loc = np.stack([rng.integers(-1, n, size=pairs) for n in n_macro])
        pos_rel = rng.integers(0, cfg.num_relations, size=(b, pairs, 4))
        pos_rel[rng.random((b, pairs, 4)) < 0.1] = PAD_ID
        neg_rel = rng.integers(0, cfg.num_relations, size=(b, pairs, 4))
        return (bt.vis_fea, bt.vis_mask, bt.q_ipt, bt.q_mask, bt.q_graph, bt.macro_ipt,
                bt.macro_mask, bt.macro_graph, bt.macro_obj_loc, t(rel_loc), bt.micro_pos_obj,
                bt.micro_neg_obj, bt.micro_obj_mask, t(pos_rel), t(neg_rel))

    b, lv, ls, lq = VARIANT_B, VARIANT_LV, VARIANT_LS, VARIANT_LQ

    def valid(lo: int, hi: int, length: int) -> np.ndarray:
        n = rng.integers(lo, hi + 1, size=b)
        return (np.arange(length)[None, :] < n[:, None]).astype(np.float32)

    def graph(mask: np.ndarray, density: float) -> np.ndarray:
        g = (rng.random((b, mask.shape[1], mask.shape[1])) < density).astype(np.float32)
        g = np.maximum(g, np.eye(mask.shape[1], dtype=np.float32)[None])
        return g * mask[:, :, None] * mask[:, None, :]

    def ids(mask: np.ndarray) -> np.ndarray:
        return (rng.integers(1, 400000, size=mask.shape) * mask).astype(np.int64)

    def square(m: np.ndarray) -> np.ndarray:
        return m[:, :, None] * m[:, None, :]

    vis = rng.standard_normal((b, lv, WIDE_C)).astype(np.float32)
    qm, sm = valid(min(8, lq), lq, lq), valid(lv, ls, ls)
    q, s, qg, sg = ids(qm), ids(sm), graph(qm, 0.3), graph(sm, 0.05)
    vm = np.ones((b, lv), np.float32)
    if name in ("x", "x2", "x2_pre", "x2_distill"):
        return tuple(map(t, (vis, q, qm, qg, s, sm, sg)))
    if name in ("x4_dec", "x5_dec_mil", "x7_dec_mil", "x6_dec_mil"):
        out = (vis, vm, q, qm, qg, s, sm, sg)
        if name == "x6_dec_mil":
            idx = np.full((b, lv), -1, np.int64)
            for i in range(b):
                k = int(rng.integers(min(10, lv), lv + 1))
                idx[i, :k] = rng.choice(int(sm[i].sum()), size=k, replace=False)
            out += (idx,)
        return tuple(map(t, out))
    if name == "x2_fusion_dec_relatt":
        nm = valid(lv, ls, ls)
        link = np.full((b, ls), -1, np.int64)
        for i in range(b):
            rows = np.sort(rng.choice(int(nm[i].sum()), size=lv, replace=False))
            link[i, rows] = np.arange(lv)
        return tuple(map(t, (vis, ids(nm), square(nm), link, graph(nm, 0.05), q, square(qm),
                             qg, s, square(sm), sg)))
    return tuple(map(t, (vis, square(vm), q, square(qm), qg, s, square(sm), sg)))


@contextlib.contextmanager
def counted_attention_core(calls: dict):
    """Count the plain ``attention_core`` calls of the attention modules
    (weights out, attention dropout, or no renorm) under ``calls["plain"]``."""
    from structured_alignment_vqa_tpu_torch.ops import attention

    real = attention.attention_core

    def call(*args, **kw):
        calls["plain"] += 1
        return real(*args, **kw)

    with mock.patch.object(attention, "attention_core", call):
        yield


def variant_logits(out) -> list:
    """The logits of a variant's output: the tensor, or the leading (B, C)
    tensors of its tuple."""
    if torch.is_tensor(out):
        return [out]
    return [o for o in out if torch.is_tensor(o) and o.dim() == 2]


def variant_step(model, args, loss_fn, plain: bool, pins: "Pins | None" = None,
                 record: "dict | None" = None) -> tuple:
    """(loss, {name: gradient or None}, launches) of one f32 backward
    (taking or recording decisions as :func:`one_step`)."""
    model.zero_grad(set_to_none=True)
    reset_launch_counts()
    with plain_path() if plain else contextlib.nullcontext(), \
            decisions_taken(model, pins, record):
        loss = loss_fn(model(*args))
        loss.backward()
    torch.cuda.synchronize()
    grads = {n: None if p.grad is None else p.grad.detach().clone()
             for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads, launch_counts()


def variant_loss(name: str, args, answer):
    """The variant eval's label-smoothed CE; for x5 plus the attention-MIL
    loss of its alignment weights, visual rows onto scene-graph columns."""
    from structured_alignment_vqa_tpu_torch.train.att_mil_loss import att_mil_loss

    def loss(out):
        logits = variant_logits(out)[0]
        log_sm = torch.log_softmax(logits.float(), dim=-1)
        one_hot = torch.nn.functional.one_hot(answer, logits.shape[-1]).float()
        ce = -((0.9 * one_hot + 0.1 / logits.shape[-1]) * log_sm).sum(-1).mean()
        if name != "x5_dec_mil":
            return ce
        lv = args[0].shape[1]
        idx = torch.where(torch.arange(lv, device=answer.device)[None] < 20,
                          torch.arange(lv, device=answer.device)[None].expand(answer.shape[0], lv),
                          torch.full((1, lv), -1, device=answer.device))
        return ce + att_mil_loss([a[:, :, :lv, lv:] for a in out[1]], idx, args[7])
    return loss


def variants_phase(card: str) -> dict:
    """The 17 ablation variants at the variant eval CLI's full width (f32):
    (a) five forwards each, launches held to VARIANT_FORWARD; (b) the kernel
    path against the plain path (logits, answers, every K1/K3/K4 input);
    (c) one f32 backward of x2_dec and x5_dec_mil, kernels against plain
    versions (K2 in it); (d) both in bf16 as information; (e) the device
    time of one request of each."""
    from structured_alignment_vqa_tpu_torch.models import init_random_
    from structured_alignment_vqa_tpu_torch.models.variants import VARIANTS, build_variant

    total = dict.fromkeys(counted_wrappers(), 0)
    for seed, name in enumerate(VARIANTS):
        cfg = variant_config(name)
        model = build_variant(name, cfg)
        init_random_(model, torch.Generator(device="cuda").manual_seed(seed))
        model.eval()
        args = variant_inputs(name, seed)
        b = args[0].shape[0]
        calls = {"plain": 0}
        with torch.inference_mode():
            model(*args)               # warm-up: cuBLAS handles, allocator
            torch.cuda.synchronize()
            reset_launch_counts()
            with counted_attention_core(calls):
                t0 = time.perf_counter()
                for _ in range(REQUESTS):
                    out = model(*args)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
        launches = launch_counts()
        total = {k: total[k] + launches[k] for k in total}
        k1, k3, k4, plain = VARIANT_FORWARD[name]
        want = dict(K1=k1, K2=0, K3=k3, K4=k4, K5=0, K6=0)
        got = {k: v / REQUESTS for k, v in launches.items()}
        check(got == want and calls["plain"] == plain * REQUESTS,
              f"variants {name}: launches a forward {got} == {want}, plain attention_core "
              f"calls {calls['plain'] / REQUESTS:g} == {plain}")
        print(f"variants {name} f32 bs {b}: {seconds / REQUESTS * 1e3:.2f} ms a request, "
              f"{REQUESTS * b / seconds:.1f} pairs/s on {card} (information only)", flush=True)

        # the plain path takes the kernel path's decisions (pinned_decisions)
        seen = {}
        with torch.inference_mode():
            with recorded_kernel_inputs(seen), recorded_decisions(model) as decisions:
                kernel_out = model(*args)
            before = launch_counts()
            pins = Pins(decisions)
            with plain_path(), pinned_decisions(model, pins):
                plain_out = model(*args)
            check(before == launch_counts(), f"variants {name}: the plain path launched no kernel")
        pins_hold(f"variants {name} f32: the plain path", pins)
        kl, pl = variant_logits(kernel_out), variant_logits(plain_out)
        diff = max((a - c).abs().max().item() for a, c in zip(kl, pl))
        finite = all(torch.isfinite(x).all().item() for x in kl)
        check(finite and len(kl) == len(pl) and diff <= LOGIT_TOL_F32,
              f"variants {name} f32: {len(kl)} logits, max|kernel - plain| {diff:.3g} <= "
              f"{LOGIT_TOL_F32:g}")
        pair_line(f"variants {name} f32 logits", diff, LOGIT_TOL_F32, [pins])
        del decisions, pins
        same = min((a.argmax(-1) == c.argmax(-1)).float().mean().item() for a, c in zip(kl, pl))
        check(same == 1.0, f"variants {name} f32: answers kernel == plain for {same:.4f} of {b}")
        cli_kernels_against_plain(seen, f"variants {name}")
        del seen, kernel_out, out

        if name in VARIANT_STEPS:
            answer = torch.from_numpy(np.random.default_rng(seed).integers(
                1, cfg.num_classes, size=b)).to("cuda")
            loss_fn = variant_loss(name, args, answer)
            decisions = {}
            kernel = variant_step(model, args, loss_fn, plain=False, record=decisions)
            check(kernel[2]["K2"] == kernel[2]["K1"] == k1 and kernel[2]["K4"] == k4,
                  f"variants {name} f32 backward: launches {kernel[2]}, a K2 for each K1")
            pins = Pins(decisions)
            plain_step = variant_step(model, args, loss_fn, plain=True, pins=pins)
            check(not any(plain_step[2].values()),
                  f"variants {name} plain backward: launched no kernel ({plain_step[2]})")
            pins_hold(f"variants {name} f32 backward: the plain path", pins)
            err, limit, worst = compare_steps(
                f"variants {name} f32 backward, kernels against plain versions", kernel,
                plain_step, LOSS_TOL_F32, GRAD_TOL_F32, shift_free=True)
            pair_line(f"variants {name} f32 backward", err, limit, [pins], worst)
            del decisions, pins
            total["K2"] += kernel[2]["K2"]
            model16 = build_variant(name, variant_config(name, torch.bfloat16))
            model16.load_state_dict(model.state_dict())
            with torch.inference_mode():
                out16 = variant_logits(model16.eval()(*args))[0]
            agree = (out16.argmax(-1) == pl[0].argmax(-1)).float().mean().item()
            print(f"variants {name} bf16: answers agree with f32 plain on {agree:.4f} of {b} "
                  "(information only)", flush=True)
            del model16, out16
            with torch.inference_mode():
                profile_device(lambda: model(*args), f"one bs-{b} {name} f32 request")
        del model, args, plain_out, kl, pl
        torch.cuda.empty_cache()
    return total


# ---- the variant eval CLI (ROADMAP item 17b) -------------------------------

# each variant the TPU package's variant eval CLI can call, with its family's
# loader; the others (relatt, fusion_dec_mil(2), x3_ori, x4_dec) take other
# inputs than its three call forms and fail there as in the TPU package
VARIANT_CLI_RUNS = tuple((name, "itp_gt") for name in (
    "x", "x2", "x2_pre", "x2_distill", "x2_dec", "x2_dec_ori", "x2_mlp_dec", "x2_syb_dec",
    "x2_fusion_dec")) + tuple((name, "itp_bbox_q") for name in (
        "x5_dec_mil", "x6_dec_mil", "x7_dec_mil"))
VARIANT_CLI_PROFILED = ("x", "x2_dec", "x5_dec_mil")
VARIANT_CLI_LOSS_RTOL = 1e-4
# a sample whose two largest logits are closer than this may take either
# answer on the two paths
VARIANT_CLI_MARGIN = 1e-4
VARIANT_CLI_FIXTURE = CLI_FIXTURE
# every preset of data/node_graph_dataset.py:config_for_variant
VARIANT_PRESETS = ("itp", "itp_gt", "itp_gt_loc", "itp_gt_bbox", "itp_gt_bbox_gtrel",
                   "itp_gtWpred_bbox", "itp_GTRelPredNode_bbox", "itp_GTRelPredNode_bbox_freq",
                   "itp_bbox_q", "itp_bbox_aug", "itp_bbox_visrel")


def variant_cli_log(output_dir: str) -> dict:
    """The loader's samples/s, the eval's pairs/s and ms a batch from the
    variant eval CLI's log."""
    import os

    with open(os.path.join(output_dir, "training.log")) as f:
        text = f.read()
    out = {}
    for key, pattern in (("samples_s", r"loader: .*\(([\d.]+) samples/s"),
                         ("pairs_s", r"eval: .*\(([\d.]+) pairs/s"),
                         ("batch_ms", r"eval: .*, ([\d.]+) ms a batch")):
        found = re.findall(pattern, text)
        out[key] = float(found[-1]) if found else float("nan")
    return out


def variant_cli_phase(card: str) -> dict:
    """The variant eval CLI (``train.evaluate_variants.main``) on the card at
    its default widths, each variant it can call against the same model's
    in-process plain path on the same batches; the other loader presets
    through the loader alone."""
    import logging
    import os
    import shutil
    import tempfile

    from structured_alignment_vqa_tpu_torch.data.fixtures import write_fixture
    from structured_alignment_vqa_tpu_torch.data.node_graph_dataset import (
        NodeGraphDataset,
        config_for_variant,
    )
    from structured_alignment_vqa_tpu_torch.models import init_random_
    from structured_alignment_vqa_tpu_torch.models.variants import build_variant
    from structured_alignment_vqa_tpu_torch.parallel.train_step import TrainState, adam
    from structured_alignment_vqa_tpu_torch.train import evaluate_variants as ev
    from structured_alignment_vqa_tpu_torch.utils.checkpoint import save_checkpoint
    from structured_alignment_vqa_tpu_torch.utils.metrics import AverageMeter

    total = dict.fromkeys(counted_wrappers(), 0)
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        t0 = time.perf_counter()
        write_fixture(data, **VARIANT_CLI_FIXTURE)
        print(f"variant_cli: fixture tree ({VARIANT_CLI_FIXTURE['n_images']} images) written "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)
        loaded = {}     # loader preset -> (dataset, the batches the CLI builds)
        for seed, (name, loader) in enumerate(VARIANT_CLI_RUNS):
            out, ckpt = os.path.join(tmp, f"out_{name}"), os.path.join(tmp, "ckpt")
            argv = ["--data_dir_azure", data, "--output_dir", out, "--variant", name,
                    "--loader", loader, "--split", "val", "--q_tar_fn", "val.tar",
                    "--log_steps", "4", "--weight_dir", ckpt]
            args = ev.build_parser().parse_args(argv)
            if loader not in loaded:
                ds = NodeGraphDataset("val", config_for_variant(
                    loader, data, q_tar=args.q_tar_fn, maxlen=args.maxlen, min_cnt=args.min_cnt))
                loaded[loader] = ds, ev.load_batches(ds, args)
            ds, batches = loaded[loader]
            model = build_variant(name, ev.model_config(args, ds))
            init_random_(model, torch.Generator(device="cuda").manual_seed(seed))
            save_checkpoint(ckpt, TrainState(model, adam(model.parameters())), epoch=1)

            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            loss, acc = ev.main(argv)
            cli_s = time.perf_counter() - t0
            launches = launch_counts()
            total = {k: total[k] + launches[k] for k in total}
            shutil.rmtree(ckpt)

            # the same model in-process on the plain path, over the batches
            # the CLI builds, the sums read batch by batch
            family = ev.family_of(name)
            meter, corr, n, close = AverageMeter(), 0.0, 0.0, 0
            with torch.inference_mode(), plain_path():
                for b in batches:
                    t = ev.batch_tensors(b, "cuda")
                    logits = ev.variant_logits(model.eval(), family, t)
                    top = logits.float().topk(2, dim=-1).values
                    close += int(((top[:, 0] - top[:, 1] < VARIANT_CLI_MARGIN)
                                  & (t["sample_valid"] > 0)).sum())
                    s_loss, s_corr, s_n = ev.logit_sums(logits, t).tolist()
                    if s_n > 0:
                        meter.update(s_loss / s_n, int(s_n))
                    corr, n = corr + s_corr, n + s_n
            rel = abs(loss - meter.avg) / abs(meter.avg) if n else float("nan")
            check(n > 0 and np.isfinite(loss) and rel <= VARIANT_CLI_LOSS_RTOL,
                  f"variant_cli {name} ({loader}): the CLI's loss {loss:.7g} against the plain "
                  f"path's {meter.avg:.7g} over {len(batches)} batches ({n:g} valid), relative "
                  f"{rel:.3g} <= {VARIANT_CLI_LOSS_RTOL:g}")
            cli_corr = round(acc * n)
            check(abs(cli_corr - corr) <= close,
                  f"variant_cli {name}: correct {cli_corr} against the plain path's {corr:g} "
                  f"({close} valid sample(s) with a logit margin below {VARIANT_CLI_MARGIN:g})")
            k1, k3, k4, _ = VARIANT_FORWARD[name]
            want = dict(K1=k1, K2=0, K3=k3, K4=k4, K5=0, K6=0)
            per_batch = {k: v / len(batches) for k, v in launches.items()}
            check(per_batch == want, f"variant_cli {name}: launches a batch {per_batch} == {want}")
            rates = variant_cli_log(out)
            print(f"variant_cli {name} f32 bs {args.batch_size}: the CLI {cli_s:.1f} s in all, "
                  f"eval {rates['pairs_s']:.1f} pairs/s, {rates['batch_ms']:.2f} ms a batch, "
                  f"the loader cold {rates['samples_s']:.1f} samples/s, K1 {per_batch['K1']:g} "
                  f"and K3 {per_batch['K3']:g} a batch on {card} (information only)", flush=True)
            if name in VARIANT_CLI_PROFILED:
                logger = logging.getLogger("variant_cli")
                profile_device(lambda: ev.eval_batches(model, batches[:3], logger, 10 ** 6,
                                                       family=family, device="cuda"),
                               f"variant CLI {name}: its eval loop over 3 bs-{args.batch_size} "
                               "batches")
            del model
            torch.cuda.empty_cache()

        # the other presets of config_for_variant, through the loader alone
        args = ev.build_parser().parse_args(["--data_dir_azure", data])
        for preset in VARIANT_PRESETS:
            if preset in loaded:
                continue
            ds = NodeGraphDataset("val", config_for_variant(
                preset, data, q_tar="val.tar", maxlen=args.maxlen, min_cnt=args.min_cnt))
            t0 = time.perf_counter()
            batches = ev.load_batches(ds, args)
            seconds = time.perf_counter() - t0
            valid = int(sum(b["sample_valid"].sum() for b in batches))
            shapes = {tuple(b["node_graph"].shape) for b in batches}
            ls = args.maxlen - args.maxlen_q
            check(valid > 0 and shapes == {(args.batch_size, ls, ls)},
                  f"variant_cli loader {preset}: {valid} of {len(ds)} samples valid in "
                  f"{len(batches)} batches of {shapes}; {len(ds) / seconds:.1f} samples/s cold "
                  "(information)")
    return total


# ---- ring and Ulysses sequence parallelism (ROADMAP item 16) ---------------

SEQ_WORLD = 2
# launches of one attention call at seq 2: the ring's K4 (partial) once a
# key block and K5, K6 once a block in the backward; Ulysses K4, K5, K6 once
SEQ_CALL = {"ring": dict(K4=2, K5=2, K6=2), "ulysses": dict(K4=1, K5=1, K6=1)}
# a rank's obj+rel step at seq 2: every encoder block's self-attention on
# the ring (the visual encoder at L 66 too: 33 keys a block), the decoders'
# one-query cross-attention on K1 (visual) and K4 (symbolic) as before
SEQ_STEP = dict(K1=6, K2=6, K3=24, K4=6 + 12 * 2, K5=6 + 12 * 2, K6=6 + 12 * 2)
SEQ_TIMED = 5
# sample 2's keys and queries end here: its second 768-key block is wholly masked
SEQ_MASKED_FROM = 700


def seq_inputs(dtype):
    """The obj+rel self-attention at B 4, L 1,536, C 512 (``flash_inputs``
    "self L=1506+30", seeded), sample 2's keys and queries valid only below
    ``SEQ_MASKED_FROM``, so that its second 768-key block is wholly masked;
    a dy."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, key_mask, _, graph = flash_inputs(gen, "self L=1506+30", REL_L, REL_L, dtype)
    key_mask[2, SEQ_MASKED_FROM:] = 0.0
    dy = torch.randn(REL_B, REL_L, C, generator=gen, device="cuda").to(dtype)
    return (q, k, v, key_mask, key_mask.clone(), graph), dy


@contextlib.contextmanager
def seq_plain_path():
    """The ring and Ulysses loops with the plain versions of K4, K5 and K6."""
    from structured_alignment_vqa_tpu_torch.ops import flash_graph_attention as fl
    from structured_alignment_vqa_tpu_torch.ops import ring_attention as ra
    from structured_alignment_vqa_tpu_torch.ops import ulysses_attention as ua

    def plain_forward(q, k, v, key_mask, query_mask, graph, heads, renorm, emit):
        return fl.flash_graph_attention_plain(q, k, v, key_mask, query_mask, graph, heads,
                                              renorm, emit)

    with mock.patch.object(ra, "flash_graph_attention", fl.flash_graph_attention_plain), \
            mock.patch.object(ra, "flash_bwd_dq", fl.flash_bwd_dq_plain), \
            mock.patch.object(ra, "flash_bwd_dkv", fl.flash_bwd_dkv_plain), \
            mock.patch.object(ua, "_forward", plain_forward), \
            mock.patch.object(ua, "flash_graph_attention_bwd", fl.flash_graph_attention_bwd_plain):
        yield


def attention_and_grads(fn, args, dy, renorm: str) -> tuple:
    """(out, dq, dk, dv) of ``fn(q, k, v, key_mask, query_mask, graph, heads,
    renorm)`` with ``dy`` the gradient of out."""
    q, k, v = (t.detach().clone().requires_grad_(True) for t in args[:3])
    out = fn(q, k, v, *args[3:], HEADS, renorm)
    grads = torch.autograd.grad(out, (q, k, v), dy)
    torch.cuda.synchronize()
    return (out.detach(), *grads)


def seq_against(what: str, got: tuple, want: tuple, dtype) -> None:
    """out within K4's tolerance, dq, dk, dv within K5's and K6's."""
    err = (got[0].float() - want[0].float()).abs().max().item()
    check(err <= TOL[dtype] and bool(torch.isfinite(got[0].float()).all()),
          f"{what} out: max|a-b| {err:.3g} <= {TOL[dtype]:g}")
    for name, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        e = rel_err(g, w)
        check(e <= K2_TOL[dtype] and bool(torch.isfinite(g.float()).all()),
              f"{what} {name}: max|a-b|/max|b| {e:.3g} <= {K2_TOL[dtype]:g}")


def seq_worker(rank: int, coordinator: str, out: str) -> int:
    """One rank of the seq phase: ring and Ulysses on the obj+rel shape in
    bf16 and f32 (against the one-process K4/K5/K6 and against their plain
    loop), their times and bytes, then one obj+rel f32 step at seq 2 (rank
    0 saves its gradients, every rank the decisions it took)."""
    from structured_alignment_vqa_tpu_torch.ops import flash_graph_attention as fl
    from structured_alignment_vqa_tpu_torch.ops import ring_attention as ra
    from structured_alignment_vqa_tpu_torch.ops import ulysses_attention as ua
    from structured_alignment_vqa_tpu_torch.parallel.mesh import init_distributed, shutdown
    from structured_alignment_vqa_tpu_torch.parallel.sharding import seq_rotate
    from structured_alignment_vqa_tpu_torch.parallel.train_step import (
        create_train_state,
        make_train_step,
        shard_state,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = init_distributed(coordinator, SEQ_WORLD, rank, backend="gloo", device="cuda:0",
                            seq_parallel=SEQ_WORLD)
    path = dict.fromkeys(counted_wrappers(), 0)

    def on_path(fn):
        before = launch_counts()
        result = fn()
        torch.cuda.synchronize()
        moved = {k: launch_counts()[k] - before[k] for k in before}
        for k in path:
            path[k] += moved[k]
        return result, moved

    impls = {"ring": ra.ring_graph_attention, "ulysses": ua.ulysses_graph_attention}
    results = {}
    try:
        for dtype in (torch.bfloat16, torch.float32):
            args, dy = seq_inputs(dtype)
            for renorm in ("l1", "sum_eps"):
                single = attention_and_grads(fl.flash_graph_attention, args, dy, renorm)
                for impl, fn in impls.items():
                    call = lambda *a: fn(*a, mesh)    # noqa: E731
                    sent = seq_rotate.bytes
                    got, moved = on_path(lambda: attention_and_grads(call, args, dy, renorm))
                    rotated = seq_rotate.bytes - sent
                    what = f"seq rank {rank} {impl} {dtype} {renorm}"
                    want = dict.fromkeys(moved, 0) | SEQ_CALL[impl]
                    check(moved == want, f"{what}: launches {moved} == {want}")
                    seq_against(f"{what} against the one-process K4/K5/K6", got, single, dtype)
                    before = launch_counts()
                    with seq_plain_path():
                        plain = attention_and_grads(call, args, dy, renorm)
                    check(launch_counts() == before, f"{what}: the plain loop launched nothing")
                    seq_against(f"{what} kernels against their plain loop", got, plain, dtype)
                    if renorm == "l1":
                        def fwd():
                            return call(*args, HEADS, renorm)
                        fwd_ms = time_ms(fwd, iters=SEQ_TIMED, warmup=1)
                        both_ms = time_ms(lambda: attention_and_grads(call, args, dy, renorm),
                                          iters=SEQ_TIMED, warmup=1)
                        single_ms = time_ms(lambda: attention_and_grads(
                            fl.flash_graph_attention, args, dy, renorm), iters=SEQ_TIMED,
                            warmup=1)
                        results[impl, str(dtype)] = dict(fwd_ms=fwd_ms, both_ms=both_ms,
                                                         single_ms=single_ms, rotated=rotated)
                        print(f"seq rank {rank} {impl} {dtype} B {REL_B} L {REL_L} C {C} H "
                              f"{HEADS}: forward {fwd_ms:.3f} ms, forward + backward "
                              f"{both_ms:.3f} ms (one process's K4 + K5 + K6 {single_ms:.3f} "
                              f"ms), {rotated} bytes rotated a layer, launches a layer "
                              f"{ {k: v for k, v in moved.items() if v} } (information only)",
                              flush=True)
                    del got, plain
                del single
            del args, dy
            torch.cuda.empty_cache()

        cfg = rel_config(compute_dtype=torch.float32, dropout_rate=0.0, seq_axis="seq")
        model = random_model(cfg, seed=3)
        state = shard_state(create_train_state(model, 1e-4), mesh)
        step = make_train_step(model, state.optimizer, cfg, mesh=mesh)
        batch = rel_batches(cfg, 1)[0]
        t0 = time.perf_counter()
        with recorded_decisions(model) as decisions:
            m, moved = on_path(lambda: step(state, batch, torch.Generator(device="cuda")
                                            .manual_seed(11)))
        results["step"] = dict(loss=m["loss"].item(), launches=moved,
                               seconds=time.perf_counter() - t0)
        if rank == 0:
            torch.save({n: p.grad.cpu() for n, p in model.named_parameters()
                        if p.grad is not None}, f"{out}/grads.pt")
        torch.save(decisions_to_cpu(decisions), f"{out}/decisions{rank}.pt")
        del model, state, step, batch, decisions
    finally:
        shutdown(mesh)
    results["path"] = path
    results["failures"] = list(failures)
    torch.save(results, f"{out}/rank{rank}.pt")
    return 0


def seq_shard_kernels(card: str) -> None:
    """K4 (``emit="partial"``), K5 and K6 at the ring's shard shape: rank
    1's 768 queries against the second 768-key block, where sample 2's keys
    are all masked; against their plain versions, timed, with bounds."""
    from structured_alignment_vqa_tpu_torch.ops import flash_graph_attention as fl

    half = REL_L // SEQ_WORLD
    for dtype in (torch.bfloat16, torch.float32):
        (q, k, v, key_mask, query_mask, graph), dy = seq_inputs(dtype)
        rows = slice(half, REL_L)
        args = tuple(t[:, rows].contiguous() for t in (q, k, v, key_mask, query_mask)) + (
            graph[:, rows, rows].contiguous(),)
        label = f"ring shard Tq={half} Tk={half} (sample 2's keys all masked)"
        check(float(args[3][2].sum()) == 0.0, f"K4 {label}: the block holds a wholly masked "
              "sample")
        k4_against_plain(label, args, HEADS)
        size = torch.finfo(dtype).bits // 8
        b, t = REL_B, half
        ms = time_ms(lambda: fl.flash_graph_attention(*args, HEADS, "l1", "partial"))
        plain_ms = time_ms(lambda: fl.flash_graph_attention_plain(*args, HEADS, "l1",
                                                                  "partial"), iters=5)
        # reads q, k, v and the graph block; writes a (f32) and m, z, b
        nbytes = size * b * C * 3 * t + 4 * b * (t * t + 2 * t) + 4 * b * (C * t + 3 * HEADS * t)
        bound_ms, bound_by = bound(nbytes, 4.0 * b * t * t * C, dtype)
        print(f"K4 emit=partial {label} {dtype}: {k4_kernel(dtype, C // HEADS)} kernel, "
              f"{ms:.4f} ms{previous('K4', 'ring shard', dtype)}, plain {plain_ms:.4f} ms, "
              f"bound {bound_ms * 1e3:.2f} us "
              f"({bound_by}); library: none (SDPA gives no m, z, b) on {card}", flush=True)
        _, m, z, bsum = fl.flash_graph_attention(*args, HEADS, "l1", "stats")
        out = fl.flash_graph_attention(*args, HEADS, "l1")
        d_out, delta = fl.masked_grad_and_delta(out, dy[:, rows].contiguous(), args[4], HEADS)
        bwd = (args[0], args[1], args[2], args[3], args[5], m, z, bsum, delta, d_out, HEADS, "l1")
        stats_bytes = 4 * b * (t * t + t + 4 * HEADS * t)
        for key, fn, plain, n_products, nb in (
                ("K5", fl.flash_bwd_dq, fl.flash_bwd_dq_plain, 3,
                 size * b * C * 5 * t + stats_bytes),
                ("K6", fl.flash_bwd_dkv, fl.flash_bwd_dkv_plain, 4,
                 size * b * C * 6 * t + stats_bytes)):
            got, want = fn(*bwd), plain(*bwd)
            got, want = (got,) if torch.is_tensor(got) else got, \
                (want,) if torch.is_tensor(want) else want
            e = max(rel_err(g, w) for g, w in zip(got, want))
            check(e <= K2_TOL[dtype], f"{key} {label} {dtype}: max|kernel-plain|/max|plain| "
                  f"{e:.3g} <= {K2_TOL[dtype]:g}")
            kms = time_ms(lambda: fn(*bwd))
            pms = time_ms(lambda: plain(*bwd), iters=5)
            bms, bby = bound(nb, 2.0 * n_products * b * t * t * C, dtype)
            print(f"{key} {label} {dtype} (one ring rotation): {kms:.4f} ms"
                  f"{previous(key, 'ring shard', dtype)}, plain {pms:.4f} ms, "
                  f"bound {bms * 1e3:.2f} us ({bby}); library: none on {card}", flush=True)
        del args, bwd
        torch.cuda.empty_cache()


def seq_phase(card: str) -> dict:
    """Ring and Ulysses sequence parallelism (ROADMAP item 16) on the card:
    two gloo ranks as a (data 1, seq 2) mesh at the obj+rel point, against
    one process; K4's partial emit, K5 and K6 at the shard shape."""
    import os
    import tempfile

    from structured_alignment_vqa_tpu_torch.parallel.dryrun import free_ports, launch_local

    seq_shard_kernels(card)
    with tempfile.TemporaryDirectory() as tmp:
        coordinator = f"127.0.0.1:{free_ports()[0]}"
        t0 = time.perf_counter()
        outs = launch_local([[sys.executable, os.path.abspath(__file__), "--seq-rank", str(r),
                              coordinator, tmp] for r in range(SEQ_WORLD)], timeout=600)
        print(f"seq: {SEQ_WORLD} ranks on cuda:0 over gloo as (data 1, seq {SEQ_WORLD}) ran in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for r, text in enumerate(outs):
            for line in text.splitlines():
                print(f"seq rank {r}: {line}", flush=True)
        ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=True) for r in range(SEQ_WORLD)]
        grads = torch.load(f"{tmp}/grads.pt", weights_only=True)
        decisions, same = join_replicated([torch.load(f"{tmp}/decisions{r}.pt",
                                                      weights_only=True)
                                           for r in range(SEQ_WORLD)])
    for r, res in enumerate(ranks):
        check(not res["failures"], f"seq rank {r}: every check of the rank passed "
              f"({len(res['failures'])} failed)")
        step = res["step"]
        want = dict.fromkeys(step["launches"], 0) | SEQ_STEP
        check(step["launches"] == want, f"seq rank {r}: the obj+rel step's launches "
              f"{step['launches']} == {want}")
    check(ranks[0]["step"]["loss"] == ranks[1]["step"]["loss"],
          "seq: both ranks of the row log the same loss")
    # one process's steps take the row's decisions: every one is taken on whole
    # tensors, alike on both ranks (join_replicated)
    check(same, "seq: both ranks of the row took the same decisions outside the kernels")
    cfg = rel_config(compute_dtype=torch.float32, dropout_rate=0.0)
    batch = rel_batches(cfg, 1)[0]
    pins = {route: Pins(decisions) for route in ("kernel", "plain")}
    single = one_step(cfg, batch, pins=pins["kernel"])
    plain = one_step(cfg, batch, plain=True, pins=pins["plain"])
    for route, taken in pins.items():
        pins_hold(f"seq: one process's {route} path", taken)
    seq_step = (ranks[0]["step"]["loss"], {n: g.to("cuda") for n, g in grads.items()},
                ranks[0]["step"]["launches"])
    for n in single[1]:
        seq_step[1].setdefault(n, None)
    err, limit, worst = dp_against_spread(
        "seq: the (data 1, seq 2) obj+rel f32 step against one process's", seq_step, single,
        plain)
    pair_line("seq obj+rel", err, limit, list(pins.values()), worst)
    print(f"seq: a rank's obj+rel f32 step {ranks[0]['step']['seconds']:.2f} s with the ring over "
          f"gloo through the host on {card} (information only)", flush=True)
    return {k: sum(res["path"][k] for res in ranks) for k in ranks[0]["path"]}

MODEL_WORLD = 2
# the production model's 8 heads over 16 ranks: 32 columns a rank, so each
# head spans two ranks and each rank computes the one head its columns
# overlap (ops/attention.py, parallel/sharding.py:gather_heads)
MODEL_WIDE = 16
MODEL_HIDDEN = HIDDEN // MODEL_WORLD   # a rank's FFN hidden shard at model 2
MODEL_ROWS = 16384                     # the obj-only encoder's rows at bs 128 (128 x 128)
MODEL_STEP_B = 32
# the obj+rel step's batch at model 16 (REL_B at model 2)
MODEL_WIDE_REL_B = 2
# the depth of model 16's runs, for the script's time limit (its 16 ranks
# took 128-160 s with the obj+rel step at 6 blocks, and 137.1 s on a slow
# host with it at 3 and the serving forward and obj-only step at 6): one
# block of each graph stage (diagonal, cross, full), every width the
# production model's. Model 2's runs keep 6: their time is the ranks'
# start (34.1 s at 6 blocks, 33.5 at 3)
MODEL_WIDE_CUT = dict(num_blocks=3, stage1_blocks=1, stage2_blocks=2)
# launches a block of one forward and of one step on a rank: every K1 and
# K3 of the one-process path becomes the model axis's entries (K1's
# attention-only entry and its LayerNorm entry, K3's partial and epilogue),
# every K2 K2's from-d(o) entry; K4, K5 and K6 run as they are, on a rank's
# heads
MODEL_FORWARD = {"K1 heads": 4, "K1 ln": 4, "K3 partial": 4, "K3 epilogue": 4}
MODEL_LAUNCHES = {
    "serve": MODEL_FORWARD,
    "step": dict(MODEL_FORWARD, **{"K2 from d(o)": 4}),
    "rel_step": {"K1 heads": 2, "K1 ln": 2, "K3 partial": 4, "K3 epilogue": 4,
                 "K2 from d(o)": 2, "K4": 2, "K5": 2, "K6": 2}}
MODEL_TIMED = 3


def model_configs(world: int) -> dict:
    """The model phase's configurations at model ``world``: {run: config}."""
    cut = MODEL_WIDE_CUT if world == MODEL_WIDE else {}
    return {"serve": full_config(**cut),
            "step": full_config(compute_dtype=torch.float32, dropout_rate=0.0, **cut),
            "rel_step": rel_config(compute_dtype=torch.float32, dropout_rate=0.0, **cut)}


def model_shapes(n: int) -> tuple:
    """A model rank's share at model ``n``: (heads it computes, their
    columns, its FFN hidden shard, the suffix of its entries' names)."""
    from structured_alignment_vqa_tpu_torch.parallel.sharding import head_range

    lo, hi = head_range(0, C // n, C // HEADS)
    return hi - lo, (hi - lo) * (C // HEADS), HIDDEN // n, "" if n == MODEL_WORLD else f" m{n}"


def model_wrappers() -> dict:
    """The wrappers of the model axis's entries of K1, K2 and K3, each
    counting its launches."""
    from structured_alignment_vqa_tpu_torch.ops import fused_ffn, fused_graph_attention as k1

    return {"K1 heads": k1.graph_attention_heads, "K1 ln": k1.attention_ln,
            "K2 from d(o)": k1.graph_attention_heads_bwd, "K3 partial": fused_ffn.ffn_partial,
            "K3 epilogue": fused_ffn.ffn_epilogue}


def model_counts() -> dict:
    """Every kernel entry's launches: the six wrappers and the model axis's."""
    return launch_counts() | {k: fn.launches for k, fn in model_wrappers().items()}


def model_entries(card: str, n: int) -> dict:
    """The model axis's entries of K1, K2 and K3, and K4 (at model 16 K5
    and K6 too), against their plain versions at the main path's model-``n``
    shapes (bf16 and f32), timed beside their bounds: {entry: row} of the
    bf16 run at model 2, of both dtypes at model 16 (" f32" after the
    name). The LayerNorm entries take whole rows, the same at any ``n``:
    they run at model 2 only."""
    from structured_alignment_vqa_tpu_torch.ops import flash_graph_attention as fl
    from structured_alignment_vqa_tpu_torch.ops import fused_ffn as k3
    from structured_alignment_vqa_tpu_torch.ops import fused_graph_attention as k1

    heads, width, hidden, suffix = model_shapes(n)
    gen = torch.Generator(device="cuda").manual_seed(77 + n)
    rows = {}

    def row(entry, dtype, errs, tol, fn, plain, nbytes, ops, shape, library=None):
        err = max(errs)
        check(err <= tol, f"{entry}{suffix} {shape} {dtype}: max|kernel-plain|/max|plain| "
              f"{err:.3g} <= {tol:g}")
        ms, plain_ms = time_ms(fn), time_ms(plain, iters=5)
        bound_ms, bound_by = bound(nbytes, ops, dtype)
        library_ms = None if library is None else library[0]
        lib = "none" if library is None else (f"{library[1]} {library_ms:.4f} ms")
        print(f"{entry}{suffix} {shape} {dtype}: {ms:.4f} ms{previous(entry, 'model', dtype)}, "
              f"plain {plain_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us ({bound_by}); library: "
              f"{lib} on {card}", flush=True)
        if dtype == torch.bfloat16 or suffix:
            name = entry + suffix + ("" if dtype == torch.bfloat16 else " f32")
            rows[name] = dict(name=name, err=err, tolerance=tol, ms=ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                              shape=f"{'bf16' if dtype == torch.bfloat16 else 'f32'} {shape}")

    for dtype in (torch.bfloat16, torch.float32):
        size = torch.finfo(dtype).bits // 8
        # K1's attention-only entry and K2 from d(o): B 128, L 128, a rank's heads of 64
        q, k, v, key_mask, query_mask, graph, *_ = k1_inputs(gen, 128, 128, dtype, B)
        q, k, v = (t[..., :width].contiguous() for t in (q, k, v))
        args = (q, k, v, key_mask, query_mask, graph)
        shape = f"B={B} L=128 C={width} H={heads}"
        errs = []
        for renorm in ("l1", "sum_eps"):
            got = k1.graph_attention_heads(*args, heads, renorm)
            want = k1.graph_attention_plain(*args, heads, renorm)
            check(bool(torch.isfinite(got).all()),
                  f"K1 heads{suffix} {shape} {dtype} {renorm}: finite")
            errs.append(rel_err(got, want))
        nb = size * B * width * 3 * 128 + 4 * B * (2 * 128 + 128 * 128) + 4 * B * 128 * width
        # the entry has no LayerNorm: SDPA computes its function on the rows
        # with a neighbour, as beside K4
        library_ms, library_err = sdpa_yardstick(
            args, heads, lambda: k1.graph_attention_heads(*args, heads, "l1"))
        row("K1 heads", dtype, errs, TOL[dtype],
            lambda: k1.graph_attention_heads(*args, heads, "l1"),
            lambda: k1.graph_attention_plain(*args, heads, "l1"),
            nb, 4.0 * B * 128 * 128 * width, shape,
            library=(library_ms, f"SDPA, the graph as a boolean mask (max|K1 - SDPA| "
                                 f"{library_err:.3g} on the rows with a neighbour)"))
        do = torch.randn(B, 128, width, generator=gen, device="cuda").to(dtype)
        errs = []
        for renorm in ("l1", "sum_eps"):
            got = k1.graph_attention_heads_bwd(*args, do, heads, renorm)
            want = k1.graph_attention_bwd_plain(*args, do, heads, renorm)
            errs += [rel_err(g, w) for g, w in zip(got, want)]
            check(all(bool(torch.isfinite(g).all()) for g in got),
                  f"K2 from d(o){suffix} {shape} {dtype} {renorm}: finite")
        # reads q, k, v, dO, the masks and the f32 graph; writes dq, dk, dv.
        # QK^T and the weights recomputed, dA, dV, dQ and dK: 5 products of 2 B Tq Tk C
        nb = size * B * width * 7 * 128 + 4 * B * (2 * 128 + 128 * 128)
        row("K2 from d(o)", dtype, errs, K2_TOL[dtype],
            lambda: k1.graph_attention_heads_bwd(*args, do, heads, "l1"),
            lambda: k1.graph_attention_bwd_plain(*args, do, heads, "l1"),
            nb, 10.0 * B * 128 * 128 * width, shape)
        del args, do
        if n == MODEL_WORLD:
            # K1's LayerNorm entry and K3's epilogue at 16,384 rows of 512
            o = torch.randn(MODEL_ROWS, C, generator=gen, device="cuda")
            res = torch.randn(MODEL_ROWS, C, generator=gen, device="cuda").to(dtype)
            gamma = 1 + 0.05 * torch.randn(C, generator=gen, device="cuda")
            beta = 0.05 * torch.randn(C, generator=gen, device="cuda")
            b2 = (0.05 * torch.randn(C, generator=gen, device="cuda")).to(dtype)
            shape = f"rows={MODEL_ROWS} C={C}"
            nb = 4 * MODEL_ROWS * C + 2 * size * MODEL_ROWS * C + 8 * C
            got = k1.attention_ln(o, res, gamma, beta)
            want = k1.attention_ln_plain(o, res, gamma, beta)
            row("K1 ln", dtype, [rel_err(got, want)], TOL[dtype],
                lambda: k1.attention_ln(o, res, gamma, beta),
                lambda: k1.attention_ln_plain(o, res, gamma, beta), nb, 10.0 * MODEL_ROWS * C,
                shape)
            got = k3.ffn_epilogue(o, res, b2, gamma, beta)
            want = k3.ffn_epilogue_plain(o, res, b2, gamma, beta)
            row("K3 epilogue", dtype, [rel_err(got, want)], TOL[dtype],
                lambda: k3.ffn_epilogue(o, res, b2, gamma, beta),
                lambda: k3.ffn_epilogue_plain(o, res, b2, gamma, beta), nb + size * C,
                11.0 * MODEL_ROWS * C, shape)
            del o, res
        # K3's partial: 16,384 rows, C 512, a rank's hidden shard
        x = torch.randn(MODEL_ROWS, C, generator=gen, device="cuda").to(dtype)
        w1 = (torch.randn(hidden, C, generator=gen, device="cuda") / C ** 0.5).to(dtype)
        b1 = (0.05 * torch.randn(hidden, generator=gen, device="cuda")).to(dtype)
        w2 = (torch.randn(C, hidden, generator=gen, device="cuda") / HIDDEN ** 0.5).to(dtype)
        shape = f"rows={MODEL_ROWS} C={C} hidden={hidden}"
        got, want = k3.ffn_partial(x, w1, b1, w2), k3.ffn_partial_plain(x, w1, b1, w2)
        check(bool(torch.isfinite(got).all()), f"K3 partial{suffix} {shape} {dtype}: finite")
        n_split = k3.kernel_ffn_split(dtype, MODEL_ROWS, C, hidden)[0]
        print(f"K3 partial{suffix} {shape} {dtype}: {k3_path(dtype, MODEL_ROWS, C, hidden)}, "
              f"hidden shard in {n_split} block shard(s)", flush=True)
        nb = size * (MODEL_ROWS * C + 2 * C * hidden + hidden) + 4 * MODEL_ROWS * C
        row("K3 partial", dtype, [rel_err(got, want)], TOL[dtype],
            lambda: k3.ffn_partial(x, w1, b1, w2), lambda: k3.ffn_partial_plain(x, w1, b1, w2),
            nb, 4.0 * MODEL_ROWS * C * hidden, shape)
        del x, w1, w2, got, want
        # K4 on a rank's heads of 64 at the obj+rel point (B 4, self L 1,536)
        q, k, v, key_mask, query_mask, graph = flash_inputs(gen, "self L=1536", REL_L, REL_L,
                                                            dtype)
        q, k, v = (t[..., :width].contiguous() for t in (q, k, v))
        args = (q, k, v, key_mask, query_mask, graph)
        shape = f"B={REL_B} L={REL_L} C={width} H={heads}"
        head_dim = C // HEADS
        k4_split = fl.kernel_key_split(dtype, head_dim, REL_B, heads, REL_L, REL_L)[0]
        print(f"K4 heads{suffix} {shape} {dtype}: {k4_kernel(dtype, head_dim)} kernel, keys in "
              f"{k4_split} shard(s)", flush=True)
        k4_against_plain(shape, args, heads)
        got = fl.flash_graph_attention(*args, heads, "l1")
        want = fl.flash_graph_attention_plain(*args, heads, "l1")
        nb = size * REL_B * width * 4 * REL_L + 4 * REL_B * (REL_L * REL_L + 2 * REL_L)
        library_ms, _ = sdpa_yardstick(args, heads)
        row("K4 heads", dtype, [rel_err(got, want)], TOL[dtype],
            lambda: fl.flash_graph_attention(*args, heads, "l1"),
            lambda: fl.flash_graph_attention_plain(*args, heads, "l1"),
            nb, 4.0 * REL_B * REL_L * REL_L * width, shape,
            library=(library_ms, "SDPA, the graph as a boolean mask"))
        del got, want
        if n != MODEL_WORLD:
            # K5 and K6 on the rank's head: the phase k56 holds 4 heads at model 2
            dy = torch.randn(REL_B, REL_L, width, generator=gen, device="cuda").to(dtype)
            k5_split = fl.dq_key_split(dtype, head_dim, REL_B, heads, REL_L, REL_L)[0]
            print(f"K5 heads{suffix} {shape} {dtype}: {fl.dq_kernel(dtype, head_dim)} kernel, "
                  f"keys in {k5_split} shard(s); K6 the {fl.dkv_kernel(dtype, head_dim)} kernel",
                  flush=True)
            errs, _, bwd = k56_against_plain(shape, args, dy, heads)
            stats_bytes = 4 * REL_B * (REL_L * REL_L + REL_L + 4 * heads * REL_L)
            for key, fn, plain, n_products, nbytes in (
                    ("K5", fl.flash_bwd_dq, fl.flash_bwd_dq_plain, 3,
                     size * REL_B * width * 5 * REL_L + stats_bytes),
                    ("K6", fl.flash_bwd_dkv, fl.flash_bwd_dkv_plain, 4,
                     size * REL_B * width * 6 * REL_L + stats_bytes)):
                row(f"{key} heads", dtype, [errs[key]], K2_TOL[dtype], lambda: fn(*bwd),
                    lambda: plain(*bwd), nbytes,
                    2.0 * n_products * REL_B * REL_L * REL_L * width, shape)
            del dy, bwd
        del args
        torch.cuda.empty_cache()
    return rows


def model_rel_b(world: int) -> int:
    return REL_B if world == MODEL_WORLD else MODEL_WIDE_REL_B


def model_worker(rank: int, coordinator: str, out: str, world: int) -> int:
    """One rank of the model phase, (data 1, model ``world``) over gloo on
    cuda:0: a bf16 serving forward at bs 128, an f32 obj-only step at bs 32
    and an f32 obj+rel step (rank 0 saves the logits and the whole
    gradients), with each run's launches, bytes over the model row, seconds
    and the card's memory in use at its end (every rank's)."""
    from structured_alignment_vqa_tpu_torch.data.synthetic import synthetic_batch
    from structured_alignment_vqa_tpu_torch.parallel.mesh import init_distributed, shutdown
    from structured_alignment_vqa_tpu_torch.parallel import sharding
    from structured_alignment_vqa_tpu_torch.parallel.train_step import (
        create_train_state,
        make_train_step,
    )

    import os
    import resource

    # sixteen ranks share the card: segments that grow in place leave no
    # reserved-but-unused blocks behind (set before this process's first
    # allocation)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = init_distributed(coordinator, world, rank, backend="gloo", device="cuda:0",
                            model_parallel=world)
    path = dict.fromkeys(model_counts(), 0)
    results = {}

    def memory() -> dict:
        """This rank's peak since the last call and the card's memory in
        use now (every process's); frees what the last run left first."""
        free, total = torch.cuda.mem_get_info()
        out = dict(peak=torch.cuda.max_memory_allocated(), in_use=total - free)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        return out

    def on_path(fn, timed_only: bool = False):
        before, sent = model_counts(), sharding.model_bytes.sent
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        moved = {k: v - before[k] for k, v in model_counts().items()}
        for k in path:   # a repeat that is only timed is not the path's run
            path[k] += 0 if timed_only else moved[k]
        return (result, {k: v for k, v in moved.items() if v},
                sharding.model_bytes.sent - sent, seconds)

    def sharded(cfg, seed):
        # every rank draws the same weights from the seed and keeps its shard
        # (the bytes count the one shared GloVe table once)
        model = random_model(cfg, seed=seed)
        whole = model_bytes(model)
        sharding.shard_model(model, mesh)
        return model, whole, model_bytes(model)

    configs = model_configs(world)
    try:
        cfg = configs["serve"]
        model, whole, mine = sharded(cfg, 0)
        model.eval()
        batch = full_batches(cfg, 1)[0]
        with torch.no_grad():
            logits, moved, sent, seconds = on_path(lambda: model(batch)[0])
            # at model 16 a forward takes seconds: its first run is timed alone
            seconds = [seconds] if world != MODEL_WORLD else [
                on_path(lambda: model(batch)[0], timed_only=True)[3] for _ in range(MODEL_TIMED)]
        if rank == 0:
            torch.save(logits.float().cpu(), f"{out}/logits.pt")
        del model, logits
        results["serve"] = dict(launches=moved, bytes=sent, seconds=min(seconds),
                                whole=whole, mine=mine, **memory())

        for name, batch_of in (
                ("step", lambda c: synthetic_batch(c, MODEL_STEP_B, lv=36, lq=30, ls=98, seed=0)),
                ("rel_step", lambda c: rel_batches(c, 1, model_rel_b(world))[0])):
            cfg = configs[name]
            model, _, _ = sharded(cfg, 3)
            state = create_train_state(model, 1e-4)
            step = make_train_step(model, state.optimizer, cfg, mesh=mesh)
            batch = batch_of(cfg)
            with recorded_decisions(model) as decisions:
                m, moved, sent, seconds = on_path(
                    lambda: step(state, batch, torch.Generator(device="cuda").manual_seed(11)))
            save_grads(model, rank, f"{out}/{name}_grads{rank}.pt")
            torch.save(decisions_to_cpu(decisions), f"{out}/{name}_decisions{rank}.pt")
            del model, state, step, batch, decisions
            results[name] = dict(loss=m["loss"].item(), skipped=m["skipped"].item(),
                                 launches=moved, bytes=sent, seconds=seconds, **memory())
    finally:
        shutdown(mesh)
    results["path"] = path
    results["failures"] = list(failures)
    results["max_rss"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    torch.save(results, f"{out}/rank{rank}.pt")
    return 0


def save_grads(model, rank: int, path: str) -> None:
    """This rank's share of the gradients, for :func:`whole_grads`: its
    shard of every split parameter, and on rank 0 the replicated ones too
    (the same on every rank of the row once the step has summed the
    partial ones)."""
    from structured_alignment_vqa_tpu_torch.parallel.sharding import split_of

    splits = split_of(model)
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()
             if p.grad is not None and (n in splits or rank == 0)}
    torch.save({"grads": grads, "dims": {n: splits[n].dim for n in grads if n in splits}}, path)


def whole_grads(paths: list) -> dict:
    """The whole gradients from the files :func:`save_grads` wrote, one a
    rank in model order: split ones concatenated along their dim."""
    parts = [torch.load(p, weights_only=True) for p in paths]
    dims = parts[0]["dims"]
    return {n: torch.cat([p["grads"][n] for p in parts], dims[n]) if n in dims else g
            for n, g in parts[0]["grads"].items()}


def model_ranks(world: int, card: str) -> tuple:
    """``world`` ``--model-rank`` workers on cuda:0 as (data 1, model
    ``world``): (each rank's results, rank 0's logits, the whole gradients
    by step, the decisions the ranks took by step in one process's layout,
    :func:`join_model`)."""
    import os
    import tempfile

    from structured_alignment_vqa_tpu_torch.parallel.dryrun import free_ports, launch_local

    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    with tempfile.TemporaryDirectory() as tmp:
        coordinator = f"127.0.0.1:{free_ports()[0]}"
        t0 = time.perf_counter()
        outs = launch_local([[sys.executable, os.path.abspath(__file__), "--model-rank", str(r),
                              coordinator, tmp, str(world)] for r in range(world)], timeout=600)
        print(f"model: {world} ranks on cuda:0 over gloo as (data 1, model {world}) ran in "
              f"{time.perf_counter() - t0:.1f} s, the card {(total - free) / 2 ** 30:.1f} GiB "
              f"in use before they started, on {card}", flush=True)
        for r, text in enumerate(outs):
            for line in text.splitlines():
                print(f"model {world} rank {r}: {line}", flush=True)
        ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=True) for r in range(world)]
        logits = torch.load(f"{tmp}/logits.pt", weights_only=True).to("cuda")
        grads = {n: whole_grads([f"{tmp}/{n}_grads{r}.pt" for r in range(world)])
                 for n in ("step", "rel_step")}
        decisions = {n: join_model([torch.load(f"{tmp}/{n}_decisions{r}.pt", weights_only=True)
                                    for r in range(world)]) for n in ("step", "rel_step")}
    return ranks, logits, grads, decisions


def model_phase(card: str) -> dict:
    """The model axis (ROADMAP items 15b and 15d) on the card: its K1, K2
    and K3 entries and K4 against their plain versions at the model-2 and
    model-16 shapes (K5 and K6 at model 16 too); then two gloo ranks on the
    one card as (data 1, model 2) and sixteen as (data 1, model 16), the
    production model's 8 heads each spanning two ranks, at full width
    (:func:`model_configs` gives the depths) against one process: the bf16
    serving forward, an f32 obj-only step and an f32 obj+rel step (K4, K5,
    K6 on a rank's heads)."""
    from structured_alignment_vqa_tpu_torch.data.synthetic import synthetic_batch

    entries = {}
    for n in (MODEL_WORLD, MODEL_WIDE):
        entries |= model_entries(card, n)
    runs = {n: model_ranks(n, card) for n in (MODEL_WORLD, MODEL_WIDE)}

    for n, (ranks, *_) in runs.items():
        for r, res in enumerate(ranks):
            check(not res["failures"], f"model {n} rank {r}: every check of the rank passed "
                  f"({len(res['failures'])} failed)")
            for name, cfg in model_configs(n).items():
                want = {k: v * cfg.num_blocks for k, v in MODEL_LAUNCHES[name].items()}
                check(res[name]["launches"] == want, f"model {n} rank {r} {name}: launches "
                      f"{res[name]['launches']} == {want} ({cfg.num_blocks} blocks)")
        for name in ("step", "rel_step"):
            check(all(res[name]["loss"] == ranks[0][name]["loss"] for res in ranks)
                  and ranks[0][name]["skipped"] == 0,
                  f"model {n} {name}: every rank of the row logs the same loss, no step skipped")

    # the serving forward against one process's
    tol = TOL[torch.bfloat16]
    for n, (_, logits, *_) in runs.items():
        cfg = model_configs(n)["serve"]
        model = random_model(cfg, seed=0)
        model.eval()
        with torch.no_grad():
            single = model(full_batches(cfg, 1)[0])[0].float()
        del model
        top2 = single.topk(2, dim=-1).values
        err = (logits - single).abs().max().item() / single.abs().max().item()
        clear = (top2[:, 0] - top2[:, 1]) > 2 * err * single.abs().max()
        same = (logits.argmax(-1) == single.argmax(-1))
        check(err <= tol and bool(same[clear].all()),
              f"model {n} serving bf16 bs {B}, {cfg.num_blocks} blocks: logits "
              f"max|ranks-one|/max|one| {err:.3g} <= "
              f"{tol:g}; answers equal on all {int(clear.sum())} rows whose top-2 margin "
              f"exceeds twice that (equal on {int(same.sum())} of {B} rows)")

    # the f32 steps against one process's, held as the dp phase holds its ranks. A
    # decision within rounding of its threshold (a ReLU input of a decoder's K or V
    # projection into 1,536 keys) can fall the other way on the ranks, whose sums
    # run in another order, and move its weight's gradient by its whole term
    # (ROADMAP Queue 3). One process's steps take the ranks' decisions, so that
    # both sides differentiate the same function; each decision they take against
    # their own must be a knife edge (pins_hold)
    for name in ("step", "rel_step"):
        for n, (ranks, _, grads, decisions) in runs.items():
            cfg = model_configs(n)[name]
            bs = MODEL_STEP_B if name == "step" else model_rel_b(n)
            batch = (synthetic_batch(cfg, bs, lv=36, lq=30, ls=98, seed=0) if name == "step"
                     else rel_batches(cfg, 1, bs)[0])
            pins = {route: Pins(decisions[name]) for route in ("kernel", "plain")}
            single = one_step(cfg, batch, pins=pins["kernel"])
            plain = one_step(cfg, batch, plain=True, pins=pins["plain"])
            for route, taken in pins.items():
                pins_hold(f"model {n} {name}: one process's {route} path", taken)
            # every parameter's name: one with a gradient on one side only fails
            mine = (ranks[0][name]["loss"], {p: grads[name][p].to("cuda")
                                             if p in grads[name] else None for p in single[1]},
                    ranks[0][name]["launches"])
            err, limit, worst = dp_against_spread(
                f"model: the (data 1, model {n}) {name} f32 bs {bs}, {cfg.num_blocks} blocks "
                "against one process's", mine, single, plain)
            pair_line(f"model {n} {name}", err, limit, list(pins.values()), worst)
            del mine, single, plain, batch, pins
            torch.cuda.empty_cache()

    path = {}
    for n, (ranks, *_) in runs.items():
        serve = ranks[0]["serve"]
        print(f"model {n}: a rank holds {serve['mine'] / 2 ** 20:.1f} MiB of parameters and "
              f"buffers against one process's {serve['whole'] / 2 ** 20:.1f} MiB; the ranks' "
              f"peak resident host memory {sum(r['max_rss'] for r in ranks) / 2 ** 30:.1f} GiB "
              f"summed", flush=True)
        configs = model_configs(n)
        for name, what in (("serve", f"bf16 forward bs {B}"),
                           ("step", f"f32 step bs {MODEL_STEP_B}"),
                           ("rel_step", f"obj+rel f32 step bs {model_rel_b(n)}")):
            res = ranks[0][name]
            print(f"model {n}: {what}, {configs[name].num_blocks} blocks: "
                  f"{res['bytes'] / 2 ** 20:.1f} MiB through the model row's "
                  f"collectives a rank, launches {res['launches']}, {res['seconds']:.3f} s a "
                  f"rank, a rank's peak {max(r[name]['peak'] for r in ranks) / 2 ** 30:.2f} "
                  f"GiB, {max(r[name]['in_use'] for r in ranks) / 2 ** 30:.1f} GiB of the card "
                  f"in use at its end, all processes' (gloo through the host: information "
                  f"only) on {card}", flush=True)
        mine = {k: sum(res["path"][k] for res in ranks) for k in ranks[0]["path"]}
        suffix = model_shapes(n)[3]
        for entry in ("K1 heads", "K2 from d(o)", "K3 partial", "K1 ln", "K3 epilogue"):
            for name in (entry + suffix, entry + suffix + " f32"):
                if name in entries:
                    entries[name]["launches"] = mine[entry]
        # every K4, K5 and K6 of the path runs on a rank's heads
        for key in ("K4", "K5", "K6"):
            for name in (f"{key} heads{suffix}", f"{key} heads{suffix} f32"):
                if name in entries:
                    entries[name]["launches"] = mine[key]
        check(all(mine[k] > 0 for k in ("K4", "K5", "K6", "K1 heads", "K2 from d(o)",
                                        "K3 partial", "K1 ln", "K3 epilogue")),
              f"model {n}: every kernel of the path launched: {mine}")
        for k, v in mine.items():
            path[k] = path.get(k, 0) + v
    for key, entry in (("K1", "K1 heads"), ("K2", "K2 from d(o)"), ("K3", "K3 partial")):
        path[key] += path[entry]
    model_phase.entries = entries
    return {k: v for k, v in path.items() if k in counted_wrappers()}


model_phase.entries = {}


PHASES = ("k1", "k3", "k2", "serving", "training", "k4", "k56", "widths", "objrel_serving",
          "objrel_training", "cli", "train_cli", "packed", "dp", "host", "variants",
          "variant_cli", "seq", "model")
PORT = "structured_alignment_vqa_tpu_torch/csrc/"
TPU = "structured_alignment_vqa_tpu/ops/"
BF16 = str(torch.bfloat16)
# key, name, source, TPU kernel, main path, row of its phase at the main
# path's shape, that shape, tolerance of the row's comparison
KERNELS = (
    ("K1", "graph_attention_ln", "graph_attention.cu", "pallas_attention.py:55", "serving",
     ("k1", "self L=128" + BF16), "bf16 B=128 L=128 C=512 H=8", TOL[torch.bfloat16]),
    ("K2", "graph_attention_ln_bwd", "graph_attention_bwd.cu", "pallas_attention_bwd.py:53",
     "training", ("k2", "self L=128" + BF16), "bf16 B=128 L=128 C=512 H=8",
     K2_TOL[torch.bfloat16]),
    ("K3", "ffn_ln", "ffn.cu", "pallas_ffn.py:27", "serving",
     ("k3", "rows=16384" + BF16), "bf16 rows=16384 C=512 hidden=2048", TOL[torch.bfloat16]),
    ("K4", "flash_graph_attention", "flash_graph_attention.cu", "pallas_flash_attention.py:78",
     "objrel_serving", ("k4", "self L=1536" + BF16), "bf16 B=4 L=1536 C=512 H=8",
     TOL[torch.bfloat16]),
    ("K5", "flash_graph_attention_bwd_dq", "flash_graph_attention_bwd.cu",
     "pallas_flash_attention.py:367", "objrel_training", ("k56", "K5self L=1536" + BF16),
     "bf16 B=4 L=1536 C=512 H=8", K2_TOL[torch.bfloat16]),
    ("K6", "flash_graph_attention_bwd_dkv", "flash_graph_attention_bwd.cu",
     "pallas_flash_attention.py:398", "objrel_training", ("k56", "K6self L=1536" + BF16),
     "bf16 B=4 L=1536 C=512 H=8", K2_TOL[torch.bfloat16]),
)


# K1's, K2's, K4's, K5's and K6's float32 rows at the main path's shapes
# (their register-tiled kernels)
def tol_f32(key: str) -> float:
    return K2_TOL[torch.float32] if key in ("K2", "K5", "K6") else TOL[torch.float32]


F32 = str(torch.float32)
F32_MAIN = {"K1": ("k1", "self L=128" + F32, "f32 B=128 L=128 C=512 H=8"),
            "K2": ("k2", "self L=128" + F32, "f32 B=128 L=128 C=512 H=8"),
            "K4": ("k4", "self L=1536" + F32, "f32 B=4 L=1536 C=512 H=8"),
            "K5": ("k56", "K5self L=1536" + F32, "f32 B=4 L=1536 C=512 H=8"),
            "K6": ("k56", "K6self L=1536" + F32, "f32 B=4 L=1536 C=512 H=8")}


def kernel_lines(rows: dict, by_path: dict) -> list:
    kernels = []
    for key, name, src, replaces, path, (phase, row), shape, tol in KERNELS:
        main_row = rows[phase][row]
        mine = {k: r for k, r in rows[phase].items() if r.get("kernel", key) == key}
        entry = {
            "name": name, "route": "cuda", "source": PORT + src, "replaces": TPU + replaces,
            "launches": by_path[path][key], "max_abs_err": main_row["err"],
            "tolerance": tol, "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": main_row.get("library_ms"), "shape": shape,
            "launches_by_path": {p: counts[key] for p, counts in by_path.items()},
        }
        entry["max_abs_err_all_cases"] = max(r["err"] for r in mine.values())
        # the widths beyond the presets' (the rows marked wide), each beside its bound
        entry["wide_rows"] = [
            {"shape": r["label"], "dtype": str(r["dtype"]), "max_abs_err": r["err"],
             "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
             "bound_by": r["bound_by"], "library_ms": r.get("library_ms")}
            for r in mine.values() if r.get("wide")]
        # the model axis's entries of this kernel (phase model), each beside its bound
        entry["model_axis_entries"] = [
            dict(e) for n, e in model_phase.entries.items() if n.startswith(key + " ")]
        if "rel_err" in main_row:   # held relative to each output's max
            entry["max_rel_err"] = main_row["rel_err"]
            entry["max_rel_err_all_cases"] = max(r["rel_err"] for r in mine.values())
        if key in F32_MAIN:
            f32_phase, f32_row, f32_shape = F32_MAIN[key]
            r = rows[f32_phase][f32_row]
            entry["f32"] = {"shape": f32_shape, "max_abs_err": r["err"], "tolerance": tol_f32(key),
                            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                            "bound_by": r["bound_by"], "library_ms": r.get("library_ms")}
        kernels.append(entry)
    return kernels


def host_available_gib() -> float:
    """The host's MemAvailable (/proc/meminfo), GiB."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2 ** 20
    return float("nan")


def main(argv: list) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if argv[:1] == ["--dp-rank"] and len(argv) == 4:     # a worker of the dp phase
        return dp_worker(int(argv[1]), argv[2], argv[3])
    if argv[:1] == ["--host-rank"] and len(argv) == 4:   # a serving rank of the host phase
        return host_rank(int(argv[1]), argv[2], argv[3])
    if argv[:1] == ["--seq-rank"] and len(argv) == 4:    # a rank of the seq phase
        return seq_worker(int(argv[1]), argv[2], argv[3])
    if argv[:1] == ["--model-rank"] and len(argv) == 5:  # a rank of the model phase
        return model_worker(int(argv[1]), argv[2], argv[3], int(argv[4]))
    phases = PHASES
    if argv[:1] == ["--phases"] and len(argv) == 2:
        phases = tuple(argv[1].split(","))
        if not set(phases) <= set(PHASES):
            print(f"chip_smoke: phases are {PHASES}", file=sys.stderr)
            return 2
    elif argv:
        print("usage: chip_smoke.py [--phases a,b,...]", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # tear CUPTI down after each torch.profiler session (this process's
    # setting): kept set up, it stopped delivering device activity for tens
    # of seconds after the f32 rows at L 1,536 of phases k4 and k56 (each
    # session then saw a kernel one time in four or five), and two checks
    # of every whole run missed all five sessions
    os.environ.setdefault("TEARDOWN_CUPTI", "1")
    from structured_alignment_vqa_tpu_torch.ops import _build

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card} ({torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda})", flush=True)

    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {built or 'nothing to build'} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in _build.SOURCES:
        for line in _build.register_lines(_build.build_log(name)):
            print(f"  {name}: {line}")

    gen = torch.Generator(device="cuda").manual_seed(1234)
    kernel_phases = {"k1": k1_phase, "k3": k3_phase, "k2": k2_phase, "k4": k4_phase,
                     "k56": k56_phase}
    path_phases = {"serving": serving_phase, "training": training_phase, "widths": widths_phase,
                   "objrel_serving": rel_serving_phase, "objrel_training": rel_training_phase,
                   "cli": cli_phase, "train_cli": train_cli_phase, "packed": packed_phase,
                   "dp": dp_phase, "host": host_phase, "variants": variants_phase,
                   "variant_cli": variant_cli_phase, "seq": seq_phase, "model": model_phase}
    rows, by_path = {}, {}
    for phase in phases:
        t0 = time.perf_counter()
        if phase in kernel_phases:
            rows[phase] = kernel_phases[phase](gen)
        else:
            by_path[phase] = path_phases[phase](card)
        gc.collect()   # a phase's models can sit in reference cycles
        torch.cuda.empty_cache()
        print(f"phase {phase}: {time.perf_counter() - t0:.1f} s (the host's memory available "
              f"{host_available_gib():.1f} GiB)", flush=True)
    print(profiler_sessions_line(), flush=True)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all", flush=True)

    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed:", file=sys.stderr)
        for f in failures:
            print("  " + f, file=sys.stderr)
        return 1
    if phases != PHASES:
        print(f"chip_smoke: phases {phases} passed; run without arguments for the full check")
        return 0
    print(json.dumps({"kernels": kernel_lines(rows, by_path)}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
