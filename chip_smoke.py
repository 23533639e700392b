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
   128 keys, both renorms;
4. K3 (FFN + LayerNorm) the same way at 16,384, 8,448 and 128 rows;
5. K2 (the backward of K1) against its plain PyTorch version at K1's
   shapes, bf16 and f32, both renorms, with all-zero graph rows and masked
   keys; in f32 also against torch.autograd of K1's plain version;
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
   breakdown of one step.

It prints one JSON line of kernels, the card's line, and last
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero without
that last line; so does a machine without a CUDA device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import time
from unittest import mock

import torch

H100_BYTES_PER_S = 3.35e12
# published dense peaks (NVIDIA H100 SXM data sheet): bf16 on tensor cores,
# float32 outside them (TF32 is off in every comparison here)
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 2 ** -4, torch.float32: 1e-4}   # max |kernel - plain| per output
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

failures: list = []


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


def k1_phase(gen) -> dict:
    from structured_alignment_vqa_tpu_torch.ops import fused_graph_attention as k1

    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for label, tq, tk in (("self L=66", 66, 66), ("self L=128", 128, 128),
                              ("cross Tq=1 Lk=66", 1, 66), ("cross Tq=1 Lk=128", 1, 128)):
            dev = "cuda"
            n_keys = torch.randint(1, tk + 1, (B,), generator=gen, device=dev)
            key_mask = (torch.arange(tk, device=dev)[None] < n_keys[:, None]).float()
            query_mask = key_mask[:, :tq].contiguous() if tq == tk else torch.ones(B, tq, device=dev)
            graph = (torch.rand(B, tq, tk, generator=gen, device=dev) < 0.3).float()
            graph = graph * query_mask[:, :, None] * key_mask[:, None, :]
            q, k, v = (torch.relu(torch.randn(B, t, C, generator=gen, device=dev)).to(dtype)
                       for t in (tq, tk, tk))
            res = torch.randn(B, tq, C, generator=gen, device=dev).to(dtype)
            gamma = 1 + 0.05 * torch.randn(C, generator=gen, device=dev)
            beta = 0.05 * torch.randn(C, generator=gen, device=dev)
            args = (q, k, v, key_mask, query_mask, graph, res, gamma, beta, HEADS)
            err = 0.0
            for renorm in ("l1", "sum_eps"):
                got = k1.fused_graph_attention_ln(*args, renorm)
                want = k1.graph_attention_ln_plain(*args, renorm)
                torch.cuda.synchronize()
                err = max(err, (got.float() - want.float()).abs().max().item())
            check(err <= TOL[dtype], f"K1 {label} {dtype}: max|kernel-plain| {err:.3g} <= {TOL[dtype]:g}")
            ms = time_ms(lambda: k1.fused_graph_attention_ln(*args, "l1"))
            plain_ms = time_ms(lambda: k1.graph_attention_ln_plain(*args, "l1"))
            size = torch.finfo(dtype).bits // 8
            nbytes = (size * B * C * (3 * tq + 2 * tk) + 4 * B * (tq + tk + tq * tk) + 8 * C)
            bound_ms, bound_by = bound(nbytes, 4.0 * B * tq * tk * C, dtype)
            print(f"K1 {label} {dtype}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"bound {bound_ms * 1e3:.2f} us ({bound_by})", flush=True)
            rows.append(dict(label=label, dtype=dtype, err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by))
    return {r["label"] + str(r["dtype"]): r for r in rows}


def k3_phase(gen) -> dict:
    from structured_alignment_vqa_tpu_torch.ops import fused_ffn as k3

    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for n in (16384, 8448, 128):
            dev = "cuda"
            x = torch.randn(n, C, generator=gen, device=dev).to(dtype)
            w1 = (torch.randn(HIDDEN, C, generator=gen, device=dev) / C ** 0.5).to(dtype)
            b1 = (0.05 * torch.randn(HIDDEN, generator=gen, device=dev)).to(dtype)
            w2 = (torch.randn(C, HIDDEN, generator=gen, device=dev) / HIDDEN ** 0.5).to(dtype)
            b2 = (0.05 * torch.randn(C, generator=gen, device=dev)).to(dtype)
            gamma = 1 + 0.05 * torch.randn(C, generator=gen, device=dev)
            beta = 0.05 * torch.randn(C, generator=gen, device=dev)
            args = (x, w1, b1, w2, b2, gamma, beta)
            got = k3.fused_ffn(*args)
            want = k3.ffn_ln_plain(*args)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            check(err <= TOL[dtype], f"K3 rows={n} {dtype}: max|kernel-plain| {err:.3g} <= {TOL[dtype]:g}")
            ms = time_ms(lambda: k3.fused_ffn(*args))
            plain_ms = time_ms(lambda: k3.ffn_ln_plain(*args))
            size = torch.finfo(dtype).bits // 8
            nbytes = size * (2 * n * C + 2 * C * HIDDEN + HIDDEN + C) + 8 * C
            bound_ms, bound_by = bound(nbytes, 4.0 * n * C * HIDDEN, dtype)
            print(f"K3 rows={n} {dtype}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"bound {bound_ms * 1e3:.2f} us ({bound_by})", flush=True)
            rows.append(dict(label=f"rows={n}", dtype=dtype, err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by))
    return {r["label"] + str(r["dtype"]): r for r in rows}


def k2_inputs(gen, tq: int, tk: int, dtype):
    """K1's arguments and a dy at (B, Tq, Tk, C): masked keys and, for
    self-attention, the first third of the rows with an all-zero graph
    (as the encoder's stage-1 graph on its modality rows)."""
    dev = "cuda"
    n_keys = torch.randint(1, tk + 1, (B,), generator=gen, device=dev)
    key_mask = (torch.arange(tk, device=dev)[None] < n_keys[:, None]).float()
    query_mask = key_mask[:, :tq].contiguous() if tq == tk else torch.ones(B, tq, device=dev)
    graph = (torch.rand(B, tq, tk, generator=gen, device=dev) < 0.3).float()
    graph = graph * query_mask[:, :, None] * key_mask[:, None, :]
    if tq == tk:
        graph[:, : tq // 3] = 0.0
    q, k, v = (torch.relu(torch.randn(B, t, C, generator=gen, device=dev)).to(dtype)
               for t in (tq, tk, tk))
    res = torch.randn(B, tq, C, generator=gen, device=dev).to(dtype)
    gamma = 1 + 0.05 * torch.randn(C, generator=gen, device=dev)
    beta = 0.05 * torch.randn(C, generator=gen, device=dev)
    dy = torch.randn(B, tq, C, generator=gen, device=dev).to(dtype)
    return (q, k, v, key_mask, query_mask, graph, res, gamma, beta), dy


def rel_err(got, want) -> float:
    """max |got - want| over max |want| (absolute where want is all 0)."""
    scale = want.float().abs().max().item()
    return (got.float() - want.float()).abs().max().item() / (scale if scale > 0 else 1.0)


def k2_phase(gen) -> dict:
    from structured_alignment_vqa_tpu_torch.ops import fused_graph_attention as k1

    names = ("dq", "dk", "dv", "dresidual", "dgamma", "dbeta")
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for label, tq, tk in (("self L=66", 66, 66), ("self L=128", 128, 128),
                              ("cross Tq=1 Lk=66", 1, 66), ("cross Tq=1 Lk=128", 1, 128)):
            args, dy = k2_inputs(gen, tq, tk, dtype)
            err = rel = 0.0
            for renorm in ("l1", "sum_eps"):
                got = k1.fused_graph_attention_ln_bwd(*args, dy, HEADS, renorm)
                want = k1.graph_attention_ln_bwd_plain(*args, dy, HEADS, renorm)
                torch.cuda.synchronize()
                for name, g, w in zip(names, got, want):
                    e = rel_err(g, w)
                    tol = K2_TOL[dtype] if g.dtype == torch.bfloat16 else K2_TOL[torch.float32]
                    check(e <= tol and bool(torch.isfinite(g).all()),
                          f"K2 {label} {dtype} {renorm} {name}: max|kernel-plain|/max|plain| "
                          f"{e:.3g} <= {tol:g}")
                    rel = max(rel, e)
                    err = max(err, (g.float() - w.float()).abs().max().item())
                if dtype == torch.float32:
                    leaves = [a.detach().clone().requires_grad_(i in (0, 1, 2, 6, 7, 8))
                              for i, a in enumerate(args)]
                    out = k1.graph_attention_ln_plain(*leaves, HEADS, renorm)
                    auto = torch.autograd.grad(out, [leaves[i] for i in (0, 1, 2, 6, 7, 8)], dy)
                    e = max(rel_err(g, a) for g, a in zip(got, auto))
                    check(e <= K2_AUTOGRAD_TOL,
                          f"K2 {label} f32 {renorm}: max|kernel-autograd|/max|autograd| "
                          f"{e:.3g} <= {K2_AUTOGRAD_TOL:g}")
            ms = time_ms(lambda: k1.fused_graph_attention_ln_bwd(*args, dy, HEADS, "l1"))
            plain_ms = time_ms(lambda: k1.graph_attention_ln_bwd_plain(*args, dy, HEADS, "l1"))
            size = torch.finfo(dtype).bits // 8
            # reads q, k, v, residual, dy, the masks, the f32 graph and gamma;
            # writes dq, dk, dv, dresidual, dgamma and dbeta
            nbytes = (size * B * C * (5 * tq + 4 * tk) + 4 * B * (tq + tk + tq * tk) + 12 * C)
            # recomputed QK^T and AV, then dV, dA, dQ and dK: 6 products of 2 B Tq Tk C
            bound_ms, bound_by = bound(nbytes, 12.0 * B * tq * tk * C, dtype)
            print(f"K2 {label} {dtype}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"bound {bound_ms * 1e3:.2f} us ({bound_by})", flush=True)
            rows.append(dict(label=label, dtype=dtype, err=err, rel_err=rel, ms=ms,
                             plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by))
    return {r["label"] + str(r["dtype"]): r for r in rows}


@contextlib.contextmanager
def plain_path():
    """Replace each kernel wrapper, where the model calls it, by its plain
    PyTorch version: the same model then runs without a kernel on the same
    CUDA tensors, and autograd of the plain graph attention takes K2's place
    in the backward. The package has no such switch; only this comparison
    does."""
    from structured_alignment_vqa_tpu_torch.ops import attention, fused_ffn
    from structured_alignment_vqa_tpu_torch.ops.fused_graph_attention import (
        graph_attention_ln_plain,
    )

    with mock.patch.object(attention, "fused_graph_attention_ln", graph_attention_ln_plain), \
            mock.patch.object(fused_ffn, "fused_ffn", fused_ffn.ffn_ln_plain):
        yield


def launch_counts() -> dict:
    from structured_alignment_vqa_tpu_torch.ops import fused_ffn, fused_graph_attention as k1

    return {"K1": k1.fused_graph_attention_ln.launches,
            "K2": k1.fused_graph_attention_ln_bwd.launches, "K3": fused_ffn.fused_ffn.launches}


def reset_launch_counts() -> None:
    from structured_alignment_vqa_tpu_torch.ops import fused_ffn, fused_graph_attention as k1

    k1.fused_graph_attention_ln.launches = 0
    k1.fused_graph_attention_ln_bwd.launches = 0
    fused_ffn.fused_ffn.launches = 0


def profile_device(fn, what: str) -> None:
    """Device time by kernel over one call of ``fn`` (torch.profiler), and
    the device's idle share of its wall time. Information only."""
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
        return
    by_name: dict = {}
    for e in kernels:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy = sum(us for _, us in by_name.values())
    groups = {"K1 graph_attention_ln": 0.0, "K2 graph_attention_ln_bwd": 0.0, "K3 ffn_ln": 0.0,
              "gemm": 0.0, "other": 0.0}
    for name, (_, us) in by_name.items():
        key = ("K2 graph_attention_ln_bwd" if "graph_attention_ln_bwd_" in name
               else "K1 graph_attention_ln" if "graph_attention_ln_kernel" in name
               else "K3 ffn_ln" if "ffn_ln_" in name
               else "gemm" if "gemm" in name.lower() else "other")
        groups[key] += us
    print(f"profile: {what}, wall {wall_us / 1e3:.3f} ms (profiler on), device busy "
          f"{busy / 1e3:.3f} ms, idle share {1 - busy / wall_us:.3f}, {len(kernels)} kernels")
    for key, us in groups.items():
        print(f"  {key}: {us / 1e3:.3f} ms ({us / busy:.3f} of device time)")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
        print(f"  {us / 1e3:9.3f} ms  x{n:<4d} {name[:110]}")


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
    for key, per in (("K1", K1_PER_FORWARD), ("K3", K3_PER_FORWARD), ("K2", 0)):
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
    with torch.inference_mode():
        kernel_logits = model32.eval()(batches[0])[:3]
        kernel_answers = predict32(batches[0])
        before = launch_counts()
        with plain_path():
            plain_logits = model32(batches[0])[:3]
            plain_answers = predict32(batches[0])
            plain_bf16_answers = predict(batches[0])
        check(before == launch_counts(), "serving: the plain path launched no kernel")
    diff = max((a - b).abs().max().item() for a, b in zip(kernel_logits, plain_logits))
    finite = all(torch.isfinite(t).all().item() for t in kernel_logits)
    check(finite and diff <= LOGIT_TOL_F32,
          f"serving f32: max|logits kernel - plain| {diff:.3g} <= {LOGIT_TOL_F32:g}")
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


def f32_step_against_plain() -> None:
    """One f32 training step at full width with the kernels and one with the
    plain versions, from the same weights and the same generator seed (so
    the same dropout masks): the loss and every parameter's gradient."""
    from structured_alignment_vqa_tpu_torch.parallel import TrainState, adam, make_train_step

    cfg = full_config(compute_dtype=torch.float32)
    batch = full_batches(cfg, 1)[0]
    grads, losses = [], []
    for plain in (False, True):
        model = random_model(cfg, seed=3)
        opt = adam(model.parameters(), lr=1e-4)
        step = make_train_step(model, opt, cfg)
        gen = torch.Generator(device="cuda").manual_seed(11)
        before = launch_counts()
        with plain_path() if plain else contextlib.nullcontext():
            metrics = step(TrainState(model, opt), batch, gen)
        torch.cuda.synchronize()
        moved = {k: launch_counts()[k] - before[k] for k in before}
        want = {k: 0 for k in moved} if plain else {"K1": K1_PER_FORWARD, "K2": K2_PER_STEP,
                                                    "K3": K3_PER_FORWARD}
        check(moved == want, f"train f32 {'plain' if plain else 'kernel'} step: launches "
              f"{moved} == {want}")
        losses.append(metrics["loss"].item())
        grads.append({n: p.grad for n, p in model.named_parameters()})
        del model, opt, step
    err_loss = abs(losses[0] - losses[1]) / abs(losses[1])
    check(err_loss <= LOSS_TOL_F32, f"train f32: loss kernel {losses[0]:.7g} plain {losses[1]:.7g}, "
          f"relative difference {err_loss:.3g} <= {LOSS_TOL_F32:g}")
    errs = {}
    for name, g in grads[0].items():
        w = grads[1][name]
        if g is None or w is None:
            if (g is None) != (w is None):
                check(False, f"train f32: {name} has a gradient on one path only")
            continue
        norm = w.float().norm().item()
        diff = (g - w).float().norm().item()
        errs[name] = (diff / norm if norm > 0 else diff, rel_err(g, w),
                      bool(torch.isfinite(g).all()))
    worst = max(errs, key=lambda n: errs[n][0])
    check(all(e[2] for e in errs.values()) and errs[worst][0] <= GRAD_TOL_F32,
          f"train f32: {len(errs)} finite gradients, worst |kernel-plain|/|plain| "
          f"{errs[worst][0]:.3g} ({worst}) <= {GRAD_TOL_F32:g}")
    for name in sorted(errs, key=lambda n: -errs[n][0])[:4]:
        print(f"  {name}: norm-relative {errs[name][0]:.3g}, max-relative {errs[name][1]:.3g}",
              flush=True)


def training_phase(card: str) -> dict:
    from structured_alignment_vqa_tpu_torch.parallel import TrainState, adam, make_train_step

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
    for key, per in (("K1", K1_PER_FORWARD), ("K2", K2_PER_STEP), ("K3", K3_PER_FORWARD)):
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

    f32_step_against_plain()
    torch.cuda.empty_cache()

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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from structured_alignment_vqa_tpu_torch.ops import _build

    card = card_line()
    print(f"card: {card} ({torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda})", flush=True)

    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {built or 'nothing to build'} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(1234)
    k1_rows = k1_phase(gen)
    k3_rows = k3_phase(gen)
    k2_rows = k2_phase(gen)
    by_path = {"serving": serving_phase(card), "training": training_phase(card)}

    main_rows = {"K1": (k1_rows, k1_rows["self L=128" + str(torch.bfloat16)]),
                 "K2": (k2_rows, k2_rows["self L=128" + str(torch.bfloat16)]),
                 "K3": (k3_rows, k3_rows["rows=16384" + str(torch.bfloat16)])}
    kernels = []
    for key, name, src, replaces, path, shape, tol in (
        ("K1", "graph_attention_ln", "structured_alignment_vqa_tpu_torch/csrc/graph_attention.cu",
         "structured_alignment_vqa_tpu/ops/pallas_attention.py:55", "serving",
         "bf16 B=128 L=128 C=512 H=8", TOL[torch.bfloat16]),
        ("K2", "graph_attention_ln_bwd",
         "structured_alignment_vqa_tpu_torch/csrc/graph_attention_bwd.cu",
         "structured_alignment_vqa_tpu/ops/pallas_attention_bwd.py:53", "training",
         "bf16 B=128 L=128 C=512 H=8", K2_TOL[torch.bfloat16]),
        ("K3", "ffn_ln", "structured_alignment_vqa_tpu_torch/csrc/ffn.cu",
         "structured_alignment_vqa_tpu/ops/pallas_ffn.py:27", "serving",
         "bf16 rows=16384 C=512 hidden=2048", TOL[torch.bfloat16]),
    ):
        rows, main_row = main_rows[key]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": by_path[path][key], "max_abs_err": main_row["err"],
            "tolerance": tol, "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"], "library_ms": None, "shape": shape,
            "max_abs_err_all_cases": max(r["err"] for r in rows.values()),
            "launches_by_path": {p: counts[key] for p, counts in by_path.items()},
        })
        if "rel_err" in main_row:   # K2's tolerance is relative to each output's max
            kernels[-1]["max_rel_err"] = main_row["rel_err"]
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed:", file=sys.stderr)
        for f in failures:
            print("  " + f, file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
