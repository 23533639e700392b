"""A data- and model-parallel dry run over local processes (the port's
counterpart of the TPU package's ``__graft_entry__.py:dryrun_multichip``).

``dryrun_multichip(n)`` starts ``n`` processes that form a gloo group (on
one card, ``cuda:0``, unless the caller asks for the CPU with
``device="cpu"``), each holding its rows of
one global batch at tiny widths with all three graph stages (stage
boundaries 1 and 2 of 3 blocks), both MIL-NCE branches and the shared
GloVe table. Each rank takes one dense step and, from the same weights,
one step with the sparse table. The ranks must end with bitwise-equal
parameters, gradients and sparse moments, and those must equal the
single-process step on the whole batch, which this process takes
(:func:`step_errors`). With ``--model M`` the ranks form a (n / M, 1, M)
grid of (data, seq, model), each holding its shard of the split parameters
(``parallel/sharding.py:param_pspec``); each rank prints its place in the
grid and its parameter bytes beside one process's, and the states compared
are gathered whole. ::

    python -m structured_alignment_vqa_tpu_torch.parallel.dryrun --n 2 [--model 2] [--device cpu]

:func:`launch_local` starts and watches such processes; the tests and
``chip_smoke.py`` use it for their own workers.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from structured_alignment_vqa_tpu_torch.device import resolve_device
from structured_alignment_vqa_tpu_torch.parallel.mesh import free_ports

# the TPU package's dry-run model (__graft_entry__.py), dropout off so that
# the ranks and the single process draw no masks
DRYRUN_CFG = dict(
    num_classes=64, num_relations=16, vocab_size=4096, hidden_size=64, hidden_size_mil=32,
    num_blocks=3, num_heads=4, dropout_rate=0.0, maxlen=64, maxlen_q=8, maxlen_v=6, topn=2,
    stage1_blocks=1, stage2_blocks=2, only_obj=False, use_dec_mask=True, share_glove=True,
)
ROWS_PER_RANK = 2
BUCKET = dict(lv=8, lq=8, ls=16, n_rel=4)
LR = 1e-3
# the ranks' step against the single process's: the loss relative to its
# value and each summed gradient by the norm of its difference over its own
# norm (sums in another order: ~2e-6 seen); the parameters after the step
# element by element, where the gradient is above GRAD_FLOOR of its
# tensor's largest: Adam's first step moves an element by about lr times
# the sign of its gradient, and where the gradient is rounding noise
# (a K projection's bias, whose true gradient is 0) so is that sign
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5
PARAM_ATOL = 1e-5
GRAD_FLOOR = 1e-4
_MODULE = "structured_alignment_vqa_tpu_torch.parallel.dryrun"


def launch_local(commands: Sequence[List[str]], timeout: float) -> List[str]:
    """Run ``commands`` side by side and return their standard outputs.

    The checkout's root is put on each one's ``PYTHONPATH``. When one
    fails, or ``timeout`` seconds pass, every one still running is killed
    and ``RuntimeError`` carries the ends of their error outputs: a rank
    left waiting in a collective never outlives the run.
    """
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory() as tmp:
        outs = [open(os.path.join(tmp, f"{i}.out"), "w+") for i in range(len(commands))]
        errs = [open(os.path.join(tmp, f"{i}.err"), "w+") for i in range(len(commands))]
        procs = [subprocess.Popen(c, stdout=o, stderr=e, env=env, cwd=root)
                 for c, o, e in zip(commands, outs, errs)]
        deadline = time.monotonic() + timeout
        failed = None
        try:
            while any(p.poll() is None for p in procs):
                bad = [i for i, p in enumerate(procs) if p.returncode not in (None, 0)]
                if bad or time.monotonic() > deadline:
                    failed = f"process {bad[0]} exited {procs[bad[0]].returncode}" if bad \
                        else f"timed out after {timeout:g} s"
                    break
                time.sleep(0.05)
            else:
                bad = [i for i, p in enumerate(procs) if p.returncode != 0]
                if bad:
                    failed = f"process {bad[0]} exited {procs[bad[0]].returncode}"
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        texts = []
        for f in outs + errs:
            f.seek(0)
            texts.append(f.read())
            f.close()
    if failed:
        tails = "\n".join(f"--- process {i} ---\n{t[-3000:]}"
                          for i, t in enumerate(texts[len(commands):]))
        raise RuntimeError(f"local launch failed: {failed}\n{tails}")
    return texts[:len(commands)]


def _arrays(world: int) -> Dict[str, np.ndarray]:
    from structured_alignment_vqa_tpu_torch.data.synthetic import synthetic_arrays
    from structured_alignment_vqa_tpu_torch.models import ModelConfig

    return synthetic_arrays(ModelConfig(**DRYRUN_CFG), ROWS_PER_RANK * world, seed=1, **BUCKET)


def _steps(arrays: Dict[str, np.ndarray], device, mesh=None) -> dict:
    """One dense and one sparse step from the same weights; the state after
    each, whole, on the CPU; with a model axis also each rank's place and
    parameter bytes (``layout``)."""
    from structured_alignment_vqa_tpu_torch.data.synthetic import batch_from_arrays
    from structured_alignment_vqa_tpu_torch.models import AttModelX3, ModelConfig, init_random_
    from structured_alignment_vqa_tpu_torch.parallel.sharding import (
        full_grads,
        full_state_dict,
        put_batch,
    )
    from structured_alignment_vqa_tpu_torch.parallel.train_step import (
        create_train_state,
        make_train_step,
        shard_state,
    )

    cfg = ModelConfig(**DRYRUN_CFG)
    out = {}
    for sparse in (False, True):
        model = AttModelX3(cfg, device=device)
        init_random_(model, torch.Generator(device).manual_seed(0))
        state = create_train_state(model, LR, sparse_table=sparse)
        whole = sum(t.numel() * t.element_size() for t in model.state_dict().values())
        if mesh is not None:
            shard_state(state, mesh)
        if mesh is not None and not sparse:   # the sparse table stays whole
            out["layout"] = dict(data=mesh.data_index, seq=mesh.seq_index,
                                 model=mesh.model_index, shape=mesh.shape, whole=whole,
                                 mine=sum(t.numel() * t.element_size()
                                          for t in model.state_dict().values()))
        step = make_train_step(model, state.optimizer, cfg, sparse_table=sparse, mesh=mesh)
        batch = batch_from_arrays(arrays, "cpu")
        metrics = step(state, batch.to(device) if mesh is None else put_batch(batch, mesh))
        names = {k for k, _ in [*model.named_parameters(), *model.named_buffers()]}
        saved = {k: v.detach().cpu().clone() for k, v in full_state_dict(model).items()
                 if k in names}
        saved.update({"grad." + k: g.cpu().clone() for k, g in full_grads(model).items()})
        if sparse:
            saved["table_opt.mu"] = state.table_opt.mu.cpu()
        out["sparse" if sparse else "dense"] = {
            "state": saved, "metrics": {k: float(v) for k, v in metrics.items()}}
    return out


def _worker(argv: List[str]) -> None:
    from structured_alignment_vqa_tpu_torch.parallel.mesh import init_distributed, shutdown

    ap = argparse.ArgumentParser()
    for flag in ("--rank", "--world", "--model"):
        ap.add_argument(flag, type=int, required=True)
    for flag in ("--coordinator", "--out", "--device"):
        ap.add_argument(flag, required=True)
    a = ap.parse_args(argv)
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = init_distributed(a.coordinator, a.world, a.rank, backend="gloo", device=a.device,
                            model_parallel=a.model)
    try:
        # a data row's rows: the ranks of a model row take the same ones
        d = mesh.data_index
        rows = slice(d * ROWS_PER_RANK, (d + 1) * ROWS_PER_RANK)
        local = {k: v[rows] for k, v in _arrays(mesh.data).items()}
        torch.save(_steps(local, torch.device(a.device), mesh), f"{a.out}/rank{a.rank}.pt")
    finally:
        shutdown(mesh)


def dryrun_multichip(n_ranks: int = 2, device: "str | None" = None, timeout: float = 300,
                     model_parallel: int = 1) -> dict:
    """The dry run (module docstring) on ``device``, by default the card
    (``cuda:0``; ``RuntimeError`` without one); returns :func:`step_errors`
    of rank 0 against the single process per step, and raises
    ``RuntimeError`` when the ranks disagree with each other or an error
    exceeds its tolerance. With ``model_parallel`` > 1 it prints each rank's
    place in the grid and its parameter bytes."""
    if device is None:
        resolve_device(None)   # raises without a card
        device = "cuda:0"
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        coordinator = f"127.0.0.1:{free_ports()[0]}"
        launch_local([[sys.executable, "-m", _MODULE, "--worker", "--rank", str(r),
                       "--world", str(n_ranks), "--model", str(model_parallel),
                       "--coordinator", coordinator, "--out", tmp, "--device", device]
                      for r in range(n_ranks)], timeout)
        ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=True) for r in range(n_ranks)]
    for r, got in enumerate(ranks):
        lay = got["layout"]
        print(f"dryrun rank {r}: (data, seq, model) = ({lay['data']}, {lay['seq']}, "
              f"{lay['model']}) of {lay['shape']}; parameter and buffer bytes {lay['mine']:,} "
              f"of one process's {lay['whole']:,}")
    want = _steps(_arrays(n_ranks // model_parallel), torch.device(device))
    summary = {}
    for case, ref in want.items():
        for r, got in enumerate(ranks[1:], 1):
            for name, t in got[case]["state"].items():
                if not torch.equal(t, ranks[0][case]["state"][name]):
                    raise RuntimeError(f"dryrun {case}: rank {r} and rank 0 differ in {name}")
        summary[case] = step_errors(ranks[0][case], ref, want["dense"]["state"])
        bad = {k: v for k, v in summary[case].items() if v[0] > v[1]}
        if bad:
            raise RuntimeError(f"dryrun {case}: {n_ranks} ranks against one process: {bad}")
    return summary


def step_errors(got: dict, want: dict, grads: dict) -> dict:
    """``{what: (error, tolerance)}`` of a step ``got`` against ``want``
    (``{"state", "metrics"}`` as :func:`_steps` saves them): the loss, the
    worst gradient and the worst parameter (elements whose gradient in
    ``grads`` is above the floor; the sparse table's moment everywhere)."""
    loss = abs(got["metrics"]["loss"] - want["metrics"]["loss"]) / abs(want["metrics"]["loss"])
    grad = param = 0.0
    for name, w in want["state"].items():
        g = got["state"][name]
        if name.startswith("grad."):
            grad = max(grad, (g - w).norm().item() / max(w.norm().item(), 1e-30))
            continue
        diff = (g.float() - w.float()).abs()
        dg = grads.get("grad." + name)
        if dg is not None:
            diff = diff[dg.abs() > GRAD_FLOOR * dg.abs().max()]
        if diff.numel():
            param = max(param, diff.max().item())
    return {"loss": (loss, LOSS_RTOL), "grads": (grad, GRAD_RTOL), "params": (param, PARAM_ATOL)}


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--worker"]:
        _worker(argv[1:])
        return
    ap = argparse.ArgumentParser(description="data- and model-parallel dry run over local "
                                             "processes")
    ap.add_argument("--n", type=int, default=2)
    ap.add_argument("--model", type=int, default=1, help="the model axis's size")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the ranks on the CPU; by default they share cuda:0")
    a = ap.parse_args(argv)
    for case, row in dryrun_multichip(a.n, a.device, model_parallel=a.model).items():
        print(f"dryrun {case}: {row}")


if __name__ == "__main__":
    main()
