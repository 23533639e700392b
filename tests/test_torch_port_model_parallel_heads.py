"""The model axis where it does not divide the heads: a head spans model
ranks, and each rank computes every head its columns overlap
(``parallel/sharding.py:gather_heads``, ``ops/attention.py:_project``),
against the JAX package's (data, model) mesh, whose GSPMD reshards the
heads of such a layout.

One spawn serves the module: eight gloo ranks on the CPU (this file run as
a script) lay their group out as (data 2, model 4) and (data 1, seq 2,
model 4) (``parallel/mesh.py:grid``), run every case below and save what
they hold; the tests compare. The ranks run the plain versions of the
kernels (CPU tensors). At hidden 24 with 3 heads of 8 over model 4 (6
columns a rank), rank 0 computes head 0, rank 1 heads 0 and 1, rank 2
heads 1 and 2, rank 3 head 2. Checks, float32, at the tolerances of
``tests/test_torch_port_model_parallel.py``:

* each rank's tensors at (data 2, model 4) bitwise shard r of the JAX
  package's ``shard_params`` arrays on ``make_mesh(8, model_parallel=4)``;
* one dense obj-only (data 2, model 4) step against JAX's step on
  ``make_mesh(8, model_parallel=4)`` and against the port's one-process
  step on the whole batch: losses within 1e-5 relative, every gradient
  within 1e-5 of its norm, the parameters after Adam within 1e-5;
* one obj+rel (data 2, model 4) step through the flash path (525 keys)
  against the port's one-process step (which the obj+rel tests hold
  against JAX);
* (data 1, seq 2, model 4) forwards through ring and Ulysses attention at
  hidden 24 with 6 heads of 4 (2 heads a rank; Ulysses on all 6, which
  the seq axis divides) within 1e-5 of one process's logits;
* ``gather_heads`` alone: its output and its backward equal a single
  process's slice of the whole tensor and autograd through it, where two
  ranks share a head;
* graph attention with attention dropout and its weights returned
  (``attention_core``): the ranks draw the one-process mask for the
  global heads, so the output, the weights of a rank's heads and the
  input's gradient equal one process's.
"""

import os
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from structured_alignment_vqa_tpu_torch.data.synthetic import batch_from_arrays, synthetic_arrays
from structured_alignment_vqa_tpu_torch.models import AttModelX3, ModelConfig, init_random_
from structured_alignment_vqa_tpu_torch.ops import attention as attention_mod
from structured_alignment_vqa_tpu_torch.ops.attention import GraphGuidedAttention
from structured_alignment_vqa_tpu_torch.parallel.context import use_mesh
from structured_alignment_vqa_tpu_torch.parallel.dryrun import free_ports, launch_local
from structured_alignment_vqa_tpu_torch.parallel.mesh import grid, init_distributed, shutdown
from structured_alignment_vqa_tpu_torch.parallel.sharding import (
    full_grads,
    full_state_dict,
    gather_heads,
    head_range,
    shard_model,
    shard_params,
)
from structured_alignment_vqa_tpu_torch.parallel.train_step import (
    create_train_state,
    make_train_step,
    shard_state,
)

WORLD = 8
MODEL = 4
BATCH = 4
LR = 1e-3
LOGIT_ATOL = 1e-5
# hidden 24 over 3 heads of 8: model 4 splits the projections (6 columns a
# rank) but not the heads; vocab 1,024 and region features of 32 so that
# the table, fc1 and the heads' hidden layers split too
HEADS_KW = dict(
    num_classes=11, num_relations=7, vocab_size=1024, glove_dim=12, vis_fea_dim=32,
    hidden_size=24, hidden_size_mil=16, num_blocks=3, num_heads=3, dropout_rate=0.0,
    maxlen=32, maxlen_q=8, maxlen_v=6, topn=2, stage1_blocks=1, stage2_blocks=2,
)
# obj+rel: 520 macro nodes + 5 question tokens take the flash path
REL_KW = dict(HEADS_KW, only_obj=False, maxlen=1024, hidden_size_mil=8)
# 6 heads of 4 over model 4: 2 heads a rank, and seq 2 divides the 6 heads
SEQ_KW = dict(HEADS_KW, num_heads=6)
BUCKETS = {"dense": dict(lv=4, lq=5, ls=10), "objrel": dict(lv=4, lq=5, ls=520),
           "seq": dict(lv=4, lq=4, ls=12)}   # seq: encoder lengths 8 and 16
SEQ_IMPLS = ("ring", "ulysses")
# gather_heads alone: (B, T, C) over model 4 at head width 8
GATHER_SHAPE = (2, 5, 24)
GATHER_HEAD_DIM = 8
DROPOUT = 0.3


def _rows(arrays, mesh):
    """This rank's data row's share of the batch (rank-major)."""
    n = len(next(iter(arrays.values()))) // mesh.data
    return {k: v[mesh.data_index * n:(mesh.data_index + 1) * n] for k, v in arrays.items()}


def _model(kw, weights, **extra):
    model = AttModelX3(ModelConfig(share_glove=True, **kw, **extra), device="cpu")
    model.load_state_dict(weights)
    return model


def gather_inputs():
    """The whole tensor and each rank's output weights of the gather_heads
    case, drawn from a seed."""
    gen = torch.Generator().manual_seed(21)
    x = torch.randn(GATHER_SHAPE, generator=gen)
    cols = GATHER_SHAPE[-1] // MODEL
    ws = []
    for r in range(MODEL):
        lo, hi = head_range(r, cols, GATHER_HEAD_DIM)
        ws.append(torch.randn(*GATHER_SHAPE[:-1], (hi - lo) * GATHER_HEAD_DIM, generator=gen))
    return x, ws


def dropout_attention(weights):
    att = GraphGuidedAttention(24, 3, device="cpu", dropout_rate=DROPOUT, return_att=True)
    att.load_state_dict(weights)
    return att.train()


def dropout_run(att, inputs):
    """``(out, weights, dx)`` of one training-mode call with dropout drawn
    from a seeded generator, the loss ``sum(out * dy)``."""
    x = inputs["x"].clone().requires_grad_()
    gen = torch.Generator().manual_seed(4)
    out, weights = att(x, x, x, inputs["graph"], generator=gen)
    (out * inputs["dy"]).sum().backward()
    return out.detach(), weights.detach(), x.grad


# ---- the ranks: this file run as a script --------------------------------

def _step_rank(case, mesh):
    cfg = ModelConfig(share_glove=True, **case["kw"])
    model = _model(case["kw"], case["weights"])
    state = shard_state(create_train_state(model, LR), mesh)
    step = make_train_step(model, state.optimizer, cfg, mesh=mesh)
    m = step(state, batch_from_arrays(_rows(case["arrays"], mesh), "cpu"))
    return {"metrics": {k: float(v) for k, v in m.items()},
            "params": {k: v.clone() for k, v in full_state_dict(model).items()},
            "grads": {n: g.clone() for n, g in full_grads(model).items()}}


def _worker(rank, coordinator, tmp):
    torch.set_num_threads(1)
    base = init_distributed(coordinator, WORLD, rank, device="cpu")
    try:
        dm, sm = grid(base, 1, MODEL), grid(base, 2, MODEL)
        inputs = torch.load(f"{tmp}/inputs.pt", weights_only=False)
        out = {"layout": [(m.data_index, m.seq_index, m.model_index, m.data, m.seq, m.model)
                          for m in (dm, sm)]}
        model = _model(HEADS_KW, inputs["dense"]["weights"])
        shard_params(model, dm)
        out["shards"] = {k: v.clone() for k, v in model.state_dict().items()}
        for name in ("dense", "objrel"):
            out[name] = _step_rank(inputs[name], dm)

        # ring and Ulysses on (data 1, seq 2, model 4), each call counted
        calls = dict.fromkeys(SEQ_IMPLS, 0)
        for impl, attr in (("ring", "ring_graph_attention"),
                           ("ulysses", "ulysses_graph_attention")):
            def counted(*a, _fn=getattr(attention_mod, attr), _impl=impl, **kw):
                calls[_impl] += 1
                return _fn(*a, **kw)
            setattr(attention_mod, attr, counted)
        for impl in SEQ_IMPLS:
            model = _model(SEQ_KW, inputs["seq"]["weights"], seq_axis="seq", seq_impl=impl)
            shard_params(model, sm)
            model.eval()
            with torch.no_grad(), use_mesh(sm):
                out[impl] = model(batch_from_arrays(inputs["seq"]["arrays"], "cpu"))[0]
        out["seq_calls"] = calls

        # gather_heads alone over the model row of (data 2, model 4)
        x, ws = gather_inputs()
        cols = GATHER_SHAPE[-1] // MODEL
        r = dm.model_index
        mine = x[..., r * cols:(r + 1) * cols].clone().requires_grad_()
        y = gather_heads(mine, dm, *head_range(r, cols, GATHER_HEAD_DIM), GATHER_HEAD_DIM)
        (y * ws[r]).sum().backward()
        out["gather_heads"] = (y.detach(), mine.grad)

        # attention dropout and weights out, through attention_core
        att = dropout_attention(inputs["dropout"]["weights"])
        shard_model(att, dm)
        out["dropout"] = dropout_run(att, inputs["dropout"])
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        shutdown(base)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
    sys.exit(0)


# ---- the tests ------------------------------------------------------------

import structured_alignment_vqa_tpu.ops.pallas_attention as pa  # noqa: E402
from structured_alignment_vqa_tpu_torch.parallel.sharding import param_pspec  # noqa: E402
from test_torch_port_model_parallel import (  # noqa: E402
    _jax_case,
    assert_step_matches,
    jax_mesh_step,
    jax_shards,
    port_cases,
    port_single_step,
)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def _port_case(kw, name, seed):
    """Seeded random weights (off the LayerNorm knife edge) and a batch."""
    model = AttModelX3(ModelConfig(share_glove=True, **kw), device="cpu")
    init_random_(model, torch.Generator().manual_seed(seed))
    arrays = synthetic_arrays(ModelConfig(share_glove=True, **kw), BATCH, seed=seed,
                              **BUCKETS[name])
    return {"name": name, "kw": kw, "sparse": False, "arrays": arrays,
            "weights": {k: v.clone() for k, v in model.state_dict().items()}}


def _dropout_inputs():
    gen = torch.Generator().manual_seed(31)
    att = GraphGuidedAttention(24, 3, device="cpu")
    init_random_(att, gen)
    x = torch.randn(2, 7, 24, generator=gen)
    dy = torch.randn(2, 7, 24, generator=gen)
    # padding rows: masked keys and queries, no gradient into their LayerNorm
    # of an all-zero row (whose backward divides by its zero variance)
    x[1, 5:] = dy[1, 5:] = 0.0
    return {"weights": att.state_dict(), "x": x,
            "graph": (torch.rand(2, 7, 7, generator=gen) > 0.4).float(), "dy": dy}


@pytest.fixture(scope="module")
def heads_world():
    """The cases, what each rank holds after them, and the references:
    JAX's mesh step and shards, the port's one-process steps and forwards
    (computed while the ranks run)."""
    torch.set_num_threads(1)
    cases = {"dense": _jax_case(HEADS_KW, "dense", 7),
             "objrel": _port_case(REL_KW, "objrel", 9), "seq": _port_case(SEQ_KW, "seq", 5)}
    inputs = {**port_cases(cases), "dropout": _dropout_inputs()}
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(1) as pool:
        torch.save(inputs, f"{tmp}/inputs.pt")
        coordinator = f"127.0.0.1:{free_ports()[0]}"
        here = os.path.abspath(__file__)
        done = pool.submit(launch_local, [[sys.executable, here, str(r), coordinator, tmp]
                                          for r in range(WORLD)], 420)
        pa.INTERPRET_MODE = True
        try:
            want = jax_mesh_step(cases["dense"], WORLD, MODEL)
            shards = jax_shards(cases["dense"]["jparams"], MODEL, WORLD, HEADS_KW["num_blocks"])
        finally:
            pa.INTERPRET_MODE = False
        single = {name: port_single_step(cases[name]) for name in ("dense", "objrel")}
        model = _model(SEQ_KW, cases["seq"]["weights"]).eval()
        with torch.no_grad():
            single["seq"] = model(batch_from_arrays(cases["seq"]["arrays"], "cpu"))[0]
        single["dropout"] = dropout_run(dropout_attention(inputs["dropout"]["weights"]),
                                        inputs["dropout"])
        done.result()
        ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=True) for r in range(WORLD)]
    return ranks, want, shards, single


def test_ranks_form_the_data_model_grids(heads_world):
    ranks, *_ = heads_world
    for r, out in enumerate(ranks):
        assert out["layout"] == [(r // 4, 0, r % 4, 2, 1, 4), (0, r // 4, r % 4, 1, 2, 4)]


def test_each_rank_holds_shard_r_of_the_jax_arrays_bitwise(heads_world):
    ranks, _, shards, _ = heads_world
    for r, out in enumerate(ranks):
        mine = out["shards"]
        for name, per_device in shards.items():
            np.testing.assert_array_equal(mine[name].numpy(), per_device[r],
                                          err_msg=f"rank {r} {name}")
        # the projections split by columns: 6 of 24, less than a head of 8
        blk = "att_syb.enc_self_attention_0"
        assert mine[f"{blk}.Q_proj.0.weight"].shape == (6, 24)
        assert param_pspec(f"{blk}.Q_proj.0.weight", (24, 24), MODEL) == 0


def test_data2_model4_step_over_split_heads_equals_jax_mesh_step_and_one_process(heads_world):
    ranks, want, _, single = heads_world
    got = ranks[0]["dense"]
    assert_step_matches(got, want, "jax")
    assert_step_matches(got, single["dense"], "one process")
    for out in ranks[1:]:
        assert all(torch.equal(out["dense"]["params"][k], v) for k, v in got["params"].items())


def test_objrel_data2_model4_step_over_split_heads_equals_one_process(heads_world):
    ranks, _, _, single = heads_world
    got = ranks[0]["objrel"]
    assert_step_matches(got, single["objrel"], "one process")
    assert got["grads"]["MIL_NCE.R"].abs().max() > 0
    for out in ranks[1:]:
        assert all(torch.equal(out["objrel"]["params"][k], v) for k, v in got["params"].items())


@pytest.mark.parametrize("impl", SEQ_IMPLS)
def test_seq2_model4_forward_over_split_heads_equals_one_process(heads_world, impl):
    ranks, _, _, single = heads_world
    for r, out in enumerate(ranks):
        err = (out[impl] - single["seq"]).abs().max().item()
        assert err <= LOGIT_ATOL, (impl, r, err)
        # the encoders' self-attention took the seq path: 6 blocks a forward
        assert out["seq_calls"][impl] == 2 * SEQ_KW["num_blocks"], out["seq_calls"]


def test_gather_heads_backward_sums_the_shares_of_a_shared_head(heads_world):
    ranks, *_ = heads_world
    x, ws = gather_inputs()
    whole = x.clone().requires_grad_()
    cols, d = GATHER_SHAPE[-1] // MODEL, GATHER_HEAD_DIM
    ranges = [head_range(r, cols, d) for r in range(MODEL)]
    assert ranges == [(0, 1), (0, 2), (1, 3), (2, 3)]   # ranks 0 and 1 share head 0, ...
    sum((whole[..., lo * d:hi * d] * w).sum() for (lo, hi), w in zip(ranges, ws)).backward()
    for rank, out in enumerate(ranks):
        r = rank % MODEL
        y, grad = out["gather_heads"]
        lo, hi = ranges[r]
        assert torch.equal(y, x[..., lo * d:hi * d])
        assert torch.equal(grad, whole.grad[..., r * cols:(r + 1) * cols]), rank
        # a slice of this rank's own gradient would miss the other ranks' shares
        own = torch.zeros(*GATHER_SHAPE[:-1], MODEL * cols)
        own[..., lo * d:hi * d] = ws[r]
        assert not torch.equal(grad, own[..., r * cols:(r + 1) * cols]), rank


def test_attention_dropout_over_split_heads_draws_the_one_process_mask(heads_world):
    ranks, _, _, single = heads_world
    out, weights, dx = single["dropout"]
    cols, d = 24 // MODEL, 8
    for rank, got in enumerate(ranks):
        lo, hi = head_range(rank % MODEL, cols, d)
        g_out, g_weights, g_dx = got["dropout"]
        assert (g_out - out).abs().max().item() <= LOGIT_ATOL, rank
        assert torch.allclose(g_weights, weights[:, lo:hi], rtol=0, atol=1e-6), rank
        assert (g_dx - dx).abs().max().item() <= LOGIT_ATOL * dx.abs().max().item(), rank
