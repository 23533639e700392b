"""The port's model axis (``parallel/sharding.py:param_pspec`` and its
collectives, the split layers of ``ops/layers.py``, ``ops/attention.py``,
``models/att_model_x3.py`` and ``ops/quant.py``, the model axis of
``parallel/mesh.py`` and ``parallel/train_step.py``, whole-tensor
checkpoints) against the JAX package's (data, model) mesh, as
``tests/test_train_step.py:118`` and ``tests/test_sparse_table.py:290``
hold the JAX package's.

One spawn serves the module: four gloo ranks on the CPU (this file run as
a script) lay their group out as (data 2, model 2), (data 1, seq 2, model
2) and (data 1, model 4) (``parallel/mesh.py:grid``), run every case below
and save what they hold; the tests compare. The ranks run the plain
versions of the kernels (CPU tensors), 4 heads at hidden 16. The obj+rel
step has a file and a spawn of its own
(``tests/test_torch_port_model_parallel_rel.py``), so that each file's
JAX references fit about a minute. Checks, float32:

* each rank's tensors at model 2 and 4 bitwise shard r of the JAX
  package's ``shard_params`` arrays on ``make_mesh(4, model_parallel=n)``;
* one (data 2, model 2) step, dense and with the sparse table (obj-only;
  obj+rel through the flash path in the other file), against JAX's step on
  ``make_mesh(4, model_parallel=2)`` and against the port's one-process
  step on the whole batch: losses within 1e-5 relative, every gradient
  within 1e-5 of its norm, the parameters after Adam within 1e-5, the
  sparse table and its moments whole on every rank, every rank's whole
  parameters bitwise the same;
* a (data 1, seq 2, model 2) forward and a (data 1, model 4) forward within
  1e-5 of one process's logits;
* a model-2 checkpoint and ``.pth`` load in one process bitwise, and a
  one-process checkpoint loads into model-2 ranks bitwise;
* graph attention with attention dropout and its weights returned, its 4
  heads whole on each of the model-2 ranks (2 a rank): every rank draws
  one process's (B, H, Tq, Tk) mask and slices its heads' share, so the
  weights, the output and dx are one process's, and the two ranks' heads
  drop different weights.
"""

import os
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

from unittest import mock

import numpy as np
import pytest
import torch

from structured_alignment_vqa_tpu_torch.data.synthetic import batch_from_arrays, synthetic_arrays
from structured_alignment_vqa_tpu_torch.models import AttModelX3, ModelConfig, init_random_
from structured_alignment_vqa_tpu_torch.models.torch_export import save_pth
from structured_alignment_vqa_tpu_torch.ops.attention import GraphGuidedAttention
from structured_alignment_vqa_tpu_torch.parallel.context import use_mesh
from structured_alignment_vqa_tpu_torch.parallel.dryrun import GRAD_FLOOR, free_ports, launch_local
from structured_alignment_vqa_tpu_torch.parallel.mesh import grid, init_distributed, shutdown
from structured_alignment_vqa_tpu_torch.parallel.sharding import (
    full_grads,
    full_state_dict,
    shard_model,
    shard_params,
)
from structured_alignment_vqa_tpu_torch.parallel.sparse_table import TABLE_NAME
from structured_alignment_vqa_tpu_torch.parallel.train_step import (
    create_train_state,
    make_train_step,
    shard_state,
)
from structured_alignment_vqa_tpu_torch.utils.checkpoint import (
    load_params_for_eval,
    save_checkpoint,
)

WORLD = 4
BATCH = 4
LR = 1e-3
B1 = 0.9
LOSS_RTOL = GRAD_RTOL = PARAM_ATOL = LOGIT_ATOL = 1e-5
# hidden 16 over 4 heads; vocab 1,024 and region features of 32 so that
# every rule of param_pspec splits something: the table by rows, the
# projections, fc1, syb_mlp, ipt_mlp and the heads' hidden layers by
# columns, fc2, syb_mlp2 and cls_hidden by rows
TINY_KW = dict(
    num_classes=11, num_relations=7, vocab_size=1024, glove_dim=12, vis_fea_dim=32,
    hidden_size=16, hidden_size_mil=16, num_blocks=3, num_heads=4, dropout_rate=0.0,
    maxlen=32, maxlen_q=8, maxlen_v=6, topn=2, stage1_blocks=1, stage2_blocks=2,
)
# obj+rel: maxlen 1,024 splits the positional tables by rows, hidden_size_mil
# 8 splits marco_mlp and syb_mlp by rows, and 520 macro nodes + 5 question
# tokens take the flash path (more than 512 keys)
REL_KW = dict(TINY_KW, only_obj=False, maxlen=1024, hidden_size_mil=8)
BUCKETS = {"obj": dict(lv=4, lq=5, ls=10), "rel": dict(lv=4, lq=5, ls=520)}
SEQ_BUCKET = dict(lv=4, lq=4, ls=12)     # encoder lengths 8 and 16: both divide seq 2
STEP_CASES = ("dense", "sparse")
# graph attention with dropout, hidden 16 over 4 heads: whole heads at model 2
DROPOUT = 0.3
DROPOUT_HEADS = 4


def _rows(arrays, mesh):
    """This rank's data row's share of the batch (rank-major)."""
    n = len(next(iter(arrays.values()))) // mesh.data
    return {k: v[mesh.data_index * n:(mesh.data_index + 1) * n] for k, v in arrays.items()}


def dropout_attention(weights):
    att = GraphGuidedAttention(16, DROPOUT_HEADS, device="cpu", dropout_rate=DROPOUT,
                               return_att=True)
    att.load_state_dict(weights)
    return att.train()


def dropout_run(att, inputs):
    """``(out, weights, dx, the dropout masks drawn)`` of one training-mode
    call with dropout drawn from a seeded generator, the loss ``sum(out *
    dy)``."""
    x = inputs["x"].clone().requires_grad_()
    gen = torch.Generator().manual_seed(4)
    draws, bernoulli = [], torch.bernoulli

    def drawn(*a, **kw):
        draws.append(bernoulli(*a, **kw))
        return draws[-1]

    with mock.patch.object(torch, "bernoulli", drawn):
        out, weights = att(x, x, x, inputs["graph"], generator=gen)
    (out * inputs["dy"]).sum().backward()
    return out.detach(), weights.detach(), x.grad, draws


# ---- the ranks: this file run as a script --------------------------------

def _model(kw, weights, **extra):
    model = AttModelX3(ModelConfig(share_glove=True, **kw, **extra), device="cpu")
    model.load_state_dict(weights)
    return model


def _step_rank(spec, mesh, tmp):
    sparse = spec["sparse"]
    cfg = ModelConfig(share_glove=True, **spec["kw"])
    model = _model(spec["kw"], spec["weights"])
    state = shard_state(create_train_state(model, LR, sparse_table=sparse), mesh)
    step = make_train_step(model, state.optimizer, cfg, sparse_table=sparse, mesh=mesh)
    m = step(state, batch_from_arrays(_rows(spec["arrays"], mesh), "cpu"))
    out = {"metrics": {k: float(v) for k, v in m.items()},
           "params": {k: v.clone() for k, v in full_state_dict(model).items()},
           "grads": {n: g.clone() for n, g in full_grads(model).items()},
           "table_whole": tuple(model.get_parameter(TABLE_NAME).shape)}
    if sparse:
        out["mu"] = state.table_opt.mu.clone()
    if spec["name"] == "dense":
        # whole-tensor files from the split state (rank 0 writes them)
        save_checkpoint(f"{tmp}/ckpt_mp", state, 1, mesh=mesh)
        if mesh.rank == 0:
            save_pth(f"{tmp}/mp.pth", model)
        else:
            full_state_dict(model)   # export_state_dict's gathers, on every rank of the row
    return out


def _worker(rank, coordinator, tmp):
    torch.set_num_threads(1)
    base = init_distributed(coordinator, WORLD, rank, device="cpu")
    try:
        dm, sm, m4 = grid(base, 1, 2), grid(base, 2, 2), grid(base, 1, 4)
        inputs = torch.load(f"{tmp}/inputs.pt", weights_only=False)
        out = {"layout": [(m.data_index, m.seq_index, m.model_index, m.data, m.seq, m.model)
                          for m in (dm, sm, m4)]}
        for case in inputs["steps"]:
            out[case] = _step_rank(inputs[case], dm, tmp)
        if inputs["steps"] != STEP_CASES:
            torch.save(out, f"{tmp}/rank{rank}.pt")
            return
        for name, mesh in (("model2", dm), ("model4", m4)):
            model = _model(TINY_KW, inputs["dense"]["weights"])
            shard_params(model, mesh)
            out[name] = {k: v.clone() for k, v in model.state_dict().items()}
        # forwards on (data 1, seq 2, model 2) and (data 1, model 4)
        for name, mesh, extra, arrays in (
                ("seq_model", sm, dict(seq_axis="seq"), inputs["seq_arrays"]),
                ("model4_forward", m4, {}, inputs["dense"]["arrays"])):
            model = _model(TINY_KW, inputs["dense"]["weights"], **extra)
            shard_params(model, mesh)
            model.eval()
            with torch.no_grad(), use_mesh(mesh):
                out[name] = model(batch_from_arrays(arrays, "cpu"))[0]
        # a one-process checkpoint into model-2 ranks
        model = _model(TINY_KW, inputs["dense"]["weights"])
        load_params_for_eval(f"{tmp}/ckpt_one", model)
        shard_params(model, dm)
        out["loaded"] = {k: v.clone() for k, v in model.state_dict().items()}
        # attention dropout on whole heads over the model row of (data 2, model 2)
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

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

import structured_alignment_vqa_tpu.ops.pallas_attention as pa  # noqa: E402
from structured_alignment_vqa_tpu.parallel.mesh import make_mesh  # noqa: E402
from structured_alignment_vqa_tpu.parallel.sharding import param_pspec as jax_pspec  # noqa: E402
from structured_alignment_vqa_tpu.parallel.sparse_table import (  # noqa: E402
    TABLE_PATH,
    init_table_opt,
)
from structured_alignment_vqa_tpu.parallel.train_step import TrainState as JaxState  # noqa: E402
from structured_alignment_vqa_tpu.parallel.train_step import adam as jax_adam  # noqa: E402
from structured_alignment_vqa_tpu.parallel.train_step import (  # noqa: E402
    _empty_like,
    _tree_get,
    _tree_set,
    put_batch,
)
from structured_alignment_vqa_tpu.parallel.train_step import (  # noqa: E402
    make_train_step as jax_train_step,
)
from structured_alignment_vqa_tpu.parallel.train_step import (  # noqa: E402
    shard_state as jax_shard_state,
)
from structured_alignment_vqa_tpu_torch.models.convert import (  # noqa: E402
    name_map,
    state_dict_from_jax,
    table_opt_from_jax,
)
from structured_alignment_vqa_tpu_torch.models.torch_import import (  # noqa: E402
    import_torch_state_dict,
)
from structured_alignment_vqa_tpu_torch.parallel.sharding import (  # noqa: E402
    param_pspec,
)
from test_torch_port_model import JaxConfig, JaxModel, jax_batch, perturbed  # noqa: E402


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def spawn_ranks(pool, tmp, inputs):
    """Start the four ranks on ``inputs`` (saved to ``tmp``); returns the
    future of their outputs."""
    torch.save(inputs, f"{tmp}/inputs.pt")
    coordinator = f"127.0.0.1:{free_ports()[0]}"
    here = os.path.abspath(__file__)
    return pool.submit(launch_local, [[sys.executable, here, str(r), coordinator, tmp]
                                      for r in range(WORLD)], 420)


def _jax_case(kw, name, seed):
    model = JaxModel(JaxConfig(share_glove=True, **kw))
    arrays = synthetic_arrays(ModelConfig(share_glove=True, **kw), BATCH, seed=seed,
                              **BUCKETS["rel" if name == "objrel" else "obj"])
    init = jax.jit(model.init)(jax.random.key(0), jax_batch(arrays))["params"]
    params, jparams = perturbed(init, seed=seed)
    return {"name": name, "kw": kw, "sparse": name == "sparse", "arrays": arrays,
            "jparams": jparams, "jmodel": model,
            "weights": state_dict_from_jax(params, kw["num_blocks"])}


def port_cases(cases):
    """The cases as the ranks take them: without the JAX side."""
    return {name: {k: v for k, v in c.items() if k not in ("jparams", "jmodel")}
            for name, c in cases.items()}


def jax_mesh_step(case, n_devices=WORLD, model_parallel=2):
    """JAX's step on ``make_mesh(n_devices, model_parallel)`` (state laid out by
    its ``shard_state``, the batch by ``put_batch``): the metrics, the params
    after it and the gradients (Adam's first moment over 1 - b1), whole, by
    the port's names."""
    model, tx = case["jmodel"], jax_adam(LR)
    params = jax.tree.map(jnp.array, case["jparams"])
    if case["sparse"]:
        table = _tree_get(params, TABLE_PATH)
        opt_state = (tx.init(_tree_set(params, TABLE_PATH, _empty_like(table))),
                     init_table_opt(table))
    else:
        opt_state = tx.init(params)
    mesh = make_mesh(n_devices, model_parallel=model_parallel)
    state = jax_shard_state(JaxState(step=jnp.zeros((), jnp.int32), params=params,
                                     opt_state=opt_state), mesh)
    step = jax_train_step(model, tx, model.cfg, sparse_table=case["sparse"], table_lr=LR)
    state, m = step(state, put_batch(jax_batch(case["arrays"]), mesh), jax.random.key(1))
    nb = case["kw"]["num_blocks"]
    adam_state = (state.opt_state[0] if case["sparse"] else state.opt_state)[0]
    grads = jax.tree.map(lambda mu: mu / (1 - B1), jax.device_get(adam_state.mu))
    out = {"metrics": {k: float(v) for k, v in m.items()},
           "params": state_dict_from_jax(jax.device_get(state.params), nb),
           "grads": state_dict_from_jax(grads, nb)}
    if case["sparse"]:
        out["mu"] = table_opt_from_jax(jax.device_get(state.opt_state[1]))["mu"]
        out["grads"][TABLE_NAME] = out["mu"] / (1 - B1)
    return out


def port_single_step(case):
    """The port's one-process step on the whole batch."""
    cfg = ModelConfig(share_glove=True, **case["kw"])
    model = _model(case["kw"], case["weights"])
    state = create_train_state(model, LR, sparse_table=case["sparse"])
    m = make_train_step(model, state.optimizer, cfg, sparse_table=case["sparse"])(
        state, batch_from_arrays(case["arrays"], "cpu"))
    out = {"metrics": {k: float(v) for k, v in m.items()},
           "params": {k: v.clone() for k, v in model.state_dict().items()},
           "grads": {n: p.grad.clone() for n, p in model.named_parameters()
                     if p.grad is not None}}
    if case["sparse"]:
        out["mu"] = state.table_opt.mu.clone()
        out["grads"][TABLE_NAME] = out["mu"] / (1 - B1)
    return out


def jax_shards(jparams, n, n_devices=WORLD, num_blocks=TINY_KW["num_blocks"]):
    """{port name: [shard of device d for d in 0..n_devices-1]} of the JAX
    package's params laid out by its rules on ``make_mesh(n_devices,
    model_parallel=n)``."""
    mesh = make_mesh(n_devices, model_parallel=n)
    placed = jax.tree_util.tree_map_with_path(
        lambda path, v: jax.device_put(v, NamedSharding(mesh, jax_pspec(path, v, n))), jparams)
    devices = list(mesh.devices.reshape(-1))
    out = {}
    for tname, path, transpose in name_map(num_blocks):
        node = placed
        for key in path:
            node = node.get(key) if isinstance(node, dict) else None
        if node is None:
            continue
        by_device = {s.device: np.asarray(s.data) for s in node.addressable_shards}
        out[tname] = [by_device[d].T if transpose else by_device[d] for d in devices]
    glove = placed["glove"]["table"]
    by_device = {s.device: np.asarray(s.data) for s in glove.addressable_shards}
    out[TABLE_NAME] = [by_device[d] for d in devices]
    return out


def _dropout_inputs():
    gen = torch.Generator().manual_seed(31)
    att = GraphGuidedAttention(16, DROPOUT_HEADS, device="cpu")
    init_random_(att, gen)
    x = torch.randn(2, 7, 16, generator=gen)
    dy = torch.randn(2, 7, 16, generator=gen)
    # padding rows: masked keys and queries, no gradient into their LayerNorm
    # of an all-zero row (whose backward divides by its zero variance)
    x[1, 5:] = dy[1, 5:] = 0.0
    return {"weights": att.state_dict(), "x": x,
            "graph": (torch.rand(2, 7, 7, generator=gen) > 0.4).float(), "dy": dy}


@pytest.fixture(scope="module")
def model_world():
    """The cases, what each rank holds after them, and the references:
    JAX's mesh steps and the port's one-process steps and forwards
    (computed while the ranks run)."""
    torch.set_num_threads(1)
    cases = {"dense": _jax_case(TINY_KW, "dense", 7)}
    cases["sparse"] = dict(cases["dense"], name="sparse", sparse=True)
    seq_arrays = synthetic_arrays(ModelConfig(share_glove=True, **TINY_KW), BATCH, seed=5,
                                  **SEQ_BUCKET)
    dropout = _dropout_inputs()
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(1) as pool:
        one = _model(TINY_KW, cases["dense"]["weights"])
        save_checkpoint(f"{tmp}/ckpt_one", create_train_state(one, LR), 1)
        done = spawn_ranks(pool, tmp, {**port_cases(cases), "seq_arrays": seq_arrays,
                                       "steps": STEP_CASES, "dropout": dropout})
        pa.INTERPRET_MODE = True
        try:
            want = {name: jax_mesh_step(cases[name]) for name in STEP_CASES}
            shards = {n: jax_shards(cases["dense"]["jparams"], n) for n in (2, 4)}
        finally:
            pa.INTERPRET_MODE = False
        single = {name: port_single_step(cases[name]) for name in STEP_CASES}
        forwards = {}
        for name, arrays in (("seq_model", seq_arrays),
                             ("model4_forward", cases["dense"]["arrays"])):
            model = _model(TINY_KW, cases["dense"]["weights"]).eval()
            with torch.no_grad():
                forwards[name] = model(batch_from_arrays(arrays, "cpu"))[0]
        forwards["dropout"] = dropout_run(dropout_attention(dropout["weights"]), dropout)
        done.result()
        ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=True) for r in range(WORLD)]
        files = {"ckpt": torch.load(f"{tmp}/ckpt_mp/epoch_1.pt", weights_only=True),
                 "pth": torch.load(f"{tmp}/mp.pth", weights_only=True),
                 "one": torch.load(f"{tmp}/ckpt_one/epoch_1.pt", weights_only=True)}
    return cases, ranks, want, single, forwards, shards, files


def test_ranks_form_the_data_seq_model_grid(model_world):
    _, ranks, *_ = model_world
    for r, out in enumerate(ranks):
        assert out["layout"] == [(r // 2, 0, r % 2, 2, 1, 2), (0, r // 2, r % 2, 1, 2, 2),
                                 (0, 0, r, 1, 1, 4)]


@pytest.mark.parametrize("n", [2, 4])
def test_each_rank_holds_shard_r_of_the_jax_arrays_bitwise(model_world, n):
    _, ranks, _, _, _, shards, _ = model_world
    for r, out in enumerate(ranks):
        mine = out[f"model{n}"]
        for name, per_device in shards[n].items():
            np.testing.assert_array_equal(mine[name].numpy(), per_device[r],
                                          err_msg=f"model {n} rank {r} {name}")
        # the table by rows, q/k/v and fc1 by columns, fc2 by rows
        blk = "att_syb.enc_self_attention_0"
        assert mine[TABLE_NAME].shape[0] == TINY_KW["vocab_size"] // n
        assert mine[f"{blk}.Q_proj.0.weight"].shape == (16 // n, 16)
        assert mine["att_syb.enc_feed_forward_0.conv2.weight"].shape == (16, 64 // n)


def _grad_errors(got, want):
    joint = sum(w.norm().item() ** 2 for w in want.values()) ** 0.5
    return {name: (g - want[name]).norm().item() / (want[name].norm().item() or joint)
            for name, g in got.items()}


def assert_step_matches(got, want, what):
    for key in ("loss", "ce", "mil_nce_loss"):
        a, b = got["metrics"][key], want["metrics"][key]
        assert abs(a - b) <= LOSS_RTOL * abs(b), (what, key, a, b)
    for key in ("n", "n_correct", "skipped"):
        assert got["metrics"][key] == want["metrics"][key], (what, key)
    grads = dict(got["grads"])
    if "mu" in got:
        grads[TABLE_NAME] = got["mu"] / (1 - B1)
    errs = _grad_errors(grads, want["grads"])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_RTOL, (what, worst, errs[worst])
    for name in grads:
        g = want["grads"][name]
        above = g.abs() > GRAD_FLOOR * g.abs().max()
        diff = (got["params"][name] - want["params"][name]).abs()[above]
        assert diff.numel() == 0 or diff.max() <= PARAM_ATOL, (what, name, diff.max())


@pytest.mark.parametrize("case", STEP_CASES)
def test_data2_model2_step_equals_jax_mesh_step_and_one_process(model_world, case):
    cases, ranks, want, single, *_ = model_world
    got = ranks[0][case]
    assert_step_matches(got, want[case], "jax")
    assert_step_matches(got, single[case], "one process")
    for out in ranks[1:]:
        assert all(torch.equal(out[case]["params"][k], v) for k, v in got["params"].items())
    # the sparse table stays whole on every rank; split otherwise
    table_rows = cases[case]["kw"]["vocab_size"]
    assert got["table_whole"][0] == (table_rows if case == "sparse" else table_rows // 2)


@pytest.mark.parametrize("name", ["seq_model", "model4_forward"])
def test_seq_model_and_model4_forwards_equal_one_process(model_world, name):
    _, ranks, _, _, forwards, _, _ = model_world
    for r, out in enumerate(ranks):
        err = (out[name] - forwards[name]).abs().max().item()
        assert err <= LOGIT_ATOL, (name, r, err)


def test_checkpoints_are_whole_both_ways(model_world):
    cases, ranks, _, _, _, _, files = model_world
    whole = ranks[0]["dense"]["params"]
    # the model-2 checkpoint and .pth load in one process bitwise
    ckpt = files["ckpt"]
    params = dict(ckpt["params"], **{a: ckpt["params"][s] for a, s in ckpt["tied"].items()})
    model = _model(TINY_KW, cases["dense"]["weights"])
    model.load_state_dict(params)
    assert all(torch.equal(model.state_dict()[k], v) for k, v in whole.items())
    model = _model(TINY_KW, cases["dense"]["weights"])
    assert import_torch_state_dict(files["pth"], model) == []
    assert all(torch.equal(model.state_dict()[k], v) for k, v in whole.items())
    # Adam's moments whole too (a parameter without a gradient has none)
    moments = ckpt["optimizer"]["state"]
    shapes = [tuple(p.shape) for p in model.parameters()]
    assert moments and all(tuple(m["exp_avg"].shape) == shapes[i] for i, m in moments.items())
    # a one-process checkpoint into model-2 ranks: each rank's shard bitwise
    one = files["one"]["params"]
    for r, out in enumerate(ranks):
        for name, t in out["loaded"].items():
            if name not in one:
                continue
            dim = param_pspec(name, tuple(one[name].shape), 2)
            want = one[name] if dim is None else one[name].chunk(2, dim)[r % 2]
            assert torch.equal(t, want), (r, name)


def test_attention_dropout_over_whole_heads_draws_the_one_process_mask(model_world):
    _, ranks, _, _, forwards, _, _ = model_world
    out, weights, dx, (mask,) = forwards["dropout"]
    per = DROPOUT_HEADS // 2
    for rank, got in enumerate(ranks):
        lo = (rank % 2) * per
        g_out, g_weights, g_dx, g_draws = got["dropout"]
        assert torch.allclose(g_weights, weights[:, lo:lo + per], rtol=0, atol=1e-6), rank
        assert (g_out - out).abs().max().item() <= LOGIT_ATOL, rank
        assert (g_dx - dx).abs().max().item() <= LOGIT_ATOL * dx.abs().max().item(), rank
        # one draw of every head's mask, one process's, of which the rank
        # keeps its heads' share
        assert len(g_draws) == 1 and torch.equal(g_draws[0], mask), rank
    # so the ranks of a model row drop different weights on their heads
    # (each drawing a mask of its own heads' shape would drop the same)
    kept = [ranks[r]["dropout"][3][0][:, (r % 2) * per:(r % 2 + 1) * per] for r in (0, 1)]
    assert not torch.equal(kept[0], kept[1])
