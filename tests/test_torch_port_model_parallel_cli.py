"""The model axis's rule and entries against the JAX package, and
``--model_parallel`` through the port's CLIs on gloo CPU ranks.

* The layout, leaf by leaf: the port's ``param_pspec`` on every name of
  ``models/convert.py:name_map`` against the JAX package's on the
  full-width tree (``jax.eval_shape`` of ``ModelConfig`` defaults, 1,843
  classes, ``share_glove``) at model 2 and 4, the int8 serving names too:
  168 split leaves, 209,926,432 of 215,802,553 parameters, the attention
  projections by columns.
* The model axis's entries (their plain versions, run on the CPU) against
  the JAX kernels in interpret mode: K1's attention-only entry on each
  half of the heads, the halves gathered, then the LayerNorm entry,
  against JAX's K1; K2 from d(o) on each half against JAX's K2; K3's
  partial on each half of the hidden width, summed, then the epilogue,
  against JAX's K3. float32 within 1e-5, bf16 within one bf16 ulp.
* The CLIs with ``--model_parallel 2 --platform cpu`` (two spawned gloo
  ranks, one data row): predict writes the one-process answers file byte
  for byte, float and ``--int8`` (the int8 table and its row scales split
  by rows, the heads' int8 kernels by columns and rows); eval logs one process's counts and its loss within 1e-5
  relative (the f32 sums of the split layers run in another order); the
  training CLI logs one process's first-step loss within 1e-5 relative
  and writes a checkpoint of whole tensors that one process loads.
* ``local_ranks`` starts ``--model_parallel`` ranks for every data rank
  and refuses a host with fewer cards than the axis.
* The dry run (``parallel/dryrun.py``) at (data 1, model 2) prints each
  rank's place in the grid and its parameter bytes, and its dense and
  sparse steps equal one process's.
"""

import json
import os
import re
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import structured_alignment_vqa_tpu.ops.pallas_attention as pa
from structured_alignment_vqa_tpu.models import AttModelX3 as JaxModel
from structured_alignment_vqa_tpu.models.config import ModelConfig as JaxConfig
from structured_alignment_vqa_tpu.ops.pallas_attention import (
    fused_graph_attention_ln as jax_k1,
)
from structured_alignment_vqa_tpu.ops.pallas_attention_bwd import fused_attention_bwd
from structured_alignment_vqa_tpu.ops.pallas_ffn import fused_ffn as jax_k3
from structured_alignment_vqa_tpu.parallel.sharding import param_pspec as jax_pspec
from structured_alignment_vqa_tpu_torch.data.dataset import BatchLoader, GQASuperNodeDataset
from structured_alignment_vqa_tpu_torch.data.fixtures import write_fixture
from structured_alignment_vqa_tpu_torch.data.synthetic import synthetic_arrays
from structured_alignment_vqa_tpu_torch.data.transfer import host_tensors
from structured_alignment_vqa_tpu_torch.models import AttModelX3, ModelConfig, init_random_
from structured_alignment_vqa_tpu_torch.models.convert import _int8_entries, name_map
from structured_alignment_vqa_tpu_torch.ops import fused_ffn as k3
from structured_alignment_vqa_tpu_torch.ops import fused_graph_attention as k1
from structured_alignment_vqa_tpu_torch.parallel.dryrun import dryrun_multichip, launch_local
from structured_alignment_vqa_tpu_torch.parallel.sharding import param_pspec
from structured_alignment_vqa_tpu_torch.parallel.sparse_table import TABLE_NAME
from structured_alignment_vqa_tpu_torch.parallel.train_step import TrainState, adam
from structured_alignment_vqa_tpu_torch.train import main as train_main
from structured_alignment_vqa_tpu_torch.utils.checkpoint import (
    load_params_for_eval,
    save_checkpoint,
)
from test_torch_port_model import jax_batch

ATOL = 1e-5
ROWS = 4


@pytest.fixture(autouse=True)
def _setup():
    torch.set_num_threads(1)
    pa.INTERPRET_MODE = True
    yield
    pa.INTERPRET_MODE = False


# ---- the layout ------------------------------------------------------------

def _port_dim(spec, transpose):
    """The port tensor's split dimension for a flax PartitionSpec: a kernel
    (in, out) is the transposed ``nn.Linear.weight`` (out, in)."""
    if spec == jax.sharding.PartitionSpec():
        return None
    axis = next(i for i, a in enumerate(spec) if a == "model")
    return 1 - axis if transpose else axis


@pytest.fixture(scope="module")
def full_width_leaves():
    """(JAX path, shape) of every leaf of the production tree."""
    kw = dict(num_classes=1843, share_glove=True)
    arrays = synthetic_arrays(ModelConfig(**kw), 2, lv=4, lq=5, ls=10, seed=0)
    shapes = jax.eval_shape(JaxModel(JaxConfig(**kw)).init, jax.random.key(0),
                            jax_batch(arrays))["params"]
    return [(tuple(str(getattr(k, "key", k)) for k in path), tuple(v.shape))
            for path, v in jax.tree_util.tree_flatten_with_path(shapes)[0]]


def _by_path(num_blocks):
    """JAX path -> (port name, transpose), the shared table and the int8
    leaves included."""
    out = {path: (tname, transpose)
           for tname, path, transpose in name_map(num_blocks) + _int8_entries(num_blocks)}
    out[("glove", "table")] = (TABLE_NAME, False)
    out[("glove", "table_q")] = (TABLE_NAME + "_q", False)
    out[("glove", "table_scale")] = (TABLE_NAME + "_scale", False)
    return out


class _Key:
    def __init__(self, key):
        self.key = key


class _Leaf:
    def __init__(self, shape):
        self.shape = shape


def _jax_rule(path, shape, n):
    return jax_pspec(tuple(_Key(k) for k in path), _Leaf(shape), n)


@pytest.mark.parametrize("n", [2, 4])
def test_port_rule_is_jax_param_pspec_leaf_for_leaf_at_full_width(full_width_leaves, n):
    names = _by_path(6)
    split = total = split_params = 0
    for path, shape in full_width_leaves:
        tname, transpose = names[path]
        want = _port_dim(_jax_rule(path, shape, n), transpose)
        port_shape = shape[::-1] if transpose else shape
        assert param_pspec(tname, port_shape, n) == want, (path, n)
        total += int(np.prod(shape))
        if want is not None:
            split += 1
            split_params += int(np.prod(shape))
    assert (split, split_params, total) == (168, 209_926_432, 215_802_553)
    # a rank's parameters: its shards of the split leaves and every whole one
    assert total - split_params + split_params // n == {2: 110_839_337, 4: 58_357_729}[n]
    # the heads split with the projections' columns; the 1,843-class output
    # kernels stay whole
    assert param_pspec("att_syb.enc_self_attention_0.Q_proj.0.weight", (512, 512), n) == 0
    assert param_pspec("cls.3.weight", (1843, 512), n) is None


@pytest.mark.parametrize("n", [2, 4])
def test_int8_table_its_scales_and_head_kernels_split_as_jax(n):
    int8 = [(("glove", "table_q"), (407_000, 300)), (("glove", "table_scale"), (407_000,)),
            (("cls_hidden", "kernel_q"), (1024, 512)),
            (("cls_vis_hidden", "kernel_q"), (512, 512)),
            (("cls_vis_hidden", "kernel_scale"), (512,)), (("cls_out", "kernel_q"), (512, 1843))]
    names = _by_path(6)
    got = []
    for path, shape in int8:
        tname, transpose = names[path]
        want = _port_dim(_jax_rule(path, shape, n), transpose)
        assert param_pspec(tname, shape[::-1] if transpose else shape, n) == want, path
        got.append(want)
    assert got == [0, 0, 1, 0, None, None]


# ---- the entries' plain versions against the JAX kernels -----------------------

def _attention_inputs(rng, b, t, c):
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    x[0, -2:] = 0.0
    res = rng.standard_normal((b, t, c)).astype(np.float32)
    q, k, v = (np.maximum(a, 0).astype(np.float32) for a in (res * 0.5 + 0.1, x * 0.3, x))
    km = (np.abs(x.sum(-1)) > 0).astype(np.float32)
    qm = (rng.random((b, t)) > 0.15).astype(np.float32)
    graph = (rng.random((b, t, t)) > 0.4).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    dy = rng.standard_normal((b, t, c)).astype(np.float32)
    return (q, k, v, km, qm, graph, res, gamma, beta), dy


def _halves(t, n=2):
    return [p.contiguous() for p in t.chunk(n, dim=-1)]


def _assert_close(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = np.maximum(1.0, np.abs(want).max(axis=-1, keepdims=True))
    assert (np.abs(got - want) <= tol * scale).all(), (what, np.abs(got - want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("renorm", ["l1", "sum_eps"])
def test_k1_and_k2_entries_on_half_the_heads_equal_jax_kernels(rng, dtype, renorm):
    heads, tol = 4, (ATOL if dtype == "float32" else 2 ** -7)
    tdt = getattr(torch, dtype)
    args, dy = _attention_inputs(rng, 2, 9, 16)
    t = [torch.from_numpy(a) for a in args]
    q, k, v, res = (t[i].to(tdt) for i in (0, 1, 2, 6))
    km, qm, graph, gamma, beta = t[3], t[4], t[5], t[7], t[8]
    shards = list(zip(*(_halves(x) for x in (q, k, v))))
    o = torch.cat([k1.graph_attention_plain(qs, ks, vs, km, qm, graph, heads // 2, renorm)
                   for qs, ks, vs in shards], dim=-1).requires_grad_(True)
    out = k1.attention_ln_plain(o, res, gamma, beta)
    j = [jnp.asarray(a) for a in args]
    for i in (0, 1, 2, 6):
        j[i] = j[i].astype(getattr(jnp, dtype))
    want = jax_k1(*j, heads, renorm)
    _assert_close(out.detach().float().numpy(), want.astype(jnp.float32), tol, "K1")
    # K2 from d(o): d(o) is the LayerNorm backward of dy (autograd, as the
    # LayerNorm entry's backward), each half of the heads from its columns
    dyt = torch.from_numpy(dy).to(tdt)
    (do,) = torch.autograd.grad(out, o, dyt)
    grads = [k1.graph_attention_bwd_plain(qs, ks, vs, km, qm, graph, dos, heads // 2, renorm)
             for (qs, ks, vs), dos in zip(shards, _halves(do))]
    want = fused_attention_bwd(*j, jnp.asarray(dy).astype(getattr(jnp, dtype)), heads, renorm,
                               interpret=True)
    for i, name in enumerate(("dq", "dk", "dv")):
        got = torch.cat([g[i] for g in grads], dim=-1)
        assert got.dtype == tdt
        _assert_close(got.float().numpy(), want[i].astype(jnp.float32), tol, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k3_partials_of_two_hidden_shards_and_epilogue_equal_jax_kernel(rng, dtype):
    c, hd = 16, 64
    tdt = getattr(torch, dtype)
    x = rng.standard_normal((2, 9, c)).astype(np.float32)
    w1 = (rng.standard_normal((c, hd)) / np.sqrt(c)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(hd)).astype(np.float32)
    w2 = (rng.standard_normal((hd, c)) / np.sqrt(hd)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(c)).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    tx, tw1, tb1, tw2, tb2 = (torch.from_numpy(np.ascontiguousarray(a)).to(tdt)
                              for a in (x, w1.T, b1, w2.T, b2))
    y = sum(k3.ffn_partial_plain(tx, w1s.contiguous(), b1s.contiguous(), w2s.contiguous())
            for w1s, b1s, w2s in zip(tw1.chunk(2, 0), tb1.chunk(2, 0), tw2.chunk(2, 1)))
    assert y.dtype == torch.float32
    got = k3.ffn_epilogue_plain(y, tx, tb2, torch.from_numpy(gamma), torch.from_numpy(beta))
    jdt = getattr(jnp, dtype)
    want = jax_k3(*(jnp.asarray(a).astype(jdt) for a in (x, w1, b1, w2, b2)),
                  jnp.asarray(gamma), jnp.asarray(beta))
    # one bf16 ulp at |out| < 4 is 2^-6
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=ATOL if dtype == "float32" else 2 ** -6, rtol=0)
    # and the split whole is the port's one-kernel FFN
    whole = k3.ffn_ln_plain(tx, tw1, tb1, tw2, tb2, torch.from_numpy(gamma),
                            torch.from_numpy(beta))
    np.testing.assert_allclose(got.float().numpy(), whole.float().numpy(),
                               atol=ATOL if dtype == "float32" else 2 ** -6, rtol=0)


# ---- the CLIs ----------------------------------------------------------------------

EVAL_LINE = re.compile(r"Eval\[val\] Loss: ([^,]+), accuracy: ([0-9.]+)/([0-9.]+) =")
FIRST_LOSS = re.compile(r"Step \[\d+\], Loss: ([^,]+),")


def _cli_argv(root, out, *extra):
    """Hidden 16 over 2 heads, the 401,000-row table: at --model_parallel 2
    every rule splits something."""
    return [
        "--data_dir_azure", root, "--output_dir", out, "--model_v", "3", "--only_obj",
        "--with_loc", "--decMask", "--with_MILNCE_loss", "--pred_rel",
        "--batch_size", str(ROWS), "--maxlen", "128", "--maxlen_q", "12", "--maxlen_v", "8",
        "--hidden_size", "16", "--hidden_size_mil", "8", "--num_blocks", "3", "--num_heads", "2",
        "--min_cnt", "50", "--topN", "2", "--log_steps", "1", "--log_steps_val", "100",
        "--vocab_size", "401000", "--glove_dim", "8", "--num_workers", "2", "--lr", "1e-3",
        "--seed", "7", "--dropout_rate", "0.1", "--share_glove", "--platform", "cpu", *extra,
    ]


def _cli(cli, argv):
    code = ("import os, sys; os.environ['OMP_NUM_THREADS'] = '1'; "
            f"from structured_alignment_vqa_tpu_torch.train import {cli}; "
            f"{cli}.main(sys.argv[1:])")
    return [sys.executable, "-c", code, *argv]


def _save_random_weights(tmp, root):
    """A checkpoint of seeded random weights, the answer heads' output
    biases shifted by minus their mean logits over one batch, so that the
    answers spread over the classes."""
    from structured_alignment_vqa_tpu_torch.models.att_model_x3 import _Head

    args = train_main.build_parser().parse_args(_cli_argv(root, "unused"))
    cfg, train_dc, _, _ = train_main.configs_from_args(args)
    model = AttModelX3(cfg, device="cpu")
    init_random_(model, torch.Generator().manual_seed(3))
    batch = next(iter(BatchLoader(GQASuperNodeDataset("train", train_dc), 8, shuffle=False)))
    heads = [m for m in model.modules() if isinstance(m, _Head)]
    outs = {}
    hooks = [m.register_forward_hook(lambda m, _, out: outs.__setitem__(m, out)) for m in heads]
    with torch.no_grad():
        model.eval()(host_tensors(batch))
        for m in heads:
            m[-1].bias.sub_(outs[m].mean(0))
    for h in hooks:
        h.remove()
    save_checkpoint(os.path.join(tmp, "weights"), TrainState(model, adam(model.parameters())), 1,
                    generator=torch.Generator().manual_seed(8))
    return cfg


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Each CLI once in one process and once as two model ranks, side by
    side: predict (the train split, bs 8; float and int8), eval (val, bs 4)
    and one epoch of training, resumed from the random weights' checkpoint (a fresh init
    puts every post-LN row's sum on the content mask's knife edge,
    ``docs/PARITY.md``: rounding would decide which rows are masked)."""
    tmp = str(tmp_path_factory.mktemp("model_cli"))
    root = os.path.join(tmp, "data")
    write_fixture(root, n_images=8, n_questions=60, seed=1)
    cfg = _save_random_weights(tmp, root)
    for tag in ("one", "mp2"):
        os.makedirs(os.path.join(tmp, f"train_{tag}", "checkpoints"))
        shutil.copy(os.path.join(tmp, "weights", "epoch_1.pt"),
                    os.path.join(tmp, f"train_{tag}", "checkpoints", "epoch_1.pt"))
    runs = []
    for tag, extra in (("one", ()), ("mp2", ("--model_parallel", "2"))):
        serve = ("--weight_dir", os.path.join(tmp, "weights"))
        for kind, int8 in (("float", ()), ("int8", ("--int8",))):
            predict = _cli_argv(root, os.path.join(tmp, f"predict_{kind}_{tag}"), *serve, *int8,
                                *extra, "--split", "train", "--out",
                                os.path.join(tmp, f"{kind}_{tag}.jsonl"))
            predict[predict.index("--batch_size") + 1] = "8"
            runs.append(_cli("predict", predict))
        runs += [_cli("evaluate", _cli_argv(root, os.path.join(tmp, f"eval_{tag}"), *serve,
                                            *extra)),
                 _cli("main", _cli_argv(root, os.path.join(tmp, f"train_{tag}"),
                                        "--num_epochs", "2", *extra))]
    launch_local(runs, timeout=300)
    return tmp, cfg


def _log(tmp, name):
    with open(os.path.join(tmp, name, "training.log")) as f:
        return f.read()


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_predict_over_two_model_ranks_writes_one_process_answers_file(cli_runs, kind):
    tmp, _ = cli_runs
    with open(os.path.join(tmp, f"{kind}_one.jsonl"), "rb") as f:
        want = f.read()
    with open(os.path.join(tmp, f"{kind}_mp2.jsonl"), "rb") as f:
        got = f.read()
    answers = [json.loads(line) for line in want.decode().splitlines()]
    assert got == want and len(answers) == 60
    assert len({a["answer_id"] for a in answers}) > 1


def test_eval_over_two_model_ranks_logs_one_process_line(cli_runs):
    tmp, _ = cli_runs
    (got,), (want,) = (EVAL_LINE.findall(_log(tmp, f"eval_{t}")) for t in ("mp2", "one"))
    assert got[1:] == want[1:] and float(want[2]) > 0, (got, want)
    assert abs(float(got[0]) - float(want[0])) <= ATOL * abs(float(want[0])), (got, want)


def test_training_over_two_model_ranks_takes_one_process_step_and_saves_whole(cli_runs):
    tmp, cfg = cli_runs
    got, want = (FIRST_LOSS.findall(_log(tmp, f"train_{t}"))[0] for t in ("mp2", "one"))
    assert abs(float(got) - float(want)) <= ATOL * abs(float(want)), (got, want)
    assert "'model': 2" in _log(tmp, "train_mp2") and "resumed from epoch 1" in _log(tmp, "train_mp2")
    # the checkpoint it wrote holds whole tensors: one process loads it
    model = AttModelX3(cfg, device="cpu")
    assert load_params_for_eval(os.path.join(tmp, "train_mp2", "checkpoints"), model, 2) > 0
    assert model.get_parameter(TABLE_NAME).shape == (401_000, 8)


def test_local_ranks_start_model_parallel_ranks_a_data_rank(monkeypatch):
    args = train_main.build_parser().parse_args(["--model_parallel", "2", "--platform", "cpu"])
    assert train_main.local_ranks(args) == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    args = train_main.build_parser().parse_args(["--model_parallel", "2", "--batch_size", "4"])
    assert train_main.local_ranks(args) == 4
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 cards"):
        train_main.local_ranks(args)


def test_dryrun_prints_each_ranks_place_and_bytes_and_equals_one_process(capsys):
    summary = dryrun_multichip(2, "cpu", timeout=240, model_parallel=2)
    for case, errors in summary.items():
        for what, (err, tol) in errors.items():
            assert err <= tol, (case, what, err, tol)
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("dryrun rank")]
    assert [line.split(":")[1].split(" of ")[0] for line in lines] == [
        " (data, seq, model) = (0, 0, 0)", " (data, seq, model) = (0, 0, 1)"]
    mine, whole = (int(v.replace(",", "")) for v in
                   re.search(r"bytes ([\d,]+) of one process's ([\d,]+)", lines[0]).groups())
    assert whole // 2 < mine < whole
