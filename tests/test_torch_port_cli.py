"""The port's predict and eval CLIs against the TPU package's, on one fixture
tree with the same weights, float32 on the CPU.

A JAX train state is made on the fixture's probe batch and its params are
perturbed with numpy noise (off the LayerNorm knife edge); the TPU package's
``save_checkpoint`` writes it, and the same params go through
``models/convert.py:state_dict_from_jax`` into the port's
``save_checkpoint``. Then:

* the two predict CLIs write identical JSONL, except where JAX's top two
  ensemble scores lie within 1e-4 (such a sample is held by the next check
  instead; the test prints how many there were);
* the per-batch ensemble log-softmaxes agree within 1e-4;
* the two eval CLIs give losses within 1e-4 and equal accuracies;
* the port's checkpoint round-trips; every flag of the TPU package's parser
  parses in the port's; unported flags raise naming their ROADMAP item;
  with ``--model_parallel 4`` (a head split between ranks) over four spawned
  ranks the CLIs give one process's answers and eval line; the
  sparse table's and packing's training flags change nothing here; and without
  ``--platform cpu`` and without a card the CLIs raise.
"""

import json
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_alignment_vqa_tpu.data.dataset import BatchLoader as JaxLoader
from structured_alignment_vqa_tpu.data.dataset import GQASuperNodeDataset as JaxDataset
from structured_alignment_vqa_tpu.models import AttModelX3 as JaxModel
from structured_alignment_vqa_tpu.parallel import create_train_state
from structured_alignment_vqa_tpu.parallel.train_step import adam as jax_adam
from structured_alignment_vqa_tpu.train import evaluate as jax_evaluate
from structured_alignment_vqa_tpu.train import predict as jax_predict
from structured_alignment_vqa_tpu.train.main import build_parser as jax_build_parser
from structured_alignment_vqa_tpu.train.main import configs_from_args as jax_configs
from structured_alignment_vqa_tpu.utils.checkpoint import save_checkpoint as jax_save
from structured_alignment_vqa_tpu_torch.data.dataset import BatchLoader, GQASuperNodeDataset
from structured_alignment_vqa_tpu_torch.data.fixtures import write_fixture
from structured_alignment_vqa_tpu_torch.data.synthetic import synthetic_batch
from structured_alignment_vqa_tpu_torch.data.transfer import host_tensors
from structured_alignment_vqa_tpu_torch.models import AttModelX3, init_random_, tiny_test_config
from structured_alignment_vqa_tpu_torch.models.convert import GLOVE_SLOTS, state_dict_from_jax
from structured_alignment_vqa_tpu_torch.parallel.dryrun import launch_local
from structured_alignment_vqa_tpu_torch.parallel.train_step import (
    TrainState,
    adam,
    make_train_step,
)
from structured_alignment_vqa_tpu_torch.train import evaluate, main as port_main, predict
from structured_alignment_vqa_tpu_torch.utils import checkpoint as ckpt

LOGSM_ATOL = 1e-4
LOSS_ATOL = 1e-4
TIE_GAP = 1e-4


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def cli_args(root, out):
    """tests/test_driver.py's tiny flags, on the CPU."""
    return [
        "--data_dir_azure", root, "--output_dir", out, "--model_v", "3",
        "--only_obj", "--with_loc", "--decMask", "--with_MILNCE_loss",
        "--with_smooth_labeling", "--pred_rel", "--batch_size", "4",
        "--maxlen", "128", "--maxlen_q", "12", "--maxlen_v", "8",
        "--hidden_size", "16", "--hidden_size_mil", "8", "--num_blocks", "3",
        "--num_heads", "2", "--min_cnt", "50", "--topN", "2",
        "--log_steps", "2", "--log_steps_val", "2",
        "--vocab_size", "401000", "--glove_dim", "8", "--num_workers", "2",
        "--platform", "cpu",
    ]


def build_world(tmp, extra=()):
    """A fixture tree under ``tmp``, a JAX train state on its probe batch
    with perturbed params, saved by the TPU package's ``save_checkpoint``,
    and the port model holding the same weights (its constants too), saved
    by the port's; ``extra`` flags go to both CLIs."""
    root, out = str(tmp / "data"), str(tmp / "out")
    write_fixture(root, n_images=8, n_questions=32, seed=1)
    args = cli_args(root, out) + list(extra)
    jcfg, jtrain_dc, _, jtc = jax_configs(jax_build_parser().parse_args(args))
    jmodel = JaxModel(jcfg)
    probe = next(iter(JaxLoader(JaxDataset("train", jtrain_dc), jtc.batch_size, shuffle=False)))
    state = create_train_state(jmodel, jax.random.key(0), probe, jax_adam(jtc.lr))
    rng = np.random.default_rng(5)
    noisy = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        jax.device_get(state.params))
    state = state.replace(params=jax.tree.map(jnp.asarray, noisy))
    jax_ckpt = str(tmp / "jax_ckpt")
    jax_save(jax_ckpt, state, 1)

    pcfg, ptrain_dc, _, _ = port_main.configs_from_args(
        port_main.build_parser().parse_args(args))
    model = AttModelX3(pcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(noisy, pcfg.num_blocks,
                                              jax.device_get(state.constants)), strict=True)
    port_ckpt = str(tmp / "port_ckpt")
    ckpt.save_checkpoint(port_ckpt, TrainState(model, adam(model.parameters())), 1)
    return dict(tmp=tmp, root=root, out=out, args=args, jmodel=jmodel, params=state.params,
                constants=state.constants, jtrain_dc=jtrain_dc, model=model.eval(),
                ptrain_dc=ptrain_dc, jax_ckpt=jax_ckpt, port_ckpt=port_ckpt)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return build_world(tmp_path_factory.mktemp("cli"))


@pytest.fixture(scope="module")
def scores(world):
    """Per batch of the predict loader (train split, in order): the JAX and
    the port ensemble log-softmax sums, and which rows are valid."""
    apply = jax.jit(lambda p, b: world["jmodel"].apply({"params": p}, b, deterministic=True))
    jl = JaxLoader(JaxDataset("train", world["jtrain_dc"]), 4, shuffle=False, drop_last=False,
                   num_threads=2)
    pl = BatchLoader(GQASuperNodeDataset("train", world["ptrain_dc"]), 4, shuffle=False,
                     drop_last=False, num_threads=2)
    out = []
    for jb, pb in zip(jl, pl):
        lc, lv, ls, _, _ = apply(world["params"], jb)
        want = sum(np.asarray(jax.nn.log_softmax(x.astype(jnp.float32), -1)) for x in (lv, ls, lc))
        with torch.inference_mode():
            plc, plv, pls, _, _ = world["model"](host_tensors(pb))
        got = sum(torch.log_softmax(x.float(), -1).numpy() for x in (plv, pls, plc))
        out.append((want, got, pb.sample_valid.astype(bool)))
    return out


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_predict_cli_writes_the_jax_cli_answers(world, scores, capsys):
    tmp, args = world["tmp"], world["args"]
    extra = ["--split", "train", "--pipeline_depth", "2", "--warmup_batches", "1"]
    jax_out, port_out = str(tmp / "jax.jsonl"), str(tmp / "port.jsonl")
    n_jax = jax_predict.main(args + ["--weight_dir", world["jax_ckpt"], "--out", jax_out] + extra)
    n_port = predict.main(args + ["--weight_dir", world["port_ckpt"], "--out", port_out,
                                  "--use_pallas"] + extra)
    with open(os.path.join(world["out"], "training.log")) as f:
        log = f.read()
    assert "--use_pallas has no effect" in log and f"predicted {n_port} answers" in log
    want, got = read_jsonl(jax_out), read_jsonl(port_out)
    assert n_jax == n_port == len(want) == len(got) > 0
    gaps = {}
    base = 0
    for jscores, _, valid in scores:
        top2 = np.sort(jscores, axis=-1)[:, -2:]
        for j in np.flatnonzero(valid):
            gaps[base + j] = float(top2[j, 1] - top2[j, 0])
        base += len(valid)
    differ = [(w["index"], w["answer_id"], g["answer_id"]) for w, g in zip(want, got) if w != g]
    assert [w["index"] for w in want] == [g["index"] for g in got]
    assert all(gaps[i] < TIE_GAP for i, _, _ in differ), differ
    with capsys.disabled():
        print(f"\npredict CLI: {len(differ)} of {len(want)} answers differ from JAX's, each a "
              f"near tie (JAX top-two gap < {TIE_GAP:g})")


def test_ensemble_log_softmax_agrees_with_jax_batch_by_batch(scores):
    n = 0
    for want, got, valid in scores:
        np.testing.assert_allclose(got[valid], want[valid], atol=LOGSM_ATOL, rtol=0)
        n += int(valid.sum())
    assert n > 0


def test_eval_cli_gives_the_jax_cli_loss_and_accuracy(world):
    args = world["args"] + ["--split", "train"]
    jloss, jacc = jax_evaluate.main(args + ["--weight_dir", world["jax_ckpt"]])
    ploss, pacc = evaluate.main(args + ["--weight_dir", world["port_ckpt"]])
    assert np.isfinite(ploss) and ploss > 0
    assert abs(ploss - float(jloss)) <= LOSS_ATOL
    assert pacc == float(jacc)


def tiny_state(share_glove=False, seed=0):
    cfg = tiny_test_config(share_glove=share_glove)
    model = AttModelX3(cfg, device="cpu")
    init_random_(model, torch.Generator().manual_seed(seed))
    return cfg, TrainState(model, adam(model.parameters(), lr=1e-3))


def opt_tensors(optimizer):
    return [t.clone() for s in optimizer.state_dict()["state"].values()
            for t in s.values() if torch.is_tensor(t)]


def test_checkpoint_round_trips_adam_moments_and_step(tmp_path):
    cfg, state = tiny_state()
    step = make_train_step(state.model, state.optimizer, cfg)
    batch = synthetic_batch(cfg, 3, device="cpu")
    step(state, batch)
    saved_params = {k: v.clone() for k, v in state.model.state_dict().items()}
    saved_opt = opt_tensors(state.optimizer)
    assert saved_opt and state.step == 1
    path = ckpt.save_checkpoint(str(tmp_path), state, 1)
    assert os.path.basename(path) == "epoch_1.pt"
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    step(state, batch)                       # move params and moments on
    assert state.step == 2

    state, epoch = ckpt.restore_checkpoint(str(tmp_path), state)
    assert epoch == 1 and state.step == 1
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, saved_params[k]), k
    assert all(torch.equal(a, b) for a, b in zip(opt_tensors(state.optimizer), saved_opt))

    _, fresh = tiny_state(seed=9)
    assert ckpt.load_params_for_eval(str(tmp_path), fresh.model) == 1
    assert fresh.step == 0 and not fresh.optimizer.state_dict()["state"]
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, saved_params[k]), k


def test_checkpoint_saves_the_shared_table_once_and_ties_it_on_load(tmp_path):
    _, state = tiny_state(share_glove=True)
    ckpt.save_checkpoint(str(tmp_path), state, 3)
    payload = torch.load(ckpt.checkpoint_path(str(tmp_path), 3), weights_only=True)
    saved = [s for s in GLOVE_SLOTS if s in payload["params"]]
    assert len(saved) == 1 and sorted(payload["tied"]) == sorted(set(GLOVE_SLOTS) - set(saved))
    assert set(payload["tied"].values()) == set(saved)
    _, fresh = tiny_state(share_glove=True, seed=4)
    ckpt.load_params_for_eval(str(tmp_path), fresh.model)
    m = fresh.model
    assert m.att_syb.syb_emb.weight is m.MIL_NCE.syb_emb.weight is m.att_vis_grid.syb_emb.weight
    assert torch.equal(m.att_syb.syb_emb.weight, state.model.att_syb.syb_emb.weight)


def test_max_to_keep_prunes_the_oldest(tmp_path):
    _, state = tiny_state()
    for epoch in (1, 2, 3, 4):
        ckpt.save_checkpoint(str(tmp_path), state, epoch, max_to_keep=2)
    assert ckpt.saved_epochs(str(tmp_path)) == [3, 4]
    assert ckpt.latest_epoch(str(tmp_path)) == 4
    assert ckpt.latest_epoch(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.load_params_for_eval(str(tmp_path / "none"), state.model)


def test_every_jax_flag_parses_with_the_same_default_and_value():
    jp, pp = jax_build_parser(), port_main.build_parser()
    assert vars(pp.parse_args([])) == vars(jp.parse_args([]))
    n = 0
    for action in jp._actions:
        for opt in action.option_strings:
            if opt in ("-h", "--help"):
                continue
            if action.nargs == 0:
                argv = [opt]
            else:
                value = {int: "3", float: "0.25"}.get(action.type, "some_value")
                argv = [opt, value]
            assert vars(pp.parse_args(argv)) == vars(jp.parse_args(argv)), argv
            n += 1
    assert n == len(jp._actions) - 1


# several hosts need a coordinator (data parallelism is ported: item 15)
UNPORTED = [
    (["--num_processes", "2"], ValueError, "needs --coordinator"),
]
EVAL_LINE = re.compile(r"Eval\[val\] Loss: ([^,]+), accuracy: ([0-9.]+)/([0-9.]+) =")
EVAL_RTOL = 1e-5


@pytest.mark.parametrize("cli", ["predict", "evaluate"])
@pytest.mark.parametrize("flags,error,item", UNPORTED, ids=["--coordinator"])
def test_unported_flags_raise_naming_their_item(world, cli, flags, error, item):
    main = {"predict": predict.main, "evaluate": evaluate.main}[cli]
    with pytest.raises(error, match=item):
        main(world["args"] + ["--weight_dir", world["port_ckpt"]] + flags)


@pytest.fixture(scope="module")
def model_parallel_runs(world):
    """The predict CLI (train split) and the eval CLI (val) on the world's
    checkpoint, each in one process and with ``--model_parallel 4`` (four
    spawned gloo ranks), all four side by side."""
    tmp, runs = world["tmp"], []
    for cli in ("predict", "evaluate"):
        for tag, extra in (("one", ()), ("mp4", ("--model_parallel", "4"))):
            out = str(tmp / f"{cli}_{tag}")
            argv = world["args"] + ["--weight_dir", world["port_ckpt"], "--output_dir", out,
                                    *extra]
            if cli == "predict":
                argv += ["--split", "train", "--out", f"{out}.jsonl"]
            code = ("import os, sys; os.environ['OMP_NUM_THREADS'] = '1'; "
                    f"from structured_alignment_vqa_tpu_torch.train import {cli}; "
                    f"{cli}.main(sys.argv[1:])")
            runs.append([sys.executable, "-c", code, *argv])
    launch_local(runs, timeout=300)
    return tmp


@pytest.mark.parametrize("cli", ["predict", "evaluate"])
def test_model_parallel_4_clis_equal_one_process(model_parallel_runs, scores, cli):
    """hidden 16 over 4 model ranks splits the projections and its 2 heads
    do not divide (a head split between ranks): the predict CLI writes one
    process's answers file (but for near ties), the eval CLI logs one
    process's line."""
    tmp = model_parallel_runs
    if cli == "predict":
        want, got = (read_jsonl(tmp / f"predict_{tag}.jsonl") for tag in ("one", "mp4"))
        assert len(want) == len(got) > 0
        assert [w["index"] for w in want] == [g["index"] for g in got]
        gaps = port_top2_gaps(scores)
        assert all(gaps[w["index"]] < TIE_GAP for w, g in zip(want, got) if w != g)
    else:
        logs = []
        for tag in ("one", "mp4"):
            with open(tmp / f"evaluate_{tag}" / "training.log") as f:
                logs.append(EVAL_LINE.findall(f.read()))
        (want,), (got,) = logs
        assert got[1:] == want[1:] and float(want[2]) > 0, (got, want)
        assert abs(float(got[0]) - float(want[0])) <= EVAL_RTOL * abs(float(want[0]))


def port_top2_gaps(scores):
    """{sample index: the gap between the port's top two ensemble scores}
    over the predict loader's stream (train split, in order)."""
    gaps, base = {}, 0
    for _, pscores, valid in scores:
        top2 = np.sort(pscores, axis=-1)[:, -2:]
        for j in np.flatnonzero(valid):
            gaps[base + j] = float(top2[j, 1] - top2[j, 0])
        base += len(valid)
    return gaps


@pytest.mark.parametrize("cli", ["predict", "evaluate"])
@pytest.mark.parametrize("flags", [["--sparse_table"], ["--table_moments_bf16"],
                                   ["--n_pack", "2", "--pack_bucket", "1"]],
                         ids=["sparse_table", "table_moments_bf16", "n_pack"])
def test_training_only_flags_change_nothing_in_the_eval_clis(world, cli, flags):
    """The sparse table's and packing's flags configure training; the
    predict and eval CLIs accept them and give the answers and loss they
    give without (their loaders pack nothing, as the TPU package's)."""
    args = world["args"] + ["--weight_dir", world["port_ckpt"], "--split", "train"]
    if cli == "predict":
        outs = [str(world["tmp"] / f"{name}.jsonl") for name in ("without", "with")]
        predict.main(args + ["--out", outs[0]])
        predict.main(args + flags + ["--out", outs[1]])
        want, got = (read_jsonl(o) for o in outs)
        assert got == want and len(got) > 0
    else:
        assert evaluate.main(args + flags) == evaluate.main(args)


@pytest.mark.parametrize("cli", ["predict", "evaluate"])
@pytest.mark.parametrize("platform", [None, "gpu"])
def test_without_platform_cpu_and_without_a_card_the_cli_raises(world, monkeypatch, cli,
                                                                platform):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = world["args"][:-2] + ([] if platform is None else ["--platform", platform])
    main = {"predict": predict.main, "evaluate": evaluate.main}[cli]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(args + ["--weight_dir", world["port_ckpt"], "--out", str(world["tmp"] / "x.jsonl")])
