"""The port's training CLI (``train.main.main`` -> ``train.loop.train``) on
fixture trees, float32 on the CPU. JAX-free but for the graft and sinusoid
checks, which hold the port against the TPU package's functions.

* The per-step losses the CLI logs over 2 epochs equal, bitwise, a hand
  loop of ``make_train_step`` over the same ``BatchLoader`` from the same
  initial weights (``train.loop.new_model``) and dropout generator (seeded
  from ``seed + 1``), dense and with ``--sparse_table``.
* Resume logs ``resumed from epoch 1`` and reaches the params, the sparse
  table's moments and the dropout stream of an uninterrupted 2-epoch run.
* Device-resident batches train as streaming does (the twin of
  ``tests/test_resident.py``).
* ``--profile_steps 2`` writes a Chrome trace under ``<output_dir>/profile``.
* GloVe is found in ``<data_dir>/vector_cache`` and grafted as the TPU
  package's ``graft_glove`` grafts it; the sinusoid table equals JAX's.
* ``--model_v 2`` exits; without ``--platform cpu`` and without a card the
  CLI raises; the predict and eval CLIs serve the checkpoint it wrote.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from structured_alignment_vqa_tpu_torch.data.dataset import BatchLoader, GQASuperNodeDataset
from structured_alignment_vqa_tpu_torch.data.fixtures import write_fixture
from structured_alignment_vqa_tpu_torch.data.transfer import host_tensors
from structured_alignment_vqa_tpu_torch.ops.layers import sinusoidal_position_encoding
from structured_alignment_vqa_tpu_torch.parallel.train_step import (
    create_train_state,
    make_train_step,
)
from structured_alignment_vqa_tpu_torch.train import evaluate, loop, predict
from structured_alignment_vqa_tpu_torch.train import main as train_main
from structured_alignment_vqa_tpu_torch.train.predict import make_predict_step
from structured_alignment_vqa_tpu_torch.utils.checkpoint import load_params_for_eval

SINUSOID_ATOL = 1e-6
STEP_LOSS = re.compile(r"Epoch \[(\d+)/\d+\], Step \[(\d+)\], Loss: ([^,]+), MIL NCE Loss")


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def tiny_args(root, out, *extra):
    """tests/test_driver.py's tiny flags, on the CPU, a step logged each step."""
    return [
        "--data_dir_azure", root, "--output_dir", out, "--model_v", "3",
        "--only_obj", "--with_loc", "--decMask", "--with_MILNCE_loss",
        "--pred_rel", "--batch_size", "4", "--maxlen", "128", "--maxlen_q", "12",
        "--maxlen_v", "8", "--hidden_size", "16", "--hidden_size_mil", "8",
        "--num_blocks", "3", "--num_heads", "2", "--min_cnt", "50", "--topN", "2",
        "--log_steps", "1", "--log_steps_val", "100", "--vocab_size", "401000",
        "--glove_dim", "8", "--num_workers", "2", "--lr", "1e-3", "--seed", "7",
        "--share_glove", "--platform", "cpu", *extra,
    ]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("train_cli") / "data")
    write_fixture(path, n_images=8, n_questions=32, seed=1)
    return path


def read_log(out):
    with open(os.path.join(out, "training.log")) as f:
        return f.read()


def logged_losses(out):
    return [(int(e), int(s), float(v)) for e, s, v in STEP_LOSS.findall(read_log(out))]


def read_metrics(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def hand_loop(args, n_epochs):
    """make_train_step over the CLI's train loader, epoch by epoch, from the
    weights and generator the CLI starts from: [(epoch, step, loss)]."""
    model_cfg, train_dc, _, tc = train_main.configs_from_args(
        train_main.build_parser().parse_args(args))
    model_cfg = model_cfg.replace(topn=train_dc.topn, only_obj=train_dc.only_obj)
    model = loop.new_model(model_cfg, tc.seed, "cpu")
    state = create_train_state(model, tc.lr, tc.warmup_steps, sparse_table=tc.sparse_table)
    step = make_train_step(model, state.optimizer, model_cfg, with_milnce=tc.with_milnce,
                           sparse_table=tc.sparse_table)
    gen = torch.Generator().manual_seed(tc.seed + 1)
    loader = BatchLoader(GQASuperNodeDataset("train", train_dc), tc.batch_size, shuffle=True,
                         seed=tc.seed, num_threads=tc.num_workers)
    out = []
    for epoch in range(n_epochs):
        loader.set_epoch(epoch)
        for i, b in enumerate(loader):
            m = step(state, host_tensors(b), gen)
            out.append((epoch + 1, i + 1, m["loss"].item()))
    return out, state


@pytest.fixture(scope="module")
def runs(root, tmp_path_factory):
    """The CLI's 2-epoch runs, dense and sparse: {name: (args, output dir, state)}."""
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("runs")
    out = {}
    for name, extra in (("dense", ()), ("sparse", ("--sparse_table",))):
        args = tiny_args(root, str(tmp / name), "--num_epochs", "2", *extra)
        out[name] = (args, str(tmp / name), train_main.main(args))
    return out


@pytest.mark.parametrize("name", ["dense", "sparse"])
def test_cli_logs_the_losses_of_a_hand_loop_bitwise(runs, name):
    args, out, state = runs[name]
    want, hand = hand_loop(args, 2)
    got = logged_losses(out)
    assert len(got) == len(want) >= 12
    assert got == want
    assert (state.table_opt is not None) == (name == "sparse")
    for (k, v), w in zip(state.model.state_dict().items(), hand.model.state_dict().values()):
        assert torch.equal(v, w), k


def test_resume_reaches_the_uninterrupted_run(root, runs, tmp_path):
    args, _, whole = runs["sparse"]
    out = str(tmp_path / "resumed")
    first = [a if a != runs["sparse"][1] else out for a in args]
    n = first.index("--num_epochs")
    first[n + 1] = "1"
    train_main.main(first)
    assert "resumed from" not in read_log(out)
    first[n + 1] = "2"
    state = train_main.main(first)
    assert "resumed from epoch 1" in read_log(out)
    assert state.step == whole.step and int(state.table_opt.count) == int(whole.table_opt.count)
    for (k, v), w in zip(state.model.state_dict().items(), whole.model.state_dict().values()):
        assert torch.equal(v, w), k
    assert torch.equal(state.table_opt.mu, whole.table_opt.mu)
    assert torch.equal(state.table_opt.nu, whole.table_opt.nu)
    assert logged_losses(out)[-1] == logged_losses(runs["sparse"][1])[-1]


def test_resident_batches_train_as_streaming(root, tmp_path):
    cache = str(tmp_path / "cache")

    def run(name, resident_gb, epochs=3):
        out = str(tmp_path / name)
        train_main.main(tiny_args(
            root, out, "--num_epochs", str(epochs), "--dropout_rate", "0.0", "--cache_dir",
            cache, "--batch_replay", "--no_resume", "--eval_every", str(epochs),
            "--checkpoint_every", str(epochs), "--resident_gb", str(resident_gb),
            "--log_steps", "2"))
        return out, read_metrics(out)

    # a cache-building pass yields batches in build order, warm replay
    # shuffles by epoch: both compared runs start from a warm cache
    run("warm", 0, epochs=1)
    _, stream = run("stream", 0)
    res_out, resident = run("resident", 8.0)

    def series(ms, name):
        return [(m["step"], m["value"]) for m in ms if m["name"] == name]

    for name in ("Avg Loss", "Test Acc", "Train Acc"):
        assert series(stream, name), name
        assert series(stream, name) == series(resident, name), name
    assert "device-resident" in read_log(res_out)
    assert "device-resident" not in read_log(str(tmp_path / "stream"))


def test_profile_steps_writes_a_trace(root, tmp_path):
    out = str(tmp_path / "prof")
    train_main.main(tiny_args(root, out, "--num_epochs", "1", "--batch_size", "2",
                              "--profile_steps", "2"))
    files = os.listdir(os.path.join(out, "profile"))
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(out, "profile", files[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


def test_trace_writes_a_chrome_trace_of_its_body(tmp_path):
    from structured_alignment_vqa_tpu_torch.utils.profiling import StepTimer, trace

    with trace(str(tmp_path / "t")):
        torch.ones(8).add_(1)
    with trace(None):
        pass
    files = os.listdir(tmp_path / "t")
    assert len(files) == 1
    with open(tmp_path / "t" / files[0]) as f:
        assert any("aten::add_" in str(e.get("name")) for e in json.load(f)["traceEvents"])
    timer = StepTimer(window=3)
    assert timer.tick() is None and timer.tick() > 0


def test_glove_is_found_in_vector_cache_and_grafted_as_jax_grafts(root, tmp_path, monkeypatch):
    import jax

    from structured_alignment_vqa_tpu.train.loop import graft_glove as jax_graft
    from structured_alignment_vqa_tpu_torch.models.convert import state_dict_from_jax
    from test_torch_port_model import TINY, build_pair

    vectors = np.random.default_rng(0).standard_normal((20, 300)).astype(np.float32)
    os.makedirs(os.path.join(root, "vector_cache"), exist_ok=True)
    path = os.path.join(root, "vector_cache", "glove.6B.300d.npy")
    np.save(path, vectors)
    seen = {}
    monkeypatch.setattr(train_main, "train", lambda *a, **kw: seen.update(kw))
    try:
        train_main.main(tiny_args(root, str(tmp_path / "g")))
    finally:
        os.unlink(path)
    assert seen["glove_table"].shape == (407000, 300)
    np.testing.assert_array_equal(seen["glove_table"][:20], vectors)

    table = np.random.default_rng(1).standard_normal((30, TINY["glove_dim"])).astype(np.float32)
    # three tables (no share_glove): every one is grafted
    _, jparams, _, model, _ = build_pair(TINY, False, False)
    want = state_dict_from_jax(jax.device_get(jax_graft(jparams, table)), TINY["num_blocks"])
    loop.graft_glove(model, table)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)
    assert sum(not np.array_equal(want[k].numpy(), v.numpy())
               for k, v in state_dict_from_jax(jax.device_get(jparams),
                                               TINY["num_blocks"]).items()) == 3


@pytest.mark.parametrize("zeros_pad,scale", [(True, True), (False, False), (True, False)])
def test_sinusoid_table_equals_jax(zeros_pad, scale):
    from structured_alignment_vqa_tpu.ops.layers import (
        sinusoidal_position_encoding as jax_sinusoid,
    )

    want = np.asarray(jax_sinusoid(2, 50, 64, zeros_pad, scale))
    got = sinusoidal_position_encoding(2, 50, 64, zeros_pad, scale, device="cpu")
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=SINUSOID_ATOL, rtol=0)
    assert (not zeros_pad) == bool(got[:, 0].abs().max() > 0)


def test_model_v_other_than_3_exits(root, tmp_path):
    args = tiny_args(root, str(tmp_path / "v2"))
    args[args.index("--model_v") + 1] = "2"
    with pytest.raises(SystemExit,
                       match=r"model_v != 3: use structured_alignment_vqa_tpu_torch\.models\.variants"):
        train_main.main(args)


@pytest.mark.parametrize("platform", [None, "gpu"])
def test_without_platform_cpu_and_without_a_card_the_cli_raises(root, tmp_path, monkeypatch,
                                                                platform):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = tiny_args(root, str(tmp_path / "nocard"))[:-2]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main.main(args + ([] if platform is None else ["--platform", platform]))


def test_predict_and_eval_clis_serve_the_training_checkpoint(runs, tmp_path):
    train_args, out, state = runs["sparse"]
    ckpt = os.path.join(out, "checkpoints")
    # their own output dir: each CLI starts its training.log afresh
    args = [str(tmp_path) if a == out else a for a in train_args]
    answers = str(tmp_path / "answers.jsonl")
    n = predict.main(args + ["--weight_dir", ckpt, "--split", "val", "--out", answers])
    model_cfg, _, val_dc, tc = train_main.configs_from_args(
        train_main.build_parser().parse_args(args))
    model = loop.new_model(model_cfg, 0, "cpu")
    assert load_params_for_eval(ckpt, model) == state.step
    step = make_predict_step(model)
    want = []
    for b in BatchLoader(GQASuperNodeDataset("val", val_dc), tc.batch_size, shuffle=False,
                         drop_last=False):
        got = step(host_tensors(b)).numpy()
        want += [int(a) for a, ok in zip(got, b.sample_valid) if ok]
    with open(answers) as f:
        written = [json.loads(line)["answer_id"] for line in f]
    assert n == len(written) == len(want) > 0 and written == want
    loss, acc = evaluate.main(args + ["--weight_dir", ckpt, "--split", "val"])
    last = re.findall(r"Epoch \[2/2\], Val Loss: ([^,]+), accuracy: [^=]+= (\S+)", read_log(out))
    assert last and (float(last[-1][0]), float(last[-1][1])) == (loss, acc)
