"""Several processes through the port's CLI: the twin of
``tests/test_multihost.py`` and the training CLI on two CPU processes
(gloo), against the JAX package where it has a counterpart.

* Two processes join through the training CLI's init path
  (``--coordinator --num_processes 2 --process_id i --platform cpu``,
  ``train/main.py:run_ranks``), each holding its half of a global batch of
  8: both report the same global loss and count, and the loss equals JAX's
  single-device loss on the whole batch (1e-5 relative).
* The training CLI on two processes over a fixture tree (dropout 0.1, the
  sparse table, batch replay): one checkpoint file an epoch, holding both
  ranks' dropout generators; a run resumed after epoch 1 ends where an
  uninterrupted one does, bitwise; the ranks' parameters are bitwise equal;
  the eval lines count every valid sample of both ranks' loaders, whose val
  batch counts differ; the ranks' samples are disjoint. One invocation
  that spawns two local ranks (``run_ranks``' branch for several cards a
  host, its card count stubbed to 2) writes the checkpoints of the two
  single-rank invocations, bitwise, and so does one without
  ``--coordinator`` (the host's ranks alone, at a local port).
* With no ``--coordinator`` and the card count stubbed to 2, the eval CLI
  (each rank its stride of whole batches) logs one process's loss and
  counts, and the predict CLI (each rank its
  stride of whole batches, cold and through the batch cache, obj-only and
  ``--mcb``) writes one process's answers file byte for byte; a count of 3
  at ``--batch_size 4`` warns about the idle card; predict still refuses
  ``--coordinator``.
* ``fitting_data_size`` equals the data axis of JAX's ``fitting_mesh``;
  the launcher's argv for both presets equals JAX's ``build_train_argv``
  but for the module; ``--dry_run`` prints one command a host.
"""

import json
import os
import re
import sys
import warnings

import pytest
import torch

from structured_alignment_vqa_tpu_torch.parallel.dryrun import free_ports, launch_local

BATCH = 8
TWIN_KW = dict(
    num_classes=11, num_relations=7, vocab_size=50, glove_dim=12, vis_fea_dim=16,
    hidden_size=16, hidden_size_mil=8, num_blocks=3, num_heads=2, dropout_rate=0.0,
    maxlen=32, maxlen_q=8, maxlen_v=6, topn=2, stage1_blocks=1, stage2_blocks=2,
)
LOSS_RTOL = 1e-5


# ---- the processes: this file run as a script ------------------------------

def _twin_step(args, mesh):
    """One rank's step on its half of the global batch; prints the global
    metrics."""
    from structured_alignment_vqa_tpu_torch.data.synthetic import batch_from_arrays
    from structured_alignment_vqa_tpu_torch.models import AttModelX3, ModelConfig
    from structured_alignment_vqa_tpu_torch.parallel.train_step import (
        create_train_state,
        make_train_step,
        shard_state,
    )

    inputs = torch.load(os.path.join(args.output_dir, "inputs.pt"), weights_only=False)
    cfg = ModelConfig(**TWIN_KW)
    model = AttModelX3(cfg, device=mesh.device)
    model.load_state_dict(inputs["weights"])
    state = shard_state(create_train_state(model, 1e-3), mesh)
    step = make_train_step(model, state.optimizer, cfg, mesh=mesh)
    half = BATCH // mesh.world
    local = {k: v[mesh.rank * half:(mesh.rank + 1) * half] for k, v in inputs["arrays"].items()}
    m = step(state, batch_from_arrays(local, mesh.device))
    print("RESULT", json.dumps({"pid": mesh.rank, "world": mesh.world, "loss": float(m["loss"]),
                                "n": float(m["n"]), "step": state.step}), flush=True)


def _cli_rank(out_file, argv):
    """One rank of the training CLI; saves its final parameters."""
    from structured_alignment_vqa_tpu_torch.train import main as train_main

    state = train_main.main(argv)
    torch.save({"params": {n: p.detach().clone() for n, p in state.model.named_parameters()},
                "step": state.step, "count": state.table_opt.count.clone()}, out_file)


if __name__ == "__main__":
    torch.set_num_threads(1)
    if sys.argv[1] == "twin":
        from structured_alignment_vqa_tpu_torch.train import main as train_main

        train_main.run_ranks(train_main.build_parser().parse_args(sys.argv[2:]), _twin_step)
    else:
        _cli_rank(sys.argv[2], sys.argv[3:])
    sys.exit(0)


# ---- the tests ------------------------------------------------------------

import jax  # noqa: E402

import structured_alignment_vqa_tpu.ops.pallas_attention as pa  # noqa: E402
from structured_alignment_vqa_tpu.parallel import mesh as jax_mesh  # noqa: E402
from structured_alignment_vqa_tpu.train import launch as jax_launch  # noqa: E402
from structured_alignment_vqa_tpu_torch.data.dataset import (  # noqa: E402
    BatchLoader,
    GQASuperNodeDataset,
)
from structured_alignment_vqa_tpu_torch.data.fixtures import write_fixture  # noqa: E402
from structured_alignment_vqa_tpu_torch.data.transfer import host_tensors  # noqa: E402
from structured_alignment_vqa_tpu_torch.data.synthetic import synthetic_arrays  # noqa: E402
from structured_alignment_vqa_tpu_torch.models import (  # noqa: E402
    AttModelX3,
    ModelConfig,
    init_random_,
)
from structured_alignment_vqa_tpu_torch.models.att_model_x3 import _Head  # noqa: E402
from structured_alignment_vqa_tpu_torch.models.convert import state_dict_from_jax  # noqa: E402
from structured_alignment_vqa_tpu_torch.parallel.mesh import fitting_data_size  # noqa: E402
from structured_alignment_vqa_tpu_torch.parallel.train_step import (  # noqa: E402
    TrainState,
    adam,
)
from structured_alignment_vqa_tpu_torch.train import evaluate, launch, predict  # noqa: E402
from structured_alignment_vqa_tpu_torch.train import main as train_main  # noqa: E402
from structured_alignment_vqa_tpu_torch.utils.checkpoint import (  # noqa: E402
    checkpoint_path,
    save_checkpoint,
    saved_epochs,
)
from test_torch_port_model import JaxConfig, JaxModel, jax_batch, perturbed  # noqa: E402
from test_torch_port_train_step import _jax_loss  # noqa: E402

HERE = os.path.abspath(__file__)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def test_two_processes_through_the_cli_init_path_give_jax_global_loss(tmp_path):
    arrays = synthetic_arrays(ModelConfig(**TWIN_KW), BATCH, lv=4, lq=5, ls=10, seed=7)
    jmodel = JaxModel(JaxConfig(**TWIN_KW))
    jb = jax_batch(arrays)
    params, jparams = perturbed(jax.jit(jmodel.init)(jax.random.key(0), jb)["params"])
    torch.save({"arrays": arrays, "weights": state_dict_from_jax(params, TWIN_KW["num_blocks"])},
               tmp_path / "inputs.pt")
    coordinator = f"127.0.0.1:{free_ports()[0]}"
    outs = launch_local([[sys.executable, HERE, "twin", "--platform", "cpu", "--output_dir",
                          str(tmp_path), "--coordinator", coordinator, "--num_processes", "2",
                          "--process_id", str(pid)] for pid in range(2)], timeout=180)
    results = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("RESULT "):
                r = json.loads(line[len("RESULT "):])
                results[r["pid"]] = r
    assert set(results) == {0, 1} and results[0]["world"] == 2
    assert results[0]["n"] == results[1]["n"] == BATCH
    assert results[0]["loss"] == results[1]["loss"]
    assert results[0]["step"] == results[1]["step"] == 1
    pa.INTERPRET_MODE = True
    try:
        want = float(jax.jit(_jax_loss(jmodel, True))(jparams, jb))
    finally:
        pa.INTERPRET_MODE = False
    assert abs(results[0]["loss"] - want) <= LOSS_RTOL * abs(want), (results[0]["loss"], want)


# ---- the training CLI on two processes ------------------------------------

CLI_ROWS = 4          # --batch_size: rows a rank a step (one rank a host)
VAL_LINE = re.compile(r"Val Loss: [^,]+, accuracy: ([0-9.]+)/([0-9.]+) =")


def _cli_argv(root, out, cache, *extra):
    return [
        "--data_dir_azure", root, "--output_dir", out, "--model_v", "3", "--only_obj",
        "--with_loc", "--decMask", "--with_MILNCE_loss", "--pred_rel",
        "--batch_size", str(CLI_ROWS), "--maxlen", "128", "--maxlen_q", "12", "--maxlen_v", "8",
        "--hidden_size", "16", "--hidden_size_mil", "8", "--num_blocks", "3", "--num_heads", "2",
        "--min_cnt", "50", "--topN", "2", "--log_steps", "1", "--log_steps_val", "100",
        "--vocab_size", "401000", "--glove_dim", "8", "--num_workers", "2", "--lr", "1e-3",
        "--seed", "7", "--dropout_rate", "0.1", "--share_glove", "--sparse_table",
        "--cache_dir", cache, "--batch_replay", "--platform", "cpu", *extra,
    ]


# one invocation of the training CLI whose host has two ranks: the card
# count stubbed (the CPU has one rank a host), the ranks spawned by
# run_ranks with one intra-op thread each, as the other processes here
SPAWN_TWO_LOCAL = ("import os, sys; os.environ['OMP_NUM_THREADS'] = '1'; "
                   "from structured_alignment_vqa_tpu_torch.train import main as m; "
                   "m.local_ranks = lambda args: 2; m.main(sys.argv[1:])")


# the same for the eval and predict CLIs
SPAWN_TWO_LOCAL_CLI = ("import os, sys; os.environ['OMP_NUM_THREADS'] = '1'; "
                       "from structured_alignment_vqa_tpu_torch.train import main as m, {cli}; "
                       "m.local_ranks = lambda args: 2; {cli}.main(sys.argv[1:])")


def _spawned(tmp, root, port, name="spawned"):
    """The command for one invocation of two local ranks, 2 epochs, taking
    the two single-rank invocations' rows a rank; with no ``port``, without
    ``--coordinator``."""
    out, cache = os.path.join(tmp, name), os.path.join(tmp, f"{name}_cache")
    group = () if port is None else ("--coordinator", f"127.0.0.1:{port}", "--num_processes",
                                     "1", "--process_id", "0")
    argv = _cli_argv(root, out, cache, "--num_epochs", "2", *group)
    argv[argv.index("--batch_size") + 1] = str(2 * CLI_ROWS)
    return [sys.executable, "-c", SPAWN_TWO_LOCAL, *argv]


def _serving_argv(tmp, root, name, cli, *extra):
    """The eval or predict CLI's flags over a checkpoint of random weights
    (``--mcb`` among ``extra`` for the MCB head's): ``--batch_size 4`` to
    eval (val holds a single batch of 8), 8 to predict."""
    head = "mcb" if "--mcb" in extra else "concat"
    argv = _cli_argv(root, os.path.join(tmp, name), os.path.join(tmp, f"{name}_cache"),
                     "--weight_dir", os.path.join(tmp, f"weights_{head}"), *extra)
    if cli == "predict":
        argv[argv.index("--batch_size") + 1] = str(2 * CLI_ROWS)
        argv += ["--split", "train", "--out", os.path.join(tmp, f"{name}.jsonl")]
    return argv


def _one_process_eval(tmp, root):
    """The eval CLI in one process of one rank, as a process of its own
    beside the spawned ranks (one thread, as they)."""
    code = ("import os, sys; os.environ['OMP_NUM_THREADS'] = '1'; "
            "from structured_alignment_vqa_tpu_torch.train import evaluate; "
            "evaluate.main(sys.argv[1:])")
    return [sys.executable, "-c", code, *_serving_argv(tmp, root, "eval_one", "evaluate")]


def _spawned_cli(cli, argv):
    return [sys.executable, "-c", SPAWN_TWO_LOCAL_CLI.format(cli=cli), *argv]


def _save_random_weights(tmp, root):
    """A checkpoint of seeded random weights for each head (concat, MCB),
    each answer head's output bias shifted by minus its mean logits over
    one batch, so that the answers spread over the classes."""
    for head, extra in (("concat", ()), ("mcb", ("--mcb",))):
        args = train_main.build_parser().parse_args(_cli_argv(root, "unused", "unused", *extra))
        cfg, train_dc, _, _ = train_main.configs_from_args(args)
        model = AttModelX3(cfg, device="cpu")
        init_random_(model, torch.Generator().manual_seed(3))
        batch = next(iter(BatchLoader(GQASuperNodeDataset("train", train_dc), 2 * CLI_ROWS,
                                      shuffle=False)))
        heads = [m for m in model.modules() if isinstance(m, _Head)]
        outs = {}
        hooks = [m.register_forward_hook(lambda m, _, out: outs.__setitem__(m, out))
                 for m in heads]
        with torch.no_grad():
            model.eval()(host_tensors(batch))
            for m in heads:
                m[-1].bias.sub_(outs[m].mean(0))
        for h in hooks:
            h.remove()
        save_checkpoint(os.path.join(tmp, f"weights_{head}"),
                        TrainState(model, adam(model.parameters())), 1)


# the serving runs of two local ranks without --coordinator: (name, CLI,
# extra flags); "predict_cold" publishes its batch cache, "predict_warm"
# reads the one the fixture's one-process run published
SPAWNED_SERVING = (("eval_noflag", "evaluate", ()),
                   ("predict_cold", "predict", ("--batch_cache_dir", "{tmp}/batches_cold")),
                   ("predict_warm", "predict", ("--batch_cache_dir", "{tmp}/batches")),
                   ("predict_mcb", "predict", ("--mcb",)))


def _two_ranks(tmp, name, root, epochs, port):
    """Commands for one 2-process run of the training CLI."""
    coordinator = f"127.0.0.1:{port}"
    out, cache = os.path.join(tmp, name), os.path.join(tmp, f"{name}_cache")
    return [[sys.executable, HERE, "cli", os.path.join(tmp, f"{name}_rank{r}_{epochs}.pt"),
             *_cli_argv(root, out, cache, "--num_epochs", str(epochs), "--coordinator",
                        coordinator, "--num_processes", "2", "--process_id", str(r))]
            for r in range(2)]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Two epochs uninterrupted (``full``), and one epoch then a resumed
    second (``resumed``), each on two processes; two epochs of one
    invocation spawning two local ranks (``spawned``). 60 questions give
    15 val samples: 8 on rank 0 (2 batches) and 7 on rank 1 (1 batch)."""
    tmp = str(tmp_path_factory.mktemp("dp_cli"))
    root = os.path.join(tmp, "data")
    write_fixture(root, n_images=8, n_questions=60, seed=1)
    _save_random_weights(tmp, root)
    predict.main(_serving_argv(tmp, root, "cache_pass", "predict", "--batch_cache_dir",
                               f"{tmp}/batches"))
    ports = free_ports(3)
    launch_local(_two_ranks(tmp, "full", root, 2, ports[0])
                 + _two_ranks(tmp, "resumed", root, 1, ports[1])
                 + [_one_process_eval(tmp, root), _spawned(tmp, root, ports[2]),
                    _spawned(tmp, root, None, "noflag")],
                 timeout=300)
    # the second batch: the serving runs beside the resumed epoch, so that
    # no more than a dozen processes run at once
    launch_local(_two_ranks(tmp, "resumed", root, 2, free_ports()[0])
                 + [_spawned_cli(cli, _serving_argv(tmp, root, name, cli, *(
                     e.format(tmp=tmp) for e in extra))) for name, cli, extra in SPAWNED_SERVING],
                 timeout=300)
    states = {(name, r): torch.load(os.path.join(tmp, f"{name}_rank{r}_2.pt"))
              for name in ("full", "resumed") for r in range(2)}
    return tmp, root, states


def _log(tmp, name):
    with open(os.path.join(tmp, name, "training.log")) as f:
        return f.read()


def test_the_cli_checkpoints_once_an_epoch_with_every_ranks_generator(cli_runs):
    tmp, _, _ = cli_runs
    for name in ("full", "resumed"):
        ckpt = os.path.join(tmp, name, "checkpoints")
        assert saved_epochs(ckpt) == [1, 2]
        assert sorted(os.listdir(ckpt)) == ["epoch_1.pt", "epoch_2.pt"]   # no stray temp file
        payload = torch.load(checkpoint_path(ckpt, 2), weights_only=True)
        assert len(payload["generators"]) == 2
        assert not torch.equal(payload["generators"][0], payload["generators"][1])


def test_resumed_two_rank_run_ends_where_an_uninterrupted_one_does(cli_runs):
    tmp, _, states = cli_runs
    assert "resumed from epoch 1" in _log(tmp, "resumed")
    assert "resumed from epoch" not in _log(tmp, "full")
    full, resumed = states[("full", 0)], states[("resumed", 0)]
    assert full["step"] == resumed["step"] > 0
    assert int(full["count"]) == int(resumed["count"]) == full["step"]
    for name, p in full["params"].items():
        assert torch.equal(p, resumed["params"][name]), name


def test_the_two_ranks_hold_bitwise_equal_parameters(cli_runs):
    _, _, states = cli_runs
    for name in ("full", "resumed"):
        a, b = states[(name, 0)], states[(name, 1)]
        assert a["step"] == b["step"]
        for k, p in a["params"].items():
            assert torch.equal(p, b["params"][k]), (name, k)


def _rank_loaders(root, split, shuffle):
    args = train_main.build_parser().parse_args(_cli_argv(root, "unused", "unused"))
    _, train_dc, val_dc, _ = train_main.configs_from_args(args)
    ds = GQASuperNodeDataset(split, train_dc if split == "train" else val_dc)
    return [BatchLoader(ds, CLI_ROWS, shuffle=shuffle, seed=7, shard_idx=r, num_shards=2)
            for r in range(2)]


def test_the_eval_lines_count_both_ranks_valid_samples(cli_runs):
    """Every rank evaluates its stride of val, the rank that runs out first
    stepping on padding rows until both are done: the logged counts are
    every valid sample of both ranks' loaders, whose batch counts differ."""
    tmp, root, _ = cli_runs
    loaders = _rank_loaders(root, "val", shuffle=False)
    per_rank = [[int(b.sample_valid.sum()) for b in loader] for loader in loaders]
    assert len(per_rank[0]) != len(per_rank[1])
    want = sum(sum(b) for b in per_rank)
    for name in ("full", "spawned"):
        counts = [int(float(n)) for _, n in VAL_LINE.findall(_log(tmp, name))]
        assert counts == [want, want] and 0 < want <= len(loaders[0].ds), name


def test_two_spawned_local_ranks_train_as_two_single_rank_invocations(cli_runs):
    """``run_ranks`` spawning two ranks on one host (global ranks 0 and 1,
    ``--batch_size`` split over them) writes, epoch by epoch, the
    checkpoints that two invocations of one rank each write."""
    tmp, _, _ = cli_runs
    assert "over 2 rank(s), 4 row(s) a rank a step" in _log(tmp, "spawned")
    for epoch in (1, 2):
        got, want = (torch.load(checkpoint_path(os.path.join(tmp, name, "checkpoints"), epoch),
                                weights_only=True) for name in ("spawned", "full"))
        assert len(got["generators"]) == 2
        for key in ("params", "table_opt"):
            for k, v in want[key].items():
                assert torch.equal(got[key][k], v), (epoch, key, k)
        for g, w in zip(got["generators"], want["generators"]):
            assert torch.equal(g, w), epoch
        assert got["step"] == want["step"] > 0


def test_two_local_ranks_without_coordinator_train_as_two_single_rank_invocations(cli_runs):
    """No ``--coordinator``: ``run_ranks`` forms the host's group at a local
    port and writes, epoch by epoch, the two-process run's checkpoints."""
    tmp, _, _ = cli_runs
    assert "over 2 rank(s), 4 row(s) a rank a step" in _log(tmp, "noflag")
    for epoch in (1, 2):
        got, want = (torch.load(checkpoint_path(os.path.join(tmp, name, "checkpoints"), epoch),
                                weights_only=True) for name in ("noflag", "full"))
        assert len(got["generators"]) == 2
        for key in ("params", "table_opt"):
            assert got[key].keys() == want[key].keys()
            for k, v in want[key].items():
                assert torch.equal(got[key][k], v), (epoch, key, k)
        for g, w in zip(got["generators"], want["generators"]):
            assert torch.equal(g, w), epoch
        assert got["step"] == want["step"] > 0


EVAL_LINE = re.compile(r"Eval\[val\] Loss: ([^,]+), accuracy: ([0-9.]+)/([0-9.]+) =")


def test_two_local_ranks_evaluate_as_one_process(cli_runs):
    """The eval CLI over two spawned ranks, each its stride of whole
    batches of val, logs one process's line: its loss and its counts,
    which are every valid sample of one process's loader. (Two ranks of 2
    rows each would keep other samples: the eval loader drops an
    under-full batch of a bucket, as the TPU package's does.)"""
    tmp, root, _ = cli_runs
    (got,), (want,) = (EVAL_LINE.findall(_log(tmp, name)) for name in ("eval_noflag", "eval_one"))
    args = train_main.build_parser().parse_args(_cli_argv(root, "unused", "unused"))
    _, _, val_dc, _ = train_main.configs_from_args(args)
    batches = list(BatchLoader(GQASuperNodeDataset("val", val_dc), CLI_ROWS, shuffle=False))
    valid = sum(int(b.sample_valid.sum()) for b in batches)
    assert got == want and float(want[2]) == valid > 0, (got, want, valid)
    assert f"val: {len(batches)} batch(es) over 2 ranks" in _log(tmp, "eval_noflag")
    assert len(batches) > 2


@pytest.mark.parametrize("name", ["predict_cold", "predict_warm", "predict_mcb"])
def test_two_local_ranks_write_one_process_answers_file(cli_runs, name):
    """Two spawned ranks, each serving whole batches in stride, rank 0
    writing: the answers file of one process byte for byte, cold (rank 0
    publishing the batch cache), through a cache a one-process run
    published (each rank reading its own batches) and with the MCB head,
    whose norm spans the batch."""
    tmp, root, _ = cli_runs
    extra = ("--mcb",) if name == "predict_mcb" else ()
    predict.main(_serving_argv(tmp, root, f"one_{name}", "predict", *extra))
    with open(os.path.join(tmp, f"one_{name}.jsonl"), "rb") as f:
        want = f.read()
    with open(os.path.join(tmp, f"{name}.jsonl"), "rb") as f:
        got = f.read()
    answers = [json.loads(line) for line in want.decode().splitlines()]
    assert got == want and len(answers) == 60
    assert len({a["answer_id"] for a in answers}) > 1
    assert "on 2 rank(s)" in _log(tmp, name)


def test_an_idle_card_is_warned_about(monkeypatch):
    """Three cards at ``--batch_size 4``: two ranks, one card idle."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    args = train_main.build_parser().parse_args(["--batch_size", "4"])
    with pytest.warns(UserWarning, match=r"uses only 2 of 3 devices \(1 idle\)"):
        assert train_main.local_ranks(args) == 2


def test_predict_still_refuses_a_coordinator():
    with pytest.raises(ValueError, match="takes no --coordinator"):
        predict.main(["--platform", "cpu", "--weight_dir", "unused", "--coordinator",
                      "127.0.0.1:1"])


def test_no_sample_is_seen_twice_in_an_epoch(cli_runs):
    _, root, _ = cli_runs
    for epoch in (0, 1):
        loaders = _rank_loaders(root, "train", shuffle=True)
        for loader in loaders:
            loader.set_epoch(epoch)
        a, b = (set(loader._indices().tolist()) for loader in loaders)
        assert not a & b
        assert a | b == set(range(len(loaders[0].ds)))


# ---- the mesh rule and the launcher ---------------------------------------

@pytest.mark.parametrize("n_devices,batch_size", [(8, 32), (8, 4), (8, 6), (8, 7), (4, 6),
                                                  (2, 3), (1, 5)])
def test_fitting_data_size_equals_jax_fitting_mesh(monkeypatch, n_devices, batch_size):
    """The same data size, and a warning about idle devices from both or
    from neither."""
    devices = jax.devices()[:n_devices]
    monkeypatch.setattr(jax_mesh.jax, "devices", lambda: devices)
    with warnings.catch_warnings(record=True) as jax_warned:
        warnings.simplefilter("always")
        want = jax_mesh.fitting_mesh(batch_size).shape["data"]
    with warnings.catch_warnings(record=True) as port_warned:
        warnings.simplefilter("always")
        got = fitting_data_size(n_devices, batch_size)
    assert got == want
    assert len(port_warned) == len(jax_warned) == (want < n_devices)


@pytest.mark.parametrize("preset", sorted(jax_launch.PRESETS))
def test_launcher_argv_equals_jax_but_for_the_module(preset):
    assert launch.PRESETS[preset] == jax_launch.PRESETS[preset]
    extra = ["--share_glove", "--bf16"]
    got = launch.build_train_argv(preset, "/data", "out", extra)
    want = jax_launch.build_train_argv(preset, "/data", "out", extra)
    assert want[2] == "structured_alignment_vqa_tpu.train.main"
    assert got[:2] + got[3:] == want[:2] + want[3:]
    assert got[2] == "structured_alignment_vqa_tpu_torch.train.main"


def test_launcher_dry_run_prints_one_command_a_host(capsys):
    lines = launch.main(["--preset", "obj_rel", "--data_dir", "/data", "--hosts", "h0,h1,h2",
                         "--port", "1234", "--dry_run"])
    assert capsys.readouterr().out.splitlines() == lines and len(lines) == 3
    for h, line in enumerate(lines):
        assert line.startswith(f"ssh h{h} ")
        assert f"--coordinator h0:1234 --num_processes 3 --process_id {h}" in line
        assert "structured_alignment_vqa_tpu_torch.train.main" in line


def test_model_parallel_still_raises_naming_item_15b():
    # the model axis is ported (tests/test_torch_port_model_parallel.py),
    # and a head split between ranks too (item 15d,
    # tests/test_torch_port_model_parallel_heads.py): the production model's
    # 8 heads over 16 ranks pass the flags' check, and on the CPU one
    # invocation starts the 16 ranks of a data rank
    train_main.check_axes(model_parallel=16, hidden_size=512, num_heads=8)
    args = train_main.build_parser().parse_args(["--model_parallel", "16", "--platform", "cpu"])
    assert (args.hidden_size, args.num_heads) == (512, 8)
    train_main.check_supported_flags(args)
    assert train_main.local_ranks(args) == 16
