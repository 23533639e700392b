"""The port's data-parallel step (``parallel/{mesh,context,sharding}.py`` and
the mesh path of ``parallel/train_step.py``) against the JAX package's
single-device step on the global batch, as ``tests/test_train_step.py:98``
and ``tests/test_sparse_table.py:264`` hold its 8-way sharded step.

One spawn serves the module: two gloo ranks on the CPU (this file run as a
script) take every case below on their halves of a batch of 8 and save what
they hold; the tests compare. Same weights on both sides (JAX params
perturbed off the LayerNorm knife edge, carried by ``models/convert.py``),
float32, dropout 0, one thread a process. Checks:

* the dense step, the sparse-table step, the obj+rel step (the relation
  MIL-NCE and the rewrite's joint softmax over both ranks' records) and a
  step whose second half holds invalid samples (the CE's global
  denominator): ``loss``, ``ce`` and ``mil_nce_loss`` within 1e-5
  relative, the counts equal, every gradient within 1e-5 of the norm of
  its JAX counterpart (of all gradients' joint norm where JAX's is exactly
  0: the K projections' biases), the parameters after the Adam step within 1e-5
  (elements whose gradient is above 1e-4 of its tensor's largest, as
  ``parallel/dryrun.py:step_errors`` explains), the sparse table's moment
  within 1e-5, and both ranks bitwise equal;
* a NaN on one rank: both ranks skip the step and keep bitwise-equal
  parameters and Adam state, those of the step before;
* the MCB pooling at hidden 512 into 16,000 bins: the two ranks' rows
  against the single process's pooling of all 8, values and gradients;
* the dry run of ``parallel/dryrun.py`` (2 ranks, both MIL branches, dense
  and sparse, against the single process).
"""

import os
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from structured_alignment_vqa_tpu_torch.data.synthetic import batch_from_arrays, synthetic_arrays
from structured_alignment_vqa_tpu_torch.models import AttModelX3, ModelConfig
from structured_alignment_vqa_tpu_torch.ops.mcb import compact_bilinear_pooling, count_sketch_matrix
from structured_alignment_vqa_tpu_torch.parallel.context import use_mesh
from structured_alignment_vqa_tpu_torch.parallel.dryrun import (
    GRAD_FLOOR,
    dryrun_multichip,
    free_ports,
    launch_local,
)
from structured_alignment_vqa_tpu_torch.parallel.mesh import init_distributed, shutdown
from structured_alignment_vqa_tpu_torch.parallel.train_step import (
    create_train_state,
    make_train_step,
    shard_state,
)

WORLD = 2
BATCH = 8
LR = 1e-3
B1 = 0.9                  # Adam's first-moment decay, both packages
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5
PARAM_ATOL = 1e-5
MCB_ATOL = 1e-5
MCB_D, MCB_OUT = 512, 16000
TINY_KW = dict(
    num_classes=11, num_relations=7, vocab_size=50, glove_dim=12, vis_fea_dim=16,
    hidden_size=16, hidden_size_mil=8, num_blocks=3, num_heads=2, dropout_rate=0.0,
    maxlen=32, maxlen_q=8, maxlen_v=6, topn=2, stage1_blocks=1, stage2_blocks=2,
)
STEP_CASES = ("dense", "sparse", "objrel", "invalid")


# ---- the ranks: this file run as a script --------------------------------

def _rows(arrays, rank):
    """This rank's half of every field."""
    n = BATCH // WORLD
    return {k: v[rank * n:(rank + 1) * n] for k, v in arrays.items()}


def _port_step(spec, mesh, batches):
    cfg = ModelConfig(share_glove=True, **spec["kw"])
    model = AttModelX3(cfg, device="cpu")
    model.load_state_dict(spec["weights"])
    state = create_train_state(model, LR, sparse_table=spec["sparse"])
    shard_state(state, mesh)
    step = make_train_step(model, state.optimizer, cfg, sparse_table=spec["sparse"], mesh=mesh)
    metrics = [step(state, batch_from_arrays(_rows(a, mesh.rank), "cpu")) for a in batches]
    out = {"metrics": [{k: float(v) for k, v in m.items()} for m in metrics],
           "params": {n: p.detach().clone() for n, p in model.named_parameters()},
           "grads": {n: p.grad.clone() for n, p in model.named_parameters()
                     if p.grad is not None},
           "adam": {i: {k: v.clone() for k, v in s.items()}
                    for i, s in state.optimizer.state_dict()["state"].items()}}
    if spec["sparse"]:
        out["mu"] = state.table_opt.mu.clone()
    return out


def _mcb_rank(spec, mesh):
    x1, x2 = (torch.from_numpy(_rows({"x": spec[k]}, mesh.rank)["x"]).requires_grad_(True)
              for k in ("x1", "x2"))
    w = torch.from_numpy(_rows({"w": spec["w"]}, mesh.rank)["w"])
    with use_mesh(mesh):
        out = compact_bilinear_pooling(x1, x2, torch.from_numpy(spec["s1"]),
                                       torch.from_numpy(spec["s2"]), MCB_OUT)
    (out * w).sum().backward()
    return {"out": out.detach(), "g1": x1.grad, "g2": x2.grad}


def _worker(rank, coordinator, tmp):
    torch.set_num_threads(1)
    mesh = init_distributed(coordinator, WORLD, rank, device="cpu")
    try:
        inputs = torch.load(f"{tmp}/inputs.pt", weights_only=False)
        out = {case: _port_step(inputs[case], mesh, [inputs[case]["arrays"]])
               for case in STEP_CASES}
        spec = inputs["nonfinite"]
        out["nonfinite"] = _port_step(spec, mesh, [spec["arrays"], spec["poisoned"]])
        out["mcb"] = _mcb_rank(inputs["mcb"], mesh)
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        shutdown(mesh)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
    sys.exit(0)


# ---- the tests ------------------------------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import structured_alignment_vqa_tpu.ops.pallas_attention as pa  # noqa: E402
from structured_alignment_vqa_tpu.parallel.train_step import TrainState as JaxState  # noqa: E402
from structured_alignment_vqa_tpu.parallel.train_step import adam as jax_adam  # noqa: E402
from structured_alignment_vqa_tpu.parallel.sparse_table import (  # noqa: E402
    TABLE_PATH,
    init_table_opt,
)
from structured_alignment_vqa_tpu.parallel.train_step import (  # noqa: E402
    _empty_like,
    _tree_get,
    _tree_set,
)
from structured_alignment_vqa_tpu.parallel.train_step import (  # noqa: E402
    make_train_step as jax_train_step,
)
from structured_alignment_vqa_tpu_torch.models.convert import (  # noqa: E402
    state_dict_from_jax,
    table_opt_from_jax,
)
from test_torch_port_model import JaxConfig, JaxModel, jax_batch, perturbed  # noqa: E402
from structured_alignment_vqa_tpu_torch.parallel.sparse_table import TABLE_NAME  # noqa: E402


@pytest.fixture(autouse=True)
def _setup():
    torch.set_num_threads(1)
    pa.INTERPRET_MODE = True
    yield
    pa.INTERPRET_MODE = False


class _JaxSteps:
    """One configuration's JAX model, its initial params and its jitted
    steps (dense and sparse), traced once for every case."""

    def __init__(self, kw):
        self.kw = kw
        self.model = JaxModel(JaxConfig(share_glove=True, **kw))
        self.init = None
        self.tx = jax_adam(LR)
        self.dense = jax_train_step(self.model, self.tx, self.model.cfg)
        self.sparse = jax_train_step(self.model, self.tx, self.model.cfg, sparse_table=True,
                                     table_lr=LR)

    def case(self, seed):
        """Params perturbed from ``seed``, the port weights holding the same
        and the global batch's arrays."""
        arrays = synthetic_arrays(ModelConfig(share_glove=True, **self.kw), BATCH, lv=4, lq=5,
                                  ls=10, seed=seed)
        arrays["answer"][[0, 5]] = 0                  # out-of-vocabulary answers on both ranks
        if self.init is None:
            self.init = jax.jit(self.model.init)(jax.random.key(0), jax_batch(arrays))["params"]
        params, jparams = perturbed(self.init, seed=seed)
        return {"kw": self.kw, "sparse": False, "arrays": arrays, "jparams": jparams,
                "weights": state_dict_from_jax(params, self.kw["num_blocks"])}

    def run(self, case, arrays_list):
        """JAX's single-device step(s) on the whole batch: the metrics of
        each step, the params after the last, the gradients of the last
        applied one and the sparse moment, by the port's names. Adam's
        first moment after one update from zero is (1 - b1) times the
        gradient, so the gradients come from it."""
        copy = jax.tree.map(jnp.array, case["jparams"])
        if case["sparse"]:
            # create_train_state(sparse_table=True)'s layout, without its init
            table = _tree_get(copy, TABLE_PATH)
            opt_state = (self.tx.init(_tree_set(copy, TABLE_PATH, _empty_like(table))),
                         init_table_opt(table))
        else:
            opt_state = self.tx.init(copy)
        state = JaxState(step=jnp.zeros((), jnp.int32), params=copy, opt_state=opt_state)
        step = self.sparse if case["sparse"] else self.dense
        metrics = []
        for a in arrays_list:
            state, m = step(state, jax_batch(a), jax.random.key(1))
            metrics.append({k: float(v) for k, v in m.items()})
        nb = case["kw"]["num_blocks"]
        adam_state = (state.opt_state[0] if case["sparse"] else state.opt_state)[0]
        grads = jax.tree.map(lambda mu: mu / (1 - B1), jax.device_get(adam_state.mu))
        out = {"metrics": metrics,
               "params": state_dict_from_jax(jax.device_get(state.params), nb),
               "grads": state_dict_from_jax(grads, nb)}
        if case["sparse"]:
            out["mu"] = table_opt_from_jax(jax.device_get(state.opt_state[1]))["mu"]
            out["grads"][TABLE_NAME] = out["mu"] / (1 - B1)
        return out


@pytest.fixture(scope="module")
def dp_world():
    """The cases, what each rank holds after them, and JAX's single-device
    steps on the whole batches (computed while the ranks run)."""
    torch.set_num_threads(1)
    pa.INTERPRET_MODE = True
    obj, rel = _JaxSteps(TINY_KW), _JaxSteps(dict(TINY_KW, only_obj=False))
    cases = {"dense": obj.case(7), "objrel": rel.case(9)}
    cases["sparse"] = dict(cases["dense"], sparse=True)
    cases["invalid"] = obj.case(11)
    cases["invalid"]["arrays"]["sample_valid"][[5, 6, 7]] = 0   # rank 1: one valid of 4
    cases["nonfinite"] = obj.case(13)
    poisoned = {k: v.copy() for k, v in cases["nonfinite"]["arrays"].items()}
    poisoned["vis_fea"][6, 0, 0] = np.nan                       # on rank 1 only
    cases["nonfinite"]["poisoned"] = poisoned
    rng = np.random.default_rng(3)
    sketch_rng = np.random.default_rng(4)
    cases["mcb"] = {
        "x1": rng.standard_normal((BATCH, MCB_D)).astype(np.float32),
        "x2": rng.standard_normal((BATCH, MCB_D)).astype(np.float32),
        "w": rng.standard_normal((BATCH, MCB_OUT)).astype(np.float32),
        "s1": count_sketch_matrix(sketch_rng, MCB_D, MCB_OUT),
        "s2": count_sketch_matrix(sketch_rng, MCB_D, MCB_OUT),
    }
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(1) as pool:
        torch.save({name: {k: v for k, v in c.items() if k != "jparams"}
                    for name, c in cases.items()}, f"{tmp}/inputs.pt")
        coordinator = f"127.0.0.1:{free_ports()[0]}"
        here = os.path.abspath(__file__)
        ranks_done = pool.submit(launch_local, [[sys.executable, here, str(r), coordinator, tmp]
                                                for r in range(WORLD)], 240)
        want = {name: (rel if name == "objrel" else obj).run(cases[name], [cases[name]["arrays"]])
                for name in STEP_CASES}
        want["nonfinite"] = obj.run(cases["nonfinite"], [cases["nonfinite"]["arrays"], poisoned])
        ranks_done.result()
        ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=True) for r in range(WORLD)]
    pa.INTERPRET_MODE = False
    return cases, ranks, want


def _grad_errors(got, want):
    """Each gradient by the norm of its difference over its own norm; one
    that JAX computes as exactly 0 (a K projection's bias: the softmax
    ignores a shift every key shares) over the norm of all of JAX's
    gradients together."""
    joint = sum(w.norm().item() ** 2 for w in want.values()) ** 0.5
    return {name: (g - want[name]).norm().item() / (want[name].norm().item() or joint)
            for name, g in got.items()}


def _assert_params_match(got, want):
    """The parameters after a step, where the gradient decides them."""
    for name, p in got["params"].items():
        g = want["grads"][name]
        above = g.abs() > GRAD_FLOOR * g.abs().max()
        diff = (p - want["params"][name]).abs()[above]
        assert diff.numel() == 0 or diff.max() <= PARAM_ATOL, (name, diff.max())


def _assert_step_matches_jax(got, want):
    for key in ("loss", "ce", "mil_nce_loss"):
        a, b = got["metrics"][0][key], want["metrics"][0][key]
        assert abs(a - b) <= LOSS_RTOL * abs(b), (key, a, b)
    for key in ("n", "n_correct", "skipped"):
        assert got["metrics"][0][key] == want["metrics"][0][key], key
    errs = _grad_errors(got["grads"], want["grads"])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_RTOL, (worst, errs[worst])
    _assert_params_match(got, want)
    if "mu" in want:
        np.testing.assert_allclose(got["mu"].numpy(), want["mu"].numpy(),
                                   atol=PARAM_ATOL, rtol=0)


def _same(a, b):
    """Bitwise equal, NaN where NaN (a skipped step's summed gradients)."""
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(a.nan_to_num(),
                                                                        b.nan_to_num())


def _assert_ranks_equal(ranks, case):
    for r, out in enumerate(ranks[1:], 1):
        for part in ("params", "grads", "adam", "mu"):
            a, b = out[case].get(part, {}), ranks[0][case].get(part, {})
            if torch.is_tensor(a):
                assert _same(a, b), (case, part, r)
                continue
            assert a.keys() == b.keys(), (case, part)
            for k in a:
                same = (all(_same(x, b[k][n]) for n, x in a[k].items())
                        if isinstance(a[k], dict) else _same(a[k], b[k]))
                assert same, (case, part, k, r)


@pytest.mark.parametrize("case", STEP_CASES)
def test_two_rank_step_equals_jax_on_the_global_batch(dp_world, case):
    _, ranks, want = dp_world
    _assert_ranks_equal(ranks, case)
    _assert_step_matches_jax(ranks[0][case], want[case])
    if case == "objrel":
        assert np.isfinite(want[case]["metrics"][0]["mil_nce_loss"])
        assert ranks[0][case]["grads"]["MIL_NCE.R"].abs().max() > 0
    if case == "invalid":
        assert ranks[0][case]["metrics"][0]["n"] == BATCH - 3


def test_a_nan_on_one_rank_skips_the_step_on_both(dp_world):
    _, ranks, want = dp_world
    assert [m["skipped"] for m in want["nonfinite"]["metrics"]] == [0.0, 1.0]
    _assert_ranks_equal(ranks, "nonfinite")
    got = ranks[0]["nonfinite"]
    assert [m["skipped"] for m in got["metrics"]] == [0.0, 1.0]
    assert all(int(s["step"]) == 1 for s in got["adam"].values())   # one update taken
    # what the skip kept is the first step's state
    _assert_params_match(got, want["nonfinite"])


def test_mcb_pooling_over_two_ranks_equals_one_process(dp_world):
    cases, ranks, _ = dp_world
    spec = cases["mcb"]
    x1, x2 = (torch.from_numpy(spec[k]).requires_grad_(True) for k in ("x1", "x2"))
    out = compact_bilinear_pooling(x1, x2, torch.from_numpy(spec["s1"]),
                                   torch.from_numpy(spec["s2"]), MCB_OUT)
    (out * torch.from_numpy(spec["w"])).sum().backward()
    half = BATCH // WORLD
    for r, got in enumerate(ranks):
        rows = slice(r * half, (r + 1) * half)
        np.testing.assert_allclose(got["mcb"]["out"].numpy(), out[rows].detach().numpy(),
                                   atol=MCB_ATOL, rtol=0)
        for key, g in (("g1", x1.grad), ("g2", x2.grad)):
            err = (got["mcb"][key] - g[rows]).abs().max().item() / g.abs().max().item()
            assert err <= MCB_ATOL, (r, key, err)


def test_dryrun_two_ranks_dense_and_sparse_equal_one_process():
    summary = dryrun_multichip(2, "cpu", timeout=240)
    assert set(summary) == {"dense", "sparse"}
    for case, errors in summary.items():
        for what, (err, tol) in errors.items():
            assert err <= tol, (case, what, err, tol)
