"""The port's ring and Ulysses sequence parallelism (``ops/ring_attention.py``,
``ops/ulysses_attention.py``, the seq axis of ``parallel/mesh.py`` and the
step over it) against the JAX package's, as ``tests/test_ring_attention.py``
and ``tests/test_ulysses_attention.py`` hold the JAX package's.

One spawn serves the module: four gloo ranks on the CPU (this file run as
a script) lay their group out as (data 2, seq 2) and as (data 1, seq 4)
(``parallel/mesh.py:grid``), run every case below and save what they hold;
the tests compare. The ranks run the plain versions of K4, K5 and K6 (CPU
tensors). Checks, float32:

* ring and Ulysses at n = 2 and 4, both renorms: each rank's rows of the
  output and of dq, dk, dv (gradients of sum(out^2)) within 1e-5 of each
  output's max of JAX's ``ring_graph_attention`` /
  ``ulysses_graph_attention`` on the virtual 8-device CPU mesh
  (``tests/conftest.py``) and of the port's single-device
  ``attention_core``; every rank of a seq row bitwise the same;
* a shard of padding only (keys and queries all masked), through the ring
  at n = 4 and Ulysses at n = 2;
* the errors for an indivisible length and a head count, with JAX's
  messages, and the dispatch's warning and single-device path for a length
  the axis does not divide;
* one (data 2, seq 2) training step, ring and Ulysses, against JAX's
  single-device step on the whole batch: losses within 1e-5 relative,
  gradients within 1e-5 of their norm, the parameters after Adam within
  1e-5, all four ranks bitwise equal.
"""

import os
import sys
import tempfile
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from structured_alignment_vqa_tpu_torch.data.synthetic import batch_from_arrays, synthetic_arrays
from structured_alignment_vqa_tpu_torch.models import AttModelX3, ModelConfig
from structured_alignment_vqa_tpu_torch.ops import ulysses_attention as port_ulysses
from structured_alignment_vqa_tpu_torch.ops.attention import GraphGuidedAttention, attention_core
from structured_alignment_vqa_tpu_torch.ops.ring_attention import ring_graph_attention
from structured_alignment_vqa_tpu_torch.parallel.context import use_mesh
from structured_alignment_vqa_tpu_torch.parallel.dryrun import GRAD_FLOOR, free_ports, launch_local
from structured_alignment_vqa_tpu_torch.parallel.mesh import (
    Mesh,
    check_axes,
    grid,
    init_distributed,
    shutdown,
)
from structured_alignment_vqa_tpu_torch.parallel.sharding import seq_rotate
from structured_alignment_vqa_tpu_torch.parallel.train_step import (
    create_train_state,
    make_train_step,
    shard_state,
)

WORLD = 4
TOL = 1e-5          # of each output's max
LR = 1e-3
B1 = 0.9
LOSS_RTOL = GRAD_RTOL = PARAM_ATOL = 1e-5
IMPLS = ("ring", "ulysses")
ATTENTION_CASES = [(n, impl, renorm, "random") for n in (2, 4) for impl in IMPLS
                   for renorm in ("l1", "sum_eps")] + [(4, "ring", "l1", "masked"),
                                                       (2, "ulysses", "l1", "masked")]
HEADS = {"random": 4, "masked": 2}
TINY_KW = dict(
    num_classes=11, num_relations=7, vocab_size=50, glove_dim=12, vis_fea_dim=16,
    hidden_size=16, hidden_size_mil=8, num_blocks=3, num_heads=2, dropout_rate=0.0,
    maxlen=32, maxlen_q=8, maxlen_v=6, topn=2, stage1_blocks=1, stage2_blocks=2,
)
STEP_BATCH = 4
BUCKET = dict(lv=4, lq=4, ls=12)     # encoder lengths 8 and 16: both divide seq 2


def case_name(case) -> str:
    return "-".join(map(str, case))


def make_inputs(kind: str, seed: int = 0) -> dict:
    """numpy (q, k, v, key_mask, query_mask, graph), B 4 at L 32, C 16, as
    ``tests/test_ring_attention.py:make_inputs``; "masked" is its
    ``test_masked_shard`` (the second half of every row padding, q = k = v)
    at B 2."""
    rng = np.random.default_rng(seed)
    if kind == "masked":
        x = rng.standard_normal((2, 32, 16)).astype(np.float32)
        x[:, 16:] = 0.0
        q = (np.maximum(x, 0) + 0.1 * (np.arange(32)[None, :, None] < 16)).astype(np.float32)
        mask = np.sign(np.abs(x.sum(-1))).astype(np.float32)
        return dict(q=q, k=q, v=q, km=mask, qm=mask, graph=np.ones((2, 32, 32), np.float32))
    x = rng.standard_normal((4, 32, 16)).astype(np.float32)
    x[0, -2:] = 0.0
    mask = np.sign(np.abs(x.sum(-1))).astype(np.float32)
    graph = (rng.random((4, 32, 32)) > 0.4).astype(np.float32)
    graph[0, 3, :] = 0.0    # a dead row
    return dict(q=np.maximum(x * 0.5 + 0.1, 0), k=np.maximum(x * 0.3 - 0.05, 0),
                v=np.maximum(x, 0), km=mask, qm=mask, graph=graph)


def _rows(arrays: dict, mesh: Mesh) -> dict:
    """This rank's data row's share of the batch (rank-major)."""
    n = len(next(iter(arrays.values()))) // mesh.data
    d = mesh.data_index
    return {k: v[d * n:(d + 1) * n] for k, v in arrays.items()}


# ---- the ranks: this file run as a script --------------------------------

def _attention_rank(case, arrays, mesh):
    n, impl, renorm, kind = case
    a = {k: torch.from_numpy(v) for k, v in _rows(arrays, mesh).items()}
    q, k, v = (a[x].clone().requires_grad_(True) for x in "qkv")
    fn = ring_graph_attention if impl == "ring" else port_ulysses.ulysses_graph_attention
    sent = seq_rotate.bytes
    out = fn(q, k, v, a["km"], a["qm"], a["graph"], HEADS[kind], renorm, mesh)
    (out ** 2).sum().backward()
    return {"out": out.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad,
            "rotated": seq_rotate.bytes - sent}


def _step_rank(impl, spec, mesh):
    cfg = ModelConfig(share_glove=True, seq_axis="seq", seq_impl=impl, **TINY_KW)
    model = AttModelX3(cfg, device="cpu")
    model.load_state_dict(spec["weights"])
    state = create_train_state(model, LR)
    shard_state(state, mesh)
    step = make_train_step(model, state.optimizer, cfg, mesh=mesh)
    calls = {"to_heads": 0}
    to_heads = port_ulysses.to_heads

    def counted(*args):
        calls["to_heads"] += 1
        return to_heads(*args)

    port_ulysses.to_heads = counted
    sent = seq_rotate.bytes
    try:
        m = step(state, batch_from_arrays(_rows(spec["arrays"], mesh), "cpu"))
    finally:
        port_ulysses.to_heads = to_heads
    return {"metrics": {k: float(v) for k, v in m.items()},
            "params": {n: p.detach().clone() for n, p in model.named_parameters()},
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None},
            "rotated": seq_rotate.bytes - sent, "to_heads": calls["to_heads"]}


def _worker(rank, coordinator, tmp):
    torch.set_num_threads(1)
    base = init_distributed(coordinator, WORLD, rank, device="cpu")
    try:
        meshes = {n: grid(base, n) for n in (2, 4)}
        inputs = torch.load(f"{tmp}/inputs.pt", weights_only=False)
        out = {case_name(c): _attention_rank(c, inputs["attention"][c[3]], meshes[c[0]])
               for c in ATTENTION_CASES}
        out.update({impl: _step_rank(impl, inputs["step"], meshes[2]) for impl in IMPLS})
        out["layout"] = [(m.data_index, m.seq_index, m.data, m.seq) for m in meshes.values()]
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        shutdown(base)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
    sys.exit(0)


# ---- the tests ------------------------------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402

import structured_alignment_vqa_tpu.ops.pallas_attention as pa  # noqa: E402
from structured_alignment_vqa_tpu.ops.ring_attention import (  # noqa: E402
    ring_graph_attention as jax_ring,
)
from structured_alignment_vqa_tpu.ops.ulysses_attention import (  # noqa: E402
    ulysses_graph_attention as jax_ulysses,
)
from structured_alignment_vqa_tpu.parallel.train_step import TrainState as JaxState  # noqa: E402
from structured_alignment_vqa_tpu.parallel.train_step import adam as jax_adam  # noqa: E402
from structured_alignment_vqa_tpu.parallel.train_step import (  # noqa: E402
    make_train_step as jax_train_step,
)
from structured_alignment_vqa_tpu_torch.models.convert import state_dict_from_jax  # noqa: E402
from test_torch_port_model import JaxConfig, JaxModel, jax_batch, perturbed  # noqa: E402


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def jax_seq_mesh(n):
    return JaxMesh(np.asarray(jax.devices()[:n]).reshape(1, n), ("data", "seq"))


def jax_attention(case, a):
    """JAX's out and (dq, dk, dv) of sum(out^2) on the whole batch."""
    n, impl, renorm, kind = case
    fn = jax_ring if impl == "ring" else jax_ulysses
    km, qm, g = (jnp.asarray(a[x]) for x in ("km", "qm", "graph"))

    def loss(q, k, v):
        out = fn(q, k, v, km, qm, g, HEADS[kind], renorm, mesh=jax_seq_mesh(n), q_tile=8,
                 k_tile=8, interpret=True)
        return jnp.sum(out ** 2), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(a[x]) for x in "qkv"))
    return {"out": np.asarray(out), **{f"d{x}": np.asarray(d) for x, d in zip("qkv", grads)}}


def port_single(case, a):
    """The port's single-device attention_core on the whole batch."""
    _, _, renorm, kind = case
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    q, k, v = (t[x].clone().requires_grad_(True) for x in "qkv")
    out, _ = attention_core(q, k, v, t["km"], t["qm"], HEADS[kind], graph=t["graph"],
                            renorm=renorm)
    (out ** 2).sum().backward()
    return {"out": out.detach().numpy(), "dq": q.grad.numpy(), "dk": k.grad.numpy(),
            "dv": v.grad.numpy()}


def jax_step(spec):
    """JAX's single-device step on the whole batch: its metrics, the params
    after it and the gradients (Adam's first moment over 1 - b1), by the
    port's names."""
    model = JaxModel(JaxConfig(share_glove=True, **TINY_KW))
    params = jax.tree.map(jnp.asarray, spec["jparams"])
    tx = jax_adam(LR)
    state = JaxState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params))
    state, m = jax_train_step(model, tx, model.cfg)(state, jax_batch(spec["arrays"]),
                                                     jax.random.key(1))
    nb = TINY_KW["num_blocks"]
    grads = jax.tree.map(lambda mu: mu / (1 - B1), jax.device_get(state.opt_state[0].mu))
    return {"metrics": {k: float(v) for k, v in m.items()},
            "params": state_dict_from_jax(jax.device_get(state.params), nb),
            "grads": state_dict_from_jax(grads, nb)}


@pytest.fixture(scope="module")
def seq_world():
    """The inputs, what each rank holds after every case, and the
    references (computed while the ranks run)."""
    torch.set_num_threads(1)
    attention = {kind: make_inputs(kind) for kind in ("random", "masked")}
    cfg = ModelConfig(share_glove=True, **TINY_KW)
    arrays = synthetic_arrays(cfg, STEP_BATCH, seed=7, **BUCKET)
    jmodel = JaxModel(JaxConfig(share_glove=True, **TINY_KW))
    params, jparams = perturbed(jax.jit(jmodel.init)(jax.random.key(0),
                                                     jax_batch(arrays))["params"], seed=7)
    step = {"arrays": arrays, "weights": state_dict_from_jax(params, TINY_KW["num_blocks"])}
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(1) as pool:
        torch.save({"attention": attention, "step": step}, f"{tmp}/inputs.pt")
        coordinator = f"127.0.0.1:{free_ports()[0]}"
        here = os.path.abspath(__file__)
        done = pool.submit(launch_local, [[sys.executable, here, str(r), coordinator, tmp]
                                          for r in range(WORLD)], 240)
        pa.INTERPRET_MODE = True
        try:
            want = {case_name(c): jax_attention(c, attention[c[3]]) for c in ATTENTION_CASES}
            want["step"] = jax_step(dict(step, jparams=jparams))
        finally:
            pa.INTERPRET_MODE = False
        single = {case_name(c): port_single(c, attention[c[3]]) for c in ATTENTION_CASES}
        done.result()
        ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=True) for r in range(WORLD)]
    return attention, ranks, want, single


def test_ranks_form_the_data_seq_grid(seq_world):
    _, ranks, _, _ = seq_world
    for r, out in enumerate(ranks):
        assert out["layout"] == [(r // 2, r % 2, 2, 2), (0, r, 1, 4)]


def _assert_rows_close(got: dict, want: dict, rows: slice, what):
    for key in ("out", "dq", "dk", "dv"):
        w = want[key][rows]
        err = float(np.abs(got[key].numpy() - w).max())
        assert err <= TOL * float(np.abs(w).max()), (what, key, err)


@pytest.mark.parametrize("case", ATTENTION_CASES, ids=case_name)
def test_seq_attention_equals_jax_and_single_device(seq_world, case):
    _, ranks, want, single = seq_world
    name = case_name(case)
    n, impl = case[0], case[1]
    per_row = len(want[name]["out"]) // (WORLD // n)
    for r, out in enumerate(ranks):
        d = r // n
        rows = slice(d * per_row, (d + 1) * per_row)
        _assert_rows_close(out[name], want[name], rows, (name, r, "jax"))
        _assert_rows_close(out[name], single[name], rows, (name, r, "attention_core"))
        first = ranks[d * n][name]
        assert all(torch.equal(out[name][k], first[k]) for k in ("out", "dq", "dk", "dv"))
        # the ring rotates K, V and the key mask n - 1 times forward and
        # K, V, the key mask and the f32 dk, dv back; Ulysses rotates nothing
        assert (out[name]["rotated"] > 0) == (impl == "ring"), (name, r)


@pytest.mark.parametrize("impl", IMPLS)
def test_data2_seq2_step_equals_jax_single_device_step(seq_world, impl):
    _, ranks, want, _ = seq_world
    ref = want["step"]
    got = ranks[0][impl]
    for key in ("loss", "ce", "mil_nce_loss"):
        a, b = got["metrics"][key], ref["metrics"][key]
        assert abs(a - b) <= LOSS_RTOL * abs(b), (key, a, b)
    for key in ("n", "n_correct", "skipped"):
        assert got["metrics"][key] == ref["metrics"][key], key
    joint = sum(w.norm().item() ** 2 for w in ref["grads"].values()) ** 0.5
    for name, g in got["grads"].items():
        w = ref["grads"][name]
        err = (g - w).norm().item() / (w.norm().item() or joint)
        assert err <= GRAD_RTOL, (name, err)
    for name, p in got["params"].items():
        g = ref["grads"][name]
        above = g.abs() > GRAD_FLOOR * g.abs().max()
        diff = (p - ref["params"][name]).abs()[above]
        assert diff.numel() == 0 or diff.max() <= PARAM_ATOL, (name, diff.max())
    for out in ranks[1:]:
        for part in ("params", "grads"):
            assert all(torch.equal(out[impl][part][k], v) for k, v in got[part].items())
    # both encoders went through the seq path in all 3 blocks of each: the
    # ring rotates, Ulysses calls to_heads on q, k, v and, backward, on dy
    if impl == "ring":
        assert got["rotated"] > 0 and got["to_heads"] == 0
    else:
        assert got["rotated"] == 0 and got["to_heads"] == 2 * 3 * 4


def _fake_mesh(n):
    """A seq row of n ranks with no group: enough for what raises, or falls
    back, before any collective."""
    return Mesh(data=1, rank=0, local_rank=0, local_world=1, device=torch.device("cpu"), seq=n)


def _jax_error(fn, *args):
    with pytest.raises(ValueError) as err:
        fn(*args)
    return str(err.value)


@pytest.mark.parametrize("impl,length,heads", [("ring", 30, 2), ("ulysses", 30, 4),
                                               ("ulysses", 32, 2)])
def test_errors_carry_jax_messages(impl, length, heads):
    a = make_inputs("random")
    a = {k: v[:1, :length, :length] if k == "graph" else v[:1, :length] for k, v in a.items()}
    jfn, pfn = ((jax_ring, ring_graph_attention) if impl == "ring"
                else (jax_ulysses, port_ulysses.ulysses_graph_attention))
    jargs = [jnp.asarray(a[x]) for x in ("q", "k", "v", "km", "qm", "graph")]
    want = _jax_error(lambda: jfn(*jargs, heads, "l1", mesh=jax_seq_mesh(4)))
    targs = [torch.from_numpy(a[x]) for x in ("q", "k", "v", "km", "qm", "graph")]
    got = _jax_error(lambda: pfn(*targs, heads, "l1", _fake_mesh(4)))
    assert got == want
    assert ("heads" if length == 32 else "divisible") in got


def test_indivisible_length_warns_and_takes_the_single_device_path():
    torch.manual_seed(0)
    plain = GraphGuidedAttention(16, 2, device="cpu")
    seq = GraphGuidedAttention(16, 2, device="cpu", seq_axis="seq")
    seq.load_state_dict(plain.state_dict())
    x = torch.randn(2, 30, 16)
    graph = (torch.rand(2, 30, 30) > 0.4).float()
    with use_mesh(_fake_mesh(4)), pytest.warns(UserWarning, match="ring attention skipped"):
        got = seq(x, x, x, graph)
    assert torch.equal(got, plain(x, x, x, graph))
    with use_mesh(_fake_mesh(1)), warnings.catch_warnings():
        warnings.simplefilter("error")
        assert torch.equal(seq(x, x, x, graph), plain(x, x, x, graph))


def test_seq_axis_is_supported_and_the_model_axis_still_raises():
    check_axes(seq_parallel=2)
    model = AttModelX3(ModelConfig(seq_axis="seq", seq_impl="ulysses", **TINY_KW),
                       device="cpu")
    assert model.att_syb.enc_self_attention_0.seq_impl == "ulysses"
    # the model axis is ported, a head split between ranks too (item 15d:
    # 3 heads over model 2); a hidden width the heads do not divide raises
    check_axes(model_parallel=2, seq_parallel=2, hidden_size=16, num_heads=2)
    check_axes(model_parallel=2, seq_parallel=2, hidden_size=24, num_heads=3)
    with pytest.raises(ValueError, match="not divisible by num_heads"):
        check_axes(model_parallel=2, seq_parallel=2, hidden_size=16, num_heads=3)
