"""The yardstick of ``chip_smoke.py``'s f32 pair checks on the CPU.

A check that pairs two f32 paths (ranks against one process, kernels
against their plain versions, a packed slot against its sample alone)
records the decisions the path under test takes outside the kernels (each
ReLU module's input > 0, an FFN's hidden ReLU where it runs outside K3,
each ``ops/attention.py:content_mask`` row's sum != 0), joins them into
one process's layout and makes the reference take them
(``chip_smoke.py:recorded_decisions``, ``join_*``, ``Pins``,
``pinned_decisions``). Checks, float32, at ``tiny_test_config`` widths:

* (a) the decisions of a run taken by a second whose inputs differ by
  rounding: the gate passes and the second run's ReLUs take the recorded
  decisions; a ReLU input planted at +-1e-9 is one pinned knife edge;
* (b) one weight moved by 1e-3 of itself: the gate refuses, the flips'
  inputs lying beyond ``KNIFE_EDGE`` of their calls' largest;
* (c) a content_mask row summing to exactly 0.0 on one side is pinned, and
  a row with a clearly nonzero sum is refused;
* (d) two gloo ranks as (data 2), (data 1, seq 2) and (data 1, model 2)
  (one spawn, this file run as a script) record a training step's
  decisions; the joins of rows, of a seq row and of a model row rebuild
  one process's decisions on the whole batch, bit for bit;
* (e) a packed run's decisions joined into its samples' runs alone give
  each of those runs' own decisions wherever the sample has tokens.
"""

import os
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from structured_alignment_vqa_tpu_torch.data import dataset as port_ds  # noqa: E402
from structured_alignment_vqa_tpu_torch.data.packing import collate_packed  # noqa: E402
from structured_alignment_vqa_tpu_torch.data.synthetic import (  # noqa: E402
    batch_from_arrays,
    synthetic_arrays,
)
from structured_alignment_vqa_tpu_torch.data.transfer import host_tensors  # noqa: E402
from structured_alignment_vqa_tpu_torch.models import (  # noqa: E402
    AttModelX3,
    init_random_,
    tiny_test_config,
)
from structured_alignment_vqa_tpu_torch.ops import attention  # noqa: E402
from structured_alignment_vqa_tpu_torch.parallel.dryrun import free_ports, launch_local  # noqa: E402
from structured_alignment_vqa_tpu_torch.parallel.mesh import (  # noqa: E402
    grid,
    init_distributed,
    shutdown,
)
from structured_alignment_vqa_tpu_torch.parallel.train_step import (  # noqa: E402
    create_train_state,
    make_train_step,
    shard_state,
)

WORLD = 2
LR = 1e-3
BATCH = 4
BUCKET = dict(lv=4, lq=4, ls=12)   # encoder lengths 8 and 16: both divide seq 2
LAYOUTS = ("dp", "seq", "model")


def config(**kw):
    return tiny_test_config(share_glove=True, **kw)


def tiny_model(seed=0, **kw):
    model = AttModelX3(config(**kw), device="cpu")
    init_random_(model, torch.Generator().manual_seed(seed))
    return model


def recorded(model, run):
    """``run()``'s result and the decisions ``model`` took in it."""
    with cs.recorded_decisions(model) as decisions:
        out = run()
    return out, decisions


# ---- the ranks: this file run as a script --------------------------------

def _worker(rank, coordinator, tmp):
    torch.set_num_threads(1)
    base = init_distributed(coordinator, WORLD, rank, device="cpu")
    try:
        inputs = torch.load(f"{tmp}/inputs.pt", weights_only=False)
        meshes = {"dp": grid(base, 1, 1), "seq": grid(base, 2, 1), "model": grid(base, 1, 2)}
        out = {}
        for layout, mesh in meshes.items():
            cfg = config(seq_axis="seq" if layout == "seq" else None)
            model = AttModelX3(cfg, device="cpu")
            model.load_state_dict(inputs["weights"])
            state = shard_state(create_train_state(model, LR), mesh)
            step = make_train_step(model, state.optimizer, cfg, mesh=mesh)
            n = BATCH // mesh.data
            rows = {k: v[mesh.data_index * n:(mesh.data_index + 1) * n]
                    for k, v in inputs["arrays"].items()}
            _, out[layout] = recorded(model, lambda: step(state, batch_from_arrays(rows, "cpu")))
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        shutdown(base)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
    sys.exit(0)


# ---- the tests ------------------------------------------------------------

@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def layouts():
    """Each rank's decisions in each layout, and one process's on the whole
    batch (computed while the ranks run)."""
    torch.set_num_threads(1)
    weights = tiny_model(seed=3).state_dict()
    arrays = synthetic_arrays(config(), BATCH, seed=5, **BUCKET)
    with tempfile.TemporaryDirectory() as tmp:
        torch.save({"weights": weights, "arrays": arrays}, f"{tmp}/inputs.pt")
        coordinator = f"127.0.0.1:{free_ports()[0]}"
        here = os.path.abspath(__file__)
        with ThreadPoolExecutor(1) as pool:
            done = pool.submit(launch_local, [[sys.executable, here, str(r), coordinator, tmp]
                                              for r in range(WORLD)], 300)
            cfg = config()
            model = AttModelX3(cfg, device="cpu")
            model.load_state_dict(weights)
            state = create_train_state(model, LR)
            step = make_train_step(model, state.optimizer, cfg)
            _, single = recorded(model, lambda: step(state, batch_from_arrays(arrays, "cpu")))
            done.result()
        ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=True) for r in range(WORLD)]
    return ranks, single


def assert_same_decisions(got, want, what):
    assert got.keys() == want.keys(), what
    # the FFNs' ReLUs run inside K3's plain version: sites of no call
    assert sum(len(calls) for calls in want.values()) > 50, what
    for site, calls in want.items():
        assert len(got[site]) == len(calls), (what, site)
        for i, (g, w) in enumerate(zip(got[site], calls)):
            assert g.shape == w.shape, (what, site, i)
            if site == cs.CONTENT_MASK:
                assert torch.equal(g != 0, w != 0), (what, site, i)
                torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
            else:
                assert torch.equal(g, w), (what, site, i)


def test_rounding_takes_the_recorded_decisions_and_passes():
    """(a) on the model: every ReLU and content_mask call recorded on one
    run is taken by a second whose region features differ by one ulp,
    none against its own."""
    model = tiny_model().eval()
    arrays = synthetic_arrays(config(), BATCH, seed=1, **BUCKET)
    nudged = dict(arrays, vis_fea=arrays["vis_fea"] * np.float32(1 + 2 ** -23))
    agree = []
    with torch.no_grad():
        _, decisions = recorded(model, lambda: model(batch_from_arrays(arrays, "cpu")))
        pins = cs.Pins(decisions)
        with cs.pinned_decisions(model, pins):
            # registered after the pins' hooks, which replace the ReLUs' outputs
            hooks = [relu.register_forward_hook(
                lambda _m, inputs, out, name=name: agree.append(torch.equal(
                    out != 0, pins.calls[name][pins.taken[name] - 1] & (inputs[0] != 0))))
                for name, (_, relu) in cs.relu_sites(model).items()]
            model(batch_from_arrays(nudged, "cpu"))
            for h in hooks:
                h.remove()
    pins.finish()
    assert pins.knife_edges_only() and not pins.mismatches and pins.pinned == 0
    assert pins.decisions[cs.RELU] > 0 and pins.decisions[cs.CONTENT_MASK] > 0
    # the FFNs' hidden ReLUs, outside K3 in its plain version on the CPU
    ffn = {s for s in decisions["calls"] if ".conv1." in s}
    assert ffn and all(decisions["calls"][s] for s in ffn)
    assert len(agree) == sum(len(c) for s, c in decisions["calls"].items()
                             if s != cs.CONTENT_MASK and s not in ffn) and all(agree)
    # the sites: the attention projections, the heads, MIL-NCE's MLPs
    sites = set(decisions["calls"])
    assert {"cls.1", "MIL_NCE.vis_mlp.1", "att_syb.enc_self_attention_0.K_proj.1",
            cs.CONTENT_MASK} <= sites


def planted(x0: float):
    """A ReLU of 131,072 inputs on a Linear whose column 7 is input column
    0, that column's row 0 set to ``x0``: (module, input)."""
    gen = torch.Generator().manual_seed(2)
    layer = nn.Sequential(nn.Linear(64, 512), nn.ReLU())
    with torch.no_grad():
        layer[0].weight.copy_(torch.randn(512, 64, generator=gen) / 8)
        layer[0].bias.copy_(0.05 * torch.randn(512, generator=gen))
        layer[0].weight[7] = 0.0
        layer[0].weight[7, 0] = 1.0
        layer[0].bias[7] = 0.0
    x = torch.randn(256, 64, generator=gen)
    x[0, 0] = x0
    return layer, x


def test_a_knife_edge_within_rounding_is_pinned():
    """(a) with one knife edge: a ReLU input at +1e-9 on the recorded run
    and -1e-9 on the pinned one (an O(1) input moved by 2e-9) is taken as
    recorded, one decision of 131,072, its share of the call's max ~1e-9."""
    layer, x = planted(1e-9)
    _, decisions = recorded(layer, lambda: layer(x))
    layer, x = planted(-1e-9)
    pins = cs.Pins(decisions)
    with cs.pinned_decisions(layer, pins):
        out = layer(x)
    pins.finish()
    assert pins.knife_edges_only() and pins.pinned == 1 and pins.worst < 1e-8
    assert out[0, 7].item() == x[0, 0].item() != 0.0   # taken: the input passes
    assert pins.decisions[cs.RELU] == 256 * 512


def test_a_weight_moved_by_1e_3_is_refused():
    """(b) one projection's weight moved by 1e-3 of itself: the decisions
    that then differ lie beyond KNIFE_EDGE of their calls' largest."""
    model = tiny_model().eval()
    batch = batch_from_arrays(synthetic_arrays(config(), BATCH, seed=1, **BUCKET), "cpu")
    with torch.no_grad():
        _, decisions = recorded(model, lambda: model(batch))
        w = model.att_vis_grid.enc_self_attention_0.Q_proj[0].weight
        w.mul_(1 + 1e-3 * torch.randn(w.shape, generator=torch.Generator().manual_seed(4)))
        pins = cs.Pins(decisions)
        with cs.pinned_decisions(model, pins):
            model(batch)
    pins.finish()
    assert not pins.mismatches and pins.pinned > 0
    assert pins.worst > cs.KNIFE_EDGE and not pins.knife_edges_only()


@pytest.mark.parametrize("pinned_row, knife_edge", [
    # [1, -1, 2, -2 + 1 ulp] sums to 2.4e-7: within rounding of 0.0
    ([1.0, -1.0, 2.0, float(np.nextafter(np.float32(-2.0), np.float32(0.0)))], True),
    ([1.0, -1.0, 0.25, 0.25], False),    # sums to 0.5
])
def test_content_mask_rows_on_the_knife_edge_are_pinned_others_refused(pinned_row, knife_edge):
    """(c) 100,000 rows of 4 (sums 2-6), one of which sums to exactly 0.0
    on the recorded side: where that row sums to 2.4e-7 on the pinned side
    it is taken masked and the gate passes; where it sums to 0.5 the gate
    refuses."""
    x = torch.rand(100, 1000, 4, generator=torch.Generator().manual_seed(6)) + 0.5
    tested, pinned_side = x.clone(), x.clone()
    tested[3, 7] = torch.tensor([1.0, -1.0, 2.0, -2.0])
    pinned_side[3, 7] = torch.tensor(pinned_row)
    holder = nn.Module()
    with cs.recorded_decisions(holder) as decisions:
        attention.content_mask(tested)
    pins = cs.Pins(decisions)
    with cs.pinned_decisions(holder, pins):
        keep = attention.content_mask(pinned_side)
    pins.finish()
    assert keep[3, 7].item() == 0.0 and int(keep.sum()) == 100_000 - 1
    assert pins.pinned == 1 and pins.decisions[cs.CONTENT_MASK] == 100_000
    assert pins.knife_edges_only() is knife_edge, pins.flips
    assert (pins.worst < 1e-7) is knife_edge


@pytest.mark.parametrize("layout", LAYOUTS)
def test_joins_rebuild_one_process_decisions(layouts, layout):
    """(d) the ranks' decisions of one training step, joined, equal one
    process's on the whole batch: rows (dp), a seq row (every rank's the
    same), a model row (column shards concatenated)."""
    ranks, single = layouts
    parts = [r[layout] for r in ranks]
    if layout == "dp":
        joined = cs.join_rows(parts)
        assert parts[0]["calls"][cs.CONTENT_MASK][0].shape[0] == BATCH // WORLD
    elif layout == "seq":
        joined, same = cs.join_replicated(parts)
        assert same
    else:
        joined = cs.join_model(parts)
        # the split attention projections saw half their columns a rank
        proj = "att_syb.enc_self_attention_0.V_proj.1"
        assert parts[0]["calls"][proj][0].shape[-1] * 2 == single["calls"][proj][0].shape[-1]
    assert_same_decisions(joined["calls"], single["calls"], layout)


def sample(rng, no, nm, nq):
    ids = lambda n: rng.integers(1, 40, size=n).astype(np.int64)  # noqa: E731
    edges = lambda n, k: [tuple(map(int, rng.integers(0, n, 2))) for _ in range(k)]  # noqa: E731
    return port_ds.Sample(
        vis_fea=rng.standard_normal((no, 16)).astype(np.float32), macro_ids=ids(nm),
        macro_edges=edges(nm, 2 * nm),
        obj_locs=np.sort(rng.choice(nm, size=min(no, nm), replace=False)).astype(np.int64),
        micro_pos_obj=rng.integers(1, 40, size=(no, 2)).astype(np.int64),
        micro_neg_obj=rng.integers(1, 40, size=(no, 2)).astype(np.int64),
        q_ids=ids(nq), q_edges=edges(nq, nq), answer=1)


def test_packed_join_gives_each_sample_its_own_decisions(monkeypatch):
    """(e) a packed run (rows of up to 3 samples) and its samples' runs
    alone through the tight collate (2 a run): the packed decisions joined
    (``join_packed``) equal each run's own wherever its sample has tokens,
    its decoder token and its heads' rows; every call's axis is found."""
    shape = (8, 20, 10)
    monkeypatch.setattr(cs, "PACK_SHAPE", shape)
    monkeypatch.setattr(cs, "N_PACK", 3)
    monkeypatch.setattr(cs, "B", 2)
    rng = np.random.default_rng(0)
    groups = [[sample(rng, 3, 8, 4), sample(rng, 4, 9, 5)], [sample(rng, 2, 6, 3)], None,
              [sample(rng, 1, 4, 3), sample(rng, 2, 5, 4), sample(rng, 2, 6, 3)]]
    kw = dict(vocab_size=401000, glove_dim=8, maxlen=64, maxlen_q=12, maxlen_v=8)
    model = tiny_model(**kw).eval()
    bshape = port_ds.BatchShape(*shape)

    def run(gs, n_pack):
        batch = host_tensors(collate_packed(gs, bshape, 2, n_pack, 16))
        return recorded(model, lambda: model(batch))[1]

    with torch.no_grad():
        packed = run(groups, 3)
        joined, unmapped = cs.join_packed(packed, groups)
        alone = [s for g in groups for s in (g or [])]
        runs = [run([[s] for s in alone[i:i + 2]], 1) for i in range(0, len(alone), 2)]
    assert not unmapped and len(joined) == len(runs) == 3
    for j, own in zip(joined, runs):
        for site, calls in own["calls"].items():
            assert len(j["calls"][site]) == len(calls), site
            for i, (mine, (keep, defined)) in enumerate(zip(calls, j["calls"][site])):
                assert keep.shape == mine.shape and bool(defined.any()), (site, i)
                d = defined.expand_as(mine)
                if site == cs.CONTENT_MASK:
                    assert torch.equal(keep[d] != 0, mine[d] != 0), (site, i)
                    torch.testing.assert_close(keep[d], mine[d], rtol=1e-5, atol=1e-6)
                else:
                    assert torch.equal(keep[d], mine[d]), (site, i)
