"""Reference ``.pth`` checkpoints in and out of the port
(``models/torch_import.py``, ``models/torch_export.py``) against the JAX
package's ``models/torch_import.py`` and ``models/torch_export.py``, float32
on the CPU, no dropout, for each of (only_obj, share_glove, use_mcb).

For the same weights:
* the port's ``export_state_dict`` equals JAX's key for key, in order and
  bitwise, with and without a template, with and without ``module.``;
* a ``.pth`` that JAX's ``save_pth`` writes, imported into a fresh port
  model, gives logits within 1e-5 of JAX's, and parameters bitwise those of
  JAX's import carried over by ``convert.state_dict_from_jax``;
* the port's export, imported by JAX, gives JAX logits within 1e-5 of the
  port's;
* the unmatched keys of a dict with dead keys and an unknown key equal
  JAX's; a shape mismatch raises; export then import is exact.

JAX's import has no ``share_glove`` branch (its name map reaches the
per-branch tables only), so where the port shares one table the JAX side
imports into the same model with three tables, which the export fills
alike. One case carries weights only as a ``.pth`` that JAX's ``save_pth``
writes, through the port's import and ``save_checkpoint``, into the port's
predict CLI, whose answers must equal the JAX predict CLI's.
"""

import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_alignment_vqa_tpu.models import AttModelX3 as JaxModel
from structured_alignment_vqa_tpu.models.config import ModelConfig as JaxConfig
from structured_alignment_vqa_tpu.models.torch_export import export_state_dict as jax_export
from structured_alignment_vqa_tpu.models.torch_export import save_pth as jax_save_pth
from structured_alignment_vqa_tpu.models.torch_import import (
    import_torch_state_dict as jax_import,
)
from structured_alignment_vqa_tpu.ops.mcb import count_sketch_matrix
from structured_alignment_vqa_tpu.train import predict as jax_predict
from structured_alignment_vqa_tpu_torch.data.synthetic import batch_from_arrays, synthetic_arrays
from structured_alignment_vqa_tpu_torch.models import AttModelX3, ModelConfig, init_random_
from structured_alignment_vqa_tpu_torch.models.convert import GLOVE_SLOTS, state_dict_from_jax
from structured_alignment_vqa_tpu_torch.models.torch_export import export_state_dict, save_pth
from structured_alignment_vqa_tpu_torch.models.torch_import import import_torch_state_dict
from structured_alignment_vqa_tpu_torch.parallel.train_step import TrainState, adam
from structured_alignment_vqa_tpu_torch.train import main as port_main
from structured_alignment_vqa_tpu_torch.train import predict
from structured_alignment_vqa_tpu_torch.utils.checkpoint import save_checkpoint
from test_torch_port_cli import build_world, read_jsonl
from test_torch_port_model import TINY, jax_batch

LOGIT_ATOL = 1e-5
CASES = list(itertools.product([True, False], repeat=3))
IDS = [f"{'obj' if o else 'objrel'}-{'shared' if s else 'tables'}-{'mcb' if m else 'concat'}"
       for o, s, m in CASES]
DEAD = {"att_vis_grid.v_mlp.0.weight": (4, 4), "MIL_NCE.bilinear.weight": (3, 2, 2),
        "att_syb.q_positional_encoding.lookup_table": (5, 4)}
UNKNOWN = "att_vis_grid.no_such_module.weight"


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def _kw(only_obj, share_glove, use_mcb, **extra):
    return dict(TINY, only_obj=only_obj, share_glove=share_glove, use_mcb=use_mcb, mcb_out=24,
                dropout_rate_mcb=0.0, **extra)


def _random_variables(jmodel, jb, seed):
    """Variables of ``jmodel`` drawn with numpy from the shapes of its init
    (no compile): matrices and tables at xavier scale, LayerNorm gammas 1
    plus noise, other vectors noise; the MCB sketches as its init draws
    them."""
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jb)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        shape = leaf.shape
        if len(shape) >= 2:
            return (rng.standard_normal(shape) * np.sqrt(2.0 / (shape[-2] + shape[-1]))
                    ).astype(np.float32)
        base = 1.0 if jax.tree_util.keystr(path).endswith("['gamma']") else 0.0
        return (base + 0.05 * rng.standard_normal(shape)).astype(np.float32)

    out = {"params": jax.tree_util.tree_map_with_path(draw, shapes["params"])}
    if "constants" in shapes:
        sketch_rng = np.random.default_rng(jmodel.mcb_sketch_seed)
        dims = (jmodel.cfg.hidden_size, jmodel.cfg.mcb_out)
        out["constants"] = {n: count_sketch_matrix(sketch_rng, *dims)
                            for n in ("sketch1", "sketch2")}
    return out


def _apply(jmodel, variables, jb):
    return jmodel.apply(jax.tree.map(jnp.asarray, variables), jb, deterministic=True)


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request):
    """JAX variables drawn from a seed on a synthetic batch and the JAX
    logits; a port model holding the same weights; the JAX model with three
    tables (``share_glove`` off) that JAX's import fills, and variables of
    it from another seed."""
    only_obj, share_glove, use_mcb = request.param
    kw = _kw(only_obj, share_glove, use_mcb)
    cfg = ModelConfig(**kw)
    arrays = synthetic_arrays(cfg, 3, lv=4, lq=5, ls=10, seed=7)
    jb = jax_batch(arrays)
    jmodel = JaxModel(JaxConfig(**kw))
    jvars = _random_variables(jmodel, jb, seed=5)
    model = AttModelX3(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(jvars["params"], cfg.num_blocks,
                                              jvars.get("constants")), strict=True)
    target = JaxModel(JaxConfig(**dict(kw, share_glove=False)))
    return dict(kw=kw, cfg=cfg, jvars=jvars, jb=jb, want=_apply(jmodel, jvars, jb),
                model=model.eval(), batch=batch_from_arrays(arrays, "cpu"), target=target,
                target_vars=_random_variables(target, jb, seed=6), only_obj=only_obj,
                use_mcb=use_mcb)


def _fresh(case, seed=9):
    model = AttModelX3(case["cfg"], device="cpu")
    init_random_(model, torch.Generator().manual_seed(seed))
    return model.eval()


def _logits(model, batch):
    with torch.no_grad():
        return model(batch)


def _assert_close(got, want, what):
    names = ("concat", "vis", "syb", "mil_obj", "mil_rel")
    for name, g, w in zip(names, got, want):
        if w is None:
            continue
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_allclose(g, np.asarray(w), atol=LOGIT_ATOL, rtol=0,
                                   err_msg=f"{what}: {name}")


def _jax_kw(case):
    return dict(only_obj=case["only_obj"], use_mcb=case["use_mcb"])


def _template(case):
    """A reference-like template: JAX's export of other weights, with dead
    keys, under ``module.``."""
    rng = np.random.default_rng(3)
    tmpl = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(np.float32))
            for k, v in jax_export(case["jvars"], TINY["num_blocks"], ddp_prefix=True,
                                   **_jax_kw(case)).items()}
    for name, shape in DEAD.items():
        tmpl["module." + name] = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return tmpl


@pytest.mark.parametrize("with_template,ddp_prefix", [(False, True), (False, False),
                                                      (True, True), (True, False)])
def test_export_equals_jax_export_key_for_key(case, with_template, ddp_prefix):
    template = _template(case) if with_template else None
    want = jax_export(case["jvars"], TINY["num_blocks"], template=template,
                      ddp_prefix=ddp_prefix, **_jax_kw(case))
    got = export_state_dict(case["model"], template=template, ddp_prefix=ddp_prefix)
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].dtype == torch.float32 and got[k].device.type == "cpu", k
        assert torch.equal(got[k], w), k
    if case["cfg"].share_glove:
        prefix = "module." if ddp_prefix else ""
        ptrs = {got[prefix + slot].untyped_storage().data_ptr() for slot in GLOVE_SLOTS}
        assert len(ptrs) == 1


def test_a_jax_pth_imported_gives_jax_logits_and_jax_import_params(case, tmp_path):
    fn = str(tmp_path / "model_0.pth")
    jax_save_pth(fn, case["jvars"], TINY["num_blocks"], **_jax_kw(case))
    sd = torch.load(fn, weights_only=True)
    model = _fresh(case)
    assert import_torch_state_dict(sd, model) == []
    _assert_close(_logits(model, case["batch"]), case["want"], "JAX save_pth -> port")

    imported, unmatched = jax_import(sd, case["target_vars"], TINY["num_blocks"],
                                     **_jax_kw(case))
    assert unmatched == []
    want = state_dict_from_jax(jax.device_get(imported["params"]), TINY["num_blocks"],
                               jax.device_get(imported.get("constants")))
    got = model.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        assert torch.equal(got[k], w), k


def test_the_port_export_imported_by_jax_gives_the_port_logits(case):
    exported = export_state_dict(case["model"])
    imported, unmatched = jax_import(exported, case["target_vars"], TINY["num_blocks"],
                                     **_jax_kw(case))
    assert unmatched == []
    got = _apply(case["target"], imported, case["jb"])
    _assert_close(got, _logits(case["model"], case["batch"]), "port export -> JAX")


def test_unmatched_keys_equal_jax(case):
    sd = export_state_dict(case["model"])
    rng = np.random.default_rng(4)
    for name, shape in DEAD.items():
        sd["module." + name] = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    sd["module." + UNKNOWN] = torch.zeros(3)
    if case["use_mcb"]:   # the concat head's keys mean nothing to an MCB model
        sd["module.cls.0.weight"] = torch.zeros(2, 2)
    else:                 # the MCB head's are dead without it
        sd["module.cls_mcb.0.weight"] = torch.zeros(2, 2)
    if case["only_obj"]:  # as is the relation matrix of obj-only
        sd["module.MIL_NCE.R"] = torch.zeros(2, 2, 2)
    _, want = jax_import(sd, case["target_vars"], TINY["num_blocks"], **_jax_kw(case))
    got = import_torch_state_dict(sd, _fresh(case))
    assert got == want and UNKNOWN in got


def test_a_shape_mismatch_raises_naming_the_key(case):
    sd = {"att_vis_grid.syb_mlp2.weight": np.zeros((7, 9), np.float32)}
    with pytest.raises(ValueError, match="shape mismatch at att_vis_grid.syb_mlp2.weight"):
        import_torch_state_dict(sd, _fresh(case))


def test_export_then_import_is_exact(case, tmp_path):
    fn = str(tmp_path / "model_1.pth")
    save_pth(fn, case["model"])
    model = _fresh(case)
    assert import_torch_state_dict(torch.load(fn, weights_only=True), model) == []
    want = case["model"].state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_either_positional_encoding_spelling_loads():
    """The reference's visual branch holds its positional table in a
    Sequential (``.0.``), the symbolic branch's bare; either spelling loads
    into either branch, as in JAX's name map."""
    cfg = ModelConfig(**_kw(True, True, False))
    source = AttModelX3(cfg, device="cpu")
    init_random_(source, torch.Generator().manual_seed(1))
    sd = export_state_dict(source, ddp_prefix=False)
    swapped = {}
    for k, v in sd.items():
        k = (k.replace("att_vis_grid.syb_positional_encoding.0.",
                       "att_vis_grid.syb_positional_encoding.")
             .replace("att_syb.syb_positional_encoding.", "att_syb.syb_positional_encoding.0."))
        swapped[k] = v
    model = AttModelX3(cfg, device="cpu")
    assert import_torch_state_dict(swapped, model) == []
    for k, v in source.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


def test_shared_table_from_the_first_slot_and_another_table_left_unmatched():
    cfg = ModelConfig(**_kw(True, True, False))
    source = AttModelX3(cfg, device="cpu")
    init_random_(source, torch.Generator().manual_seed(1))
    sd = {k: v.clone() for k, v in export_state_dict(source).items()}
    sd["module." + GLOVE_SLOTS[2]] += 1.0
    model = AttModelX3(cfg, device="cpu")
    assert import_torch_state_dict(sd, model) == [GLOVE_SLOTS[2]]
    assert torch.equal(model.state_dict()[GLOVE_SLOTS[1]], sd["module." + GLOVE_SLOTS[0]])


def test_an_int8_model_neither_exports_nor_imports():
    model = AttModelX3(ModelConfig(**_kw(True, True, False, int8_serving=True)), device="cpu")
    with pytest.raises(ValueError, match="int8_serving"):
        export_state_dict(model)
    with pytest.raises(ValueError, match="quantize"):
        import_torch_state_dict({}, model)


def test_a_jax_pth_served_by_the_port_cli_gives_the_jax_cli_answers(tmp_path):
    """Weights travel only as the ``.pth`` JAX's ``save_pth`` writes: into a
    fresh port model, the port's checkpoint, the port's predict CLI."""
    world = build_world(tmp_path)
    fn = str(tmp_path / "model_0.pth")
    args = world["args"]
    jax_save_pth(fn, {"params": world["params"], "constants": world["constants"]},
                 TINY["num_blocks"])
    cfg = port_main.configs_from_args(port_main.build_parser().parse_args(args))[0]
    model = AttModelX3(cfg, device="cpu")
    init_random_(model, torch.Generator().manual_seed(9))
    assert import_torch_state_dict(torch.load(fn, weights_only=True), model) == []
    save_checkpoint(str(tmp_path / "from_pth"), TrainState(model, adam(model.parameters())), 1)
    outs = [str(tmp_path / f"{name}.jsonl") for name in ("jax", "port")]
    extra = ["--split", "train"]
    n_jax = jax_predict.main(args + ["--weight_dir", world["jax_ckpt"], "--out", outs[0]]
                             + extra)
    n_port = predict.main(args + ["--weight_dir", str(tmp_path / "from_pth"), "--out", outs[1]]
                          + extra)
    want, got = read_jsonl(outs[0]), read_jsonl(outs[1])
    assert n_jax == n_port == len(want) > 0
    assert got == want, [(w, g) for w, g in zip(want, got) if w != g][:4]
    assert json.dumps(got) == json.dumps(want)
