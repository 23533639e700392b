"""Shared cases of ``tests/test_torch_port_variants*.py``: each ablation
variant of the JAX package and of the port on the same numpy inputs at
``tiny_test_config`` sizes (B 2, LV 4, LS 6, LQ 5), random params drawn with
numpy (off the LayerNorm knife edge, docs/PARITY.md) and carried into the
port by ``models/convert_variants.py``. float32 on the CPU, no
dropout, TF32 off.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from structured_alignment_vqa_tpu.models import variants as jax_variants
from structured_alignment_vqa_tpu.models.config import tiny_test_config as jax_tiny
from structured_alignment_vqa_tpu_torch.models import variants as port_variants
from structured_alignment_vqa_tpu_torch.models.config import tiny_test_config as port_tiny
from structured_alignment_vqa_tpu_torch.models.convert_variants import (
    variant_name_map,
    variant_state_dict_from_jax,
)

B, LV, LS, LQ = 2, 4, 6, 5
N_NODES = LS          # relatt's vis-symbolic node rows
N_REL_CAND = 2        # x3_ori's relation candidates per pair
PAD_ID = 400000
LOGIT_TOL = 1e-4      # logits and losses
ATT_TOL = 1e-5        # attention weights

MAX_POOL = ("x", "x2", "x2_pre", "x2_distill")
DEC = ("x2_dec", "x2_mlp_dec", "x2_syb_dec", "x2_fusion_dec")
ONE_D = ("x4_dec", "x5_dec_mil", "x7_dec_mil")
SQUARE = DEC + ("x2_dec_ori", "x2_fusion_dec_mil", "x2_fusion_dec_mil2")
# the aliases: forks byte-identical to another name
ALIASES = {"x2_pre": "x2", "x2_syb_dec": "x2_fusion_dec"}


def config_kwargs(name: str) -> dict:
    kw = dict(maxlen_v=LV, maxlen=LS + 4, maxlen_q=LQ)
    if name == "x2_fusion_dec_relatt":
        kw["maxlen"] = N_NODES + LQ + 4   # its visual table indexes nodes ++ question
    if name == "x3_ori":
        # its symbolic tables are maxlen rows, indexed by macro ++ question
        kw.update(only_obj=False, maxlen=LS + LQ + 4)
    return kw


def configs(name: str, **extra):
    kw = dict(config_kwargs(name), **extra)
    return jax_tiny(**kw), port_tiny(**kw)


def _square(m):
    return (m[:, :, None] * m[:, None, :]).astype(np.float32)


def numpy_inputs(name: str, seed: int = 0) -> tuple:
    """The positional inputs of ``name``'s forward, numpy, as the variant
    eval CLI builds them for its family (square masks for the dec family,
    1-D for the others)."""
    cfg, _ = configs(name)
    rng = np.random.default_rng(seed)
    vis = rng.standard_normal((B, LV, cfg.vis_fea_dim)).astype(np.float32)
    q = rng.integers(1, cfg.vocab_size - 2, (B, LQ)).astype(np.int64)
    syb = rng.integers(1, cfg.vocab_size - 2, (B, LS)).astype(np.int64)
    qm = np.ones((B, LQ), np.float32)
    qm[0, LQ - 2:] = 0.0
    sm = np.ones((B, LS), np.float32)
    sm[1, LS - 2:] = 0.0
    vm = np.ones((B, LV), np.float32)
    vm[0, LV - 1:] = 0.0
    qg = (rng.random((B, LQ, LQ)) > 0.5).astype(np.float32)
    sg = (rng.random((B, LS, LS)) > 0.5).astype(np.float32)
    if name in MAX_POOL:
        return vis, q, qm, qg, syb, sm, sg
    if name in SQUARE:
        return vis, _square(vm), q, _square(qm), qg, syb, _square(sm), sg
    if name in ONE_D:
        return vis, vm, q, qm, qg, syb, sm, sg
    if name == "x6_dec_mil":
        idx_of_obj = np.array([[0, 2, 4, -1], [1, 3, -1, -1]], np.int64)
        return vis, vm, q, qm, qg, syb, sm, sg, idx_of_obj
    if name == "x2_fusion_dec_relatt":
        vs_ipt = rng.integers(1, cfg.vocab_size - 2, (B, N_NODES)).astype(np.int64)
        vs_mask = np.ones((B, N_NODES), np.float32)
        vs_mask[0, N_NODES - 2:] = 0.0
        vs_graph = (rng.random((B, N_NODES, N_NODES)) > 0.5).astype(np.float32)
        link = np.full((B, N_NODES), -1, np.int64)
        link[0, [1, 3, 4]] = [3, 0, 2]        # values unread: regions go in order
        link[1, [0, 2, 3, 5]] = [1, 2, 0, 3]
        return (vis, vs_ipt, _square(vs_mask), link, vs_graph, q, _square(qm), qg, syb,
                _square(sm), sg)
    if name == "x3_ori":
        return x3_ori_inputs(cfg, rng, vis, q, qm, qg, syb, sm, sg)
    raise KeyError(name)


def x3_ori_inputs(cfg, rng, vis, q, qm, qg, macro, mm, mg):
    """x3_ori's 15 inputs; LV doubles as its object count. ``macro_rel_loc``
    repeats a row and holds negative rows, so that later pairs overwrite
    earlier ones and negative rows wrap to the end."""
    o = LV
    pairs = o * (o - 1)
    macro_obj_loc = np.array([[2, 5, -1, 0], [0, 4, 3, 1]], np.int64)
    macro_rel_loc = np.array([[1, 3, 3, -1, 5, 2, 3, -1, 4, 0, 1, -2],
                              [1, 2, 3, 5, 5, 4, 0, 2, 3, -1, -3, 1]], np.int64)
    assert macro_rel_loc.shape[1] == pairs
    micro_pos_obj = rng.integers(1, cfg.vocab_size - 2, (B, o, cfg.topn)).astype(np.int64)
    micro_neg_obj = rng.integers(1, cfg.vocab_size - 2, (B, o, cfg.topn)).astype(np.int64)
    micro_obj_mask = np.ones((B, o, cfg.topn), np.float32)
    micro_obj_mask[0, 2, :] = 0.0
    micro_obj_mask[1, 1, 1] = 0.0
    micro_pos_rel = rng.integers(0, cfg.num_relations, (B, pairs, N_REL_CAND)).astype(np.int64)
    micro_pos_rel[0, 3, :] = PAD_ID     # an all-PAD pair
    micro_pos_rel[0, 1, 1] = PAD_ID
    micro_pos_rel[1, 5, 0] = PAD_ID
    micro_neg_rel = rng.integers(0, cfg.num_relations, (B, pairs, N_REL_CAND)).astype(np.int64)
    vm = np.ones((B, o), np.float32)
    return (vis, _square(vm), q, _square(qm), qg, macro, _square(mm), mg, macro_obj_loc,
            macro_rel_loc, micro_pos_obj, micro_neg_obj, micro_obj_mask, micro_pos_rel,
            micro_neg_rel)


def jax_args(args):
    return tuple(jnp.asarray(a, jnp.int32) if np.issubdtype(a.dtype, np.integer)
                 else jnp.asarray(a) for a in args)


def port_args(args):
    return tuple(torch.from_numpy(a) for a in args)


def random_params(model, args, kw, seed: int = 5, noise: float = 0.05):
    """A float32 numpy params tree of ``model``'s shapes (``jax.eval_shape``
    of its init: no init compiles), drawn from ``seed``: matrices and tables
    normal at xavier scale, LayerNorm gammas 1 + noise, other vectors noise
    (every param off the LayerNorm knife edge)."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0), *args, **kw))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        shape = leaf.shape
        x = rng.standard_normal(shape)
        if len(shape) >= 2:
            return (x * np.sqrt(2.0 / (shape[-2] + shape[-1]))).astype(np.float32)
        base = 1.0 if path[-1].key == "gamma" else 0.0
        return (base + noise * x).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def flat(out) -> list:
    """The numpy arrays of an output tuple, attention-weight lists flattened."""
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in flat(o)]
    return [np.asarray(out.detach() if torch.is_tensor(out) else out, dtype=np.float32)]


@functools.lru_cache(maxsize=None)
def jax_case(name: str, kw_items: tuple = ()):
    """(perturbed numpy params, output tuple) of the JAX variant on
    :func:`numpy_inputs`; ``kw_items`` are forward keyword arguments."""
    cfg, _ = configs(name)
    model = jax_variants.build_variant(name, cfg)
    args = jax_args(numpy_inputs(name))
    kw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw_items}
    params = random_params(model, args, kw)
    out = model.apply({"params": jax.tree.map(jnp.asarray, params)}, *args,
                      deterministic=True, **kw)
    return params, out


def port_model(name: str, params):
    """The port's variant, eval mode, with the converted JAX params loaded strictly."""
    _, cfg = configs(name)
    model = port_variants.build_variant(name, cfg, device="cpu")
    model.load_state_dict(variant_state_dict_from_jax(name, params, cfg), strict=True)
    return model.eval()


def leaf_paths(tree, prefix=()) -> set:
    out = set()
    for k, v in tree.items():
        out |= leaf_paths(v, prefix + (k,)) if isinstance(v, dict) else {prefix + (k,)}
    return out


def unmapped_leaves(name: str, params) -> set:
    """JAX leaves no entry of the name map reads."""
    _, cfg = configs(name)
    return leaf_paths(params) - {path for _, path, _ in variant_name_map(name, cfg)}


def assert_outputs_close(got, want, what: str) -> None:
    """Logits and losses within LOGIT_TOL, (B, H, Tq, Tk) attention weights
    within ATT_TOL, every output of the tuple in the same shape."""
    got, want = flat(got), flat(want)
    assert len(got) == len(want), (what, len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        tol = ATT_TOL if g.ndim == 4 else LOGIT_TOL
        err = float(np.abs(g - w).max()) if g.size else 0.0
        assert np.isfinite(g).all() and err <= tol, (what, i, g.shape, err, tol)


def name_map_matches(name: str, **cfg_kw) -> None:
    """The name map at a config covers the JAX model's leaves and the port
    model's parameters exactly, shape for shape (``jax.eval_shape`` of the
    JAX init: nothing runs)."""
    jcfg, pcfg = configs(name, **cfg_kw)
    model = jax_variants.build_variant(name, jcfg)
    args = jax_args(numpy_inputs(name))
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0), *args))["params"]
    port = port_variants.build_variant(name, pcfg, device="cpu")
    port_shapes = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    entries = variant_name_map(name, pcfg)
    assert {t for t, _, _ in entries} == set(port_shapes)
    assert {p for _, p, _ in entries} == leaf_paths(shapes)
    for tname, path, transpose in entries:
        node = shapes
        for key in path:
            node = node[key]
        want = tuple(reversed(node.shape)) if transpose else tuple(node.shape)
        assert port_shapes[tname] == want, (tname, path, port_shapes[tname], want)


def smoothed_ce(logits, answer, xp):
    """The variant eval CLI's loss: label-smoothed (0.1) cross-entropy,
    averaged over the batch (numpy answers; ``xp`` jnp or torch)."""
    k = logits.shape[-1]
    if xp is torch:
        one_hot = torch.nn.functional.one_hot(torch.from_numpy(answer), k).float()
        log_sm = torch.log_softmax(logits.float(), dim=-1)
        return -((0.9 * one_hot + 0.1 / k) * log_sm).sum(-1).mean()
    one_hot = jax.nn.one_hot(jnp.asarray(answer), k)
    log_sm = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
    return -jnp.sum((0.9 * one_hot + 0.1 / k) * log_sm, -1).mean()


def assert_grads_match(name: str, model, jgrads, rtol: float = 1e-4) -> None:
    """Every port gradient within ``rtol`` of the JAX one's norm (a
    parameter no path reads has no port gradient and a zero JAX one)."""
    _, cfg = configs(name)
    want = variant_state_dict_from_jax(name, jgrads, cfg)
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    for tname, p in named.items():
        w = want[tname]
        g = torch.zeros_like(p) if p.grad is None else p.grad
        err = (g - w).norm().item() / max(w.norm().item(), 1e-12)
        assert err <= rtol, (tname, err)
