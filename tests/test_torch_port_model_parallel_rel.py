"""The model axis on the obj+rel path: one (data 2, model 2) step of four
gloo ranks on the CPU through the flash path (520 macro nodes and 5
question tokens: 525 keys, K4/K5/K6's plain versions on 2 of 4 heads a
rank), with the relation MIL-NCE, the positional tables split by rows
(maxlen 1,024) and ``marco_mlp``/``syb_mlp`` split by rows (hidden_size_mil
8), against JAX's step on ``make_mesh(4, model_parallel=2)`` and the port's
one-process step on the whole batch, at the tolerances of
``tests/test_torch_port_model_parallel.py`` (whose ranks this file
spawns).
"""

import tempfile
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

import structured_alignment_vqa_tpu.ops.pallas_attention as pa
from structured_alignment_vqa_tpu_torch.parallel.sharding import param_pspec
from test_torch_port_model_parallel import (
    REL_KW,
    WORLD,
    _jax_case,
    assert_step_matches,
    jax_mesh_step,
    port_cases,
    port_single_step,
    spawn_ranks,
)


@pytest.fixture(scope="module")
def rel_world():
    torch.set_num_threads(1)
    case = _jax_case(REL_KW, "objrel", 9)
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(1) as pool:
        done = spawn_ranks(pool, tmp, {**port_cases({"objrel": case}), "steps": ("objrel",)})
        pa.INTERPRET_MODE = True
        try:
            want = jax_mesh_step(case)
        finally:
            pa.INTERPRET_MODE = False
        single = port_single_step(case)
        done.result()
        ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=True)["objrel"]
                 for r in range(WORLD)]
    return ranks, want, single


def test_objrel_data2_model2_step_equals_jax_mesh_step_and_one_process(rel_world):
    ranks, want, single = rel_world
    got = ranks[0]
    assert_step_matches(got, want, "jax")
    assert_step_matches(got, single, "one process")
    for out in ranks[1:]:
        assert all(torch.equal(out["params"][k], v) for k, v in got["params"].items())
    assert got["grads"]["MIL_NCE.R"].abs().max() > 0
    # this layout splits what the obj-only one does not: the positional
    # tables by rows, and marco_mlp and syb_mlp by rows (in > out)
    assert param_pspec("att_vis_grid.syb_positional_encoding.0.lookup_table", (1024, 16), 2) == 0
    assert param_pspec("MIL_NCE.marco_mlp.0.weight", (8, 12), 2) == 1
