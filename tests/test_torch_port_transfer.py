"""The host-to-device mover (``data/transfer.py``) on the CPU.

A batch shipped with bf16 features gives bitwise the same bf16-compute
logits as the same batch shipped in f32 (the model casts ``vis_fea`` to the
compute dtype at both of its uses); the shipped dtypes are those
``data/batch.py`` documents; on the CPU nothing is pinned and no stream or
event is made; a collated batch (int8 masks, int32 ids) gives the same
logits as the same batch with the synthetic batches' int64 ids and int32
masks. Packed batches (their segment ids and positions int32) too.
"""

import dataclasses

import numpy as np
import pytest
import torch

from structured_alignment_vqa_tpu_torch.data.dataset import BatchLoader, DataConfig, GQASuperNodeDataset
from structured_alignment_vqa_tpu_torch.data.fixtures import write_fixture
from structured_alignment_vqa_tpu_torch.data.transfer import (
    BatchMover,
    HostFetch,
    host_tensors,
    shipped,
)
from structured_alignment_vqa_tpu_torch.models import AttModelX3, init_random_, tiny_test_config

INT8 = ("vis_mask", "q_mask", "q_graph", "macro_mask", "macro_graph", "micro_obj_mask")


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


@pytest.fixture(scope="module", params=["obj", "objrel", "packed"])
def loader(request, tmp_path_factory):
    """Unpacked obj-only and obj+rel batches, and packed rows (up to two
    samples, whose six segment and position fields ship too)."""
    root = str(tmp_path_factory.mktemp("transfer_tree"))
    write_fixture(root, n_images=4, n_questions=16, seed=2, n_obj_range=(2, 5))
    only_obj = request.param != "objrel"
    cfg = DataConfig(data_dir=root, maxlen=128 if only_obj else 256, topn=2, min_cnt=50,
                     only_obj=only_obj, pred_rel=True)
    packing = dict(n_pack=2, pack_bucket=1) if request.param == "packed" else {}
    return BatchLoader(GQASuperNodeDataset("train", cfg), 3, shuffle=False, drop_last=False,
                       num_threads=2, **packing)


def model_for(loader, dtype, seed=0):
    ds_cfg = loader.ds.cfg
    cfg = tiny_test_config(
        vocab_size=401000, glove_dim=8, vis_fea_dim=2048, topn=ds_cfg.topn,
        only_obj=ds_cfg.only_obj, maxlen=ds_cfg.maxlen + 200, maxlen_q=40,
        num_classes=len(loader.ds.ans_w2id) + 1, compute_dtype=dtype)
    model = AttModelX3(cfg, device="cpu")
    init_random_(model, torch.Generator().manual_seed(seed))
    return model.eval()


@pytest.mark.parametrize("bf16", [False, True])
def test_shipped_dtypes_are_the_documented_ones(loader, bf16):
    mover = BatchMover("cpu", bf16_features=bf16)
    assert mover.stream is None
    for host, ship in shipped(loader, mover):
        assert ship.event is None and ship.pinned == ()
        batch = ship.ready()
        assert batch is ship.batch
        nbytes = 0
        for f in dataclasses.fields(batch):
            t = getattr(batch, f.name)
            if t is None:
                assert getattr(host, f.name) is None
                continue
            want = (torch.bfloat16 if bf16 else torch.float32) if f.name == "vis_fea" else (
                torch.int8 if f.name in INT8 else torch.int32)
            assert t.dtype == want and t.device.type == "cpu" and not t.is_pinned(), f.name
            want_values = getattr(host, f.name)
            if t.dtype == torch.bfloat16:
                want_values = torch.from_numpy(want_values).to(torch.bfloat16).float().numpy()
            assert np.array_equal(t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy(),
                                  want_values), f.name
            nbytes += t.numel() * t.element_size()
        assert ship.nbytes == nbytes


def test_bf16_features_give_bitwise_the_same_bf16_logits(loader):
    model = model_for(loader, torch.bfloat16)
    n = 0
    with torch.inference_mode():
        for host in loader:
            a = model(host_tensors(host, bf16_features=True))
            b = model(host_tensors(host, bf16_features=False))
            for x, y in zip(a, b):
                assert torch.equal(x, y)
            n += 1
    assert n > 0


def test_collated_dtypes_give_the_logits_of_widened_ids_and_masks(loader):
    """int8 masks and int32 ids (collate) against int64 ids and int32 masks
    (the synthetic batches' dtypes): the same float32 logits bitwise."""
    model = model_for(loader, torch.float32, seed=1)
    host = next(iter(loader))
    collated = host_tensors(host)
    widened = dataclasses.replace(collated, **{
        f.name: (getattr(collated, f.name).to(torch.int32) if f.name in INT8
                 else getattr(collated, f.name).long())
        for f in dataclasses.fields(collated)
        if getattr(collated, f.name) is not None and f.name != "vis_fea"})
    with torch.inference_mode():
        for x, y in zip(model(collated), model(widened)):
            assert torch.equal(x, y)


def test_shipped_keeps_the_loader_order_and_host_fetch_returns_the_tensor(loader):
    hosts = list(loader)
    moved = list(shipped(loader, BatchMover("cpu")))
    assert len(moved) == len(hosts)
    for h, (host, ship) in zip(hosts, moved):
        assert np.array_equal(h.q_ipt, host.q_ipt)
        assert np.array_equal(ship.batch.q_ipt.numpy(), h.q_ipt)
    t = torch.arange(5)
    fetch = HostFetch(t)
    assert fetch.event is None and np.array_equal(fetch.result(), np.arange(5))
