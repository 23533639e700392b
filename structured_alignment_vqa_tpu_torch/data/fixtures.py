"""Synthetic on-disk fixtures in the reference's raw data format: the port's
own copy of the TPU package's ``data/fixtures.py`` (the same draws from the
same seed, so both write the same members).

Writes a miniature GQA-style dataset — feature/graph npz tars, question json
tars, vocab TSVs, GT scene graphs, relation dictionary — so the full host
pipeline (tar indexing -> graph construction -> tokenization -> collate) can
be exercised end-to-end without the real 100GB archives. Formats follow
`data_loader_itp_bbox_super_node_onlyobj.py:244-334` exactly.
"""

from __future__ import annotations

import io
import json
import os
import tarfile
from typing import List

import numpy as np

OBJECTS = ["man", "car", "dog", "tree", "window", "shirt", "chair", "ball"]
ATTRS = ["red", "small", "wooden", "round"]
RELATIONS = {
    "man,car": "to the left of",
    "dog,tree": "near",
    "car,tree": "behind",
    "man,dog": "holding",
    "window,chair": "above",
}
ANSWERS = ["yes", "no", "red", "man", "left"]
QUESTION_WORDS = ["what", "color", "is", "the", "left", "of", "near", "holding"]


def _add_bytes(tar: tarfile.TarFile, name: str, data: bytes):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tar.addfile(info, io.BytesIO(data))


def _npz_bytes(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def write_fixture(
    root: str,
    n_images: int = 12,
    n_questions: int = 48,
    seed: int = 0,
    n_obj_range: tuple = (2, 5),
    n_words_range: tuple = (2, 6),
    n_classes: int = len(OBJECTS),
    bbox_bin_num: int = 64,
    p_easy: float = 0.0,
    class_feature_sigma: float = None,
    p_detector_correct: float = 0.0,
) -> dict:
    """Create the fixture tree under ``root``; returns summary info.

    ``n_obj_range`` / ``n_words_range`` are half-open [lo, hi) draws for
    objects-per-image and words-per-question. The defaults keep the tiny
    CI-sized fixtures; scale-up runs use GQA-realistic ranges (bottom-up
    detectors emit 10-36 boxes per image, questions run 3-15 words), which
    produces the production macro-graph length mix rather than the 10-20
    token graphs the tiny defaults give. ``n_classes`` > len(OBJECTS) pads
    the detector class vocabulary with synthetic names (production has 1600
    classes; tiny vocabularies make topN negative pools run dry — the regime
    where the reference's ``random.sample`` raises and drops the sample).

    Questions are *learnable*: each asks about one target object by carrying
    the quantized-corner position token of its bbox (the same ``x{i}y{j}``
    name the super-node graph builder attaches to that object as a position
    node), and the answer is the target's object name. Answering requires
    aligning the question node to the scene-graph position node and reading
    the object it grounds — the structured-alignment task itself — so
    training accuracy on the fixture should climb well above the answer
    prior. ``bbox_bin_num`` must match the loader's ``--bbox_bin_num``.

    ``p_easy``: fraction of questions that *additionally* carry the target's
    name token — a short-circuit (copy the name) learnable in a few hundred
    steps, useful to separate "the training loop optimizes" from "the
    alignment task is hard" in scale-up runs with tight step budgets.

    ``class_feature_sigma``: None (default) draws each object's 2048-d visual
    feature i.i.d. — nothing about the answer is then *generalizable* from
    vis features, which is why round 2's production-scale run could not move
    off the answer prior (docs/DESIGN.md "Scale-up run"). A float switches to
    detector-realistic features: a fixed per-class prototype (seeded by the
    class, shared across images) plus ``sigma``-scaled i.i.d. noise, the way
    real bottom-up-attention features encode the class. The planted task then
    has a generalizable solution — align the question's position token to the
    macro position node, follow it to the super node's visual feature, and
    decode the class prototype — with ceiling set by sigma and by corner-bin
    collisions, not by memorization capacity.

    ``p_detector_correct``: probability the detector's top-1 class
    (``objects_id[k][0]``) equals the true class instead of a uniform draw —
    the reference's detector is right most of the time, and the MIL micro
    positives / relation rep nodes inherit that correlation. 0 (default)
    keeps the old uncorrelated behavior.
    """
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "preprocessed"), exist_ok=True)

    classes = list(OBJECTS) + [
        f"thing{k:04d}" for k in range(max(0, n_classes - len(OBJECTS)))
    ]
    # per-class feature prototypes: seeded by (seed, class index) so the same
    # class gets the same prototype in every image and every regeneration
    proto = (
        np.random.default_rng((seed, 7919)).standard_normal(
            (len(OBJECTS), 2048)
        ).astype(np.float32)
        if class_feature_sigma is not None else None
    )

    # --- vocab files ---
    with open(os.path.join(root, "objects_vocab.txt"), "w") as f:
        for o in classes:
            f.write(o + "\n")
    with open(os.path.join(root, "attributes_vocab.txt"), "w") as f:
        for a in ATTRS:
            f.write(a + "\n")

    # graph-node vocab: objects, attrs, relations (space-stripped), position
    # nodes, question words
    vocab: List[str] = ["<pad_tok>"]
    vocab += classes + ATTRS
    vocab += sorted({v.replace(" ", "") for v in RELATIONS.values()})
    vocab += ["left", "right", "top", "bottom"]
    # every position-node name the quantizer can emit (corners normalized by
    # image dims then floored into bbox_bin_num bins; == bin_num at the edge)
    for x in range(0, bbox_bin_num + 1):
        for y in range(0, bbox_bin_num + 1):
            vocab.append(f"x{x}y{y}")
    vocab += QUESTION_WORDS
    with open(os.path.join(root, "preprocessed", "de.vocab.composite2.tsv"), "w") as f:
        for i, w in enumerate(dict.fromkeys(vocab)):
            f.write(f"{w} {i + 10}\n")

    with open(os.path.join(root, "preprocessed", "en.vocab.tsv"), "w") as f:
        for a in dict.fromkeys(ANSWERS + OBJECTS):
            f.write(f"{a} 100\n")
        f.write("rare_answer 1\n")  # below min_cnt, must be filtered

    with open(os.path.join(root, "GT_relations_dict_compsite.json"), "w") as f:
        json.dump(RELATIONS, f)

    # --- per-image features / graphs / GT scene graphs ---
    scene_graphs = {}
    img_targets = {}  # image_id -> [(obj name, corner-bin position token)]
    fea_tar_path = os.path.join(root, "gt_bua_npz.tar")
    with tarfile.open(fea_tar_path, "w") as tar:
        for img in range(n_images):
            image_id = f"img{img:04d}"
            n_obj = int(rng.integers(*n_obj_range))
            fea = rng.standard_normal((n_obj, 2048)).astype(np.float32)

            w, h = 640, 480
            bbox = np.stack([
                rng.uniform(0, w / 2, n_obj), rng.uniform(0, h / 2, n_obj),
                rng.uniform(w / 2, w, n_obj), rng.uniform(h / 2, h, n_obj),
            ], axis=1).astype(np.float32)

            obj_names = [OBJECTS[int(k)] for k in rng.integers(0, len(OBJECTS), n_obj)]
            if proto is not None:
                # detector-realistic features: class prototype + noise (the
                # rng draw above keeps the default path's stream unchanged)
                name_idx = np.asarray([OBJECTS.index(n) for n in obj_names])
                fea = (
                    proto[name_idx]
                    + class_feature_sigma * fea
                ).astype(np.float32)
            img_targets[image_id] = [
                (
                    obj_names[k],
                    f"x{int(bbox[k][0] / w * bbox_bin_num)}"
                    f"y{int(bbox[k][1] / h * bbox_bin_num)}",
                )
                for k in range(n_obj)
            ]
            objects_id = [
                list(rng.integers(0, len(classes), size=6)) for _ in range(n_obj)
            ]
            if p_detector_correct > 0.0:
                for k in range(n_obj):
                    if rng.random() < p_detector_correct:
                        objects_id[k][0] = OBJECTS.index(obj_names[k])
            attrs_id = [int(rng.integers(0, len(ATTRS))) for _ in range(n_obj)]
            info = {"objects_id": objects_id, "attrs_id": attrs_id}

            # full GT record: the GT-graph loaders also need x/y/w/h,
            # attributes, relations, and image dims (`data_loader_itp_gt.py:112-129`)
            obj_keys = [f"o{k}" for k in range(n_obj)]
            scene_graphs[image_id] = {
                "width": w,
                "height": h,
                "objects": {
                    obj_keys[k]: {
                        "name": obj_names[k],
                        "x": float(bbox[k][0]),
                        "y": float(bbox[k][1]),
                        "w": float(bbox[k][2] - bbox[k][0]),
                        "h": float(bbox[k][3] - bbox[k][1]),
                        "attributes": [ATTRS[attrs_id[k]]] if rng.random() > 0.2 else [],
                        "relations": [
                            {"object": obj_keys[int(t)], "name": list(RELATIONS.values())[int(rng.integers(0, 5))]}
                            for t in rng.integers(0, n_obj, size=int(rng.integers(0, 2)))
                        ],
                    }
                    for k in range(n_obj)
                },
            }
            _add_bytes(
                tar, f"{image_id}.npz",
                _npz_bytes(
                    x=fea, fea=fea, bbox=bbox, image_w=np.float64(w), image_h=np.float64(h),
                    info=np.asarray(info, dtype=object),
                ),
            )

    for split in ("train", "val"):
        with open(os.path.join(root, f"{split}_sceneGraphs.json"), "w") as f:
            json.dump(scene_graphs, f)

    # --- question tars ---
    image_ids = sorted(scene_graphs.keys())
    for split, n_q in (("train", n_questions), ("val", max(n_questions // 4, 4))):
        with tarfile.open(os.path.join(root, f"{split}.tar"), "w") as tar:
            for qi in range(n_q):
                image_id = image_ids[int(rng.integers(0, len(image_ids)))]
                targets = img_targets[image_id]
                name, pos_tok = targets[int(rng.integers(0, len(targets)))]
                n_words = int(rng.integers(*n_words_range))
                # "what <pos_tok> ..." — the position token names the target
                # object's quantized corner; fillers are uninformative
                nodes = ["what", pos_tok] + (
                    [name] if rng.random() < p_easy else []
                ) + [
                    QUESTION_WORDS[int(k)]
                    for k in rng.integers(0, len(QUESTION_WORDS), max(n_words - 2, 0))
                ]
                n_nodes = len(nodes)
                edges = [
                    [int(a), int(b)]
                    for a in range(n_nodes) for b in range(n_nodes)
                    if a != b and rng.random() < 0.4
                ]
                qdata = {
                    "node_list": nodes,
                    "edge_pair": edges,
                    "answer": name,
                    "image_id": image_id,
                }
                _add_bytes(tar, f"{split}/q{qi:05d}.json", json.dumps(qdata).encode())

    return {"n_images": n_images, "image_ids": image_ids}
