"""Node-graph loader family: the non-super-node loader variants, unified.
The port's own copy of the TPU package's ``data/node_graph_dataset.py``,
which gives the same samples and the same batches, value for value (numpy
graph building, no torch).

The reference keeps eight loader forks whose only differences are how symbolic
nodes/edges are constructed. Here a single dataset class is
parameterized by:

* ``node_source``:
    - 'detected'  — detected class+attr per region (`data_loader_itp.py:103-161`)
    - 'gt'        — GT scene-graph names + first attribute
                    (`data_loader_itp_gt.py:104-157`)
    - 'pred_node' — top detected label per GT object, GT or frequency-dict
                    relations (`data_loader_itp_GTRelPredNode_bbox.py:120-218`)
* ``relation_source``: 'freq_dict' | 'gt' | 'freq_dict_geo' (geometric
  consistency filter, `GTRelPredNode:210-214`)
* ``position_nodes``: 'none' | 'bbox_corners' | 'center_grid'
* ``label_noise_rate`` — the dataAug label-noise augmentation
  (`data_loader_itp_bbox.py` GQADataset_aug)
* ``emit_idx_of_obj`` — object-row indices for the x6/x7 MIL models
  (`data_loader_itp_bbox_q.py:393-461`)

Reference quirks are preserved by default and each carries an opt-out flag:

* the GT loader records node indices *after* appending (off by one:
  `data_loader_itp_gt.py:116-123`) — ``gt_off_by_one``;
* its center-grid position name floors ``cy/height`` *before* multiplying by
  the grid (`data_loader_itp_gt.py:129`) — ``center_grid_floor_bug``;
* the detected loader's position nodes use the stale ``row_idx`` from the
  preceding scan loop (every position node comes from the last region's bbox)
  and are indexed off by one (`data_loader_itp.py:130-141`) —
  ``detected_stale_bbox``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from structured_alignment_vqa_tpu_torch.data.dataset import DataConfig, GQASuperNodeDataset
from structured_alignment_vqa_tpu_torch.data.graph_builder import (
    PAD_NODE,
    _spatial_correct,
    quantize_bbox,
)
from structured_alignment_vqa_tpu_torch.models.glove import SPECIALS

PAD = SPECIALS.PAD
UNK = SPECIALS.UNK


@dataclasses.dataclass
class NodeGraphConfig(DataConfig):
    node_source: str = "gt"              # 'detected' | 'gt' | 'gt_named' | 'gt_with_pred' | 'pred_node'
    relation_source: str = "freq_dict"   # 'freq_dict' | 'gt' | 'freq_dict_geo'
    position_nodes: str = "none"         # 'none' | 'bbox_corners' | 'center_grid'
    pos_grid_num: int = 10
    label_noise_rate: float = 0.0        # dataAug
    emit_idx_of_obj: bool = False
    emit_visrel: bool = False            # vis-branch symbolic graph (visGraph)
    # parity quirk switches (True = replicate the reference)
    gt_off_by_one: bool = True
    center_grid_floor_bug: bool = True
    detected_stale_bbox: bool = True
    fea_key: str = "fea"                 # GT loader reads npz['fea'] (`itp_gt:177`)
    # the plain GT loader and the detected loader tokenize WITHOUT the synonym
    # converter (`data_loader_itp_gt.py:183`, `data_loader_itp.py`); the bbox
    # family applies it (`GTRelPredNode:267-271`)
    use_word_converter: bool = True


@dataclasses.dataclass
class NodeSample:
    vis_fea: np.ndarray
    node_ids: np.ndarray
    edges: List[Tuple[int, int]]
    q_ids: np.ndarray
    q_edges: List
    answer: int
    idx_of_obj: Optional[np.ndarray] = None
    # visGraph path (`data_loader_itp_bbox.py:114-220` convert_graph_visrel):
    vis_node_ids: Optional[np.ndarray] = None    # vis-branch symbolic nodes
    vis_edges: Optional[List[Tuple[int, int]]] = None
    syb2vis: Optional[np.ndarray] = None         # (N, 2) [vis_node_row, region]
    valid2all: Optional[np.ndarray] = None       # valid-object -> region row


class NodeGraphDataset(GQASuperNodeDataset):
    """Reuses the super-node dataset's vocab/tar machinery; only node/edge
    construction differs."""

    def __init__(self, split: str, cfg: NodeGraphConfig):
        super().__init__(split, cfg)
        self.ncfg = cfg

    # -- per-source node construction ---------------------------------------------

    def _center_grid_name(self, cx, cy, width, height) -> str:
        g = self.ncfg.pos_grid_num
        if self.ncfg.center_grid_floor_bug:
            return f"x{math.floor(cx / width * g)}y{math.floor(cy / height) * g}"
        return f"x{math.floor(cx / width * g)}y{math.floor(cy / height * g)}"

    def _nodes_gt(self, gt_graph) -> Tuple[List[str], List, List[int]]:
        """GT names + first attribute + center position (`itp_gt:104-157`)."""
        off = 0 if self.ncfg.gt_off_by_one else 1
        nodes: List[str] = []
        edges: List = []
        idx_obj: List[int] = []
        names: List[str] = []
        rel2pos: Dict[str, int] = {}
        for obj_key in gt_graph["objects"]:
            data = gt_graph["objects"][obj_key]
            nodes.append(data["name"].strip().replace(" ", ""))
            # the reference records len(nodes) *after* the append
            pos_obj = len(nodes) - (1 - off) if not self.ncfg.gt_off_by_one else len(nodes)
            if data.get("attributes"):
                nodes.append(data["attributes"][0])
                pos_attr = len(nodes) if self.ncfg.gt_off_by_one else len(nodes) - 1
                edges.append([pos_obj, pos_attr])
                edges.append([pos_attr, pos_obj])
            idx_obj.append(pos_obj)
            names.append(data["name"])
            if self.ncfg.position_nodes == "center_grid":
                cx = data["x"] + data["w"] / 2
                cy = data["y"] + data["h"] / 2
                nodes.append(self._center_grid_name(cx, cy, gt_graph["width"], gt_graph["height"]))
                pos_pos = len(nodes) if self.ncfg.gt_off_by_one else len(nodes) - 1
                edges.append([pos_obj, pos_pos])
                edges.append([pos_pos, pos_obj])

        self._freq_relations(nodes, edges, idx_obj, names, rel2pos, strip=False)
        return nodes, edges, idx_obj

    def _nodes_detected(self, data_info, bbox) -> Tuple[List[str], List, List[int], np.ndarray]:
        """Detected class + attribute per region (`data_loader_itp.py:103-161`).

        The reference expects top-1 npz files (1-D ``objects_id``); topN-style
        2-D arrays take the top-1 column (the reference would crash on them).
        """
        objs, attrs = [], []
        ids = np.asarray(data_info["objects_id"])
        if ids.ndim > 1:
            ids = ids[:, 0]
        keep = np.zeros(ids.shape, np.int32)
        last_row = 0
        for row_idx, (oid, aid) in enumerate(zip(ids, data_info["attrs_id"])):
            if oid >= len(self.builder.vg_classes):
                continue
            keep[row_idx] = 1
            objs.append(self.builder.vg_classes[oid])
            attrs.append(self.builder.vg_attrs[aid])
            last_row = row_idx

        nodes: List[str] = []
        edges: List = []
        idx_obj: List[int] = []
        for i in range(len(objs)):
            pos_obj = len(nodes)
            nodes.append(objs[i])
            pos_attr = len(nodes)
            nodes.append(attrs[i])
            edges.append([pos_obj, pos_attr])
            edges.append([pos_attr, pos_obj])
            idx_obj.append(pos_obj)
            if self.ncfg.position_nodes == "bbox_corners":
                row = last_row if self.ncfg.detected_stale_bbox else i
                for cx, cy in ((0, 1), (2, 3)):
                    name = f"x{int(bbox[row][cx])}y{int(bbox[row][cy])}"
                    nodes.append(name)
                    # reference indexes the *next* slot (`itp:132-141`)
                    pos_pos = len(nodes) if self.ncfg.detected_stale_bbox else len(nodes) - 1
                    edges.append([pos_obj, pos_pos])
                    edges.append([pos_pos, pos_obj])

        rel2pos: Dict[str, int] = {}
        self._freq_relations(nodes, edges, idx_obj, objs, rel2pos, strip=False)
        return nodes, edges, idx_obj, keep

    def _nodes_pred(self, data_info, bbox, gt_graph, rng,
                    use_gt_names: bool = False) -> Tuple[List[str], List, List[int]]:
        """Top detected label per GT object (or the GT name itself when
        ``use_gt_names`` — the `data_loader_itp_gt_bbox.py:118-211` recipe,
        which shares this structure); GT or filtered frequency-dict relations
        (`GTRelPredNode:120-218`)."""
        nodes: List[str] = []
        edges: List = []
        idx_obj: List[int] = []
        names: List[str] = []
        centers: List[Tuple[float, float]] = []
        obj2idx: Dict[str, int] = {}
        attr2idx: Dict[str, int] = {}
        pos2idx: Dict[str, int] = {}
        rel2pos: Dict[str, int] = {}

        for obj_idxs, obj_key in zip(data_info["objects_id"], gt_graph["objects"]):
            obj2idx[obj_key] = len(obj2idx)
            if use_gt_names:
                nodes.append(gt_graph["objects"][obj_key]["name"].strip().replace(" ", ""))
                continue
            pred = None
            for oid in np.asarray(obj_idxs).reshape(-1):
                if oid < len(self.builder.vg_classes):
                    pred = self.builder.vg_classes[oid].replace(" ", "")
                    break
            nodes.append(pred if pred is not None else "")
        if self.ncfg.label_noise_rate > 0:
            # dataAug: replace labels with random classes at aug_rate
            for i in range(len(nodes)):
                if rng.random() < self.ncfg.label_noise_rate:
                    nodes[i] = self.builder.vg_classes[
                        int(rng.integers(0, len(self.builder.vg_classes)))
                    ].replace(" ", "")

        for obj_key in gt_graph["objects"]:
            data = gt_graph["objects"][obj_key]
            pos_obj = obj2idx[obj_key]
            if data.get("attributes"):
                a = data["attributes"][0]
                if a in attr2idx:
                    pos_attr = attr2idx[a]
                else:
                    pos_attr = len(nodes)
                    attr2idx[a] = pos_attr
                    nodes.append(a.replace(" ", ""))
                edges.append([pos_obj, pos_attr])
                edges.append([pos_attr, pos_obj])
            if self.ncfg.relation_source == "gt":
                for rel in data.get("relations", []):
                    tgt = obj2idx.get(rel["object"])
                    if tgt is None:
                        continue
                    r = rel["name"].replace(" ", "")
                    if r in rel2pos:
                        pos_rel = rel2pos[r]
                    else:
                        pos_rel = len(nodes)
                        rel2pos[r] = pos_rel
                        nodes.append("".join(r.split()))
                    edges.append([pos_obj, pos_rel])
                    edges.append([pos_rel, tgt])
            idx_obj.append(pos_obj)
            names.append(data["name"])
            centers.append((data["x"] + data["w"] / 2, data["y"] + data["h"] / 2))
            if self.ncfg.position_nodes == "bbox_corners":
                for cx, cy in ((data["x"], data["y"]), (data["x"] + data["w"], data["y"] + data["h"])):
                    name = self._center_grid_name(cx, cy, gt_graph["width"], gt_graph["height"])
                    if name in pos2idx:
                        pos_pos = pos2idx[name]
                    else:
                        pos_pos = len(nodes)
                        pos2idx[name] = pos_pos
                        nodes.append(name)
                    edges.append([pos_obj, pos_pos])
                    edges.append([pos_pos, pos_obj])

        if self.ncfg.relation_source != "gt":
            geo = self.ncfg.relation_source == "freq_dict_geo"
            self._freq_relations(nodes, edges, idx_obj, names, rel2pos,
                                 strip=True, centers=centers if geo else None)
        return nodes, edges, idx_obj

    def _freq_relations(self, nodes, edges, idx_obj, names, rel2pos,
                        strip: bool, centers=None):
        """Frequency-dictionary relation nodes shared per name, optionally
        geometry-filtered (`GTRelPredNode:195-216`, `itp_gt:136-156`)."""
        gtr = self.builder.gt_relations
        n = len(idx_obj)
        for i in range(n):
            for j in range(n):
                if i == j:
                    continue
                key = f"{names[i]},{names[j]}"
                if key not in gtr:
                    continue
                r_name = gtr[key].replace(" ", "") if strip else gtr[key]
                if r_name in rel2pos:
                    pos_rel = rel2pos[r_name]
                else:
                    pos_rel = len(nodes)
                    rel2pos[r_name] = pos_rel
                    nodes.append("".join(r_name.split()))
                if centers is not None:
                    # keep only geometrically consistent spatial relations
                    ok = ("left" in r_name and centers[i][0] < centers[j][0]
                          or "right" in r_name and centers[i][0] > centers[j][0]
                          or "top" in r_name and centers[i][1] < centers[j][1]
                          or "under" in r_name and centers[i][1] > centers[j][1])
                    if not ok:
                        continue
                edges.append([idx_obj[i], pos_rel])
                edges.append([pos_rel, idx_obj[j]])

    def _nodes_gtwpred(self, data_info, bbox, gt_graph):
        """GT+predicted node mixing (`data_loader_itp_gtWpred_bbox.py:300-416`):
        per object a *chain* of up to topN detected-label nodes whose last link
        is replaced by the GT name, consecutive candidates edged together, each
        candidate sharing the attr/position nodes; frequency-dict relations
        over every candidate pair with the spatial flip correction."""
        classes = self.builder._stripped_classes
        attrs_v = [a.replace(" ", "") for a in self.builder.vg_attrs]
        topn = self.ncfg.topn
        cand_lists, attr_lists = [], []
        for obj_idxs, obj_key, attr_idx in zip(
            data_info["objects_id"], gt_graph["objects"], data_info["attrs_id"]
        ):
            cands = []
            for oid in np.asarray(obj_idxs).reshape(-1):
                if len(cands) >= topn:
                    break
                if oid < len(classes):
                    cands.append(classes[oid])
            gt_name = gt_graph["objects"][obj_key]["name"].strip().replace(" ", "")
            if cands:
                cands[-1] = gt_name  # reference replaces the last candidate
            else:
                # reference would IndexError and drop the sample; keep the GT
                # name instead (docs/PARITY.md repair policy)
                cands = [gt_name]
            cand_lists.append(cands)
            attr_lists.append(attrs_v[attr_idx])

        nodes: List[str] = []
        edges: List = []
        idx_objs: List[List[int]] = []
        attr2idx: Dict[str, int] = {}
        pos2idx: Dict[str, int] = {}
        rel2pos: Dict[str, int] = {}
        for i, cands in enumerate(cand_lists):
            chain: List[int] = []
            prev = len(nodes)
            for name in cands:
                pos_obj = len(nodes)
                if prev != pos_obj:  # chain consecutive candidates
                    edges.append([prev, pos_obj])
                    edges.append([pos_obj, prev])
                    prev = pos_obj
                nodes.append(name)
                a = attr_lists[i]
                if a in attr2idx:
                    pa = attr2idx[a]
                else:
                    pa = len(nodes)
                    attr2idx[a] = pa
                    nodes.append(a)
                edges.append([pos_obj, pa])
                edges.append([pa, pos_obj])
                chain.append(pos_obj)
                if self.ncfg.position_nodes == "bbox_corners" and i < len(bbox):
                    for cx, cy in ((0, 1), (2, 3)):
                        pn = f"x{int(bbox[i][cx])}y{int(bbox[i][cy])}"
                        if pn in pos2idx:
                            pp = pos2idx[pn]
                        else:
                            pp = len(nodes)
                            pos2idx[pn] = pp
                            nodes.append(pn)
                        edges.append([pos_obj, pp])
                        edges.append([pp, pos_obj])
            idx_objs.append(chain)

        gtr = self.builder.gt_relations
        n = len(cand_lists)
        for i in range(n):
            for j in range(n):
                for i_, a in enumerate(cand_lists[i]):
                    for j_, b_ in enumerate(cand_lists[j]):
                        key = f"{a},{b_}"
                        if key not in gtr:
                            continue
                        r_name = gtr[key].replace(" ", "")
                        if r_name in rel2pos:
                            pos_rel = rel2pos[r_name]
                        else:
                            pos_rel = len(nodes)
                            rel2pos[r_name] = pos_rel
                            r = "".join(r_name.split())
                            if i < len(bbox) and j < len(bbox):
                                r = _spatial_correct(r, bbox, i, j)
                            nodes.append(r)
                        edges.append([idx_objs[i][i_], pos_rel])
                        edges.append([pos_rel, idx_objs[j][j_]])
        first_rows = [c[0] for c in idx_objs]
        return nodes, edges, first_rows

    def _nodes_visrel(self, data_info, bbox):
        """Vis-branch symbolic graph (`data_loader_itp_bbox.py:114-220`):
        one node per region (``__background__`` for invalid detections),
        shared attr/position/top-1-relation nodes with the spatial correction,
        background nodes fully connected; returns (nodes, edges, syb2vis,
        valid2all)."""
        classes = self.builder._stripped_classes
        attrs = [a.replace(" ", "") for a in self.builder.vg_attrs]
        ids = np.asarray(data_info["objects_id"])
        if ids.ndim > 1:  # topN detections: use the top-1 column
            ids = ids[:, 0]
        obj_names, attr_names, valid2all = [], [], []
        for row_idx, (oid, aid) in enumerate(zip(ids, data_info["attrs_id"])):
            if oid >= len(classes):
                obj_names.append("__background__")
                attr_names.append("__background_attr__")
                continue
            valid2all.append(row_idx)
            obj_names.append(classes[oid])
            attr_names.append(attrs[aid])

        nodes: List[str] = []
        edges: List = []
        idx_obj: List[int] = []
        syb2vis: List[List[int]] = []
        attr2idx: Dict[str, int] = {}
        pos2idx: Dict[str, int] = {}
        rel2pos: Dict[str, int] = {}
        n = len(obj_names)
        for i in range(n):
            pos_obj = len(nodes)
            syb2vis.append([pos_obj, i])
            nodes.append(obj_names[i])
            if attr_names[i] != "__background_attr__":
                if attr_names[i] in attr2idx:
                    pa = attr2idx[attr_names[i]]
                else:
                    pa = len(nodes)
                    attr2idx[attr_names[i]] = pa
                    nodes.append(attr_names[i])
                edges.append([pos_obj, pa])
                edges.append([pa, pos_obj])
            idx_obj.append(pos_obj)
            if self.ncfg.position_nodes == "bbox_corners" and i < len(bbox):
                for cx, cy in ((0, 1), (2, 3)):
                    name = f"x{int(bbox[i][cx])}y{int(bbox[i][cy])}"
                    if name in pos2idx:
                        pp = pos2idx[name]
                    else:
                        pp = len(nodes)
                        pos2idx[name] = pp
                        nodes.append(name)
                    edges.append([pos_obj, pp])
                    edges.append([pp, pos_obj])

        gtr = self.builder.gt_relations
        for i in range(n):
            for j in range(n):
                key = f"{obj_names[i]},{obj_names[j]}"
                if key not in gtr:
                    continue
                r_name = gtr[key].replace(" ", "")
                if r_name in rel2pos:
                    pos_rel = rel2pos[r_name]
                else:
                    pos_rel = len(nodes)
                    rel2pos[r_name] = pos_rel
                    r = "".join(r_name.split())
                    if i < len(bbox) and j < len(bbox):
                        r = _spatial_correct(r, bbox, i, j)
                    nodes.append(r)
                edges.append([idx_obj[i], pos_rel])
                edges.append([pos_rel, idx_obj[j]])

        # background regions attend everything (`itp_bbox:214-219`)
        for rid, name in enumerate(obj_names):
            if name == "__background__":
                for i in range(n):
                    edges.append([rid, i])
                    edges.append([i, rid])
        return nodes, edges, syb2vis, valid2all

    # -- sample assembly ----------------------------------------------------------

    def _tok(self, node):
        if not self.ncfg.use_word_converter:
            if node is PAD_NODE or node == PAD:
                return PAD
            return self.enc_w2id.get(node, UNK)
        return super()._tok(node)

    def _sample(self, index: int) -> Optional[NodeSample]:
        cfg = self.ncfg
        qinfo = self.questions.read_json(index)
        answer = self.ans_w2id.get(qinfo["answer"], 0)
        image_id = qinfo["image_id"]
        gt_graph = self.gt_graph[image_id]

        fea_npz = self.fea_tar.read_npz(image_id, allow_pickle=True)
        key = cfg.fea_key if cfg.fea_key in fea_npz else "x"
        vis_fea = np.asarray(fea_npz[key], dtype=np.float32)

        rng = np.random.default_rng((cfg.seed, index))
        idx_of_obj = None
        if cfg.node_source == "gt":
            nodes, edges, idx_obj = self._nodes_gt(gt_graph)
        elif cfg.node_source == "gt_named":
            g_npz = self.g_tar.read_npz(image_id, allow_pickle=True)
            bbox = quantize_bbox(g_npz["bbox"], g_npz["image_w"], g_npz["image_h"], cfg.bbox_bin_num)
            nodes, edges, idx_obj = self._nodes_pred(
                g_npz["info"].tolist(), bbox, gt_graph, rng, use_gt_names=True)
        elif cfg.node_source == "gt_with_pred":
            g_npz = self.g_tar.read_npz(image_id, allow_pickle=True)
            bbox = quantize_bbox(g_npz["bbox"], g_npz["image_w"], g_npz["image_h"], cfg.bbox_bin_num)
            nodes, edges, idx_obj = self._nodes_gtwpred(g_npz["info"].tolist(), bbox, gt_graph)
        elif cfg.node_source == "detected":
            g_npz = self.g_tar.read_npz(image_id, allow_pickle=True)
            bbox = quantize_bbox(g_npz["bbox"], g_npz["image_w"], g_npz["image_h"], cfg.bbox_bin_num)
            nodes, edges, idx_obj, keep = self._nodes_detected(g_npz["info"].tolist(), bbox)
            vis_fea = vis_fea[: len(keep)][keep.astype(bool)] if len(keep) <= len(vis_fea) else vis_fea
        elif cfg.node_source == "pred_node":
            g_npz = self.g_tar.read_npz(image_id, allow_pickle=True)
            bbox = quantize_bbox(g_npz["bbox"], g_npz["image_w"], g_npz["image_h"], cfg.bbox_bin_num)
            nodes, edges, idx_obj = self._nodes_pred(g_npz["info"].tolist(), bbox, gt_graph, rng)
        else:
            raise ValueError(cfg.node_source)

        node_ids = np.asarray([self._tok(n) for n in nodes], dtype=np.int64)
        q_ids = np.asarray([self.enc_w2id.get(qn, UNK) for qn in qinfo["node_list"]], dtype=np.int64)
        if len(node_ids) + len(q_ids) >= cfg.maxlen:
            return None
        if cfg.emit_idx_of_obj:
            idx_of_obj = np.asarray(idx_obj, dtype=np.int64)

        sample = NodeSample(
            vis_fea=vis_fea,
            node_ids=node_ids,
            edges=[tuple(e) for e in edges],
            q_ids=q_ids,
            q_edges=list(qinfo["edge_pair"]),
            answer=int(answer),
            idx_of_obj=idx_of_obj,
        )
        if cfg.emit_visrel:
            g_npz2 = self.g_tar.read_npz(image_id, allow_pickle=True)
            bbox2 = quantize_bbox(
                g_npz2["bbox"], g_npz2["image_w"], g_npz2["image_h"], cfg.bbox_bin_num
            )
            vn, ve, s2v, v2a = self._nodes_visrel(g_npz2["info"].tolist(), bbox2)
            sample.vis_node_ids = np.asarray([self._tok(x) for x in vn], dtype=np.int64)
            sample.vis_edges = [tuple(e) for e in ve]
            sample.syb2vis = np.asarray(s2v, dtype=np.int64).reshape(-1, 2)
            sample.valid2all = np.asarray(v2a, dtype=np.int64)
        return sample


def collate_node_graph(samples: Sequence[Optional[NodeSample]], lv: int, ls: int, lq: int):
    """1-D-mask batch for the x-family models (`data_loader_itp_gt.py:194-219`),
    with static shapes + validity flags. Returns a dict of numpy arrays."""
    b = len(samples)
    out = {
        "vis_fea": np.zeros((b, lv, 2048), np.float32),
        "vis_mask": np.zeros((b, lv), np.float32),
        "node_ipt": np.full((b, ls), PAD, np.int64),
        "node_mask": np.zeros((b, ls), np.float32),
        "node_graph": np.zeros((b, ls, ls), np.float32),
        "q_ipt": np.full((b, lq), PAD, np.int64),
        "q_mask": np.zeros((b, lq), np.float32),
        "q_graph": np.zeros((b, lq, lq), np.float32),
        "idx_of_obj": np.full((b, lv), -1, np.int64),
        "answer": np.zeros((b,), np.int64),
        "sample_valid": np.zeros((b,), np.int32),
    }
    for i, s in enumerate(samples):
        if s is None:
            continue
        nv = min(s.vis_fea.shape[0], lv)
        nn_ = len(s.node_ids)
        nq = len(s.q_ids)
        if nn_ > ls or nq > lq:
            continue
        out["vis_fea"][i, :nv] = s.vis_fea[:nv]
        out["vis_mask"][i, :nv] = 1
        out["node_ipt"][i, :nn_] = s.node_ids
        out["node_mask"][i, :nn_] = 1
        for a, bb in s.edges:
            if a < ls and bb < ls:
                out["node_graph"][i, a, bb] = 1
        out["q_ipt"][i, :nq] = s.q_ids
        out["q_mask"][i, :nq] = 1
        for e in s.q_edges:
            if e[0] < lq and e[1] < lq:
                out["q_graph"][i, e[0], e[1]] = 1
        if s.idx_of_obj is not None:
            k = min(len(s.idx_of_obj), lv)
            out["idx_of_obj"][i, :k] = s.idx_of_obj[:k]
        out["answer"][i] = s.answer
        out["sample_valid"][i] = 1
    return out


# reference-loader-name -> NodeGraphConfig factory
def config_for_variant(variant: str, data_dir: str, **kw) -> NodeGraphConfig:
    presets = {
        "itp": dict(node_source="detected", relation_source="freq_dict",
                    position_nodes="bbox_corners", use_word_converter=False),
        "itp_gt": dict(node_source="gt", relation_source="freq_dict",
                       position_nodes="none", fea_key="fea",
                       use_word_converter=False),
        "itp_gt_loc": dict(node_source="gt", relation_source="freq_dict",
                           position_nodes="center_grid", fea_key="fea",
                           use_word_converter=False),
        "itp_gt_bbox": dict(node_source="gt_named", relation_source="freq_dict",
                            position_nodes="bbox_corners"),
        "itp_gt_bbox_gtrel": dict(node_source="gt_named", relation_source="gt",
                                  position_nodes="bbox_corners"),
        "itp_gtWpred_bbox": dict(node_source="gt_with_pred", relation_source="freq_dict",
                                 position_nodes="bbox_corners", topn=5),
        "itp_GTRelPredNode_bbox": dict(node_source="pred_node", relation_source="gt",
                                       position_nodes="bbox_corners", fea_key="x"),
        "itp_GTRelPredNode_bbox_freq": dict(node_source="pred_node",
                                            relation_source="freq_dict_geo",
                                            position_nodes="bbox_corners", fea_key="x"),
        "itp_bbox_q": dict(node_source="pred_node", relation_source="freq_dict",
                           position_nodes="bbox_corners", emit_idx_of_obj=True),
        "itp_bbox_aug": dict(node_source="pred_node", relation_source="freq_dict",
                             position_nodes="bbox_corners", label_noise_rate=0.5),
        "itp_bbox_visrel": dict(node_source="pred_node", relation_source="freq_dict",
                                position_nodes="bbox_corners",
                                emit_idx_of_obj=True, emit_visrel=True),
    }
    base = presets[variant]
    base.update(kw)
    return NodeGraphConfig(data_dir=data_dir, **base)
