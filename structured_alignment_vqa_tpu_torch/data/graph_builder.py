"""Scene-graph -> super-node macro graph construction: the port's own copy
of the TPU package's ``data/graph_builder.py`` (negatives are drawn in the
same order from the same generator, so samples match it exactly).

Behavioral equivalent of ``convert_graph`` in the two production loaders:

* only_obj=True  — `data_loader_itp_bbox_super_node_onlyobj.py:123-243`
* only_obj=False — `dataloader/data_loader_itp_bbox_super_node.py:123-252`

Given detected region info (top object-class ids per region, attribute ids),
quantized bboxes, and the GT scene graph, build:

* macro nodes: one PAD "super node" per object, shared attribute nodes,
  (optionally) bbox-corner position nodes ``x{i}y{j}``, and relation nodes —
  top-1 named relations (only_obj) or per-ordered-pair ``__empty__`` nodes
  (full variant);
* undirected edges object<->attr / object<->position, directed
  obj_i -> rel -> obj_j;
* micro candidates: topN positive object labels (GT name first, then
  non-duplicate detected labels) and sampled negatives;
* (full variant) micro relation candidates with 5-tuple loc records
  ``[obj_i, obj_j, rel_cat, macro_rel_loc, micro_rel_loc]``.

Determinism: the reference samples negatives from the global ``random`` state;
here sampling uses an explicit ``numpy`` Generator passed by the caller, so a
(seed, sample index) pair reproduces a sample exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

PAD_NODE = object()  # sentinel for the PAD super node (reference uses id 400000)


@dataclasses.dataclass
class MacroGraph:
    """Everything ``convert_graph`` returns, as named fields."""

    nodes: List[object]               # str tokens or PAD_NODE sentinels
    edges: List[Tuple[int, int]]
    obj_locs: List[int]               # super-node row per object
    micro_pos_obj: List[List[str]]    # per object: topN candidate labels
    micro_neg_obj: List[List[str]]
    # full (only_obj=False) variant only:
    micro_pos_rel: List[object] = dataclasses.field(default_factory=list)
    micro_neg_rel: List[object] = dataclasses.field(default_factory=list)
    micro_pos_rel_loc: List[List[int]] = dataclasses.field(default_factory=list)
    micro_neg_rel_loc: List[List[int]] = dataclasses.field(default_factory=list)


def _spatial_correct(r_name: str, bbox, i: int, j: int) -> str:
    """Flip left/right/top/bottom to match actual bbox geometry
    (`...onlyobj.py:223-237`)."""
    xi = float(bbox[i][0]) + float(bbox[i][2])
    xj = float(bbox[j][0]) + float(bbox[j][2])
    yi = float(bbox[i][1]) + float(bbox[i][3])
    yj = float(bbox[j][1]) + float(bbox[j][3])
    if "left" in r_name and xi > xj:
        r_name = "right"
    if "right" in r_name and xi < xj:
        r_name = "left"
    if "bottom" in r_name and yi < yj:
        r_name = "top"
    if "top" in r_name and yi > yj:
        r_name = "bottom"
    return r_name


class SuperNodeGraphBuilder:
    """Stateless builder configured once per dataset."""

    def __init__(
        self,
        vg_classes: Sequence[str],
        vg_attrs: Sequence[str],
        gt_relations: Dict[str, str],
        topn: int,
        with_loc: bool = True,
        only_obj: bool = True,
        pred_rel: bool = False,
    ):
        self.vg_classes = list(vg_classes)
        self.vg_attrs = list(vg_attrs)
        self.gt_relations = dict(gt_relations)
        # de-duplicated relation vocabulary; index order defines rel_cat ids
        # (`...super_node.py:75-76,226`)
        self.gt_relation_clean = list(dict.fromkeys(gt_relations.values()))
        self.num_relations = len(self.gt_relation_clean)
        self.topn = topn
        self.with_loc = with_loc
        self.only_obj = only_obj
        self.pred_rel = pred_rel
        self._stripped_classes = [c.replace(" ", "") for c in self.vg_classes]
        self._stripped_attrs = [a.replace(" ", "") for a in self.vg_attrs]
        # negative-sampling acceleration: name -> every index holding it
        # (class lists contain duplicate stripped names)
        self._class_arr = np.asarray(self._stripped_classes, dtype=object)
        self._name2idx: Dict[str, np.ndarray] = {}
        for i, c in enumerate(self._stripped_classes):
            self._name2idx.setdefault(c, []).append(i)
        self._name2idx = {k: np.asarray(v) for k, v in self._name2idx.items()}
        # candidate tuples repeat heavily (~10 questions per image share the
        # same detections); memoize the complement pool per tuple
        self._pool_cache: Dict[tuple, np.ndarray] = {}
        # pair-relation lookup acceleration: the reference probes its
        # frequency dictionary with "name_i,name_j" for every ordered object
        # pair (`...onlyobj.py:198-241`); indexing by first name lets the
        # O(n_obj^2) scan skip a whole inner loop when name_i starts no
        # relation — the common case, since the dict covers a sliver of the
        # 1600^2 pair space
        self._rel_by_first: Dict[str, Dict[str, str]] = {}
        for pair_key, rel in self.gt_relations.items():
            a, _, b = pair_key.partition(",")
            self._rel_by_first.setdefault(a, {})[b] = rel

    def _sample_negatives(self, cands, rng: np.random.Generator):
        """Uniform sample without replacement from classes \\ cands.

        Distribution-equivalent to the reference's
        ``random.sample([c for c in classes if c not in cands], topn)``
        (`...onlyobj.py:148-152`) but O(classes) in C instead of a Python list
        scan per object — the single hottest line of the host pipeline.
        """
        key = tuple(cands)
        pool = self._pool_cache.get(key)
        if pool is None:
            mask = np.ones(len(self._class_arr), bool)
            for name in cands:
                hit = self._name2idx.get(name)
                if hit is not None:
                    mask[hit] = False
            pool = np.flatnonzero(mask)
            if len(self._pool_cache) > 4096:
                self._pool_cache.clear()
            self._pool_cache[key] = pool
        k = min(self.topn, len(pool))
        if k == 0:
            return []
        # draw-with-rejection: k << len(pool) so collisions are rare; keeping
        # the first k *distinct* draws is uniform-without-replacement. Fast
        # path: one vector draw, accepted outright when already distinct
        # (>99% of draws at production pool sizes).
        draw = rng.integers(0, len(pool), size=k)
        first = draw.tolist()
        if len(set(first)) == k:
            return self._class_arr[pool[draw]].tolist()
        seen: Dict[int, None] = {}
        for v in first:
            seen.setdefault(v, None)
        while len(seen) < k:
            for v in rng.integers(0, len(pool), size=k - len(seen)):
                seen.setdefault(int(v), None)
        picks = np.fromiter(seen.keys(), dtype=np.int64)
        return list(self._class_arr[pool[picks]])

    # ---- candidate construction -------------------------------------------------

    def _object_candidates(self, data_info, gt_graph, rng: np.random.Generator):
        """Per object: GT label + detected labels (topN positives), sampled
        negatives, shared attribute label, and (only_obj) correctness flags."""
        pos, neg, attrs, correct = [], [], [], []
        objects = data_info["objects_id"]
        attr_ids = data_info["attrs_id"]
        for obj_idxs, obj_key, attr_idx in zip(objects, gt_graph["objects"], attr_ids):
            gt_name = gt_graph["objects"][obj_key]["name"].strip().replace(" ", "")
            cands = [gt_name]
            corr = 0
            for oi in obj_idxs:
                if len(cands) >= self.topn:
                    break
                if oi < len(self._stripped_classes):
                    det = self._stripped_classes[oi]
                    if det != gt_name:
                        cands.append(det)
                    else:
                        corr = 1
            correct.append(corr)
            attrs.append(self._stripped_attrs[attr_idx])
            pos.append(cands)
            # reference: random.sample([c for c in classes if c not in cands],
            # topn) — raises when the pool is smaller (only possible with tiny
            # class vocabularies) and the bare except drops the sample; we draw
            # what exists and let the ragged-candidates policy decide
            # (see docs/PARITY.md)
            neg.append(self._sample_negatives(cands, rng))
        return pos, neg, attrs, correct

    # ---- macro skeleton ---------------------------------------------------------

    def _build_skeleton(self, num_obj, attrs, bbox):
        """Super nodes + shared attribute nodes + position nodes
        (`...onlyobj.py:154-196`)."""
        nodes: List[object] = []
        edges: List[Tuple[int, int]] = []
        obj_locs: List[int] = []
        attr2idx: Dict[str, int] = {}
        pos2idx: Dict[str, int] = {}
        for i in range(num_obj):
            loc = len(nodes)
            nodes.append(PAD_NODE)
            obj_locs.append(loc)

            a = attrs[i]
            if a in attr2idx:
                ai = attr2idx[a]
            else:
                ai = len(nodes)
                attr2idx[a] = ai
                nodes.append(a)
            edges.append((loc, ai))
            edges.append((ai, loc))

            if self.with_loc:
                for corner in ((0, 1), (2, 3)):
                    name = f"x{int(bbox[i][corner[0]])}y{int(bbox[i][corner[1]])}"
                    if name in pos2idx:
                        pi = pos2idx[name]
                    else:
                        pi = len(nodes)
                        pos2idx[name] = pi
                        nodes.append(name)
                    edges.append((loc, pi))
                    edges.append((pi, loc))
        return nodes, edges, obj_locs

    # ---- relation nodes ---------------------------------------------------------

    def _top1_relations(self, nodes, edges, obj_locs, pos_obj, correct, bbox):
        """only_obj variant: named relation nodes for pairs found in the
        frequency dictionary, shared per relation name, with the spatial
        correction applied on first sight (`...onlyobj.py:198-241`)."""
        rel2pos: Dict[str, int] = {}
        num_obj = len(obj_locs)
        if self.pred_rel:
            # use the top *detected* label when the detector missed the
            # GT class. (The reference indexes [1] unconditionally here
            # and relies on its bare except to drop samples whose
            # candidate list has a single entry, `...onlyobj.py:202-210`;
            # we fall back to [0] instead of dropping.)
            rep = [
                p[0] if c == 1 else p[min(1, len(p) - 1)]
                for p, c in zip(pos_obj, correct)
            ]
        else:
            rep = [p[0] for p in pos_obj]
        for i in range(num_obj):
            sub = self._rel_by_first.get(rep[i])
            if sub is None:
                continue
            for j in range(num_obj):
                rel = sub.get(rep[j])
                if rel is None:
                    continue
                r_name = rel.replace(" ", "")
                if r_name in rel2pos:
                    pos_rel = rel2pos[r_name]
                else:
                    pos_rel = len(nodes)
                    rel2pos[r_name] = pos_rel
                    r_name = _spatial_correct("".join(r_name.split()), bbox, i, j)
                    nodes.append(r_name)
                edges.append((obj_locs[i], pos_rel))
                edges.append((pos_rel, obj_locs[j]))

    def _pairwise_relations(self, nodes, edges, obj_locs, pos_obj, rng):
        """Full variant: an ``__empty__`` macro node per ordered object pair,
        micro relation candidates for every candidate-label pair, and sampled
        negatives (`...super_node.py:194-250`)."""
        num_obj = len(obj_locs)
        pair2loc: Dict[Tuple[int, int], int] = {}
        for i in range(num_obj):
            for j in range(num_obj):
                if i == j:
                    continue
                loc = len(nodes)
                pair2loc[(i, j)] = loc
                nodes.append("__empty__")
                edges.append((obj_locs[i], loc))
                edges.append((loc, obj_locs[j]))

        micro_pos: List[object] = []
        micro_neg: List[object] = []
        pos_loc: List[List[int]] = []
        neg_loc: List[List[int]] = []
        micro_idx = 0
        for i in range(num_obj):
            for j in range(num_obj):
                if i == j:
                    continue
                pair_cats = []
                pair_count = 0
                for a in pos_obj[i]:
                    for b in pos_obj[j]:
                        key = f"{a},{b}"
                        if key in self.gt_relations:
                            rel = self.gt_relations[key]
                            cat = self.gt_relation_clean.index(rel)
                            micro_pos.append(rel.replace(" ", ""))
                        else:
                            cat = self.num_relations  # PAD relation category
                            micro_pos.append(PAD_NODE)
                        pos_loc.append([i, j, cat, pair2loc[(i, j)], micro_idx])
                        pair_cats.append(cat)
                        micro_idx += 1
                        pair_count += 1
                # negatives: distinct relation categories not positive for
                # this pair, same count as positives
                pool = [c for c in range(self.num_relations) if c not in pair_cats]
                pick = rng.choice(len(pool), size=min(pair_count, len(pool)), replace=False)
                for k in pick:
                    cat = pool[k]
                    neg_loc.append([i, j, cat, pair2loc[(i, j)], -1])
                    # note: the reference does NOT space-strip negative
                    # relation tokens (`...super_node.py:247`), unlike
                    # positives — preserved for vocabulary-lookup parity
                    micro_neg.append(self.gt_relation_clean[cat])
        return micro_pos, micro_neg, pos_loc, neg_loc

    # ---- entry ------------------------------------------------------------------

    def convert(self, data_info, bbox, gt_graph, rng: np.random.Generator) -> MacroGraph:
        pos_obj, neg_obj, attrs, correct = self._object_candidates(data_info, gt_graph, rng)
        num_obj = len(pos_obj)
        nodes, edges, obj_locs = self._build_skeleton(num_obj, attrs, bbox)

        g = MacroGraph(
            nodes=nodes, edges=edges, obj_locs=obj_locs,
            micro_pos_obj=pos_obj, micro_neg_obj=neg_obj,
        )
        if self.only_obj:
            self._top1_relations(nodes, edges, obj_locs, pos_obj, correct, bbox)
        else:
            (g.micro_pos_rel, g.micro_neg_rel,
             g.micro_pos_rel_loc, g.micro_neg_rel_loc) = self._pairwise_relations(
                nodes, edges, obj_locs, pos_obj, rng
            )
        return g


def quantize_bbox(bbox: np.ndarray, image_w, image_h, bin_num: int) -> np.ndarray:
    """Normalize bbox by image size and floor into ``bin_num`` bins
    (`...onlyobj.py:273-281`)."""
    b = np.array(bbox, dtype=np.float64, copy=True)
    if b.ndim == 1:
        b = b.reshape(1, -1)
    b[:, 0] /= image_w
    b[:, 2] /= image_w
    b[:, 1] /= image_h
    b[:, 3] /= image_h
    return np.floor(b * bin_num).astype(np.int32)
