"""Reference model-text interop (LightGBM/GPBoost ``.txt`` model format).

The port's own copy of the JAX package's ``boosting/model_text.py``: host
string formatting and parsing of the trees' numpy arrays, as there (no
device work). A text model written by either package loads in the other.

Serializer/parser for the reference's native model format
(``src/LightGBM/boosting/gbdt_model_text.cpp:314`` ``SaveModelToString`` /
``:420`` ``LoadModelFromString``; per-tree block ``io/tree.cpp:343``
``Tree::ToString`` / the ``Tree(const char*)`` ctor): models trained with
the reference load here and predict identically, and boosters trained here
save to a file the reference can serve.

Structural mapping (our flat node-id arrays <-> LightGBM split/leaf split):
LightGBM numbers the ``num_leaves-1`` internal nodes and ``num_leaves``
leaves separately, child links encode leaves as ``~leaf_idx``; our ``Tree``
keeps one node-id space with ``is_leaf`` flags and self-pointing leaf
children (jit-friendly fixed-point traversal). ``decision_type`` bit flags
(``tree.h``): 1 = categorical, 2 = default-left, bits 2-3 = missing type
(0 none / 1 zero / 2 nan). Categorical splits: ``threshold`` indexes
``cat_boundaries``; ``cat_threshold`` uint32 bitsets hold the raw integer
category values that go left.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from gpboost_tpu_torch.boosting.tree import Tree


# ---------------------------------------------------------------------------
# export
def _fmt(x):
    if isinstance(x, (int, np.integer)):
        return str(int(x))
    return np.format_float_positional(
        float(x), precision=17, trim="0", unique=True)


def _arr(vals):
    return " ".join(_fmt(v) for v in vals)


def _tree_to_text(tree: Tree, tree_idx: int, bias: float,
                  missing_bits: int, cat_value_of_bin) -> str:
    """One ``Tree=k`` block (``Tree::ToString``, io/tree.cpp:343)."""
    idx = np.arange(len(tree.is_leaf))
    internal = np.flatnonzero(~tree.is_leaf & (tree.left != idx))
    leaves = np.flatnonzero(tree.is_leaf)
    if len(leaves) == 0:  # degenerate: constant tree
        leaves = np.array([0])
    i_of = {int(n): k for k, n in enumerate(internal)}
    l_of = {int(n): k for k, n in enumerate(leaves)}

    def child(n):
        n = int(n)
        return i_of[n] if n in i_of else ~l_of[n]

    L = len(leaves)
    lines = [f"Tree={tree_idx}", f"num_leaves={L}"]
    sf, sg, th, dt, lc, rc = [], [], [], [], [], []
    cat_boundaries = [0]
    cat_threshold: List[int] = []
    num_cat = 0
    for n in internal:
        n = int(n)
        sf.append(int(tree.split_feature[n]))
        sg.append(0.0 if tree.split_gain is None
                  else float(tree.split_gain[n]))
        lc.append(child(tree.left[n]))
        rc.append(child(tree.right[n]))
        is_cat = (tree.is_categorical is not None
                  and bool(tree.is_categorical[n]))
        if is_cat:
            # raw-category bitset over the values that go LEFT
            values = [cat_value_of_bin(int(tree.split_feature[n]), b)
                      for b in np.flatnonzero(tree.cat_mask[n])]
            for v in values:
                if v != int(v):
                    raise ValueError(
                        "reference model-text categorical splits require "
                        f"integer category values; got {v!r}")
            words = max(int(max(values)) // 32 + 1, 1) if values else 1
            bits = [0] * words
            for v in values:
                bits[int(v) // 32] |= 1 << (int(v) % 32)
            th.append(float(num_cat))
            dt.append(1)
            cat_threshold.extend(bits)
            cat_boundaries.append(len(cat_threshold))
            num_cat += 1
        else:
            th.append(float(tree.threshold[n]))
            d = missing_bits << 2
            if tree.default_left is None or bool(tree.default_left[n]):
                d |= 2
            dt.append(d)
    lines.append(f"num_cat={num_cat}")
    lines.append("split_feature=" + _arr(sf))
    lines.append("split_gain=" + _arr(sg))
    lines.append("threshold=" + _arr(th))
    lines.append("decision_type=" + _arr(dt))
    lines.append("left_child=" + _arr(lc))
    lines.append("right_child=" + _arr(rc))
    lines.append("leaf_value="
                 + _arr([float(tree.leaf_value[n]) + bias for n in leaves]))
    counts = (tree.node_count if tree.node_count is not None
              else np.zeros(len(tree.is_leaf)))
    lines.append("leaf_weight=" + _arr([float(counts[n]) for n in leaves]))
    lines.append("leaf_count=" + _arr([int(counts[n]) for n in leaves]))
    lines.append("internal_value=" + _arr([0.0] * len(internal)))
    lines.append("internal_weight="
                 + _arr([float(counts[n]) for n in internal]))
    lines.append("internal_count=" + _arr([int(counts[n]) for n in internal]))
    if num_cat > 0:
        lines.append("cat_boundaries=" + _arr(cat_boundaries))
        lines.append("cat_threshold=" + _arr(cat_threshold))
    lines.append("is_linear=0")
    lines.append(f"shrinkage={_fmt(tree.shrinkage)}")
    return "\n".join(lines) + "\n\n"


_OBJECTIVE_STRINGS = {
    "regression": "regression",
    "regression_l1": "regression_l1",
    "huber": "huber", "fair": "fair", "poisson": "poisson",
    "gamma": "gamma", "tweedie": "tweedie", "quantile": "quantile",
    "mape": "mape", "binary": "binary sigmoid:1",
    "cross_entropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda",
    "lambdarank": "lambdarank",
    "rank_xendcg": "rank_xendcg",
}


def booster_to_text(bst, num_iteration: Optional[int] = None) -> str:
    """Serialize a Booster to the reference's text model format
    (``GBDT::SaveModelToString``, gbdt_model_text.cpp:314)."""
    feature_names = bst.feature_name()
    F = len(feature_names)
    obj = _OBJECTIVE_STRINGS.get(bst.objective_name, bst.objective_name)
    if bst.num_models > 1:
        obj = f"{bst.objective_name} num_class:{bst.num_class}"
    limit = (len(bst.trees) if num_iteration in (None, -1, 0)
             else min(num_iteration * bst.num_models, len(bst.trees)))
    # feature_infos: [min:max] per feature (the loader checks the count)
    if bst.train_set is not None and bst.train_set.raw_data is not None:
        rd = bst.train_set.raw_data
        infos = []
        for f in range(F):
            col = rd[:, f]
            fin = col[np.isfinite(col)]
            if f in (bst.train_set.categorical_feature or []):
                vals = sorted(int(v) for v in np.unique(fin))
                infos.append(":".join(str(v) for v in vals) or "none")
            elif len(fin):
                infos.append(f"[{_fmt(fin.min())}:{_fmt(fin.max())}]")
            else:
                infos.append("none")
    else:
        infos = ["[-1e308:1e308]"] * F
    header = [
        "tree", "version=v3", f"num_class={bst.num_class}",
        f"num_tree_per_iteration={bst.num_models}", "label_index=0",
        f"max_feature_idx={F - 1}", f"objective={obj}",
        "feature_names=" + " ".join(feature_names),
        "feature_infos=" + " ".join(infos), "",
    ]
    missing_bits = 2  # NaN
    if not bool(bst.params.get("use_missing", True)):
        missing_bits = 0
    elif bool(bst.params.get("zero_as_missing", False)):
        missing_bits = 1
    cat_maps = bst._cat_maps()
    inv = {int(f): {b: v for v, b in mp.items()}
           for f, mp in cat_maps.items()}

    def cat_value_of_bin(f, b):
        return inv.get(f, {}).get(b, b)

    body = []
    for k in range(limit):
        # the boost-from-average base belongs to the first tree's leaves
        # (reference GBDT::BoostFromAverage bakes it into tree 0)
        bias = float(bst.init_score[k]) if k < bst.num_models else 0.0
        body.append(_tree_to_text(bst.trees[k], k, bias, missing_bits,
                                  cat_value_of_bin))
    tail = ["end of trees", "", "feature_importances:", "", "parameters:",
            "end of parameters", "", "pandas_categorical:"
            + _pandas_cat_json(bst), ""]
    return "\n".join(header) + "".join(body) + "\n".join(tail)


def _pandas_cat_json(bst) -> str:
    import json
    pc = bst._pandas_categorical_levels()
    return json.dumps(pc if pc is not None else None)


# ---------------------------------------------------------------------------
# import
def looks_like_model_text(s: str) -> bool:
    head = s.lstrip()[:40]
    return head.startswith("tree") and "version=" in s[:200]


def _parse_tree_block(kv: dict) -> Tree:
    L = int(kv["num_leaves"])
    num_cat = int(kv.get("num_cat", 0))
    if L <= 1:
        lv = float(kv["leaf_value"].split()[0]) if kv.get("leaf_value") else 0.0
        one = np.zeros(1)
        return Tree(split_feature=np.zeros(1, np.int32),
                    threshold=one.copy(), threshold_bin=np.zeros(1, np.int32),
                    left=np.zeros(1, np.int32), right=np.zeros(1, np.int32),
                    leaf_value=np.array([lv]), is_leaf=np.ones(1, bool),
                    node_count=one.copy(), num_leaves=1, max_depth_used=1,
                    shrinkage=float(kv.get("shrinkage", 1.0)))

    def floats(key, default=None):
        if key not in kv:
            return default
        return np.array([float(x) for x in kv[key].split()], np.float64)

    def ints(key, default=None):
        v = floats(key)
        return default if v is None else v.astype(np.int64)

    I = L - 1
    split_feature = ints("split_feature")
    threshold = floats("threshold")
    decision_type = ints("decision_type", np.zeros(I, np.int64))
    left_child = ints("left_child")
    right_child = ints("right_child")
    leaf_value = floats("leaf_value")
    leaf_count = floats("leaf_count", np.zeros(L))
    internal_count = floats("internal_count", np.zeros(I))
    split_gain = floats("split_gain", np.zeros(I))
    cat_boundaries = ints("cat_boundaries", None)
    cat_threshold = ints("cat_threshold", None)

    M = 2 * L - 1
    # node ids: internal k -> k; leaf j -> I + j
    def nid(c):
        return int(c) if c >= 0 else I + (~int(c))

    is_cat_split = (decision_type & 1).astype(bool)
    max_cat_val = 1
    if num_cat > 0:
        for k in range(I):
            if is_cat_split[k]:
                ci = int(threshold[k])
                words = cat_threshold[cat_boundaries[ci]:
                                      cat_boundaries[ci + 1]]
                max_cat_val = max(max_cat_val, 32 * len(words))
    B = max_cat_val
    t = Tree(split_feature=np.zeros(M, np.int32),
             threshold=np.zeros(M), threshold_bin=np.zeros(M, np.int32),
             left=np.arange(M, dtype=np.int32),
             right=np.arange(M, dtype=np.int32),
             leaf_value=np.zeros(M), is_leaf=np.zeros(M, bool),
             node_count=np.zeros(M),
             is_categorical=np.zeros(M, bool),
             cat_mask=np.zeros((M, B), bool),
             split_gain=np.zeros(M), default_left=np.ones(M, bool),
             num_leaves=L, shrinkage=float(kv.get("shrinkage", 1.0)))
    for k in range(I):
        t.split_feature[k] = split_feature[k]
        t.split_gain[k] = split_gain[k]
        t.left[k] = nid(left_child[k])
        t.right[k] = nid(right_child[k])
        t.default_left[k] = bool(decision_type[k] & 2)
        if is_cat_split[k]:
            t.is_categorical[k] = True
            ci = int(threshold[k])
            words = cat_threshold[cat_boundaries[ci]:cat_boundaries[ci + 1]]
            for wi, w in enumerate(words):
                for b in range(32):
                    if (int(w) >> b) & 1:
                        t.cat_mask[k, 32 * wi + b] = True
        else:
            t.threshold[k] = threshold[k]
        t.node_count[k] = internal_count[k]
    for j in range(L):
        t.leaf_value[I + j] = leaf_value[j]
        t.is_leaf[I + j] = True
        t.node_count[I + j] = leaf_count[j]
    # depth for the fixed-point traversal bound
    depth = np.ones(M, np.int32)
    for k in range(I):  # parents precede children in LightGBM numbering
        for c in (int(t.left[k]), int(t.right[k])):
            depth[c] = depth[k] + 1
    t.max_depth_used = int(depth.max())
    if not t.is_categorical.any():
        t.is_categorical = None
        t.cat_mask = None
    return t


_OBJECTIVE_PARSE = {
    "regression": "regression", "regression_l2": "regression",
    "regression_l1": "regression_l1", "huber": "huber", "fair": "fair",
    "poisson": "poisson", "gamma": "gamma", "tweedie": "tweedie",
    "quantile": "quantile", "mape": "mape", "binary": "binary",
    "cross_entropy": "cross_entropy", "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda",
    "xentlambda": "cross_entropy_lambda",
    "multiclass": "multiclass", "softmax": "multiclass",
    "multiclassova": "multiclassova", "lambdarank": "lambdarank",
    "rank_xendcg": "rank_xendcg", "custom": "regression",
}


def parse_model_text(text: str) -> dict:
    """Parse a reference ``.txt`` model into the Booster model dict consumed
    by ``Booster._load_dict`` (``GBDT::LoadModelFromString``,
    gbdt_model_text.cpp:420)."""
    import json
    lines = text.splitlines()
    header = {}
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        if line.startswith("Tree="):
            break
        if "=" in line:
            k, v = line.split("=", 1)
            header[k] = v
        elif line:
            header[line] = ""
        i += 1
    trees = []
    while i < len(lines):
        line = lines[i].strip()
        if line.startswith("Tree="):
            i += 1
            kv = {}
            while i < len(lines) and lines[i].strip():
                k, v = lines[i].split("=", 1)
                kv[k.strip()] = v.strip()
                i += 1
            trees.append(_parse_tree_block(kv))
        elif line.startswith("end of trees"):
            break
        else:
            i += 1
    pandas_categorical = None
    for line in reversed(lines):
        if line.startswith("pandas_categorical:"):
            try:
                pandas_categorical = json.loads(
                    line[len("pandas_categorical:"):])
            except json.JSONDecodeError:
                pass
            break
    obj_str = header.get("objective", "regression").split()
    objective = _OBJECTIVE_PARSE.get(obj_str[0] if obj_str else "regression",
                                     "regression")
    num_class = int(header.get("num_class", 1))
    num_models = int(header.get("num_tree_per_iteration", num_class))
    feature_names = header.get("feature_names", "").split()
    # identity category maps: the text format's categorical bitsets index
    # raw integer category values, so bin == value
    cat_maps = {}
    for t in trees:
        if t.is_categorical is None:
            continue
        for n in np.flatnonzero(t.is_categorical):
            f = int(t.split_feature[n])
            mp = cat_maps.setdefault(str(f), {})
            for v in np.flatnonzero(t.cat_mask[n]):
                mp[str(float(v))] = int(v)
    params = {"objective": objective, "num_class": num_class}
    if "average_output" in header:
        params["boosting"] = "rf"
    return {
        "version": "gpboost_tpu_v1",
        "params": params,
        "objective": objective,
        "boosting_type": params.get("boosting", "gbdt"),
        "num_class": num_class,
        "num_models": num_models,
        "init_score": [0.0] * num_models,
        "trees": [t.to_dict() for t in trees],
        "best_iteration": -1,
        "cat_maps": cat_maps or None,
        "attrs": {},
        "feature_names": feature_names or None,
        "pandas_categorical": pandas_categorical,
    }
