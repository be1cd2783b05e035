"""Model -> standalone C source export (``task=convert_model``).

The port's own copy of the JAX package's ``boosting/convert.py`` (host
string generation, no device work): the equivalent of the reference's
if-else converter
(``Tree::ToIfElse`` ``src/LightGBM/io/tree.cpp:527``,
``GBDT::SaveModelToIfElse`` ``src/LightGBM/boosting/gbdt_model_text.cpp:288``;
config keys ``convert_model`` / ``convert_model_language``,
``include/LightGBM/config.h:802-813``): emits compilable, dependency-free
C/C++ source with one ``predict_tree_K`` function per tree plus
``predict_raw`` / ``predict`` entry points (including the objective's
response transform), so models can be deployed without the framework.
"""
from __future__ import annotations

import numpy as np

_HEADER = """/* Generated by gpboost_tpu_torch convert_model — standalone predictor.
 * API:
 *   void predict_raw(const double* row, double* out);  // raw scores
 *   void predict(const double* row, double* out);      // response scale
 * `row` has NUM_FEATURES doubles; `out` has NUM_OUTPUTS doubles.
 * Missing values: pass NaN (routed by each node's learned default
 * direction, matching training).
 */
#include <math.h>

#define NUM_FEATURES %(num_features)d
#define NUM_OUTPUTS %(num_outputs)d
"""


def _fmt(x: float) -> str:
    if np.isposinf(x):
        return "INFINITY"
    if np.isneginf(x):
        return "-INFINITY"
    return repr(float(x))


def _node_code(tree, node: int, indent: str, cat_values_per_node) -> str:
    """Recursive if-else for one node (reference ``Tree::NodeToIfElse``,
    io/tree.cpp:586)."""
    if tree.is_leaf[node]:
        expr = _fmt(tree.leaf_value[node])
        if tree.lin_features is not None:
            for k in range(tree.lin_features.shape[1]):
                f = int(tree.lin_features[node, k])
                if f >= 0:
                    expr += (f" + {_fmt(tree.lin_coefs[node, k])}"
                             f" * arr[{f}]")
        return f"{indent}return {expr};\n"
    f = int(tree.split_feature[node])
    if tree.is_categorical is not None and tree.is_categorical[node]:
        vals = cat_values_per_node[node]
        checks = " || ".join(f"arr[{f}] == {_fmt(v)}" for v in vals)
        if not checks:
            checks = "0"
        cond = f"({checks})"
    else:
        # value <= threshold goes left; NaN routes by the learned default
        # direction (``default_left``, io/tree.cpp NumericalDecision)
        cond = f"(arr[{f}] <= {_fmt(tree.threshold[node])})"
        if tree.default_left is not None and tree.default_left[node]:
            cond = f"(isnan(arr[{f}]) || {cond[1:-1]})"
    out = f"{indent}if {cond} {{\n"
    out += _node_code(tree, int(tree.left[node]), indent + "  ",
                      cat_values_per_node)
    out += f"{indent}}} else {{\n"
    out += _node_code(tree, int(tree.right[node]), indent + "  ",
                      cat_values_per_node)
    out += f"{indent}}}\n"
    return out


def _tree_function(tree, index: int, cat_maps) -> str:
    # left-category raw values per categorical node
    cat_values = {}
    if tree.is_categorical is not None:
        for node in np.flatnonzero(tree.is_categorical):
            f = int(tree.split_feature[node])
            lookup = (cat_maps or {}).get(f, (cat_maps or {}).get(str(f)))
            if lookup is None:
                raise ValueError(
                    f"tree {index} splits categorically on feature {f} but "
                    "no category map is available")
            mask = tree.cat_mask[node]
            vals = []
            for raw, b in lookup.items():
                if mask[int(b)]:
                    vals.append(float(raw))
            cat_values[node] = sorted(vals)
    body = _node_code(tree, 0, "  ", cat_values)
    return (f"static double predict_tree_{index}(const double* arr) {{\n"
            f"{body}}}\n")


_TRANSFORMS = {
    "binary": "out[i] = 1.0 / (1.0 + exp(-{sig} * out[i]));",
    "cross_entropy": "out[i] = 1.0 / (1.0 + exp(-out[i]));",
    "poisson": "out[i] = exp(out[i]);",
    "gamma": "out[i] = exp(out[i]);",
    "tweedie": "out[i] = exp(out[i]);",
    "multiclassova": "out[i] = 1.0 / (1.0 + exp(-{sig} * out[i]));",
}


def booster_to_c(booster, num_iteration=None) -> str:
    """Generate standalone C source for ``booster`` (``convert_model``)."""
    trees = booster.trees
    num_models = booster.num_models
    if num_iteration not in (None, -1, 0):
        trees = trees[:min(int(num_iteration) * num_models, len(trees))]
    num_features = booster.num_feature()
    parts = [_HEADER % {"num_features": num_features,
                        "num_outputs": num_models}]
    cat_maps = booster._cat_maps()
    for i, tree in enumerate(trees):
        parts.append(_tree_function(tree, i, cat_maps))

    init = ", ".join(_fmt(v) for v in np.atleast_1d(booster.init_score))
    parts.append(
        f"static const double init_score[NUM_OUTPUTS] = {{{init}}};\n")
    lines = ["void predict_raw(const double* arr, double* out) {",
             "  int i;",
             "  for (i = 0; i < NUM_OUTPUTS; ++i) out[i] = init_score[i];"]
    for k in range(len(trees)):
        m = k % num_models
        lines.append(f"  out[{m}] += predict_tree_{k}(arr);")
    if getattr(booster, "boosting_type", "gbdt") == "rf" and trees:
        n_iter = len(trees) // num_models
        lines.append("  for (i = 0; i < NUM_OUTPUTS; ++i)")
        lines.append(f"    out[i] = init_score[i]"
                     f" + (out[i] - init_score[i]) / {n_iter}.0;")
    lines.append("}\n")
    parts.append("\n".join(lines))

    obj = booster.objective_name
    sig = getattr(booster.objective, "sigmoid", 1.0)
    body = ""
    if obj in ("multiclass", "softmax"):
        body = (
            "  double m = out[0], s = 0.0;\n"
            "  for (i = 1; i < NUM_OUTPUTS; ++i) if (out[i] > m) m = out[i];\n"
            "  for (i = 0; i < NUM_OUTPUTS; ++i)"
            " { out[i] = exp(out[i] - m); s += out[i]; }\n"
            "  for (i = 0; i < NUM_OUTPUTS; ++i) out[i] /= s;\n")
    elif obj in _TRANSFORMS:
        tmpl = _TRANSFORMS[obj].format(sig=_fmt(sig))
        body = f"  for (i = 0; i < NUM_OUTPUTS; ++i) {tmpl}\n"
    parts.append(
        "void predict(const double* arr, double* out) {\n"
        "  int i; (void)i;\n"
        "  predict_raw(arr, out);\n"
        f"{body}}}\n")
    return "\n".join(parts)


def save_model_to_c(booster, filename: str, num_iteration=None) -> None:
    with open(filename, "w") as f:
        f.write(booster_to_c(booster, num_iteration))
