"""Input marshalling: pandas DataFrames and scipy.sparse matrices.

The port's copy of the JAX package's ``boosting/compat_data.py`` (the
reference's ``python-package/gpboost/basic.py:543`` ``_data_from_pandas``
and its CSR / CSC paths, ``basic.py:847,1396``): a DataFrame's column names
become feature names, ``category`` columns become integer codes with the
training levels kept (``pandas_categorical``) so that a prediction frame
maps through the same codes, and a scipy sparse matrix is densified (the
Dataset's layout is dense ``[n, F]`` bins).

pandas is imported only where a DataFrame is given: the type checks read the
class's module name, so a numpy path never imports it (a machine without
pandas trains from arrays).
"""
from __future__ import annotations

import numpy as np


def _is_pandas_df(data) -> bool:
    cls = type(data)
    return (cls.__module__.split(".")[0] == "pandas"
            and cls.__name__ == "DataFrame")


def _is_pandas_series(data) -> bool:
    cls = type(data)
    return (cls.__module__.split(".")[0] == "pandas"
            and cls.__name__ == "Series")


def _is_scipy_sparse(data) -> bool:
    return type(data).__module__.startswith("scipy.sparse")


def marshal_label(label):
    """1-D float64 labels from a Series, a one-column DataFrame or an array
    (reference ``_label_from_pandas``, basic.py:608)."""
    if label is None:
        return None
    if _is_pandas_df(label):
        if len(label.columns) != 1:
            raise ValueError("DataFrame for label should have exactly "
                             "one column")
        label = label.iloc[:, 0]
    if _is_pandas_series(label):
        label = label.to_numpy()
    return np.asarray(label, dtype=np.float64).ravel()


def marshal_matrix(data, feature_name="auto", categorical_feature="auto",
                   pandas_categorical=None):
    """``(array [n, F] float64, feature_name or None, categorical_feature
    (sorted int indices) or None, pandas_categorical)`` of a feature matrix.

    - DataFrame: column names become feature names (``feature_name='auto'``);
      ``category`` columns become codes. Without ``pandas_categorical`` (a
      training frame) their levels are recorded, one list a categorical
      column in column order (reference basic.py:566-586); with it (a
      prediction frame) the stored levels re-map the frame, and codes of
      unseen or missing values become NaN.
    - scipy.sparse: densified to float64.
    - anything else: ``np.asarray(..., float64)``.

    ``categorical_feature`` may hold column names (resolved against the
    feature names) or indices; ``'auto'`` takes a DataFrame's ``category``
    columns and nothing for an array, as the reference does.
    """
    pd_cat_out = pandas_categorical
    if _is_pandas_df(data):
        import pandas as pd
        df = data
        if feature_name == "auto" or feature_name is None:
            feature_name = [str(c) for c in df.columns]
        cat_cols = [c for c in df.columns
                    if isinstance(df[c].dtype, pd.CategoricalDtype)]
        # the remaining columns must be numeric or bool (reference
        # _data_from_pandas's bad_indices check)
        bad = [str(c) for c in df.columns
               if c not in cat_cols
               and not (pd.api.types.is_numeric_dtype(df[c].dtype)
                        or pd.api.types.is_bool_dtype(df[c].dtype))]
        if bad:
            raise ValueError(
                "DataFrame.dtypes for data must be int, float or bool. "
                "Did not expect the data types in the following fields: "
                + ", ".join(bad))
        if cat_cols:
            if pandas_categorical is None:
                pd_cat_out = [list(df[c].cat.categories) for c in cat_cols]
                codes = {c: df[c].cat.codes for c in cat_cols}
            else:
                if len(pandas_categorical) != len(cat_cols):
                    raise ValueError(
                        "train and valid dataset categorical_feature do not "
                        "match.")
                codes = {c: df[c].cat.set_categories(levels).cat.codes
                         for c, levels in zip(cat_cols, pandas_categorical)}
            arr = np.empty((len(df), len(df.columns)), dtype=np.float64)
            for j, c in enumerate(df.columns):
                if c in codes:
                    v = codes[c].to_numpy().astype(np.float64)
                    v[v < 0] = np.nan            # unseen / missing levels
                    arr[:, j] = v
                else:
                    arr[:, j] = df[c].to_numpy(dtype=np.float64,
                                               na_value=np.nan)
        else:
            arr = df.to_numpy(dtype=np.float64, na_value=np.nan)
        if categorical_feature == "auto" or categorical_feature is None:
            cat_out = [list(df.columns).index(c) for c in cat_cols] or None
        else:
            cat_out = _resolve_cat(categorical_feature, feature_name)
        return arr, feature_name, cat_out, pd_cat_out

    if _is_scipy_sparse(data):
        arr = np.asarray(data.todense(), dtype=np.float64)
        if arr.ndim == 1:
            arr = arr[:, None]
    else:
        arr = np.asarray(data, dtype=np.float64)
    if feature_name == "auto":
        feature_name = None
    if categorical_feature == "auto" or categorical_feature is None:
        cat_out = None
    else:
        cat_out = _resolve_cat(categorical_feature, feature_name)
    return arr, feature_name, cat_out, pd_cat_out


def _resolve_cat(categorical_feature, feature_name):
    """Sorted integer indices of a list of column names and / or indices
    (reference ``Dataset.set_categorical_feature``'s name handling)."""
    out = []
    for c in categorical_feature:
        if isinstance(c, str):
            if not feature_name or c not in feature_name:
                raise ValueError(f"Unknown categorical feature name: {c!r}")
            out.append(feature_name.index(c))
        else:
            out.append(int(c))
    return sorted(set(out))
