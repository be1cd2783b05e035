"""Training callbacks (reference ``python-package/gpboost/callback.py``).

The port's own copy of the JAX package's ``boosting/callback.py``: the same
callbacks with the same ``order`` values, so that ``train`` runs them in the
same sequence (``print_evaluation`` 10, ``reset_parameter`` 15,
``record_evaluation`` 20, ``early_stopping`` 30).
"""
from __future__ import annotations

import collections
from typing import Callable, List

CallbackEnv = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"])


class EarlyStopException(Exception):
    def __init__(self, best_iteration, best_score):
        self.best_iteration = best_iteration
        self.best_score = best_score


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True) -> Callable:
    """Early stopping callback (``callback.py:146``)."""
    best_score: List[float] = []
    best_iter: List[int] = []
    best_score_list: List = []
    cmp_op: List[Callable] = []

    def _init(env):
        if not env.evaluation_result_list:
            raise ValueError(
                "For early stopping, at least one validation set is required")
        for name, metric, value, higher_better in env.evaluation_result_list:
            best_iter.append(0)
            best_score_list.append(None)
            if higher_better:
                best_score.append(float("-inf"))
                cmp_op.append(lambda a, b: a > b)
            else:
                best_score.append(float("inf"))
                cmp_op.append(lambda a, b: a < b)

    def _callback(env):
        if not best_score:
            _init(env)
        for i, (name, metric, value, higher_better) in enumerate(
                env.evaluation_result_list):
            if best_score_list[i] is None or cmp_op[i](value, best_score[i]):
                best_score[i] = value
                best_iter[i] = env.iteration
                best_score_list[i] = env.evaluation_result_list
            elif env.iteration - best_iter[i] >= stopping_rounds:
                if verbose:
                    from gpboost_tpu_torch.utils.log import log_info
                    log_info(f"Early stopping, best iteration is: "
                          f"[{best_iter[i] + 1}]")
                raise EarlyStopException(best_iter[i], best_score_list[i])
            if first_metric_only:
                break

    _callback.order = 30
    return _callback


def record_evaluation(eval_result: dict) -> Callable:
    """Record eval results into a nested dict (``callback.py:51``)."""

    def _callback(env):
        for name, metric, value, _ in env.evaluation_result_list:
            eval_result.setdefault(name, collections.OrderedDict())
            eval_result[name].setdefault(metric, [])
            eval_result[name][metric].append(value)

    _callback.order = 20
    return _callback


def print_evaluation(period: int = 1) -> Callable:
    def _callback(env):
        if period > 0 and env.evaluation_result_list and \
                (env.iteration + 1) % period == 0:
            msgs = [f"{name}'s {metric}: {value:g}"
                    for name, metric, value, _ in env.evaluation_result_list]
            from gpboost_tpu_torch.utils.log import log_info
            log_info(f"[{env.iteration + 1}]\t" + "\t".join(msgs))

    _callback.order = 10
    return _callback


log_evaluation = print_evaluation


def reset_parameter(**kwargs) -> Callable:
    """Reset parameters (e.g. learning_rate schedule) per iteration."""

    def _callback(env):
        for key, value in kwargs.items():
            if callable(value):
                new_val = value(env.iteration - env.begin_iteration)
            elif isinstance(value, list):
                new_val = value[env.iteration - env.begin_iteration]
            else:
                new_val = value
            if key in ("learning_rate", "shrinkage_rate", "eta"):
                env.model.learning_rate = float(new_val)
            else:
                env.model.params[key] = new_val

    _callback.order = 15
    return _callback
