"""Training engine: ``train`` (reference ``engine.py:21``)."""
from __future__ import annotations

from gpboost_tpu_torch import config as cfg_mod
from gpboost_tpu_torch.boosting.booster import Booster
from gpboost_tpu_torch.boosting.dataset import Dataset


def train(params: dict, train_set: Dataset, num_boost_round: int = 100,
          gp_model=None, valid_sets=None, valid_names=None, fobj=None,
          feval=None, init_model=None, early_stopping_rounds=None,
          evals_result=None, verbose_eval: bool = True, learning_rates=None,
          callbacks=None, train_gp_model_cov_pars: bool = True) -> Booster:
    """Train a (GP)Boost model (mirrors ``gpboost.train``, ``engine.py:21``)
    with the host-driven loop: ``num_boost_round`` calls of
    ``Booster.update``. With a ``gp_model`` this is the GPBoost algorithm
    (gaussian likelihood) or the LaGaBoost algorithm (the others; the
    objective names no distribution then, e.g. ``"binary"``), the GP's
    parameters refitted every round with its optimizer settings
    (``gp_model.set_optim_params``).

    Validation sets, callbacks, early stopping, custom objectives / metrics
    and continued training are not ported (ROADMAP.md Queue A, item 18) and
    raise; the device-resident loop is item 10.
    """
    given = {"valid_sets": valid_sets, "valid_names": valid_names,
             "fobj": fobj, "feval": feval, "init_model": init_model,
             "early_stopping_rounds": early_stopping_rounds,
             "evals_result": evals_result, "learning_rates": learning_rates,
             "callbacks": callbacks}
    unported = [k for k, v in given.items() if v is not None and v != []]
    if unported:
        raise NotImplementedError(
            f"train({', '.join(unported)}=...) is not ported to "
            "gpboost_tpu_torch yet (ROADMAP.md Queue A, item 18)")
    params = cfg_mod.resolve_params(params)
    params.setdefault("train_gp_model_cov_pars", train_gp_model_cov_pars)
    num_boost_round = int(params.pop("num_iterations", num_boost_round))
    booster = Booster(params=params, train_set=train_set, gp_model=gp_model)
    for _ in range(num_boost_round):
        booster.update()
    return booster
