"""The port's copy of the GP-EI Bayesian optimizer
(``sm_hpss_mtl_tpu_torch/utils/bayesopt.py``): pinned to the JAX package's
module (the same asks for the same seed and objective, the same spaces),
and the JAX package's own tests of it (``tests/test_bayesopt.py``) run on
the copy.
"""

import numpy as np
import pytest

from sm_hpss_mtl_tpu.utils import bayesopt as jbayes
from sm_hpss_mtl_tpu_torch.utils.bayesopt import (ARCH_SPACE,
                                                  MTL_HEADS_SPACE,
                                                  BayesOptimizer)


def _arch_objective(p):
    """Smooth deterministic loss over the real TCN search space with a
    unique optimum (kernel 9, Nd 6, stacks 4, filters 32, skips on)."""
    return ((p["kernel_size"] - 9) ** 2 / 64.0
            + (p["Nd"] - 6) ** 2 / 9.0
            + (p["nb_stacks"] - 4) ** 2 / 16.0
            + {8: 0.6, 16: 0.25, 32: 0.0}[p["n_filters"]]
            + (0.0 if p["use_skip_connections"] else 0.3))


def _random_search(space, objective, trials, seed):
    rng = np.random.default_rng(seed)
    best = np.inf
    for _ in range(trials):
        p = {k: v[rng.integers(len(v))] for k, v in space.items()}
        best = min(best, objective(p))
    return best


def test_bayes_beats_random_same_budget():
    trials = 20
    wins = 0
    for seed in range(5):
        opt = BayesOptimizer(ARCH_SPACE, seed=seed, n_init=5)
        for _ in range(trials):
            p = opt.ask()
            opt.tell(p, _arch_objective(p))
        b_bayes = opt.best()[1]
        b_rand = _random_search(ARCH_SPACE, _arch_objective, trials, seed)
        wins += b_bayes <= b_rand
    # Same budget, same seeds: GP-EI must win (allow one tied/lost seed).
    assert wins >= 4, f"bayes won only {wins}/5 seeds"


def test_ask_tell_mechanics_and_dedup():
    opt = BayesOptimizer(MTL_HEADS_SPACE, seed=0, n_init=3)
    seen = []
    # 12 = full cardinality of the space; every ask must be novel.
    for _ in range(12):
        p = opt.ask()
        key = (p["head_layers"], p["head_width"])
        assert key not in seen
        seen.append(key)
        opt.tell(p, float(p["head_layers"]) + p["head_width"] / 128.0)
    best_p, best_y = opt.best()
    assert best_p == {"head_layers": 1, "head_width": 16}
    # Exhausted space: ask falls back to the incumbent instead of looping.
    assert opt.ask() == best_p


def test_values_keep_python_types():
    opt = BayesOptimizer(ARCH_SPACE, seed=1)
    p = opt.ask()
    assert isinstance(p["use_skip_connections"], bool)
    assert all(isinstance(p[k], int) for k in
               ("kernel_size", "Nd", "nb_stacks", "n_filters"))


def test_deterministic_given_seed():
    def run(seed):
        opt = BayesOptimizer(ARCH_SPACE, seed=seed, n_init=4)
        hist = []
        for _ in range(10):
            p = opt.ask()
            hist.append(tuple(sorted(p.items())))
            opt.tell(p, _arch_objective(p))
        return hist
    assert run(3) == run(3)
    assert run(3) != run(4)


def test_empty_space_rejected():
    with pytest.raises(ValueError):
        BayesOptimizer({})


def test_spaces_are_the_jax_spaces():
    assert ARCH_SPACE == jbayes.ARCH_SPACE
    assert MTL_HEADS_SPACE == jbayes.MTL_HEADS_SPACE


@pytest.mark.parametrize("space", ["arch", "mtl-heads"])
@pytest.mark.parametrize("seed", [0, 5])
def test_asks_match_jax_for_the_same_seed(space, seed):
    # The same seed and the same objective give the same sequence of asks,
    # through the random initial points and the GP-EI ones, and the same
    # incumbent.
    spaces = {"arch": ARCH_SPACE, "mtl-heads": MTL_HEADS_SPACE}

    def objective(p):
        if space == "arch":
            return _arch_objective(p)
        return abs(p["head_layers"] - 2) + abs(p["head_width"] - 64) / 64

    opts = [BayesOptimizer(spaces[space], seed=seed, n_init=3),
            jbayes.BayesOptimizer(spaces[space], seed=seed, n_init=3)]
    for _ in range(10):
        asks = [o.ask() for o in opts]
        assert asks[0] == asks[1]
        for o in opts:
            o.tell(asks[0], objective(asks[0]))
    assert opts[0].best() == opts[1].best()
