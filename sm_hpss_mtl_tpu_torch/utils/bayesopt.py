"""Gaussian-process Bayesian optimization over discrete hyperparameter
spaces (numpy only): the port's own copy of
``sm_hpss_mtl_tpu/utils/bayesopt.py``, which the port may not import;
``tests/test_torch_bayesopt.py`` pins it to that module (the same asks
for the same seed).

The reference's tuner offers both ``RandomSearch`` and
``BayesianOptimization`` backends via keras-tuner
(``B3_architecture_tuning.py:251-289``); keras-tuner is absent here, so
this is an independent implementation of the same idea:
ordinal-encode each hyperparameter into [0, 1], fit a GP with an RBF
kernel to the observed (config, loss) pairs, and pick the next trial by
maximizing expected improvement over a random candidate pool.

Ask/tell interface so the caller owns the (expensive) evaluation loop:

    opt = BayesOptimizer(space, seed=0)
    for _ in range(trials):
        params = opt.ask()
        opt.tell(params, objective(params))
    best = opt.best()
"""

from __future__ import annotations

import math

import numpy as np


class BayesOptimizer:
    """GP-EI over a dict of ordered discrete choices.

    ``space``: ``{name: [value, ...]}`` — values are an *ordered* list
    (ints, floats, bools or any hashables; order defines the ordinal
    embedding, matching how keras-tuner treats Int/Choice axes).
    """

    def __init__(self, space: dict[str, list], *, seed: int = 0,
                 n_init: int = 5, n_candidates: int = 512,
                 xi: float = 0.01, noise: float = 1e-4):
        if not space:
            raise ValueError("empty search space")
        self.space = {k: list(v) for k, v in space.items()}
        self.names = list(self.space)
        self.rng = np.random.default_rng(seed)
        self.n_init = n_init
        self.n_candidates = n_candidates
        self.xi = xi
        self.noise = noise
        self.X: list[np.ndarray] = []   # encoded points
        self.y: list[float] = []
        self._asked: dict[tuple, np.ndarray] = {}

    # -- encoding ---------------------------------------------------------

    def _encode(self, params: dict) -> np.ndarray:
        vec = np.empty(len(self.names))
        for i, k in enumerate(self.names):
            choices = self.space[k]
            idx = choices.index(params[k])
            vec[i] = idx / max(len(choices) - 1, 1)
        return vec

    def _decode(self, vec: np.ndarray) -> dict:
        out = {}
        for i, k in enumerate(self.names):
            choices = self.space[k]
            idx = int(round(vec[i] * (len(choices) - 1)))
            out[k] = choices[idx]
        return out

    def _sample(self) -> dict:
        return {k: v[self.rng.integers(len(v))]
                for k, v in self.space.items()}

    def _key(self, params: dict) -> tuple:
        return tuple(params[k] for k in self.names)

    # -- GP ----------------------------------------------------------------

    @staticmethod
    def _kernel(A: np.ndarray, B: np.ndarray, ls: float) -> np.ndarray:
        d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / ls ** 2)

    def _fit_predict(self, Xc: np.ndarray):
        """GP posterior mean/std at candidates ``Xc`` given observations."""
        X = np.stack(self.X)
        y = np.asarray(self.y, dtype=np.float64)
        mu0, sd = y.mean(), y.std() + 1e-12
        yn = (y - mu0) / sd
        # Median-heuristic length scale over the observed points.
        if len(X) > 1:
            d2 = ((X[:, None, :] - X[None, :, :]) ** 2).sum(-1)
            med = np.median(d2[d2 > 0]) if (d2 > 0).any() else 1.0
            ls = math.sqrt(max(med, 1e-4))
        else:
            ls = 1.0
        K = self._kernel(X, X, ls) + self.noise * np.eye(len(X))
        L = np.linalg.cholesky(K)
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, yn))
        Ks = self._kernel(Xc, X, ls)
        mean = Ks @ alpha
        v = np.linalg.solve(L, Ks.T)
        var = np.clip(1.0 - (v ** 2).sum(0), 1e-12, None)
        return mean * sd + mu0, np.sqrt(var) * sd

    @staticmethod
    def _norm_cdf(z: np.ndarray) -> np.ndarray:
        return 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2.0)))

    def _expected_improvement(self, Xc: np.ndarray) -> np.ndarray:
        mean, std = self._fit_predict(Xc)
        best = min(self.y)
        z = (best - self.xi - mean) / std
        pdf = np.exp(-0.5 * z ** 2) / math.sqrt(2 * math.pi)
        return (best - self.xi - mean) * self._norm_cdf(z) + std * pdf

    # -- ask / tell ---------------------------------------------------------

    def ask(self) -> dict:
        """Next configuration to evaluate (dedup'd against history)."""
        seen = set(self._asked) | {
            self._key(self._decode(x)) for x in self.X}
        if len(self.X) < self.n_init:
            for _ in range(1000):
                params = self._sample()
                if self._key(params) not in seen:
                    break
            else:
                # Sampling never found a fresh point — the space is (or
                # is nearly) exhausted.  Scan it exhaustively for any
                # unseen config before conceding a repeat.
                import itertools
                for combo in itertools.product(
                        *(self.space[k] for k in self.names)):
                    if combo not in seen:
                        params = dict(zip(self.names, combo))
                        break
        else:
            cands, keys = [], []
            for _ in range(self.n_candidates):
                c = self._sample()
                k = self._key(c)
                if k not in seen:
                    cands.append(c)
                    keys.append(k)
            if not cands:  # space exhausted — repeat the incumbent
                params = self.best()[0]
            else:
                Xc = np.stack([self._encode(c) for c in cands])
                ei = self._expected_improvement(Xc)
                params = cands[int(np.argmax(ei))]
        self._asked[self._key(params)] = self._encode(params)
        return params

    def tell(self, params: dict, loss: float) -> None:
        self.X.append(self._encode(params))
        self.y.append(float(loss))
        self._asked.pop(self._key(params), None)

    def best(self) -> tuple[dict, float]:
        i = int(np.argmin(self.y))
        return self._decode(self.X[i]), self.y[i]


# Search spaces shared with cli.tune (ordered lists; see module doc).
ARCH_SPACE = {
    "kernel_size": list(range(3, 20, 2)),
    "Nd": list(range(3, 9)),
    "nb_stacks": list(range(3, 11)),
    "n_filters": [8, 16, 32],
    "use_skip_connections": [False, True],
}
MTL_HEADS_SPACE = {
    "head_layers": [1, 2, 3],
    "head_width": [16, 32, 64, 128],
}
