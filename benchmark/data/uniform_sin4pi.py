"""Data recipe ``uniform_sin4pi``: one-dimensional regression data, the JAX
package's headline data (``bench.make_data``).

Training points ``x`` uniform on [0, 1], sorted, ``y = sin(4πx) +
N(0, noise_std²)``, both from the run's seed; test points ``n_test`` evenly
spaced on ``[test_lo, test_hi]``, the same for every seed. Configuration
keys: ``n_train``, ``noise_std``, ``n_test``, ``test_lo``, ``test_hi``."""
import numpy as np

from benchmark.harness import seed_key


def make(cfg, seed):
    rng = np.random.default_rng(seed_key(seed))
    x = np.sort(rng.uniform(0.0, 1.0, cfg["n_train"])).reshape(-1, 1)
    y = np.sin(x[:, 0] * 4 * np.pi) + rng.normal(0.0, cfg["noise_std"], cfg["n_train"])
    return x, y


def test_points(cfg, seed):
    return np.linspace(cfg["test_lo"], cfg["test_hi"], cfg["n_test"]).reshape(-1, 1)
