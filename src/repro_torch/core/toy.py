"""The paper's Table 1 toy dataset (and Table 2 adversarial set).

Kept as data so tests and ``chip_smoke.py`` reproduce the paper's worked
example byte for byte: query u = (0.1, 2.5, 1, 0.5), best item 6
(1-indexed in the paper; 5 zero-indexed), Fagin terminates at depth 5
scoring 9 items, TA terminates after 2 rounds scoring 5 items.
"""

import numpy as np

# Paper Table 1 (items 1..10 -> rows 0..9).
TOY_T = np.array(
    [
        [-0.5, -1.4, -0.8, -1.0],
        [0.9, -1.9, -0.3, 0.5],
        [-0.8, -0.4, -0.1, 0.9],
        [-0.7, -1.7, 0.2, -2.5],
        [0.8, 0.2, 0.0, 0.7],
        [1.0, 1.6, 0.9, -0.6],
        [0.1, 0.4, -0.6, -2.0],
        [-2.4, 0.6, 0.4, -0.4],
        [-1.6, 0.2, 1.0, 0.3],
        [0.0, 1.0, -0.6, 1.4],
    ],
    dtype=np.float32,
)
TOY_U = np.array([0.1, 2.5, 1.0, 0.5], dtype=np.float32)
TOY_SCORES = TOY_T @ TOY_U  # [-4.85, -4.71, -0.73, -5.37, 0.93, 4.7, -0.59, 1.46, 1.49, 2.6]
TOY_BEST_ITEM = 5           # zero-indexed (paper's item 6)


def table2_adversarial(m: int = 1000):
    """Paper Table 2: Fagin needs M/2 rounds, TA needs 2, for u = (1, 1).

    t_1 decreases with index; t_2 increases; middle items tie at 0.5.
    """
    T = np.full((m, 2), 0.5, dtype=np.float32)
    T[0] = (1.1, 0.1)
    T[-1] = (0.1, 1.0)
    # strictly ordered interiors so the sort is unambiguous (paper notes ties
    # can be removed with a more complicated construction; epsilon does it)
    eps = 1e-4
    T[1:-1, 0] = 0.5 - eps * np.arange(1, m - 1, dtype=np.float32) / m
    T[1:-1, 1] = 0.5 - eps * (m - np.arange(1, m - 1, dtype=np.float32)) / m
    u = np.array([1.0, 1.0], dtype=np.float32)
    return T, u
