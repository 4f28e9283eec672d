"""REBA / RULA standard lookup tables and action-level maps.

These are the published Rapid Entire Body Assessment (Hignett & McAtamney,
2000) and Rapid Upper Limb Assessment (McAtamney & Corlett, 1993) score
tables, identical to the literal arrays in the reference
(reference lib/utils/reba.py:13-43, rula.py:13-58).
"""

import numpy as np

# --- REBA -------------------------------------------------------------------
# Group A: [trunk 1-5][neck 1-3][legs 1-4]
REBA_TABLE_A = np.array(
    [
        [[1, 2, 3, 4], [1, 2, 3, 4], [3, 3, 5, 6]],
        [[2, 3, 4, 5], [3, 4, 5, 6], [4, 5, 6, 7]],
        [[2, 4, 5, 6], [4, 5, 6, 7], [5, 6, 7, 8]],
        [[3, 5, 6, 7], [5, 6, 7, 8], [6, 7, 8, 9]],
        [[4, 6, 7, 8], [6, 7, 8, 9], [7, 8, 9, 9]],
    ],
    dtype=np.int32,
)

# Group B: [upper arm 1-6][lower arm 1-2][wrist 1-3]
REBA_TABLE_B = np.array(
    [
        [[1, 2, 2], [1, 2, 3]],
        [[1, 2, 3], [2, 3, 4]],
        [[3, 4, 5], [4, 5, 5]],
        [[4, 5, 5], [5, 6, 7]],
        [[6, 7, 8], [7, 8, 8]],
        [[7, 8, 8], [8, 9, 9]],
    ],
    dtype=np.int32,
)

# Final: [score A 1-12][score B 1-12]
REBA_TABLE_C = np.array(
    [
        [1, 1, 1, 2, 3, 3, 4, 5, 6, 7, 7, 7],
        [1, 2, 2, 3, 4, 4, 5, 6, 6, 7, 7, 8],
        [2, 3, 3, 3, 4, 5, 6, 7, 7, 8, 8, 8],
        [3, 4, 4, 4, 5, 6, 7, 8, 8, 9, 9, 9],
        [4, 4, 4, 5, 6, 7, 8, 8, 9, 9, 9, 9],
        [6, 6, 6, 7, 8, 8, 9, 9, 10, 10, 10, 10],
        [7, 7, 7, 8, 9, 9, 9, 10, 10, 11, 11, 11],
        [8, 8, 8, 9, 10, 10, 10, 10, 10, 11, 11, 11],
        [9, 9, 9, 10, 10, 10, 11, 11, 11, 12, 12, 12],
        [10, 10, 10, 11, 11, 11, 11, 12, 12, 12, 12, 12],
        [11, 11, 11, 11, 12, 12, 12, 12, 12, 12, 12, 12],
        [12, 12, 12, 12, 12, 12, 12, 12, 12, 12, 12, 12],
    ],
    dtype=np.int32,
)

REBA_ACTION_LEVELS = (
    # (score set / threshold, level, name) -- evaluated in order.
    ((1,), 1, "Negligible risk"),
    ((2, 3), 2, "Low risk. Change may be needed."),
    ((4, 5, 6, 7), 3, "Medium risk. Further Investigate. Change Soon."),
    ((8, 9, 10), 4, "High risk. Investigate and implement change"),
)
REBA_ACTION_LEVEL_HIGH = (5, "Very high risk. Implement change")  # score >= 11

# --- RULA -------------------------------------------------------------------
# Group A: [upper arm 1-6][lower arm 1-3][wrist 1-4][wrist twist 1-2]
RULA_TABLE_A = np.array(
    [
        [
            [[1, 2], [2, 2], [2, 3], [3, 3]],
            [[2, 2], [2, 2], [3, 3], [3, 3]],
            [[2, 3], [3, 3], [3, 3], [4, 4]],
        ],
        [
            [[2, 3], [3, 3], [3, 4], [4, 4]],
            [[3, 3], [3, 3], [3, 4], [4, 4]],
            [[3, 4], [4, 4], [4, 4], [5, 5]],
        ],
        [
            [[3, 3], [4, 4], [4, 4], [5, 5]],
            [[3, 4], [4, 4], [4, 4], [5, 5]],
            [[4, 4], [4, 4], [4, 5], [5, 5]],
        ],
        [
            [[4, 4], [4, 4], [4, 5], [5, 5]],
            [[4, 4], [4, 4], [4, 5], [5, 5]],
            [[4, 4], [4, 5], [5, 5], [6, 6]],
        ],
        [
            [[5, 5], [5, 5], [5, 6], [6, 7]],
            [[5, 6], [6, 6], [6, 7], [7, 7]],
            [[6, 6], [6, 7], [7, 7], [7, 8]],
        ],
        [
            [[7, 7], [7, 7], [7, 8], [8, 9]],
            [[8, 8], [8, 8], [8, 9], [9, 9]],
            [[9, 9], [9, 9], [9, 9], [9, 9]],
        ],
    ],
    dtype=np.int32,
)

# Group B: [neck 1-6][trunk 1-6][legs 1-2]
RULA_TABLE_B = np.array(
    [
        [[1, 3], [2, 3], [3, 4], [5, 5], [6, 6], [7, 7]],
        [[2, 3], [2, 3], [4, 5], [5, 5], [6, 7], [7, 7]],
        [[3, 3], [3, 4], [4, 5], [5, 5], [6, 7], [7, 7]],
        [[5, 5], [5, 6], [6, 7], [7, 7], [7, 7], [8, 8]],
        [[7, 7], [7, 7], [7, 8], [8, 8], [8, 8], [8, 8]],
        [[8, 8], [8, 8], [8, 8], [8, 9], [9, 9], [9, 9]],
    ],
    dtype=np.int32,
)

# Final: [score A 1-7][score B 1-7]
RULA_TABLE_C = np.array(
    [
        [1, 2, 3, 3, 4, 5, 5],
        [2, 2, 3, 4, 4, 5, 5],
        [3, 3, 3, 4, 4, 5, 6],
        [3, 3, 3, 4, 5, 6, 6],
        [4, 4, 4, 5, 6, 7, 7],
        [5, 5, 6, 6, 7, 7, 7],
        [5, 5, 6, 7, 7, 7, 7],
    ],
    dtype=np.int32,
)

RULA_ACTION_LEVELS = (
    ((1, 2), 1, "Acceptable posture"),
    ((3, 4), 2, "Further investigation, change may be needed"),
    ((5, 6), 3, "Further investigation, change soon"),
)
RULA_ACTION_LEVEL_HIGH = (4, "Investigate and implement change")  # score >= 7
