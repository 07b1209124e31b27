"""Dataset-level constants (reference data/data_utils.py:21-23,
data/datasets/one_step_navi.py:17-30); a copy of
``msr3d_tpu/data/constants.py``.

``VICUNA_ACTION_TOKENS``: rarely-used Vicuna tokens (largest ids) reserved
as action outputs; MSNN maps its 8-action space onto the first 8.
"""

ONESTEPNAVI_ACTION_SPACE = {
    "move_forward": 0,
    "turn_left": 1,
    "move_backward": 2,
    "turn_right": 3,
    "turn_left_forward": 4,
    "turn_left_backward": 5,
    "turn_right_backward": 6,
    "turn_right_forward": 7,
}

# first 32 of the reference's reserved-token table (only 8 are used)
VICUNA_ACTION_TOKENS = {
    "给": 31999, "弘": 31998, "收": 31997, "왕": 31996, "黃": 31995,
    "还": 31994, "边": 31993, "べ": 31992, "げ": 31991, "ὀ": 31990,
    "백": 31989, "泰": 31988, "역": 31987, "联": 31986, "怪": 31985,
    "奇": 31984, "ɯ": 31983, "番": 31982, "止": 31981, "합": 31980,
    "才": 31979, "ფ": 31978, "两": 31977, "명": 31976, "房": 31975,
    "候": 31974, "재": 31973, "교": 31972, "遠": 31971, "計": 31970,
    "故": 31969, "丁": 31968,
}

ONESTEPNAVI_ACTION_SPACE_TOKENIZE = {
    v: tok
    for v, tok in zip(
        ONESTEPNAVI_ACTION_SPACE.values(),
        list(VICUNA_ACTION_TOKENS.keys())[: len(ONESTEPNAVI_ACTION_SPACE)],
    )
}
