"""Operations and bytes that a meme's work needs, from its own sizes, and
the chip's published peaks (``peaks.json``)."""

import json
import os

with open(os.path.join(os.path.dirname(__file__), "peaks.json")) as _f:
    PEAKS = json.load(_f)
