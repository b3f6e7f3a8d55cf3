"""A 5x7 bitmap font for printable ASCII (32-126), for the port's plots.

Each glyph is five column bytes, bit 0 the top row, in a 6-pixel cell
(one blank column after the glyph); the classic 5x7 LCD character set,
written out here so that drawing text needs no font library.
`render(text, scale)` gives the text's coverage mask.
"""

from __future__ import annotations

import numpy as np

GLYPH_W, GLYPH_H, ADVANCE = 5, 7, 6

_COLUMNS = bytes.fromhex(
    "0000000000" "00005f0000" "0007000700" "147f147f14"   # space ! " #
    "242a7f2a12" "2313086462" "3649552250" "0005030000"   # $ % & '
    "001c224100" "0041221c00" "082a1c2a08" "08083e0808"   # ( ) * +
    "0050300000" "0808080808" "0060600000" "2010080402"   # , - . /
    "3e5149453e" "00427f4000" "4261514946" "2141454b31"   # 0 1 2 3
    "1814127f10" "2745454539" "3c4a494930" "0171090503"   # 4 5 6 7
    "3649494936" "064949291e" "0036360000" "0056360000"   # 8 9 : ;
    "0814224100" "1414141414" "0041221408" "0201510906"   # < = > ?
    "324979413e" "7e1111117e" "7f49494936" "3e41414122"   # @ A B C
    "7f4141221c" "7f49494941" "7f09090101" "3e41415132"   # D E F G
    "7f0808087f" "00417f4100" "2040413f01" "7f08142241"   # H I J K
    "7f40404040" "7f0204027f" "7f0408107f" "3e4141413e"   # L M N O
    "7f09090906" "3e4151215e" "7f09192946" "4649494931"   # P Q R S
    "01017f0101" "3f4040403f" "1f2040201f" "7f2018207f"   # T U V W
    "6314081463" "0304780403" "6151494543" "007f414100"   # X Y Z [
    "0204081020" "0041417f00" "0402010204" "4040404040"   # \ ] ^ _
    "0001020400" "2054545478" "7f48444438" "3844444420"   # ` a b c
    "384444487f" "3854545418" "087e090102" "081454543c"   # d e f g
    "7f08040478" "00447d4000" "2040443d00" "007f102844"   # h i j k
    "00417f4000" "7c04180478" "7c08040478" "3844444438"   # l m n o
    "7c14141408" "081414187c" "7c08040408" "4854545420"   # p q r s
    "043f444020" "3c4040207c" "1c2040201c" "3c4030403c"   # t u v w
    "4428102844" "0c5050503c" "4464544c44" "0008364100"   # x y z {
    "00007f0000" "0041360800" "0804081008")               # | } ~


def glyph(ch: str) -> np.ndarray:
    """(7, 5) bool mask of one character ('?' for one outside 32-126)."""
    code = ord(ch)
    if not 32 <= code <= 126:
        code = ord("?")
    cols = _COLUMNS[(code - 32) * GLYPH_W:(code - 31) * GLYPH_W]
    bits = np.array([[(c >> r) & 1 for c in cols] for r in range(GLYPH_H)])
    return bits.astype(bool)


def render(text: str, scale: int = 1) -> np.ndarray:
    """Coverage mask (H, W) bool of `text`, each font pixel a
    scale x scale block."""
    h, w = GLYPH_H, max(ADVANCE * len(text) - 1, 0)
    out = np.zeros((h, w), bool)
    for i, ch in enumerate(text):
        out[:, i * ADVANCE:i * ADVANCE + GLYPH_W] = glyph(ch)
    return np.kron(out, np.ones((scale, scale), bool))
