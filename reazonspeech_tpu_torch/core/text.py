"""Text normalization and character-error-rate utilities.

A copy of ``reazonspeech_tpu/core/text.py`` with the same behaviour: the
edit distance takes the port's own ``native`` library where it is available
(a C++ compiler exists), the pure-Python Wagner-Fischer below otherwise.

The reference ships two *different* normalizers that must both be preserved:

- the corpus/oneseg flavor strips a 74-symbol table and converts hankaku
  ASCII to zenkaku (reference: pkg/espnet-oneseg/src/text.py:9-57);
- the evaluation flavor strips a punctuation set, converts zenkaku to
  hankaku, and rewrites digit runs as Japanese numeral words
  (reference: pkg/evaluation/src/utils.py:14-33).

Both are implemented here, along with a Wagner-Fischer edit distance (the
reference uses the C++ ``editdistance`` package on the eval side and a pure
Python implementation on the corpus side; one implementation serves both).
"""

import re
from importlib import resources
from typing import TypedDict

__all__ = [
    "normalize",
    "cer",
    "normalize_eval",
    "calculate_cer",
    "CERResult",
    "edit_distance",
    "num_to_ja",
]

# ---------------------------------------------------------------------------
# Shared: edit distance
# ---------------------------------------------------------------------------

_native_edit_distance = None


def _load_native():
    """``native.edit_distance`` where the library is available, else False."""
    global _native_edit_distance
    if _native_edit_distance is None:
        from .. import native

        _native_edit_distance = native.edit_distance if native.available() else False
    return _native_edit_distance


def edit_distance(s: str, t: str) -> int:
    """Levenshtein distance via the Wagner-Fischer algorithm.

    Behavior-compatible with both ``editdistance.eval`` (eval side) and the
    reference's pure-Python ``_editdist`` (pkg/espnet-oneseg/src/text.py:16-32).
    Uses the C++ implementation from the native library when available.
    """
    native = _load_native()
    if native:
        return native(s, t)
    return _edit_distance_python(s, t)


def _edit_distance_python(s: str, t: str) -> int:
    """The pure-Python Wagner-Fischer."""
    n, m = len(s), len(t)
    if n == 0:
        return m
    if m == 0:
        return n
    prev = list(range(m + 1))
    for i in range(1, n + 1):
        cur = [i] + [0] * m
        si = s[i - 1]
        for j in range(1, m + 1):
            if si == t[j - 1]:
                cur[j] = prev[j - 1]
            else:
                cur[j] = min(prev[j], cur[j - 1], prev[j - 1]) + 1
        prev = cur
    return prev[m]


# ---------------------------------------------------------------------------
# Corpus / oneseg flavor: strip symbols, hankaku -> zenkaku
# ---------------------------------------------------------------------------

_ASCII = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
_ZENKAKU = (
    "ａｂｃｄｅｆｇｈｉｊｋｌｍｎｏｐｑｒｓｔｕｖｗｘｙｚ"
    "ＡＢＣＤＥＦＧＨＩＪＫＬＭＮＯＰＱＲＳＴＵＶＷＸＹＺ"
    "０１２３４５６７８９"
)
_HAN2ZEN = str.maketrans(_ASCII, _ZENKAKU)
_ZEN2HAN = str.maketrans(_ZENKAKU, _ASCII)


def _load_specials():
    with resources.files("reazonspeech_tpu_torch.core").joinpath("data/symbol.txt").open(
        encoding="utf-8"
    ) as fp:
        return {ord(line.rstrip("\n")): "" for line in fp if line.rstrip("\n")}


_SPECIALS = _load_specials()


def normalize(text: str) -> str:
    """Trim non-phonatory symbols and widen ASCII (corpus flavor).

    Reference behavior: pkg/espnet-oneseg/src/text.py:34-44.
    """
    return text.translate(_SPECIALS).translate(_HAN2ZEN)


def cer(text: str, asr: str) -> float:
    """CER between a label text and recognized speech (corpus flavor).

    Reference behavior: pkg/espnet-oneseg/src/text.py:46-57.
    """
    text = normalize(text)
    asr = normalize(asr)
    return edit_distance(text, asr) / len(text)


# ---------------------------------------------------------------------------
# Evaluation flavor: strip punctuation, zenkaku -> hankaku, digits -> kanji
# ---------------------------------------------------------------------------


class CERResult(TypedDict):
    cer: float
    distance: int
    length: int


_PUNCTUATIONS = {ord(x): "" for x in "、。「」『』，,？！!!?!?"}

# Japanese numeral building blocks (standard kanji reading, as produced by
# num2words(lang="ja") which the reference evaluation normalizer depends on,
# pkg/evaluation/src/utils.py:22-24).
_DIGITS = "零一二三四五六七八九"
_SMALL_UNITS = ("", "十", "百", "千")
_BIG_UNITS = (
    "", "万", "億", "兆", "京", "垓", "𥝱", "穣", "溝", "澗", "正", "載", "極",
    "恒河沙", "阿僧祇", "那由他", "不可思議", "無量大数",
)


def _four_digit_to_ja(n: int) -> str:
    """Render 1..9999 as kanji. 1 is implicit before 十/百/千 (e.g. 1111 -> 千百十一)."""
    out = []
    for pos in (3, 2, 1, 0):
        d = (n // 10**pos) % 10
        if d == 0:
            continue
        if d == 1 and pos > 0:
            out.append(_SMALL_UNITS[pos])
        else:
            out.append(_DIGITS[d] + _SMALL_UNITS[pos])
    return "".join(out)


def num_to_ja(num_str: str) -> str:
    """Convert a decimal digit string (optionally with a fraction) to Japanese
    numeral words, matching num2words(lang="ja") semantics: integer part in
    positional kanji (万-grouping), fractional digits read one-by-one after 点.

    Raises OverflowError for integers too large for the unit table, mirroring
    the error the reference catches (pkg/evaluation/src/utils.py:21-27).
    """
    if "." in num_str:
        int_part, frac_part = num_str.split(".", 1)
    else:
        int_part, frac_part = num_str, ""

    n = int(int_part) if int_part else 0

    if n == 0:
        words = _DIGITS[0]
    else:
        groups = []
        while n > 0:
            groups.append(n % 10000)
            n //= 10000
        if len(groups) > len(_BIG_UNITS):
            raise OverflowError("number too large for Japanese numeral units")
        parts = []
        for i in range(len(groups) - 1, -1, -1):
            g = groups[i]
            if g == 0:
                continue
            body = _four_digit_to_ja(g)
            # 万 and above need an explicit 一 (10000 -> 一万), unlike 千/百/十.
            if g == 1 and i > 0:
                body = _DIGITS[1]
            parts.append(body + _BIG_UNITS[i])
        words = "".join(parts)

    if frac_part:
        words += "点" + "".join(_DIGITS[int(d)] for d in frac_part)
    return words


def normalize_eval(s: str) -> str:
    """Evaluation-side text normalizer.

    Reference behavior: pkg/evaluation/src/utils.py:20-27 — strip punctuation,
    zenkaku->hankaku, then rewrite every digit run (with optional fraction) as
    Japanese numeral words; on numeral overflow the string is returned as-is.
    """
    s = s.translate(_PUNCTUATIONS).translate(_ZEN2HAN)
    try:
        return re.sub(r"\d+\.?\d*", lambda m: num_to_ja(m.group(0)), s)
    except OverflowError:
        return s


def calculate_cer(reference: str, prediction: str) -> CERResult:
    """CER with eval-side normalization; contract-identical to the reference
    (pkg/evaluation/src/utils.py:29-33)."""
    reference = normalize_eval(reference)
    prediction = normalize_eval(prediction)
    distance = edit_distance(reference, prediction)
    return CERResult(
        cer=distance / len(reference), distance=distance, length=len(reference)
    )
