"""Rebuild caption fragments into sentences.

A copy of ``reazonspeech_tpu/oneseg/sentence.py`` with the same behaviour.

Behavior parity with the reference (pkg/espnet-oneseg/src/sentence.py:1-60):
captions are cleaned (speaker marks, parentheticals, specials), concatenated
into one character timeline, split into sentences, and re-merged with the
original timings. The reference requires spaCy + GiNZA for sentence
splitting; GiNZA is used here when importable, with a first-party Japanese
rule-based splitter (terminal punctuation 。?!？！ with closing-quote
attachment) as the fallback so the corpus pipeline works without the
~500 MB NLP stack.
"""

import copy
import re

from .interface import Caption

__all__ = ["build_sentences", "split_sentences"]

_SPECIALS = {ord(x): "" for x in "…〜＜＞♬:→　"}

_TERMINALS = "。！？!?"
_CLOSERS = "」』）)”\"'"


def _cleanup(s: str) -> str:
    """Remove characters that confuse sentence splitting
    (parity: pkg/espnet-oneseg/src/sentence.py:8-17)."""
    s = re.sub(r"^.*≫", "", s)
    s = re.sub(r"^.*＞＞", "", s)
    s = re.sub(r"\([^)]*\)", "", s)
    s = re.sub(r"（[^）]*）", "", s)
    s = re.sub(r"\s", "", s)
    return s.translate(_SPECIALS)


def _rule_split(text: str):
    """Rule-based Japanese sentence splitting: break after terminal
    punctuation, attaching any closing quotes/brackets to the sentence."""
    sentences = []
    buf = []
    i = 0
    n = len(text)
    while i < n:
        c = text[i]
        buf.append(c)
        if c in _TERMINALS:
            # attach run of closing quotes and further terminals
            j = i + 1
            while j < n and text[j] in _TERMINALS + _CLOSERS:
                buf.append(text[j])
                j += 1
            sentences.append("".join(buf))
            buf = []
            i = j
        else:
            i += 1
    if buf:
        sentences.append("".join(buf))
    return sentences


def split_sentences(text: str):
    """Sentence-split ``text`` — GiNZA when available, rule-based otherwise."""
    try:
        import spacy

        nlp = spacy.load("ja_ginza")
    except Exception:
        return _rule_split(text)
    return [str(s) for s in nlp(text).sents]


def _merge(start: Caption, end: Caption, sentence: str) -> Caption:
    caption = copy.copy(start)
    caption.text = sentence
    caption.end_seconds = end.end_seconds
    return caption


def build_sentences(captions):
    """Reorganize captions along sentence boundaries.

    Example: two fragments '輸送機は午前１０時に' (10-12 s) and
    '離陸しました。' (12-15 s) merge into one caption spanning 10-15 s.

    Args:
        captions (list[Caption])

    Returns:
        list[Caption]
    """
    ret = []
    timeline = []
    fulltext = ""

    for caption in captions:
        text = _cleanup(caption.text)
        fulltext += text
        for _ in text:
            timeline.append(caption)

    for sentence in split_sentences(fulltext):
        if not sentence:
            continue
        start, end = timeline[0], timeline[len(sentence) - 1]
        ret.append(_merge(start, end, sentence))
        timeline = timeline[len(sentence) :]
    return ret
