"""Subtitle / transcript serialization.

A copy of ``reazonspeech_tpu/core/writers.py`` with the same behaviour.

Output-format parity targets the reference writers
(pkg/nemo-asr/src/writer.py:4-168 == pkg/espnet-asr/src/writer.py): every
writer class produces byte-identical output for the same ``Segment`` stream.

One deliberate divergence: the reference's ``get_writer`` derives the
extension with ``os.path.splitext(name)[-1]`` which keeps the leading dot
(pkg/nemo-asr/src/writer.py:162), so ``-o out.vtt`` without ``--to`` silently
falls back to the text writer. The legacy v1 CLI strips the dot correctly
(pkg/_v1/src/cli.py:168); we follow the v1 behavior and accept both ``"vtt"``
and ``".vtt"``.
"""

import json
import os

__all__ = [
    "VTTWriter",
    "SRTWriter",
    "ASSWriter",
    "JSONWriter",
    "TSVWriter",
    "TextWriter",
    "get_writer",
]


def _hms(seconds, sep, sub_digits):
    h = int(seconds / 3600)
    m = int(seconds / 60) % 60
    s = int(seconds % 60)
    frac = int((seconds % 1) * (10 ** sub_digits))
    return "%02i:%02i:%02i%s%0*i" % (h, m, s, sep, sub_digits, frac)


class VTTWriter:
    """WebVTT (Web Video Text Tracks), the W3C caption standard supported by
    HTML5 players. https://www.w3.org/TR/webvtt1/"""

    ext = "vtt"

    def __init__(self, fp):
        self.fp = fp

    @staticmethod
    def _format_time(seconds):
        return _hms(seconds, ".", 3)

    def write_header(self):
        self.fp.write("WEBVTT\n\n")

    def write(self, segment):
        self.fp.write(
            "%s --> %s\n%s\n\n"
            % (
                self._format_time(segment.start_seconds),
                self._format_time(segment.end_seconds),
                segment.text,
            )
        )


class SRTWriter:
    """SubRip subtitle format: 1-based numbered cues, comma millisecond
    separator. https://www.matroska.org/technical/subtitles.html#srt-subtitles"""

    ext = "srt"

    def __init__(self, fp):
        self.fp = fp
        self.index = 0

    @staticmethod
    def _format_time(seconds):
        return _hms(seconds, ",", 3)

    def write_header(self):
        return

    def write(self, segment):
        self.index += 1
        self.fp.write(
            "%i\n%s --> %s\n%s\n\n"
            % (
                self.index,
                self._format_time(segment.start_seconds),
                self._format_time(segment.end_seconds),
                segment.text,
            )
        )


class ASSWriter:
    """Advanced Sub Station Alpha subtitles (libass / ffmpeg burn-in);
    centisecond resolution, unpadded hour digit."""

    ext = "ass"

    def __init__(self, fp):
        self.fp = fp

    @staticmethod
    def _format_time(seconds):
        h = int(seconds / 3600)
        m = int(seconds / 60) % 60
        s = int(seconds % 60)
        cs = int((seconds % 1) * 100)
        return "%i:%02i:%02i.%02i" % (h, m, s, cs)

    def write_header(self):
        # Style block kept identical to the reference's default style
        # (pkg/nemo-asr/src/writer.py:86-96) so downstream burn-in pipelines
        # render the same.
        self.fp.write(
            "[Script Info]\n"
            "ScriptType: v4.00+\n"
            "Collisions: Normal\n"
            "Timer: 100.0000\n"
            "\n"
            "[V4+ Styles]\n"
            "Style: Default,Arial,16,&Hffffff,&Hffffff,&H0,&H0,0,0,0,0,"
            "100,100,0,0,1,1,0,2,10,10,10,0\n"
            "\n"
            "[Events]\n"
        )

    def write(self, segment):
        self.fp.write(
            "Dialogue: 0,%s,%s,Default,,0,0,0,,%s\n"
            % (
                self._format_time(segment.start_seconds),
                self._format_time(segment.end_seconds),
                segment.text,
            )
        )


class JSONWriter:
    """One JSON object per line: start/end rounded to 3 decimals, raw UTF-8."""

    ext = "json"

    def __init__(self, fp):
        self.fp = fp

    def write_header(self):
        return

    def write(self, ts):
        line = json.dumps(
            {
                "start_seconds": round(ts.start_seconds, 3),
                "end_seconds": round(ts.end_seconds, 3),
                "text": ts.text,
            },
            ensure_ascii=False,
        )
        self.fp.write(line + "\n")


class TSVWriter:
    """Tab-separated values with a header row."""

    ext = "tsv"

    def __init__(self, fp):
        self.fp = fp

    def write_header(self):
        self.fp.write("start_seconds\tend_seconds\ttext\n")

    def write(self, segment):
        self.fp.write(
            "%.3f\t%.3f\t%s\n"
            % (segment.start_seconds, segment.end_seconds, segment.text)
        )


class TextWriter:
    """Human-readable fallback: ``[HH:MM:SS.mmm --> HH:MM:SS.mmm] text``."""

    ext = "txt"

    def __init__(self, fp):
        self.fp = fp

    @staticmethod
    def _format_time(seconds):
        return _hms(seconds, ".", 3)

    def write_header(self):
        return

    def write(self, segment):
        self.fp.write(
            "[%s --> %s] %s\n"
            % (
                self._format_time(segment.start_seconds),
                self._format_time(segment.end_seconds),
                segment.text,
            )
        )


_WRITERS = (VTTWriter, SRTWriter, ASSWriter, JSONWriter, TSVWriter)


def get_writer(fp, ext=None):
    """Pick a writer for ``fp``.

    If ``ext`` is None, it is derived from the file object's name. Leading
    dots are accepted (``".vtt"`` == ``"vtt"``); unknown extensions fall back
    to :class:`TextWriter`.
    """
    if ext is None:
        name = getattr(fp, "name", "")
        ext = os.path.splitext(name)[-1]
    ext = ext.lstrip(".").lower()

    for cls in _WRITERS:
        if cls.ext == ext:
            return cls(fp)

    return TextWriter(fp)
