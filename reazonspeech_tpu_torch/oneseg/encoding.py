"""ARIB STD-B24 c-profile text decoding.

A copy of ``reazonspeech_tpu/oneseg/encoding.py`` with the same behaviour;
the gaiji table is the port's own copy of ``data/gaiji.tsv``.

Japanese 1seg broadcast captions are EUC-JP with broadcaster gaiji
(out-of-code-table glyphs). Behavior parity with the reference decoder
(pkg/espnet-oneseg/src/encoding.py:26-53): two-byte EUC-JP sequences decode
normally, failures fall back to the gaiji table, single-byte
control/whitespace bytes are dropped.

Provenance of data/gaiji.tsv: the 449 code->glyph entries are the
reference's ``_GAIJI_TABLE`` (pkg/espnet-oneseg/src/encoding.py:55-511),
reformatted as a data file. A code-point table has exactly one correct
content and decode parity requires reproducing it entry for entry, so the
values are necessarily identical to the reference's (which in turn encodes
ARIB STD-B24 broadcast glyph assignments).
"""

from importlib import resources

__all__ = ["decode_cprofile"]


def _load_gaiji():
    table = {}
    with resources.files("reazonspeech_tpu_torch.oneseg").joinpath("data/gaiji.tsv").open(
        encoding="utf-8"
    ) as fp:
        for line in fp:
            line = line.rstrip("\n")
            if not line:
                continue
            code, _, text = line.partition("\t")
            table[int(code, 16)] = text
    return table


_GAIJI_TABLE = _load_gaiji()


def _gaiji(hi, lo):
    return _GAIJI_TABLE.get(((hi & 0x7F) << 8) | (lo & 0x7F), "")


def decode_cprofile(buf) -> str:
    """Decode a c-profile byte string into text."""
    out = []
    i = 0
    n = len(buf)
    while i < n:
        b = buf[i]
        if 0xA0 < b < 0xFF:
            if i + 1 >= n:
                break
            try:
                out.append(bytes((b, buf[i + 1])).decode("euc-jp"))
            except UnicodeDecodeError:
                out.append(_gaiji(b, buf[i + 1]))
            i += 2
        else:
            # single-byte control codes (0x81-0x86 mode switches, CR/FF/SP,
            # everything else) carry no text
            i += 1
    return "".join(out)
