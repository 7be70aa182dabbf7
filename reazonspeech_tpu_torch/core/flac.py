"""Minimal FLAC encode/decode (verbatim subframes, 16-bit PCM).

A copy of ``reazonspeech_tpu/core/flac.py`` with the same behaviour (the
port's :func:`.audio.audio_from_path` reads FLAC through it).

The reference writes corpus zips with FLAC entries via soundfile/libsndfile
(pkg/espnet-oneseg/src/utils.py:9-31). This first-party implementation emits
spec-conformant FLAC streams using VERBATIM subframes (uncompressed — the
corpus zip already compresses), and reads them back. Any FLAC decoder can
read our output; our reader supports the verbatim+constant subset we emit.

Format essentials implemented: fLaC magic, STREAMINFO metadata block with
MD5, fixed-blocksize frames with UTF-8-coded frame numbers, CRC-8 header and
CRC-16 frame checksums, bit-packed big-endian signed samples.
"""

import hashlib
import struct

import numpy as np

__all__ = ["encode_flac", "decode_flac"]

_BLOCK = 4096


class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value, bits):
        self.acc = (self.acc << bits) | (value & ((1 << bits) - 1))
        self.nbits += bits
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def align(self):
        if self.nbits:
            self.write(0, 8 - self.nbits)

    def bytes(self):
        assert self.nbits == 0
        return bytes(self.buf)


class _BitReader:
    def __init__(self, data, pos=0):
        self.data = data
        self.byte = pos
        self.bit = 0

    def read(self, bits):
        v = 0
        for _ in range(bits):
            b = (self.data[self.byte] >> (7 - self.bit)) & 1
            v = (v << 1) | b
            self.bit += 1
            if self.bit == 8:
                self.bit = 0
                self.byte += 1
        return v

    def align(self):
        if self.bit:
            self.bit = 0
            self.byte += 1


def _crc8(data):
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _crc16(data):
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
    return crc


def _utf8_number(n):
    """FLAC's UTF-8-style coding of frame numbers."""
    if n < 0x80:
        return bytes([n])
    out = []
    bits = n.bit_length()
    nbytes = 2
    while bits > 1 + 5 * (nbytes - 1) + (6 - nbytes):
        nbytes += 1
    lead = (0xFF00 >> nbytes) & 0xFF
    shift = 6 * (nbytes - 1)
    out.append(lead | (n >> shift))
    for i in range(nbytes - 1):
        shift -= 6
        out.append(0x80 | ((n >> shift) & 0x3F))
    return bytes(out)


def _read_utf8_number(r: _BitReader):
    first = r.read(8)
    if first < 0x80:
        return first
    nbytes = 0
    mask = 0x80
    while first & mask:
        nbytes += 1
        mask >>= 1
    n = first & (mask - 1)
    for _ in range(nbytes - 1):
        n = (n << 6) | (r.read(8) & 0x3F)
    return n


def encode_flac(samples, samplerate, channels=None):
    """Encode int16 PCM (or float in [-1,1]) to FLAC bytes.

    samples: [N] mono or [N, channels] interleaved-order array.
    """
    x = np.asarray(samples)
    if x.dtype.kind == "f":
        x = np.clip(x * 32768.0, -32768, 32767).astype(np.int16)
    else:
        x = x.astype(np.int16)
    if x.ndim == 1:
        x = x[:, None]
    n, ch = x.shape

    md5 = hashlib.md5(x.astype("<i2").tobytes()).digest()

    # STREAMINFO
    si = _BitWriter()
    si.write(_BLOCK, 16)
    si.write(_BLOCK, 16)
    si.write(0, 24)
    si.write(0, 24)
    si.write(samplerate, 20)
    si.write(ch - 1, 3)
    si.write(15, 5)  # bps - 1
    si.write(n, 36)
    streaminfo = si.bytes() + md5

    out = bytearray(b"fLaC")
    out += bytes([0x80 | 0x00])  # last metadata block, type 0 = STREAMINFO
    out += len(streaminfo).to_bytes(3, "big")
    out += streaminfo

    frame_no = 0
    pos = 0
    while pos < n:
        block = x[pos : pos + _BLOCK]
        bs = len(block)
        hdr = _BitWriter()
        hdr.write(0b11111111111110, 14)
        hdr.write(0, 1)  # reserved
        hdr.write(0, 1)  # fixed blocksize strategy
        hdr.write(0b0111, 4)  # blocksize: 16-bit at end of header
        hdr.write(0, 4)  # sample rate: from STREAMINFO
        hdr.write(ch - 1, 4)  # independent channels
        hdr.write(0b100, 3)  # 16 bits per sample
        hdr.write(0, 1)  # reserved
        hdr.align()
        header = hdr.bytes() + _utf8_number(frame_no) + struct.pack(">H", bs - 1)
        header += bytes([_crc8(header)])

        body = _BitWriter()
        for c in range(ch):
            body.write(0, 1)  # zero pad
            body.write(0b000001, 6)  # VERBATIM
            body.write(0, 1)  # no wasted bits
            for v in block[:, c]:
                body.write(int(v) & 0xFFFF, 16)
        body.align()

        frame = header + body.bytes()
        frame += struct.pack(">H", _crc16(frame))
        out += frame
        pos += bs
        frame_no += 1

    return bytes(out)


def decode_flac(data):
    """Decode a FLAC stream (verbatim/constant subframes, 16-bit).

    Returns (samples [N] or [N, ch] int16, samplerate).
    """
    if data[:4] != b"fLaC":
        raise ValueError("not a FLAC stream")
    pos = 4
    samplerate = channels = None
    total = 0
    while True:
        hdr = data[pos]
        size = int.from_bytes(data[pos + 1 : pos + 4], "big")
        btype = hdr & 0x7F
        if btype == 0:
            r = _BitReader(data, pos + 4)
            r.read(16), r.read(16), r.read(24), r.read(24)
            samplerate = r.read(20)
            channels = r.read(3) + 1
            bps = r.read(5) + 1
            total = r.read(36)
            if bps != 16:
                raise ValueError(f"only 16-bit supported, got {bps}")
        pos += 4 + size
        if hdr & 0x80:
            break
    if samplerate is None:
        raise ValueError("missing STREAMINFO")

    out = np.zeros((total, channels), np.int16)
    filled = 0
    while filled < total and pos < len(data):
        r = _BitReader(data, pos)
        sync = r.read(14)
        if sync != 0b11111111111110:
            raise ValueError(f"bad frame sync at byte {pos}")
        r.read(1)
        r.read(1)
        bs_code = r.read(4)
        sr_code = r.read(4)
        ch_code = r.read(4)
        r.read(3)
        r.read(1)
        r.align()
        _read_utf8_number(r)
        if bs_code == 0b0111:
            bs = r.read(16) + 1
        elif bs_code == 0b0110:
            bs = r.read(8) + 1
        else:
            raise ValueError(f"unsupported blocksize code {bs_code}")
        if sr_code not in (0,):
            raise ValueError(f"unsupported sample-rate code {sr_code}")
        r.read(8)  # header CRC (unchecked on read)
        ch = ch_code + 1

        for c in range(ch):
            r.read(1)
            stype = r.read(6)
            wasted = r.read(1)
            if wasted:
                raise ValueError("wasted bits unsupported")
            if stype == 0b000001:  # verbatim
                for i in range(bs):
                    v = r.read(16)
                    out[filled + i, c] = v - 0x10000 if v >= 0x8000 else v
            elif stype == 0b000000:  # constant
                v = r.read(16)
                v = v - 0x10000 if v >= 0x8000 else v
                out[filled : filled + bs, c] = v
            else:
                raise ValueError(f"unsupported subframe type {stype}")
        r.align()
        r.read(16)  # frame CRC
        pos = r.byte
        filled += bs

    if channels == 1:
        return out[:, 0], samplerate
    return out, samplerate
