"""MPEG-TS (1seg) closed-caption extraction.

A copy of ``reazonspeech_tpu/oneseg/caption.py`` with the same behaviour.

A from-scratch transport-stream demuxer covering exactly what caption
extraction needs — behavior parity with the reference's parser
(pkg/espnet-oneseg/src/caption.py:241-292), which itself implements the
ARIB TR-B14 1seg caption carriage:

- 188-byte packets, sync 0x47 (a bad sync byte raises ValueError);
- PCR (42-bit, 27 MHz) from adaptation fields drives the stream clock;
- PAT (PID 0) → program map PIDs → PMT → caption PID (stream_type 0x06
  carrying descriptor 0x52 with component tag 0x87);
- caption PES payloads → ARIB data units (0x20 = text) → c-profile decode;
- captions are emitted as (start, end) pairs by pairing each caption's
  timestamp with the next caption's (a closing sentinel at the final PCR),
  dropping empty texts; timestamps are relative to the first PCR with
  wraparound compensation.
"""

from dataclasses import dataclass, field

from .encoding import decode_cprofile
from .interface import Caption

__all__ = ["get_captions", "TransportStreamError"]

PACKET_SIZE = 188
_SYNC = 0x47
_CLOCK_HZ = 27_000_000


class TransportStreamError(ValueError):
    pass


@dataclass
class _Packet:
    pid: int
    payload_start: bool  # PUSI
    has_payload: bool
    pcr: int | None
    payload: bytes


def _split_packet(raw: bytes) -> _Packet:
    if raw[0] != _SYNC:
        raise TransportStreamError("Invalid sync byte: %x" % raw[0])
    pid = (raw[1] & 0x1F) << 8 | raw[2]
    pusi = bool(raw[1] & 0x40)
    has_adaptation = bool(raw[3] & 0x20)
    has_payload = bool(raw[3] & 0x10)

    pcr = None
    offset = 4
    if has_adaptation:
        af_len = raw[4]
        if af_len > 0 and (raw[5] & 0x10):
            pcr = _read_pcr(raw[6:12])
        offset = 5 + af_len
    return _Packet(pid, pusi, has_payload, pcr, raw[offset:])


def _read_pcr(b: bytes) -> int:
    """42-bit PCR: 33-bit base @90 kHz + 9-bit extension @27 MHz."""
    base = (b[0] << 25) | (b[1] << 17) | (b[2] << 9) | (b[3] << 1) | (b[4] >> 7)
    ext = ((b[4] & 0x01) << 8) | b[5]
    return base * 300 + ext


def _read_pts(b: bytes) -> int:
    """33-bit PTS @90 kHz packed with marker bits; scaled to 27 MHz."""
    base = (
        ((b[0] >> 1) & 0x07) << 30
        | b[1] << 22
        | (b[2] >> 1) << 15
        | b[3] << 7
        | (b[4] >> 1)
    )
    return base * 300


def _psi_table(payload: bytes):
    """Strip the pointer field and return (table_id, section bytes sans CRC)."""
    data = payload[1 + payload[0] :] if payload else b""
    if len(data) < 3:
        return None, b""
    table_id = data[0]
    length = (data[1] & 0x0F) << 8 | data[2]
    return table_id, data[3 : 3 + length][:-4]  # section minus CRC32


def _pat_programs(payload: bytes):
    """Program-map PIDs from a PAT section (program 0 = NIT, skipped)."""
    table_id, section = _psi_table(payload)
    if table_id != 0x00:
        return []
    pids = []
    body = section[5:]  # skip tsid/version/section numbers
    for i in range(0, len(body) - 3, 4):
        program = body[i] << 8 | body[i + 1]
        pid = (body[i + 2] & 0x1F) << 8 | body[i + 3]
        if program != 0:
            pids.append(pid)
    return pids


def _pmt_caption_pid(payload: bytes):
    """Caption elementary PID from a PMT: stream_type 0x06 whose descriptor
    loop carries a stream-identifier (0x52) with component tag 0x87."""
    table_id, section = _psi_table(payload)
    if table_id != 0x02:
        return None
    if len(section) < 9:
        return None
    # section: program_number(2) version(1) sec(1) last(1) PCR_PID(2)
    #          program_info_length(2) [program descriptors] [ES loop]
    info_len = (section[7] & 0x0F) << 8 | section[8]
    es = section[9 + info_len :]
    while len(es) >= 5:
        stream_type = es[0]
        pid = (es[1] & 0x1F) << 8 | es[2]
        es_info_len = (es[3] & 0x0F) << 8 | es[4]
        if stream_type == 0x06:
            desc = es[5 : 5 + es_info_len]
            while len(desc) >= 2:
                if desc[0] == 0x52 and desc[1] >= 1 and desc[2] == 0x87:
                    return pid
                desc = desc[2 + desc[1] :]
        es = es[5 + es_info_len :]
    return None


def _pes_caption(payload: bytes):
    """(pts | None, text) from a caption PES packet."""
    pts = None
    if payload[7] >> 7:
        pts = _read_pts(payload[9:])

    header_len = payload[8]
    # ARIB synchronized PES: skip PES header, then the data-group header
    data_len = payload[11 + header_len] & 0x0F
    data = payload[12 + header_len + data_len :]

    group_id = (data[0] & 0xFC) >> 2
    if group_id in (0x00, 0x20):  # caption management data carries languages
        data = data[7 + data[6] * 5 :]
    else:
        data = data[6:]

    loop_len = data[0] << 16 | data[1] << 8 | data[2]
    data = data[3 : 3 + loop_len]

    text = []
    while data:
        unit_type = data[1]
        size = data[2] << 16 | data[3] << 8 | data[4]
        if unit_type == 0x20:  # text data unit
            text.append(decode_cprofile(data[8 : 8 + size]))
        data = data[5 + size :]
    return pts, "".join(text)


@dataclass
class _Demuxer:
    clock_init: int | None = None
    clock_now: int | None = None
    pmt_pids: list = field(default_factory=list)
    caption_pid: int | None = None
    stamped: list = field(default_factory=list)  # (pts, text)

    def feed(self, raw: bytes):
        pkt = _split_packet(raw)
        if pkt.pcr is not None:
            self.clock_now = pkt.pcr
            if self.clock_init is None:
                self.clock_init = pkt.pcr
        if not pkt.has_payload:
            return
        if not self.pmt_pids:
            if pkt.pid == 0:
                self.pmt_pids = _pat_programs(pkt.payload)
        elif self.caption_pid is None:
            if pkt.pid in self.pmt_pids:
                self.caption_pid = _pmt_caption_pid(pkt.payload)
        elif pkt.pid == self.caption_pid and pkt.payload_start:
            try:
                pts, text = _pes_caption(pkt.payload)
            except IndexError:
                return  # malformed PES; skip (parity: caption.py:270-274)
            self.stamped.append((pts if pts is not None else self.clock_now, text))

    def _seconds(self, ts):
        n = ts - self.clock_init
        if n < 0:  # 27 MHz counter wraparound
            n += _CLOCK_HZ
        return float(n / _CLOCK_HZ)

    def captions(self):
        out = []
        stamped = self.stamped + [(self.clock_now, "")]
        for (t0, text), (t1, _) in zip(stamped, stamped[1:]):
            if text:
                out.append(Caption(self._seconds(t0), self._seconds(t1), text))
        return out


def get_captions(path):
    """Extract captions from an M2TS stream file.

    Args:
        path (str): path to an M2TS file.

    Returns:
        list[Caption]
    """
    demux = _Demuxer()
    with open(path, "rb") as fp:
        while True:
            raw = fp.read(PACKET_SIZE)
            if len(raw) < PACKET_SIZE:
                break
            demux.feed(raw)
    return demux.captions()
