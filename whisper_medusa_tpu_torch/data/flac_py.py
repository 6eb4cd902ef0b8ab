"""Pure-Python FLAC decoder — the port's own copy of
whisper_medusa_tpu/data/flac_py.py (it imports only numpy).

The reference reads LibriSpeech's .flac via torchaudio's libsox backend
(reference: whisper_medusa/dataset/dataset.py:67); this framework decodes it
first-party.  The JAX package's native C++ decoder (data/native.py) is not
ported yet, so this module is the port's FLAC path (data/audio.py).

Covers the full lossless frame format: CONSTANT/VERBATIM/FIXED/LPC subframes,
Rice+Rice2 residuals with escape codes, wasted bits, and stereo decorrelation.
CRCs are not verified.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


class _BitReader:
    def __init__(self, data: bytes, byte_off: int = 0):
        self.data = data
        self.bit = 8 * byte_off
        self.nbits = 8 * len(data)

    def have(self, k: int) -> bool:
        return self.bit + k <= self.nbits

    def bits(self, k: int) -> int:
        if k == 0:
            return 0
        if not self.have(k):
            raise EOFError("flac: out of data")
        v = 0
        b = self.bit
        left = k
        data = self.data
        while left > 0:
            byte = b >> 3
            off = b & 7
            take = min(8 - off, left)
            chunk = (data[byte] >> (8 - off - take)) & ((1 << take) - 1)
            v = (v << take) | chunk
            b += take
            left -= take
        self.bit = b
        return v

    def sbits(self, k: int) -> int:
        v = self.bits(k)
        if v >> (k - 1):
            v -= 1 << k
        return v

    def unary(self) -> int:
        q = 0
        while not self.bits(1):
            q += 1
            if q > 1 << 24:
                raise ValueError("flac: corrupt unary run")
        return q

    def align(self) -> None:
        self.bit = (self.bit + 7) & ~7


def _skip_utf8(br: _BitReader) -> None:
    b0 = br.bits(8)
    follow = 0
    m = 0x80
    while b0 & m:
        follow += 1
        m >>= 1
    if follow == 1 or follow > 7:
        raise ValueError("flac: bad frame number coding")
    for _ in range(max(follow - 1, 0)):
        br.bits(8)


def _residual(br: _BitReader, block_size: int, order: int) -> List[int]:
    method = br.bits(2)
    if method > 1:
        raise ValueError("flac: reserved residual method")
    plen, escape = (4, 0xF) if method == 0 else (5, 0x1F)
    part_order = br.bits(4)
    n_parts = 1 << part_order
    if block_size % n_parts:
        raise ValueError("flac: bad partition order")
    part_samples = block_size >> part_order
    if part_samples < order:
        raise ValueError("flac: partition smaller than predictor order")
    res: List[int] = []
    for part in range(n_parts):
        count = part_samples - order if part == 0 else part_samples
        param = br.bits(plen)
        if param == escape:
            raw = br.bits(5)
            res.extend(br.sbits(raw) if raw else 0 for _ in range(count))
        else:
            for _ in range(count):
                q = br.unary()
                z = (q << param) | (br.bits(param) if param else 0)
                res.append((z >> 1) ^ -(z & 1))
    return res


_FIXED_COEF = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


def _subframe(br: _BitReader, block_size: int, bps: int) -> List[int]:
    if br.bits(1):
        raise ValueError("flac: subframe pad bit set")
    stype = br.bits(6)
    wasted = 0
    if br.bits(1):
        wasted = br.unary() + 1
    bps -= wasted
    if bps <= 0:
        raise ValueError("flac: nonpositive effective bps")

    if stype == 0:  # CONSTANT
        out = [br.sbits(bps)] * block_size
    elif stype == 1:  # VERBATIM
        out = [br.sbits(bps) for _ in range(block_size)]
    elif 8 <= stype <= 12:  # FIXED
        order = stype - 8
        out = [br.sbits(bps) for _ in range(order)]
        res = _residual(br, block_size, order)
        coef = _FIXED_COEF[order]
        for i, r in enumerate(res):
            pos = order + i
            out.append(r + sum(c * out[pos - 1 - j] for j, c in enumerate(coef)))
    elif stype >= 32:  # LPC
        order = (stype & 31) + 1
        out = [br.sbits(bps) for _ in range(order)]
        precision = br.bits(4) + 1
        if precision == 16:
            raise ValueError("flac: invalid lpc precision")
        shift = br.sbits(5)
        if shift < 0:
            raise ValueError("flac: negative lpc shift")
        coef = [br.sbits(precision) for _ in range(order)]
        res = _residual(br, block_size, order)
        for i, r in enumerate(res):
            pos = order + i
            acc = sum(c * out[pos - 1 - j] for j, c in enumerate(coef))
            out.append(r + (acc >> shift))
    else:
        raise ValueError(f"flac: reserved subframe type {stype}")
    if wasted:
        out = [v << wasted for v in out]
    return out


def decode_flac(data: bytes) -> Tuple[np.ndarray, int]:
    """Decode a FLAC byte stream to (float32 mono, sample_rate)."""
    if data[:4] != b"fLaC":
        raise ValueError("not a FLAC stream")
    off = 4
    sr = channels = bps = 0
    last = False
    while not last:
        last = bool(data[off] & 0x80)
        btype = data[off] & 0x7F
        bsize = int.from_bytes(data[off + 1: off + 4], "big")
        off += 4
        if btype == 0 and bsize >= 34:  # STREAMINFO
            s = data[off:]
            sr = (s[10] << 12) | (s[11] << 4) | (s[12] >> 4)
            channels = ((s[12] >> 1) & 0x7) + 1
            bps = (((s[12] & 1) << 4) | (s[13] >> 4)) + 1
        off += bsize
    if not sr:
        raise ValueError("flac: missing STREAMINFO")

    br = _BitReader(data, off)
    chunks: List[np.ndarray] = []
    while br.have(16):
        if br.bits(14) != 0x3FFE:
            raise ValueError("flac: lost frame sync")
        br.bits(2)  # reserved + blocking strategy
        bs_code = br.bits(4)
        sr_code = br.bits(4)
        chan_asgn = br.bits(4)
        size_code = br.bits(3)
        br.bits(1)
        _skip_utf8(br)
        if bs_code == 0:
            raise ValueError("flac: reserved block size")
        elif bs_code == 1:
            block_size = 192
        elif bs_code <= 5:
            block_size = 576 << (bs_code - 2)
        elif bs_code == 6:
            block_size = br.bits(8) + 1
        elif bs_code == 7:
            block_size = br.bits(16) + 1
        else:
            block_size = 256 << (bs_code - 8)
        if sr_code == 12:
            br.bits(8)
        elif sr_code in (13, 14):
            br.bits(16)
        fbps = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}.get(size_code, bps)
        br.bits(8)  # CRC-8

        n_ch = 2 if chan_asgn >= 8 else chan_asgn + 1
        if chan_asgn > 10 or n_ch != channels:
            raise ValueError("flac: unsupported channel assignment")
        chs = []
        for c in range(n_ch):
            extra = int((chan_asgn == 8 and c == 1) or (chan_asgn == 9 and c == 0)
                        or (chan_asgn == 10 and c == 1))
            chs.append(_subframe(br, block_size, fbps + extra))
        br.align()
        br.bits(16)  # CRC-16

        a = np.asarray(chs, np.int64)
        if chan_asgn == 8:      # left/side
            a = np.stack([a[0], a[0] - a[1]])
        elif chan_asgn == 9:    # right/side
            a = np.stack([a[1] + a[0], a[1]])
        elif chan_asgn == 10:   # mid/side
            mid = (a[0] << 1) | (a[1] & 1)
            a = np.stack([(mid + a[1]) >> 1, (mid - a[1]) >> 1])
        mono = a.mean(axis=0) / float(1 << (fbps - 1))
        chunks.append(mono.astype(np.float32))
    if not chunks:
        raise ValueError("flac: no audio frames")
    return np.concatenate(chunks), sr
