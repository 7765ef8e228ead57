"""A FLAC stream writer for the port's tests (a copy of the writer in
``tests/test_flac.py``, which no test file imports from another): valid
streams hand-assembled from STREAMINFO and frames with verbatim, constant,
fixed-order-1 and LPC rice-coded subframes, and ``mono16`` for a mono
16-bit stream of any number of 4096-sample frames."""
import numpy as np


class BitWriter:
    def __init__(self):
        self.bits = []

    def write(self, value: int, n: int):
        for i in range(n - 1, -1, -1):
            self.bits.append((value >> i) & 1)

    def write_unary(self, q: int):
        self.bits.extend([0] * q + [1])

    def align(self):
        while len(self.bits) % 8:
            self.bits.append(0)

    def bytes(self) -> bytes:
        self.align()
        out = bytearray()
        for i in range(0, len(self.bits), 8):
            b = 0
            for bit in self.bits[i : i + 8]:
                b = (b << 1) | bit
            out.append(b)
        return bytes(out)


def streaminfo(sample_rate, channels, bps, total):
    bw = BitWriter()
    bw.write(4096, 16)  # min block
    bw.write(4096, 16)  # max block
    bw.write(0, 24)     # min frame size
    bw.write(0, 24)     # max frame size
    bw.write(sample_rate, 20)
    bw.write(channels - 1, 3)
    bw.write(bps - 1, 5)
    bw.write(total, 36)
    body = bw.bytes() + b"\x00" * 16  # md5 zeros
    head = bytes([0x80]) + len(body).to_bytes(3, "big")  # last block, type 0
    return b"fLaC" + head + body


def frame_header(block_size_code, frame_idx, extra_bytes=b"", channel_code=0):
    bw = BitWriter()
    bw.write(0b11111111111110, 14)
    bw.write(0, 1)  # reserved
    bw.write(0, 1)  # fixed blocksize strategy
    bw.write(block_size_code, 4)
    bw.write(0b0101, 4)        # 16 kHz from table
    bw.write(channel_code, 4)  # 0: 1 channel; 8 / 9 / 10: left / right / mid side
    bw.write(0b100, 3)         # 16 bps
    bw.write(0, 1)             # reserved
    out = bw.bytes()
    assert frame_idx < 0x80
    out += bytes([frame_idx])  # utf8 frame number (small)
    out += extra_bytes
    out += b"\x00"  # crc8 (unverified)
    return out


def encode_verbatim(samples, bits=16):
    bw = BitWriter()
    bw.write(0, 1)          # padding
    bw.write(1, 6)          # verbatim
    bw.write(0, 1)          # no wasted bits
    mask = (1 << bits) - 1
    for s in samples:
        bw.write(int(s) & mask, bits)
    return bw


def encode_constant(value):
    bw = BitWriter()
    bw.write(0, 1)
    bw.write(0, 6)          # constant
    bw.write(0, 1)
    bw.write(int(value) & 0xFFFF, 16)
    return bw


def _rice(bw, res, rice_param):
    zz = (res << 1) if res >= 0 else ((-res) << 1) - 1
    q, r = zz >> rice_param, zz & ((1 << rice_param) - 1)
    bw.write_unary(q)
    bw.write(r, rice_param)


def encode_fixed1_rice(samples, rice_param=4):
    """Fixed predictor order 1 with one rice partition."""
    bw = BitWriter()
    bw.write(0, 1)
    bw.write(8 + 1, 6)      # fixed, order 1
    bw.write(0, 1)
    bw.write(int(samples[0]) & 0xFFFF, 16)  # warmup
    bw.write(0, 2)          # residual method 0 (4-bit rice)
    bw.write(0, 4)          # partition order 0
    bw.write(rice_param, 4)
    for i in range(1, len(samples)):
        _rice(bw, int(samples[i]) - int(samples[i - 1]), rice_param)
    return bw


def encode_lpc_rice(samples, coeffs, shift, rice_param=6, precision=15):
    """LPC of order len(coeffs): x[i] = residual + (sum c_j x[i-1-j]) >> shift."""
    order = len(coeffs)
    bw = BitWriter()
    bw.write(0, 1)
    bw.write(32 + order - 1, 6)
    bw.write(0, 1)
    for i in range(order):
        bw.write(int(samples[i]) & 0xFFFF, 16)  # warmup
    bw.write(precision - 1, 4)
    bw.write(shift, 5)
    for c in coeffs:
        bw.write(int(c) & ((1 << precision) - 1), precision)
    bw.write(0, 2)            # rice method 0
    bw.write(0, 4)            # partition order 0
    bw.write(rice_param, 4)
    for i in range(order, len(samples)):
        pred = sum(int(coeffs[j]) * int(samples[i - 1 - j]) for j in range(order)) >> shift
        _rice(bw, int(samples[i]) - pred, rice_param)
    return bw


def build_flac(subframe_writer, samples, block_size_code=0b1100):
    """One-frame mono 16 kHz 16-bit FLAC stream (4096-sample block)."""
    data = streaminfo(16000, 1, 16, len(samples))
    data += frame_header(block_size_code, 0) + subframe_writer.bytes() + b"\x00\x00"
    return data


def build_stereo(left, right, mode):
    """One 4096-sample stereo frame in decorrelation ``mode`` (left_side,
    right_side, mid_side), verbatim subframes."""
    side = left - right
    if mode == "left_side":
        code, subs = 8, ((left, 16), (side, 17))
    elif mode == "right_side":
        code, subs = 9, ((side, 17), (right, 16))
    else:
        code, subs = 10, (((left + right) >> 1, 16), (side, 17))
    bw = BitWriter()
    for samples, bits in subs:
        bw.bits.extend(encode_verbatim(samples, bits).bits)
    return (streaminfo(16000, 2, 16, len(left)) + frame_header(0b1100, 0, channel_code=code)
            + bw.bytes() + b"\x00\x00")


def mono16(pcm: np.ndarray) -> bytes:
    """A mono 16 kHz 16-bit stream of int16 ``pcm`` (a multiple of 4096
    samples), one verbatim frame per 4096 samples. A verbatim 16-bit subframe
    is byte-aligned: its header byte, then the samples big-endian."""
    pcm = np.asarray(pcm, np.int16)
    assert len(pcm) % 4096 == 0 and len(pcm) // 4096 < 0x80
    data = streaminfo(16000, 1, 16, len(pcm))
    for k in range(len(pcm) // 4096):
        block = pcm[k * 4096 : (k + 1) * 4096]
        data += frame_header(0b1100, k) + b"\x02" + block.astype(">i2").tobytes() + b"\x00\x00"
    return data
