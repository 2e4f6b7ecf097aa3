"""WEBP files without an imaging library: the counterpart of Pillow's
``save(..., "WEBP", save_all=True)`` that SaveAnimatedWEBP calls in
``comfyui_distributed_tpu/ops/basic.py``.

- The container: RIFF ``WEBP`` with ``VP8X`` (the animation flag),
  ``ANIM`` (background 0, the loop count) and one ``ANMF`` a frame (the
  whole canvas, no blending, no disposal).  A frame equal to the one
  before adds its duration to that frame instead, as libwebp's animation
  encoder merges it, and when one frame is left the file is a still
  image, as libwebp then writes it.
- Lossless (``VP8L``): no transforms, no colour cache, no backward
  references and one group of prefix codes, so every pixel is its four
  literal codes; it decodes to the 8-bit frame exactly.
- Lossy (``VP8 ``): one key frame a frame (RFC 6386): RGB to limited-range
  YUV 4:2:0 as libwebp converts it, the 16x16 luma and 8x8 chroma intra
  predictions (DC, V, H, TM) on the reconstruction, the integer DCT and
  the WHT of the sixteen luma DCs, one quantiser index from ``quality``
  (libwebp's curve), tokens under the default coefficient
  probabilities with the boolean coder, no loop filter.  ``method``
  (0-6) only changes how many modes are tried.

The tables below are RFC 6386's: ``default_coeff_probs`` (13.5),
``coeff_update_probs`` (13.4), ``dc_qlookup`` and ``ac_qlookup``
(14.1), each coefficient token's extra-bit probabilities (13.2).
:func:`webp_frames` reads a file's chunks back (frame count, durations,
loop) without decoding it.
"""

from __future__ import annotations

import heapq
import struct
from typing import List, Sequence, Tuple

import numpy as np

# --- RFC 6386 tables ---------------------------------------------------------

_COEFF_PROBS_HEX = """
8080808080808080808080808080808080808080808080808080808080808080
80fd88feffe4db8080808080bd81f2ffe3d5ffdb8080806a7ee3fcd6d1ffff80
80800162f8ffece2ffff808080b585eefeddeaff9a8080804e86caf7c6b4ffdb
80808001b9f9fff3ff8080808080b896f7ffece080808080804d6ed8ffece680
808080800165fbfff1ff8080808080aa8bf1fcecd1ffff8080802574c4f3e4ff
ffff80808001ccfefff5ff8080808080cfa0faffee8080808080806667e7ffd3
ab80808080800198fcfff0ff8080808080b187f3ffeae180808080805081d3ff
c2e080808080800101ff8080808080808080f601ff8080808080808080ff8080
8080808080808080c623eddfc1bba2a0919b3e832dc6ddacb0dc9dfcdd01442f
92d095a7dda2ffdf800195f1ffdde0ffff808080b88deafddedcffc780808051
63b5f2b0bef9caffff800181e8fdd6c5f2c4ffff806379d2fac9c6ffca808080
175ba3f2aabbf7d2ffff8001c8f6ffeaff80808080806db2f1ffe7f5ffff8080
802c82c9fdcdc0ffff8080800184effbdbd1ffa58080805e88e1fbdabeffff80
80801664aef5baa1ffc780808001b6f9ffe8eb80808080807c8ff1ffe3ea8080
808080234db5fbc1d3ffcd808080019df7ffece7ffff808080798debffe1e3ff
ff8080802d63bcfbc3d9ffe08080800101fbffd5ff8080808080cb01f8ffff80
80808080808901b1ffe0ff8080808080fd09f8fbcfd0ffc0808080af0de0f3c1
b9f9c6ffff804911abdda1b3eca7ffea80015ff7fdd4b7ffff808080ef5af4fa
d3d1ffff8080809b4dc3f8bcc3ffff8080800118effbdadbffcd808080c933db
ffc4ba8080808080452ebeefc9daffe480808001bffbffff808080808080dfa5
f9ffd5ff80808080808d7cf8ffff8080808080800110f8ffff808080808080be
24e6ffecff80808080809501ff808080808080808001e2ff8080808080808080
f7c0ff8080808080808080f080ff80808080808080800186fcffff8080808080
80d53efaffff808080808080375dff8080808080808080808080808080808080
808080808080808080808080808080808080808080808080ca18d5ebbabfdca0
f0afff7e26b6e8a9b8e4aeffbb803d2e8adb97b2f0aaffd8800170e6fac7bff7
9fffff80a66de4fcd3d7ffae808080274da2e8acb4f5b2ffff800134dcf6c6c7
f9dcffff807c4abff3b7c1faddffff80184782db9aaaf3b6ffff8001b6e1f9db
f0ffe08080809596e2fcd8cdffab8080801c6caaf2b7c2fedfffff800151e6fc
cccbffc08080807b66d1f7bcc4ffe9808080145f99f3a4adffcb80808001def8
ffd8d58080808080a8aff6fcebcdffff8080802f74d7ffd3d4ffff8080800179
ecfdd4d6ffff8080808d54d5fcc9caffdb8080802a50a0f0a2b9ffcd80808001
01ff8080808080808080f401ff8080808080808080ee01ff8080808080808080
"""
_UPDATE_PROBS_HEX = """
ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff
ffb0f6ffffffffffffffffffdff1fcfffffffffffffffff9fdfdffffffffffff
fffffff4fcffffffffffffffffeafefefffffffffffffffffdffffffffffffff
fffffffff6feffffffffffffffffeffdfefffffffffffffffffefffeffffffff
fffffffffff8fefffffffffffffffffbfffeffffffffffffffffffffffffffff
fffffffffffffdfefffffffffffffffffbfefefffffffffffffffffefffeffff
fffffffffffffffefdfffefffffffffffffafffefffefffffffffffffeffffff
ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff
ffffffffffffffffd9ffffffffffffffffffffe1fcf1fdfffffeffffffffeafa
f1fafdfffdfefffffffffeffffffffffffffffffdffefeffffffffffffffffee
fdfefefffffffffffffffff8fefffffffffffffffff9feffffffffffffffffff
fffffffffffffffffffffffffdfffffffffffffffffff7feffffffffffffffff
fffffffffffffffffffffffffffdfefffffffffffffffffcffffffffffffffff
fffffffffffffffffffffffffffffefefffffffffffffffffdffffffffffffff
fffffffffffffffffffffffffffffffefdfffffffffffffffffaffffffffffff
fffffffffeffffffffffffffffffffffffffffffffffffffffffffffffffffff
ffffffffffffffffffffffffffffffffbafbfaffffffffffffffffeafbf4feff
fffffffffffffbfbf3fdfefffefffffffffffdfeffffffffffffffffecfdfeff
fffffffffffffffbfdfdfefefffffffffffffffefefffffffffffffffffefefe
fffffffffffffffffffffffffffffffffffffffffefffffffffffffffffffefe
fffffffffffffffffffefffffffffffffffffffffffffffffffffffffffffffe
ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff
ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff
ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff
fffffffffffffffffffffffffffffffffffffffffffffffff8ffffffffffffff
fffffffafefcfefffffffffffffff8fef9fdfffffffffffffffffdfdffffffff
fffffffff6fdfdfffffffffffffffffcfefbfefefffffffffffffffefcffffff
fffffffffff8fefdfffffffffffffffffdfffefefffffffffffffffffbfeffff
fffffffffffff5fbfefffffffffffffffffdfdfefffffffffffffffffffbfdff
fffffffffffffffcfdfefffffffffffffffffffefffffffffffffffffffffcff
fffffffffffffffff9fffefffffffffffffffffffffeffffffffffffffffffff
fdfffffffffffffffffaffffffffffffffffffffffffffffffffffffffffffff
fffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffff
"""
_DC_Q_HEX = """
0405060708090a0a0b0c0d0e0f101111121314141515161617171819191a1b1c
1d1e1f20212223242525262728292a2b2c2d2e2e2f303132333435363738393a
3b3c3d3e3f404142434445464748494a4b4c4c4d4e4f50515253545556575859
5b5d5f6062646566686a6c6e707274767a7c7e80828486888a8c8f9194979a9d
"""
_AC_Q = (
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22,
    23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40,
    41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    60, 62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90, 92, 94,
    96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125, 128,
    131, 134, 137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170,
    173, 177, 181, 185, 189, 193, 197, 201, 205, 209, 213, 217, 221, 225,
    229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,)

COEFF_PROBS = np.frombuffer(bytes.fromhex("".join(_COEFF_PROBS_HEX.split())),
                            np.uint8).reshape(4, 8, 3, 11)
COEFF_UPDATE_PROBS = np.frombuffer(
    bytes.fromhex("".join(_UPDATE_PROBS_HEX.split())),
    np.uint8).reshape(4, 8, 3, 11)
DC_Q = np.frombuffer(bytes.fromhex("".join(_DC_Q_HEX.split())), np.uint8)
AC_Q = np.asarray(_AC_Q, np.int32)

ZIGZAG = np.array([0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15])
_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_CAT_PROBS = ((173, 148, 140), (176, 155, 140, 135),
              (180, 157, 141, 134, 130),
              (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# block types: Y after Y2, Y2, chroma
_TYPE_Y, _TYPE_Y2, _TYPE_UV = 0, 1, 2
# intra modes
DC_PRED, V_PRED, H_PRED, TM_PRED = 0, 1, 2, 3
# quantiser rounding, 1/256 units (libwebp's bias: [dc, ac])
_BIAS = {_TYPE_Y: (96, 110), _TYPE_Y2: (96, 108), _TYPE_UV: (110, 115)}


# --- the container -----------------------------------------------------------

def _chunk(tag: bytes, data: bytes) -> bytes:
    return tag + struct.pack("<I", len(data)) + data + b"\0" * (len(data) & 1)


def _u24(v: int) -> bytes:
    return struct.pack("<I", v)[:3]


def encode_animated_webp(frames: np.ndarray, duration_ms: int,
                         loop: int = 0, lossless: bool = True,
                         quality: int = 80, method: int = 4) -> bytes:
    """[B, H, W, 3] uint8 frames -> a WEBP file (see the module doc)."""
    frames = np.asarray(frames)
    if frames.ndim != 4 or frames.shape[-1] != 3 \
            or frames.dtype != np.uint8:
        raise ValueError(f"encode_animated_webp takes [B, H, W, 3] uint8; "
                         f"got {frames.dtype} {frames.shape}")
    _, h, w, _ = frames.shape
    if not (1 <= w <= 16383 and 1 <= h <= 16383):
        raise ValueError(f"WEBP frames are at most 16383 a side; got "
                         f"{w}x{h}")
    if not 0 <= int(quality) <= 100:
        raise ValueError(f"WEBP quality {quality} is not in [0, 100]")
    kept: List[np.ndarray] = []
    durations: List[int] = []
    for f in frames:
        if kept and np.array_equal(f, kept[-1]):
            durations[-1] += int(duration_ms)
            continue
        kept.append(f)
        durations.append(int(duration_ms))

    if lossless:
        streams = [_chunk(b"VP8L", encode_vp8l(px)) for px in kept]
    else:
        streams = [_chunk(b"VP8 ", encode_vp8(px, int(quality), int(method)))
                   for px in kept]
    if len(kept) == 1:
        return _chunk(b"RIFF", b"WEBP" + streams[0])
    if max(durations) >= 1 << 24:
        raise ValueError(f"WEBP frame of {max(durations)} ms: ANMF holds "
                         f"at most {(1 << 24) - 1}")
    body = [b"WEBP",
            _chunk(b"VP8X", bytes([0x02, 0, 0, 0]) + _u24(w - 1)
                   + _u24(h - 1)),
            _chunk(b"ANIM", struct.pack("<IH", 0, int(loop)))]
    for stream, dur in zip(streams, durations):
        # x/2, y/2, width - 1, height - 1, duration, flags: no blending
        body.append(_chunk(b"ANMF", _u24(0) + _u24(0) + _u24(w - 1)
                           + _u24(h - 1) + _u24(dur) + bytes([0x02])
                           + stream))
    return _chunk(b"RIFF", b"".join(body))


def webp_frames(data: bytes) -> Tuple[int, List[int], int]:
    """(frames, each frame's duration in ms, loop count) of a WEBP file
    from its chunks; a still image is one frame of 0 ms played once
    (loop 1, as libwebp's demuxer reports it)."""
    if data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError("not a WEBP file")
    pos, durations, loop, still = 12, [], 0, 0
    while pos + 8 <= len(data):
        tag, size = data[pos:pos + 4], struct.unpack(
            "<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if tag == b"ANIM":
            loop = struct.unpack("<H", body[4:6])[0]
        elif tag == b"ANMF":
            durations.append(int.from_bytes(body[12:15], "little"))
        elif tag in (b"VP8 ", b"VP8L"):
            still += 1
        pos += 8 + size + (size & 1)
    if not durations:
        if still != 1:
            raise ValueError("WEBP file without a frame")
        return 1, [0], 1
    return len(durations), durations, loop


# --- prefix codes (VP8L) -----------------------------------------------------

def _huffman_lengths(counts: np.ndarray, max_len: int) -> np.ndarray:
    """Code lengths of a Huffman code over the used symbols (two or
    more), none longer than ``max_len``: the counts are flattened (each
    raised to a floor that doubles) until the tree fits."""
    counts = np.asarray(counts, np.int64)
    used = np.flatnonzero(counts)
    floor = 1
    while True:
        c = np.maximum(counts[used], floor)
        heap = [(int(n), i, (int(s),)) for i, (n, s) in
                enumerate(zip(c, used))]
        heapq.heapify(heap)
        depth = dict.fromkeys((int(s) for s in used), 0)
        tie = len(heap)
        while len(heap) > 1:
            n1, _, a = heapq.heappop(heap)
            n2, _, b = heapq.heappop(heap)
            for s in a + b:
                depth[s] += 1
            heapq.heappush(heap, (n1 + n2, tie, a + b))
            tie += 1
        if max(depth.values()) <= max_len:
            out = np.zeros(len(counts), np.int64)
            for s, d in depth.items():
                out[s] = d
            return out
        floor *= 2


def _canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """DEFLATE's canonical codes for ``lengths``, bit-reversed for a
    reader that takes bits least significant first."""
    lengths = np.asarray(lengths, np.int64)
    max_len = int(lengths.max()) if lengths.size else 0
    bl_count = np.bincount(lengths, minlength=max_len + 1)
    bl_count[0] = 0
    next_code, code = [0] * (max_len + 2), 0
    for bits in range(1, max_len + 1):
        code = (code + int(bl_count[bits - 1])) << 1
        next_code[bits] = code
    out = np.zeros(len(lengths), np.int64)
    for s, n in enumerate(lengths):
        if n:
            c = next_code[n]
            next_code[n] += 1
            out[s] = int(format(c, f"0{n}b")[::-1], 2)
    return out


_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12,
                      13, 14, 15)


class _LsbWriter:
    """VP8L's bit writer: values least significant bit first, packed
    at the end in one vectorized pass."""

    def __init__(self):
        self.values: List[np.ndarray] = []
        self.nbits: List[np.ndarray] = []

    def put(self, value: int, n: int) -> None:
        self.values.append(np.array([value], np.int64))
        self.nbits.append(np.array([n], np.int64))

    def put_many(self, values: np.ndarray, nbits: np.ndarray) -> None:
        self.values.append(np.asarray(values, np.int64).ravel())
        self.nbits.append(np.asarray(nbits, np.int64).ravel())

    def prefix_code(self, counts: np.ndarray) -> Tuple[np.ndarray,
                                                       np.ndarray]:
        """Write the prefix code of ``counts`` (a simple code for one or
        two symbols below 256, else a normal one with literal lengths);
        returns each symbol's (code, length)."""
        used = np.flatnonzero(counts)
        n = len(counts)
        if len(used) == 0:
            used = np.array([0])
        if len(used) <= 2 and used.max() < 256:
            self.put(1, 1)
            self.put(len(used) - 1, 1)
            first = int(used[0])
            if first < 2:
                self.put(0, 1)
                self.put(first, 1)
            else:
                self.put(1, 1)
                self.put(first, 8)
            if len(used) == 2:
                self.put(int(used[1]), 8)
            lengths = np.zeros(n, np.int64)
            if len(used) == 2:
                lengths[used] = 1
            return _canonical_codes(lengths), lengths
        lengths = _huffman_lengths(counts, 15)
        codes = _canonical_codes(lengths)
        self.put(0, 1)
        cl_counts = np.bincount(lengths, minlength=19)
        cl_used = np.flatnonzero(cl_counts)
        if len(cl_used) == 1:
            # one length for every symbol: its code has one entry, read
            # in zero bits
            cl_lengths = np.zeros(19, np.int64)
            cl_lengths[cl_used] = 1
            cl_codes, cl_nbits = np.zeros(19, np.int64), np.zeros(19,
                                                                  np.int64)
        else:
            cl_lengths = _huffman_lengths(cl_counts, 7)
            cl_codes, cl_nbits = _canonical_codes(cl_lengths), cl_lengths
        num = max(4, max(i + 1 for i, s in enumerate(_CODE_LENGTH_ORDER)
                         if cl_lengths[s]))
        self.put(num - 4, 4)
        for s in _CODE_LENGTH_ORDER[:num]:
            self.put(int(cl_lengths[s]), 3)
        self.put(0, 1)          # every symbol's length follows
        self.put_many(cl_codes[lengths], cl_nbits[lengths])
        return codes, lengths

    def bytes(self) -> bytes:
        values = np.concatenate(self.values)
        nbits = np.concatenate(self.nbits)
        keep = nbits > 0
        values, nbits = values[keep], nbits[keep]
        total = int(nbits.sum())
        start = np.cumsum(nbits) - nbits
        sym = np.repeat(np.arange(len(values)), nbits)
        j = np.arange(total, dtype=np.int64) - np.repeat(start, nbits)
        bits = ((values[sym] >> j) & 1).astype(np.uint8)
        return np.packbits(bits, bitorder="little").tobytes()


def encode_vp8l(px: np.ndarray) -> bytes:
    """[H, W, 3] uint8 -> a VP8L bitstream (signature included) that
    decodes to ``px`` exactly, alpha unused."""
    h, w, _ = px.shape
    bw = _LsbWriter()
    bw.put(0x2F, 8)
    bw.put(w - 1, 14)
    bw.put(h - 1, 14)
    bw.put(0, 1)        # alpha unused
    bw.put(0, 3)        # version
    bw.put(0, 1)        # no transform
    bw.put(0, 1)        # no colour cache
    bw.put(0, 1)        # one group of prefix codes
    r, g, b = (px[..., i].ravel().astype(np.int64) for i in range(3))
    green = np.bincount(g, minlength=280)
    codes = [bw.prefix_code(green),
             bw.prefix_code(np.bincount(r, minlength=256)),
             bw.prefix_code(np.bincount(b, minlength=256)),
             bw.prefix_code(np.bincount(np.full(1, 255), minlength=256)),
             bw.prefix_code(np.bincount(np.zeros(1, np.int64),
                                        minlength=40))]
    # each pixel: green, red, blue (alpha's one symbol takes no bits)
    sym = np.stack([g, r, b], axis=1)
    vals = np.stack([codes[i][0][sym[:, i]] for i in range(3)], axis=1)
    lens = np.stack([codes[i][1][sym[:, i]] for i in range(3)], axis=1)
    bw.put_many(vals, lens)
    return bw.bytes()


# --- the boolean coder (VP8) -------------------------------------------------

class _Bits:
    """A sequence of (bit, probability) pairs for the boolean coder."""

    def __init__(self):
        self.bits: List[int] = []
        self.probs: List[int] = []

    def put(self, bit: int, prob: int) -> None:
        self.bits.append(int(bit))
        self.probs.append(int(prob))

    def literal(self, value: int, n: int) -> None:
        """``n`` bits at probability 1/2, most significant first."""
        for i in range(n - 1, -1, -1):
            self.put((value >> i) & 1, 128)


def _step_tables() -> Tuple[np.ndarray, np.ndarray]:
    """The coder's step in libwebp's form (the range kept less one): for
    index ``(prob * 2 + bit) << 8 | range``, the range after the decision
    and its renormalisation; and for a range after a decision (before
    it), the shift that brings range + 1 back to [128, 255]."""
    r = np.arange(256)
    prob = np.arange(256)[:, None, None]
    bit = np.arange(2)[None, :, None]
    split = (r * prob) >> 8
    after = np.clip(np.where(bit == 1, r - split - 1, split), 0, 255)
    shift = np.where(r < 127, 7 - np.floor(np.log2(r + 1)).astype(np.int64),
                     0)
    return ((after + 1) << shift[after]) - 1, shift


_STEP, _SHIFT = _step_tables()
_STEP = _STEP.ravel()
_STEP_LIST = _STEP.tolist()
# decisions a chunk when the ranges run chunk by chunk at once
_CHUNK = 1024


def _ranges(codes: np.ndarray) -> np.ndarray:
    """The range (less one) before each decision, ``codes`` being
    ``(prob * 2 + bit) << 8``.  The ranges form a chain, but two chains
    under the same decisions meet within a few hundred of them: every
    chunk of about ``_CHUNK`` decisions runs at once from a guessed
    start (254), then chunk by chunk the true chain replaces the guess,
    one decision at a time, until the two meet."""
    n = len(codes)
    nch = max(1, n // _CHUNK)
    size = -(-n // nch)
    c = np.full(nch * size, 128 << 9, np.int64)
    c[:n] = codes
    c = c.reshape(nch, size)
    guess = np.full((nch, size), -1, np.int64)
    state = np.full(nch, 254, np.int64)
    if nch > 1:
        for k in range(size):
            guess[:, k] = state
            state = _STEP[c[:, k] + state]
    ends, step = state.tolist(), _STEP_LIST
    r = 254
    for ch in range(nch):
        row = guess[ch]
        if row[0] == r:
            r = ends[ch]
            continue
        cc, g = c[ch].tolist(), row.tolist()
        k = 0
        while k < size and g[k] != r:
            g[k] = r
            r = step[cc[k] | r]
            k += 1
        row[:k] = g[:k]
        if k < size:
            r = ends[ch]
    return guess.ravel()[:n]


def _bool_encode(bits: Sequence[int], probs: Sequence[int]) -> bytes:
    """The boolean entropy coder of RFC 6386 (7.3) over ``bits`` at
    ``probs``, to libwebp's bytes.  With the ranges known
    (:func:`_ranges`), the coded value is a sum: each 1 adds split + 1,
    shifted by every renormalisation after it; one big integer holds it,
    the carries included, and its top bytes are the output."""
    # the bits, then zeros at probability 1/2 past the last byte
    tail = 9 + 8 * 2
    bits = np.concatenate([np.asarray(bits, np.int64),
                           np.zeros(tail, np.int64)])
    probs = np.concatenate([np.asarray(probs, np.int64),
                            np.full(tail, 128, np.int64)])
    rng = _ranges(((probs * 2 + bits) << 8))
    split = (rng * probs) >> 8
    shift = _SHIFT[np.where(bits == 1, rng - split - 1, split)]
    total = int(shift.sum())
    # each addend's bit position in the final value
    at = (total - np.cumsum(shift) + shift)[bits == 1]
    add = (split[bits == 1] + 1) << (at & 7)
    digits = np.bincount(at >> 3, weights=add.astype(np.float64),
                         minlength=(total >> 3) + 3).astype(np.int64)
    value, k = 0, 0
    while digits.any():
        value += int.from_bytes((digits & 255).astype(np.uint8).tobytes(),
                                "little") << (8 * k)
        digits >>= 8
        k += 1
    # whole bytes leave once more than 8 bits have shifted in
    n = max(0, -(-(total - 8) // 8))
    return ((value >> (total - 8 * n + 8))
            & ((1 << (8 * n)) - 1)).to_bytes(n, "big")


# --- transforms --------------------------------------------------------------

def _fdct(d: np.ndarray) -> np.ndarray:
    """libwebp's forward DCT of [N, 4, 4] residuals (int) -> [N, 16]."""
    d = d.astype(np.int64)
    a0 = d[:, :, 0] + d[:, :, 3]
    a1 = d[:, :, 1] + d[:, :, 2]
    a2 = d[:, :, 1] - d[:, :, 2]
    a3 = d[:, :, 0] - d[:, :, 3]
    t = np.empty((d.shape[0], 4, 4), np.int64)     # [N, row, col]
    t[:, :, 0] = (a0 + a1) * 8
    t[:, :, 1] = (a2 * 2217 + a3 * 5352 + 1812) >> 9
    t[:, :, 2] = (a0 - a1) * 8
    t[:, :, 3] = (a3 * 2217 - a2 * 5352 + 937) >> 9
    a0 = t[:, 0] + t[:, 3]
    a1 = t[:, 1] + t[:, 2]
    a2 = t[:, 1] - t[:, 2]
    a3 = t[:, 0] - t[:, 3]
    out = np.empty((d.shape[0], 4, 4), np.int64)
    out[:, 0] = (a0 + a1 + 7) >> 4
    out[:, 1] = ((a2 * 2217 + a3 * 5352 + 12000) >> 16) + (a3 != 0)
    out[:, 2] = (a0 - a1 + 7) >> 4
    out[:, 3] = (a3 * 2217 - a2 * 5352 + 51000) >> 16
    return out.reshape(-1, 16)


def _mul1(a):
    return ((a * 20091) >> 16) + a


def _mul2(a):
    return (a * 35468) >> 16


def _idct(c: np.ndarray) -> np.ndarray:
    """The decoder's inverse DCT (RFC 6386 14.3) of [N, 16]
    dequantized coefficients -> [N, 4, 4] residuals."""
    c = c.astype(np.int64).reshape(-1, 4, 4)
    a = c[:, 0] + c[:, 2]
    b = c[:, 0] - c[:, 2]
    cc = _mul2(c[:, 1]) - _mul1(c[:, 3])
    d = _mul1(c[:, 1]) + _mul2(c[:, 3])
    t = np.empty_like(c)                       # [N, row, col]
    t[:, 0], t[:, 1], t[:, 2], t[:, 3] = a + d, b + cc, b - cc, a - d
    dc = t[:, :, 0] + 4
    a = dc + t[:, :, 2]
    b = dc - t[:, :, 2]
    cc = _mul2(t[:, :, 1]) - _mul1(t[:, :, 3])
    d = _mul1(t[:, :, 1]) + _mul2(t[:, :, 3])
    out = np.empty_like(c)
    out[:, :, 0], out[:, :, 1] = (a + d) >> 3, (b + cc) >> 3
    out[:, :, 2], out[:, :, 3] = (b - cc) >> 3, (a - d) >> 3
    return out


def _fwht(dc: np.ndarray) -> np.ndarray:
    """libwebp's forward WHT of [N, 16] luma DCs (raster block order)."""
    x = dc.astype(np.int64).reshape(-1, 4, 4)
    a0 = x[:, :, 0] + x[:, :, 2]
    a1 = x[:, :, 1] + x[:, :, 3]
    a2 = x[:, :, 1] - x[:, :, 3]
    a3 = x[:, :, 0] - x[:, :, 2]
    t = np.stack([a0 + a1, a3 + a2, a3 - a2, a0 - a1], axis=2)
    a0 = t[:, 0] + t[:, 2]
    a1 = t[:, 1] + t[:, 3]
    a2 = t[:, 1] - t[:, 3]
    a3 = t[:, 0] - t[:, 2]
    return np.stack([(a0 + a1) >> 1, (a3 + a2) >> 1, (a3 - a2) >> 1,
                     (a0 - a1) >> 1], axis=1).reshape(-1, 16)


def _iwht(c: np.ndarray) -> np.ndarray:
    """The decoder's inverse WHT (RFC 6386 14.3): [N, 16] dequantized Y2
    coefficients -> the 16 luma blocks' DCs."""
    x = c.astype(np.int64).reshape(-1, 4, 4)
    a0 = x[:, 0] + x[:, 3]
    a1 = x[:, 1] + x[:, 2]
    a2 = x[:, 1] - x[:, 2]
    a3 = x[:, 0] - x[:, 3]
    t = np.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2], axis=1)   # rows
    dc = t[:, :, 0] + 3
    a0 = dc + t[:, :, 3]
    a1 = t[:, :, 1] + t[:, :, 2]
    a2 = t[:, :, 1] - t[:, :, 2]
    a3 = dc - t[:, :, 3]
    return np.stack([(a0 + a1) >> 3, (a3 + a2) >> 3, (a0 - a1) >> 3,
                     (a3 - a2) >> 3], axis=2).reshape(-1, 16)


def _quant_rows(q_dc: int, q_ac: int, bias: Tuple[int, int]
               ) -> Tuple[np.ndarray, np.ndarray]:
    """One block's step and rounding bias (1/256 units) by position."""
    q = np.full(16, q_ac, np.int64)
    q[0] = q_dc
    b = np.full(16, bias[1], np.int64)
    b[0] = bias[0]
    return q, b


def _quantize(c: np.ndarray, q: np.ndarray, bias: np.ndarray) -> np.ndarray:
    """Coefficients -> levels, rounded with libwebp's bias and clipped to
    the token alphabet's 2047."""
    mag = np.minimum((np.abs(c) * 256 + q * bias) // (q * 256), 2047)
    return np.where(c < 0, -mag, mag)


# --- intra prediction --------------------------------------------------------

def _predictions(top, left, tl, has_top, has_left,
                 modes: Sequence[int]) -> np.ndarray:
    """The decoder's n x n predictions [B, len(modes), n, n] for
    ``modes`` from B blocks' reconstructed neighbours: ``top`` and
    ``left`` [B, n], ``tl`` and the flags [B]."""
    n = top.shape[1]
    shift = n.bit_length() - 1
    st, sl = top.sum(1), left.sum(1)
    dc = np.where(has_top & has_left, (st + sl + n) >> (shift + 1),
                  np.where(has_top, (st + (n >> 1)) >> shift,
                           np.where(has_left, (sl + (n >> 1)) >> shift,
                                    128)))
    out = np.empty((top.shape[0], len(modes), n, n), np.int64)
    for i, m in enumerate(modes):
        if m == DC_PRED:
            out[:, i] = dc[:, None, None]
        elif m == V_PRED:
            out[:, i] = top[:, None, :]
        elif m == H_PRED:
            out[:, i] = left[:, :, None]
        else:
            out[:, i] = np.clip(left[:, :, None] + top[:, None, :]
                                - tl[:, None, None], 0, 255)
    return out


def _framed(src: np.ndarray) -> np.ndarray:
    """A reconstruction plane with the decoder's values outside the
    frame: row 0 is 127 (above it, the corner too), column 0 129 (left
    of it); sample (y, x) sits at (y + 1, x + 1)."""
    rec = np.zeros((src.shape[0] + 1, src.shape[1] + 1), np.int64)
    rec[0] = 127
    rec[1:, 0] = 129
    return rec


def _edges(rec: np.ndarray, y0: np.ndarray, x0: np.ndarray, n: int):
    """(top rows, left columns, top-left samples) of the n x n blocks at
    (y0, x0) [B] in a :func:`_framed` plane."""
    k = np.arange(n)
    top = rec[y0[:, None], x0[:, None] + 1 + k]
    left = rec[y0[:, None] + 1 + k, x0[:, None]]
    return top, left, rec[y0, x0]


def _to_blocks(a: np.ndarray) -> np.ndarray:
    """[B, n, n] -> [B, (n/4)^2, 4, 4] in raster block order."""
    b, n = a.shape[0], a.shape[1]
    k = n // 4
    return a.reshape(b, k, 4, k, 4).transpose(0, 1, 3, 2, 4).reshape(
        b, k * k, 4, 4)


def _from_blocks(a: np.ndarray, n: int) -> np.ndarray:
    b, k = a.shape[0], n // 4
    return a.reshape(b, k, k, 4, 4).transpose(0, 1, 3, 2, 4).reshape(
        b, n, n)


def _put(rec: np.ndarray, y0: np.ndarray, x0: np.ndarray,
         blocks: np.ndarray) -> None:
    """Write [B, n, n] reconstructed blocks at (y0, x0) of a framed
    plane."""
    k = np.arange(blocks.shape[1])
    rec[y0[:, None, None] + 1 + k[:, None],
        x0[:, None, None] + 1 + k[None, :]] = blocks


# --- RGB to YUV 4:2:0 --------------------------------------------------------

def _to_yuv(px: np.ndarray, mbw: int, mbh: int):
    """libwebp's limited-range conversion; the frame padded to whole
    macroblocks by repeating its last row and column, chroma from each
    2x2 block's sum."""
    h, w, _ = px.shape
    pad = np.pad(px, ((0, mbh * 16 - h), (0, mbw * 16 - w), (0, 0)),
                 mode="edge").astype(np.int64)
    r, g, b = pad[..., 0], pad[..., 1], pad[..., 2]
    y = (16839 * r + 33059 * g + 6420 * b + (1 << 15) + (16 << 16)) >> 16

    def sum4(c):
        return c[0::2, 0::2] + c[1::2, 0::2] + c[0::2, 1::2] + c[1::2, 1::2]

    r4, g4, b4 = sum4(r), sum4(g), sum4(b)
    half = (1 << 17) + (128 << 18)
    u = np.clip((-9719 * r4 - 19081 * g4 + 28800 * b4 + half) >> 18, 0, 255)
    v = np.clip((28800 * r4 - 24116 * g4 - 4684 * b4 + half) >> 18, 0, 255)
    return y, u, v


def _quality_to_q(quality: int) -> int:
    """libwebp's quantiser index for ``quality`` without its segments:
    127 * (1 - c) with c the cube root of its linearised quality."""
    c = quality / 100.0
    linear = c * (2.0 / 3.0) if c < 0.75 else 2.0 * c - 1.0
    return int(min(max(127.0 * (1.0 - linear ** (1.0 / 3.0)), 0), 127))


# --- the VP8 key frame -------------------------------------------------------

def _tree_tables():
    """For each level magnitude 0-2047, the bits of the coefficient
    token tree after the "more than one" branch (RFC 6386 13.2, libwebp's
    order): each bit with its probability's source, an index into the
    context's probabilities (3-10) or a fixed probability (negated)."""
    bits = np.zeros((2048, 15), np.int64)
    src = np.zeros((2048, 15), np.int64)
    count = np.zeros(2048, np.int64)
    for v in range(2, 2048):
        seq = []
        if v <= 4:
            seq = [(0, 3), (int(v != 2), 4)] + ([(int(v == 4), 5)]
                                                  if v != 2 else [])
        elif v <= 10:
            seq = [(1, 3), (0, 6)]
            if v <= 6:
                seq += [(0, 7), (int(v == 6), -159)]
            else:
                seq += [(1, 7), (int(v >= 9), -165), (int(not v & 1), -145)]
        else:
            for lo, nb, head, tab in ((11, 3, (0, 0), _CAT_PROBS[0]),
                                      (19, 4, (0, 1), _CAT_PROBS[1]),
                                      (35, 5, (1, 0), _CAT_PROBS[2]),
                                      (67, 11, (1, 1), _CAT_PROBS[3])):
                if v < lo + (1 << nb) or nb == 11:
                    seq = [(1, 3), (1, 6), (head[0], 8),
                           (head[1], 9 if head[0] == 0 else 10)]
                    seq += [(((v - lo) >> (nb - 1 - k)) & 1, -tab[k])
                            for k in range(nb)]
                    break
        count[v] = len(seq)
        for k, (b, p) in enumerate(seq):
            bits[v, k], src[v, k] = b, p
    return bits, src, count


_TREE_BITS, _TREE_SRC, _TREE_COUNT = _tree_tables()


def _neighbour_ctx(nz: np.ndarray) -> np.ndarray:
    """Each block's first-token context over a grid of blocks: its
    upper and its left neighbour's non-zero flags, 0 outside."""
    out = np.zeros(nz.shape, np.int64)
    out[1:, :] += nz[:-1, :]
    out[:, 1:] += nz[:, :-1]
    return out


def _token_bits(levels: np.ndarray, mbh: int, mbw: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Every macroblock's tokens (RFC 6386 13) as (bits, probabilities)
    in coding order: per macroblock the Y2 block, the 16 luma blocks
    (from position 1), the 4 U and the 4 V blocks; ``levels`` [mbs, 25,
    16] in zigzag order."""
    nmb = mbh * mbw
    mag = np.minimum(np.abs(levels), 2047).astype(np.int64)
    nz = (mag > 0).any(axis=2)                                # [mbs, 25]
    ctx0 = np.zeros((nmb, 25), np.int64)
    ctx0[:, 0] = _neighbour_ctx(nz[:, 0].reshape(mbh, mbw)).ravel()
    for start, k in ((1, 4), (17, 2), (21, 2)):
        grid = nz[:, start:start + k * k].reshape(mbh, mbw, k, k) \
            .transpose(0, 2, 1, 3).reshape(mbh * k, mbw * k)
        ctx0[:, start:start + k * k] = _neighbour_ctx(grid).reshape(
            mbh, k, mbw, k).transpose(0, 2, 1, 3).reshape(nmb, k * k)
    typ = np.array([_TYPE_Y2] + [_TYPE_Y] * 16 + [_TYPE_UV] * 8)
    first = np.tile((typ == _TYPE_Y).astype(np.int64), nmb)
    typ, ctx0 = np.tile(typ, nmb), ctx0.ravel()
    mag = mag.reshape(nmb * 25, 16)
    pos = np.arange(16)
    last = np.where(mag > 0, pos, -1).max(axis=1)
    prev = np.zeros_like(mag)
    prev[:, 1:] = np.minimum(mag[:, :-1], 2)
    at_first = pos[None] == first[:, None]
    coded = (pos[None] >= first[:, None]) & (pos[None] <= last[:, None])
    # the "end of block?" branch: at the first position, and after each
    # non-zero level up to one past the last
    eob = at_first | ((pos[None] > first[:, None]) & (prev > 0)
                      & (pos[None] <= last[:, None] + 1))
    # only the (block, position) pairs that code a branch, in order
    bi, pi = np.nonzero(eob | coded)
    m = mag[bi, pi]
    ctx = np.where(at_first[bi, pi], ctx0[bi], prev[bi, pi])
    probs = COEFF_PROBS[typ[bi], np.asarray(_BANDS)[pi], ctx]  # [n, 11]
    n = len(bi)
    bits = np.zeros((n, 19), np.uint8)
    prob = np.zeros((n, 19), np.uint8)
    valid = np.zeros((n, 19), bool)
    is_coded = coded[bi, pi]
    big = is_coded & (m > 0)
    bits[:, 0], prob[:, 0], valid[:, 0] = \
        pi <= last[bi], probs[:, 0], eob[bi, pi]
    bits[:, 1], prob[:, 1], valid[:, 1] = m > 0, probs[:, 1], is_coded
    bits[:, 2], prob[:, 2], valid[:, 2] = m > 1, probs[:, 2], big
    src = _TREE_SRC[m]                                        # [n, 15]
    bits[:, 3:18] = _TREE_BITS[m]
    prob[:, 3:18] = np.where(
        src >= 0, np.take_along_axis(probs, np.maximum(src, 0), axis=1),
        -src)
    valid[:, 3:18] = big[:, None] & (np.arange(15)[None]
                                     < _TREE_COUNT[m][:, None])
    bits[:, 18] = levels.reshape(nmb * 25, 16)[bi, pi] < 0
    prob[:, 18], valid[:, 18] = 128, big
    return bits[valid], prob[valid]


def encode_vp8(px: np.ndarray, quality: int = 80, method: int = 4) -> bytes:
    """[H, W, 3] uint8 -> a VP8 key frame (the ``VP8 `` chunk's body)."""
    h, w, _ = px.shape
    mbw, mbh = -(-w // 16), -(-h // 16)
    ysrc, usrc, vsrc = _to_yuv(px, mbw, mbh)
    q = _quality_to_q(int(quality))
    y1dc, y1ac = int(DC_Q[q]), int(AC_Q[q])
    y2q, y2b = _quant_rows(y1dc * 2, max(y1ac * 155 // 100, 8),
                           _BIAS[_TYPE_Y2])
    # the 16 luma blocks (their DCs go to Y2) and the 8 chroma blocks
    yq, yb = _quant_rows(y1dc, y1ac, _BIAS[_TYPE_Y])
    uq, ub = _quant_rows(min(y1dc, 132), y1ac, _BIAS[_TYPE_UV])
    qmat = np.stack([yq] * 16 + [uq] * 8)
    bmat = np.stack([yb] * 16 + [ub] * 8)
    modes = (DC_PRED, TM_PRED) if method <= 1 else \
        (DC_PRED, V_PRED, H_PRED, TM_PRED)
    yrec, urec, vrec = _framed(ysrc), _framed(usrc), _framed(vsrc)
    mb_modes = np.zeros((mbh * mbw, 2), np.int64)
    mb_levels = np.zeros((mbh * mbw, 25, 16), np.int64)
    ar16, ar8 = np.arange(16), np.arange(8)
    # a macroblock predicts from its left, upper and upper-left
    # neighbours, so the macroblocks of one anti-diagonal go together
    for t in range(mbh + mbw - 1):
        my = np.arange(max(0, t - mbw + 1), min(mbh - 1, t) + 1)
        mx = t - my
        has_top, has_left = my > 0, mx > 0
        y0, x0, c0, c1 = my * 16, mx * 16, my * 8, mx * 8
        src = ysrc[y0[:, None, None] + ar16[:, None],
                   x0[:, None, None] + ar16[None, :]]
        preds = _predictions(*_edges(yrec, y0, x0, 16), has_top, has_left,
                             modes)
        k = np.argmin(np.abs(preds - src[:, None]).sum(axis=(2, 3)), axis=1)
        b = np.arange(len(my))
        ymode, pred = np.asarray(modes)[k], preds[b, k]
        crow, ccol = c0[:, None, None] + ar8[:, None], \
            c1[:, None, None] + ar8[None, :]
        us, vs = usrc[crow, ccol], vsrc[crow, ccol]
        upreds = _predictions(*_edges(urec, c0, c1, 8), has_top, has_left,
                              modes)
        vpreds = _predictions(*_edges(vrec, c0, c1, 8), has_top, has_left,
                              modes)
        k = np.argmin(np.abs(upreds - us[:, None]).sum(axis=(2, 3))
                      + np.abs(vpreds - vs[:, None]).sum(axis=(2, 3)),
                      axis=1)
        uvmode, upred, vpred = np.asarray(modes)[k], upreds[b, k], \
            vpreds[b, k]
        coef = _fdct(np.concatenate([_to_blocks(src - pred),
                                     _to_blocks(us - upred),
                                     _to_blocks(vs - vpred)], axis=1)
                     .reshape(-1, 4, 4)).reshape(-1, 24, 16)
        y2lv = _quantize(_fwht(coef[:, :16, 0]), y2q, y2b)
        lv = _quantize(coef, qmat, bmat)
        lv[:, :16, 0] = 0
        dq = lv * qmat
        dq[:, :16, 0] = _iwht(y2lv * y2q)
        res = _idct(dq.reshape(-1, 16)).reshape(-1, 24, 4, 4)
        _put(yrec, y0, x0, np.clip(pred + _from_blocks(res[:, :16], 16),
                                   0, 255))
        _put(urec, c0, c1, np.clip(upred + _from_blocks(res[:, 16:20], 8),
                                   0, 255))
        _put(vrec, c0, c1, np.clip(vpred + _from_blocks(res[:, 20:], 8),
                                   0, 255))
        at = my * mbw + mx
        mb_modes[at, 0], mb_modes[at, 1] = ymode, uvmode
        mb_levels[at] = np.concatenate([y2lv[:, None], lv],
                                       axis=1)[:, :, ZIGZAG]

    # first partition: the frame header and each macroblock's modes
    hdr = _Bits()
    hdr.literal(0, 1)           # colour space
    hdr.literal(0, 1)           # clamping required
    hdr.literal(0, 1)           # no segmentation
    hdr.literal(0, 1)           # normal loop filter
    hdr.literal(0, 6)           # level 0: no loop filter
    hdr.literal(0, 3)           # sharpness
    hdr.literal(0, 1)           # no filter deltas
    hdr.literal(0, 2)           # one token partition
    hdr.literal(q, 7)
    for _ in range(5):          # no quantiser deltas
        hdr.literal(0, 1)
    hdr.literal(0, 1)           # refresh_entropy_probs
    for prob in COEFF_UPDATE_PROBS.ravel().tolist():
        hdr.put(0, prob)        # the default token probabilities
    hdr.literal(0, 1)           # every macroblock's tokens coded
    for ymode, uvmode in mb_modes.tolist():
        hdr.put(1, 145)         # a 16x16 luma mode
        if ymode in (DC_PRED, V_PRED):
            hdr.put(0, 156)
            hdr.put(int(ymode == V_PRED), 163)
        else:
            hdr.put(1, 156)
            hdr.put(int(ymode == TM_PRED), 128)
        if uvmode == DC_PRED:
            hdr.put(0, 142)
        else:
            hdr.put(1, 142)
            if uvmode == V_PRED:
                hdr.put(0, 114)
            else:
                hdr.put(1, 114)
                hdr.put(int(uvmode == TM_PRED), 183)
    first = _bool_encode(hdr.bits, hdr.probs)
    bits, probs = _token_bits(mb_levels, mbh, mbw)
    tokens = _bool_encode(bits, probs)
    if len(first) >= 1 << 19:
        raise ValueError("VP8 first partition over 512 KiB")
    tag = (len(first) << 5) | (1 << 4)      # key frame, version 0, shown
    return (bytes([tag & 0xFF, (tag >> 8) & 0xFF, (tag >> 16) & 0xFF])
            + b"\x9d\x01\x2a" + struct.pack("<HH", w, h) + first + tokens)
