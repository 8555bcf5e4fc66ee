"""Texture/image IO in pure NumPy (no vendored C).

The port's copy of fspt_tpu/utils/image.py.  It replaces the reference's loaders: 24-bit BMP (reference bitmap.cpp:40-105,
scanline padding + BGR→RGB + float conversion), a minimal OpenEXR scanline
reader standing in for vendored TinyEXR (reference
third_party/tiny_exr_loader.h, used at material.cpp:71-94), and PNG/PPM
output for the display buffer.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def load_bmp(path: str) -> np.ndarray:
    """24-bit uncompressed BMP → float32 [H,W,3] in [0,1], RGB, row 0 = bottom.

    Mirrors reference bitmap.cpp:40-105: scanlines padded to 4 bytes,
    BGR byte order, value/255 conversion.  (BMP stores rows bottom-up; the
    reference keeps that order and so do we.)
    """
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"BM":
        raise ValueError(f"{path}: not a BMP file")
    pixel_offset = struct.unpack_from("<I", data, 10)[0]
    header_size = struct.unpack_from("<I", data, 14)[0]
    if header_size >= 40:
        width, height = struct.unpack_from("<ii", data, 18)
        planes, bpp = struct.unpack_from("<HH", data, 26)
        compression = struct.unpack_from("<I", data, 30)[0]
    else:  # BITMAPCOREHEADER
        width, height = struct.unpack_from("<hh", data, 18)
        bpp = struct.unpack_from("<H", data, 24)[0]
        compression = 0
    if bpp != 24 or compression != 0:
        raise ValueError(f"{path}: only 24-bit uncompressed BMP supported (got {bpp}bpp)")
    flipped = height < 0
    height = abs(height)
    stride = (width * 3 + 3) & ~3
    img = np.frombuffer(data, np.uint8, stride * height, pixel_offset)
    img = img.reshape(height, stride)[:, : width * 3].reshape(height, width, 3)
    img = img[:, :, ::-1].astype(np.float32) / 255.0  # BGR → RGB
    if flipped:
        img = img[::-1]
    return np.ascontiguousarray(img)


# --- minimal OpenEXR reader -------------------------------------------------

_EXR_MAGIC = 20000630
_PIX_UINT, _PIX_HALF, _PIX_FLOAT = 0, 1, 2
_COMP_NONE, _COMP_RLE, _COMP_ZIPS, _COMP_ZIP, _COMP_PIZ = 0, 1, 2, 3, 4
_COMP_NAMES = {5: "PXR24", 6: "B44", 7: "B44A", 8: "DWAA", 9: "DWAB"}


def _read_cstr(data, off):
    end = data.index(b"\x00", off)
    return data[off:end].decode("latin-1"), end + 1


def _rle_decode(src: bytes) -> bytes:
    """OpenEXR RLE: signed count c — c < 0 → −c literal bytes follow;
    c ≥ 0 → the next byte repeats c+1 times (tiny_exr_loader.h RLE path)."""
    out = bytearray()
    i, n = 0, len(src)
    while i < n:
        c = src[i]
        if c > 127:  # negative int8 → literal run
            cnt = 256 - c
            out += src[i + 1: i + 1 + cnt]
            i += 1 + cnt
        else:
            out += src[i + 1: i + 2] * (c + 1)
            i += 2
    return bytes(out)


def _exr_unpredict(raw: bytes) -> bytes:
    """Undo the EXR delta predictor + two-half interleave (shared by the
    ZIP/ZIPS and RLE codecs)."""
    buf = np.frombuffer(raw, np.uint8).astype(np.int64)
    deltas = np.cumsum(np.concatenate([buf[:1], (buf[1:] - 128)])).astype(np.uint8)
    half = (len(deltas) + 1) // 2
    out = np.zeros(len(deltas), np.uint8)
    out[0::2] = deltas[:half]
    out[1::2] = deltas[half: half + len(deltas) - half]
    return out.tobytes()


# --- PIZ (wavelet + Huffman) decoder -----------------------------------
# Semantics follow the OpenEXR PIZ codec (the reference reads PIZ domes via
# its vendored TinyEXR, tiny_exr_loader.h); implementation is original:
# NumPy-vectorized 2-D wavelet lifting + a table-driven canonical Huffman
# decoder.  Verified against a TinyEXR-encoded golden file
# (tests/data/piz_pattern.exr).

_PIZ_BITMAP_SIZE = 8192


class _BitReader:
    """MSB-first bit reader over a bytes object."""

    __slots__ = ("data", "pos", "c", "lc")

    def __init__(self, data, pos=0):
        self.data = data
        self.pos = pos
        self.c = 0
        self.lc = 0

    def get(self, n):
        while self.lc < n:
            self.c = (self.c << 8) | (
                self.data[self.pos] if self.pos < len(self.data) else 0)
            self.pos += 1
            self.lc += 8
        self.lc -= n
        return (self.c >> self.lc) & ((1 << n) - 1)


def _huf_unpack_lengths(br: _BitReader, im: int, iM: int):
    """Canonical code lengths, with the two zero-run escapes
    (SHORT_ZEROCODE_RUN=59, LONG_ZEROCODE_RUN=63)."""
    lengths = np.zeros(iM + 1, np.int32)
    i = im
    while i <= iM:
        l = br.get(6)
        if l == 63:
            zerun = br.get(8) + 6
            i += zerun
        elif l >= 59:
            i += l - 59 + 2
        else:
            lengths[i] = l
            i += 1
    return lengths


def _huf_canonical_codes(lengths):
    """lengths[sym] → codes[sym] (canonical, longest-first numbering)."""
    n = np.zeros(59, np.int64)
    for l in lengths:
        if l > 0:
            n[l] += 1
    c = 0
    for i in range(58, 0, -1):
        nc = (c + n[i]) >> 1
        n[i] = c
        c = nc
    codes = np.zeros(len(lengths), np.int64)
    for sym, l in enumerate(lengths):
        if l > 0:
            codes[sym] = n[l]
            n[l] += 1
    return codes


def _huf_decompress(data: bytes, n_expected: int) -> np.ndarray:
    """OpenEXR hufUncompress: 20-byte header, packed code-length table,
    then the bit stream (run-length symbol = iM)."""
    im, iM, _table_len, n_bits, _ = struct.unpack_from("<5I", data, 0)
    br = _BitReader(data, 20)
    lengths = _huf_unpack_lengths(br, im, iM)
    codes = _huf_canonical_codes(lengths)
    rlc = iM

    # 14-bit fast decode table; longer codes fall back to a linear scan.
    FAST = 14
    fast_len = np.zeros(1 << FAST, np.int32)
    fast_sym = np.zeros(1 << FAST, np.int32)
    long_codes = []
    for sym in range(im, iM + 1):
        l = int(lengths[sym])
        if l == 0:
            continue
        if l <= FAST:
            base = int(codes[sym]) << (FAST - l)
            fast_len[base: base + (1 << (FAST - l))] = l
            fast_sym[base: base + (1 << (FAST - l))] = sym
        else:
            long_codes.append((l, int(codes[sym]), sym))

    out = np.empty(n_expected, np.uint16)
    produced = 0
    dr = _BitReader(data, br.pos)  # data bits start at the next whole byte
    fast_len_l = fast_len.tolist()
    fast_sym_l = fast_sym.tolist()
    while produced < n_expected:
        # Peek 14 bits (zero-padded at stream end).
        while dr.lc < FAST:
            dr.c = (dr.c << 8) | (
                dr.data[dr.pos] if dr.pos < len(dr.data) else 0)
            dr.pos += 1
            dr.lc += 8
        idx = (dr.c >> (dr.lc - FAST)) & ((1 << FAST) - 1)
        l = fast_len_l[idx]
        if l:
            sym = fast_sym_l[idx]
            dr.lc -= l
        else:
            sym = -1
            for ll, code, s in long_codes:
                while dr.lc < ll:
                    dr.c = (dr.c << 8) | (
                        dr.data[dr.pos] if dr.pos < len(dr.data) else 0)
                    dr.pos += 1
                    dr.lc += 8
                if (dr.c >> (dr.lc - ll)) & ((1 << ll) - 1) == code:
                    sym = s
                    dr.lc -= ll
                    break
            if sym < 0:
                raise ValueError("EXR PIZ: invalid Huffman code")
        if sym == rlc:
            cs = dr.get(8)
            if produced == 0:
                raise ValueError("EXR PIZ: run-length code at stream start")
            if produced + cs > n_expected:
                # OpenEXR's hufDecode overrun check: a run that would write
                # past the expected output means a corrupt stream.
                raise ValueError("EXR PIZ: run-length overrun")
            out[produced: produced + cs] = out[produced - 1]
            produced += cs
        else:
            out[produced] = sym
            produced += 1
    return out


def _wdec14(l, h):
    hi = h.astype(np.int16).astype(np.int32)
    ai = l.astype(np.int16).astype(np.int32) + (hi & 1) + (hi >> 1)
    return (ai.astype(np.int16).astype(np.uint16),
            (ai - hi).astype(np.int16).astype(np.uint16))


def _wdec16(l, h):
    m = l.astype(np.int32)
    d = h.astype(np.int32)
    bb = (m - (d >> 1)) & 0xFFFF
    aa = (d + bb - 0x8000) & 0xFFFF
    return aa.astype(np.uint16), bb.astype(np.uint16)


def _wav2_decode(buf, maxv):
    """In-place 2-D wavelet decode of a [ny, nx] uint16 array
    (OpenEXR wav2Decode, ox=1/oy=nx layout)."""
    ny, nx = buf.shape
    wdec = _wdec14 if maxv < (1 << 14) else _wdec16
    n = min(nx, ny)
    p = 1
    while p <= n:
        p <<= 1
    p >>= 1
    p2 = p
    p >>= 1
    while p >= 1:
        ys = np.arange(0, ny - p2 + 1, p2)
        xs = np.arange(0, nx - p2 + 1, p2)
        if len(ys) and len(xs):
            i00, i10 = wdec(buf[np.ix_(ys, xs)], buf[np.ix_(ys + p, xs)])
            i01, i11 = wdec(buf[np.ix_(ys, xs + p)],
                            buf[np.ix_(ys + p, xs + p)])
            a00, a01 = wdec(i00, i01)
            a10, a11 = wdec(i10, i11)
            buf[np.ix_(ys, xs)] = a00
            buf[np.ix_(ys, xs + p)] = a01
            buf[np.ix_(ys + p, xs)] = a10
            buf[np.ix_(ys + p, xs + p)] = a11
        if nx & p and len(ys):
            # Odd trailing column (1-D vertical step).
            xe = (xs[-1] + p2) if len(xs) else 0
            a, b = wdec(buf[ys, xe], buf[ys + p, xe])
            buf[ys, xe] = a
            buf[ys + p, xe] = b
        if ny & p and len(xs):
            # Odd trailing row (1-D horizontal step).
            ye = (ys[-1] + p2) if len(ys) else 0
            a, b = wdec(buf[ye, xs], buf[ye, xs + p])
            buf[ye, xs] = a
            buf[ye, xs + p] = b
        p2 = p
        p >>= 1
    return buf


def _piz_decode(raw: bytes, channels, width: int, n_lines: int) -> bytes:
    """One PIZ block → line-interleaved channel rows (the layout the
    scanline assembly loop expects)."""
    for _, ptype in channels:
        if ptype != _PIX_HALF:
            raise ValueError("EXR PIZ: only HALF channels are supported")
    min_nz, max_nz = struct.unpack_from("<2H", raw, 0)
    off = 4
    bitmap = np.zeros(_PIZ_BITMAP_SIZE, np.uint8)
    if min_nz <= max_nz:
        cnt = max_nz - min_nz + 1
        bitmap[min_nz: max_nz + 1] = np.frombuffer(raw, np.uint8, cnt, off)
        off += cnt
    # Reverse LUT: k-th set value (value 0 always included).
    bits = np.unpackbits(bitmap, bitorder="little")
    bits[0] = 1
    lut = np.nonzero(bits)[0].astype(np.uint16)
    maxv = len(lut) - 1

    (length,) = struct.unpack_from("<i", raw, off)
    off += 4
    n_shorts = len(channels) * n_lines * width
    data = _huf_decompress(raw[off: off + length], n_shorts)

    out = bytearray()
    per_chan = n_lines * width
    chan_bufs = []
    for c, _ in enumerate(channels):
        buf = data[c * per_chan: (c + 1) * per_chan].reshape(n_lines, width)
        buf = np.ascontiguousarray(buf)
        _wav2_decode(buf, maxv)
        chan_bufs.append(lut[buf])
    for line in range(n_lines):
        for buf in chan_bufs:
            out += buf[line].astype("<u2").tobytes()
    return bytes(out)


def load_exr(path: str) -> np.ndarray:
    """Minimal scanline OpenEXR reader → float32 [H,W,3] (R,G,B).

    Supports single-part scanline files with NONE/RLE/ZIPS/ZIP/PIZ
    compression and HALF/FLOAT channels (PIZ is HALF-only) — the same codec
    envelope as the reference's vendored TinyEXR loader
    (tiny_exr_loader.h:7198-7200: PXR24/B44/DWA are absent there too).
    """
    with open(path, "rb") as f:
        data = f.read()
    magic, version = struct.unpack_from("<iI", data, 0)
    if magic != _EXR_MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200:
        raise ValueError(f"{path}: tiled EXR not supported")

    off = 8
    channels = []
    compression = None
    data_window = None
    while True:
        name, off = _read_cstr(data, off)
        if not name:
            break
        atype, off = _read_cstr(data, off)
        size = struct.unpack_from("<I", data, off)[0]
        off += 4
        payload = data[off: off + size]
        off += size
        if name == "channels":
            coff = 0
            while payload[coff] != 0:
                cname, coff = _read_cstr(payload, coff)
                ptype = struct.unpack_from("<i", payload, coff)[0]
                coff += 16  # pixel type + pLinear/reserved + x/y sampling
                channels.append((cname, ptype))
        elif name == "compression":
            compression = payload[0]
        elif name == "dataWindow":
            data_window = struct.unpack("<4i", payload)

    x0, y0, x1, y1 = data_window
    width = x1 - x0 + 1
    height = y1 - y0 + 1
    channels.sort(key=lambda c: c[0])  # EXR stores channels alphabetically
    nch = len(channels)

    if compression == _COMP_ZIP:
        lines_per_block = 16
    elif compression == _COMP_PIZ:
        lines_per_block = 32
    elif compression in (_COMP_NONE, _COMP_ZIPS, _COMP_RLE):
        lines_per_block = 1
    else:
        name = _COMP_NAMES.get(compression, str(compression))
        raise ValueError(
            f"{path}: EXR compression {name} is not supported "
            "(supported: NONE, RLE, ZIPS, ZIP, PIZ). Re-encode the file, "
            "e.g. `oiiotool in.exr --compression zip -o out.exr`.")

    n_blocks = (height + lines_per_block - 1) // lines_per_block
    offsets = struct.unpack_from(f"<{n_blocks}Q", data, off)

    dtype_of = {_PIX_HALF: np.float16, _PIX_FLOAT: np.float32, _PIX_UINT: np.uint32}
    chan_arrays = {c: np.zeros((height, width), np.float32) for c, _ in channels}

    for block_off in offsets:
        y, size = struct.unpack_from("<iI", data, block_off)
        raw = data[block_off + 8: block_off + 8 + size]
        n_lines = min(lines_per_block, y1 - y + 1)
        expect = sum(
            width * n_lines * np.dtype(dtype_of[pt]).itemsize for _, pt in channels
        )
        if compression in (_COMP_ZIP, _COMP_ZIPS) and size < expect:
            raw = _exr_unpredict(zlib.decompress(raw))
        elif compression == _COMP_RLE and size < expect:
            raw = _exr_unpredict(_rle_decode(raw))
        elif compression == _COMP_PIZ and size < expect:
            raw = _piz_decode(raw, channels, width, n_lines)
        pos = 0
        for line in range(n_lines):
            yy = y - y0 + line
            for cname, ptype in channels:
                dt = dtype_of[ptype]
                nbytes = width * np.dtype(dt).itemsize
                row = np.frombuffer(raw, dt, width, pos)
                chan_arrays[cname][yy] = row.astype(np.float32)
                pos += nbytes

    def chan(name):
        if name in chan_arrays:
            return chan_arrays[name]
        if "Y" in chan_arrays:  # grayscale
            return chan_arrays["Y"]
        return np.zeros((height, width), np.float32)

    return np.stack([chan("R"), chan("G"), chan("B")], axis=-1)


def load_texture(path: str) -> np.ndarray:
    """Dispatch by extension, reference material.cpp:63-95 semantics."""
    lower = path.lower()
    if lower.endswith(".bmp"):
        return load_bmp(path)
    if lower.endswith(".exr"):
        return load_exr(path)
    raise ValueError(f"unsupported texture format: {path}")


# --- output ----------------------------------------------------------------


def write_ppm(path: str, image_u8: np.ndarray):
    h, w = image_u8.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(image_u8).tobytes())


def png_bytes(image_u8: np.ndarray) -> bytes:
    """Minimal in-memory PNG encoder (RGB8) using zlib — no external deps."""
    h, w = image_u8.shape[:2]
    raw = b"".join(
        b"\x00" + np.ascontiguousarray(image_u8[i]).tobytes() for i in range(h)
    )

    def chunk(tag, payload):
        out = struct.pack(">I", len(payload)) + tag + payload
        return out + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_png(path: str, image_u8: np.ndarray):
    """Minimal PNG writer (RGB8) using zlib — no external deps."""
    with open(path, "wb") as f:
        f.write(png_bytes(image_u8))


def write_image(path: str, image_u8: np.ndarray):
    if path.lower().endswith(".ppm"):
        write_ppm(path, image_u8)
    else:
        write_png(path, image_u8)
