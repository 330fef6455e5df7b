"""Cheap deterministic byte-domain entropy coder -- the shared engine of
the ``int8e``/``int4e`` wire forms and the content-delta codec.

Copy of the JAX package's ``models/entropy.py`` (numpy only): encoded
streams are byte-identical between the two packages, which independent
seeders and codec-qualified digests depend on.

Design point (EQuARX, arXiv:2506.17615): block-scaled quantization
leaves the value bytes with LOW per-byte entropy — int8 rows cluster
near zero after absmax scaling, and a content delta (v2 XOR v1) of a
lightly-perturbed checkpoint is MOSTLY zeros.  A heavyweight
context-model coder would eat the byte win in CPU time, so this module
codes fixed 64 KiB blocks under four trivial modes and picks, per
block, whichever is smallest:

- mode 0 — **literal**: the block verbatim (the incompressible floor;
  an encoded stream is never more than ~1 byte/block larger than raw).
- mode 1 — **sparse**: ``uint32 n`` + ``n`` uint16 positions + ``n``
  values.  Wins when well under 1/3 of the bytes are nonzero (cold
  deltas).
- mode 2 — **zigzag bitpack**: one bitwidth byte ``b`` then
  ``ceil(len*b/8)`` packed bytes of zigzagged int8 values (``b = 0``
  encodes an all-zero block in 2 bytes).  Wins on quantized value
  planes whose magnitudes fit ``b < 8`` bits.
- mode 3 — **bitmap**: ``ceil(len/8)`` presence bitmap + the nonzero
  bytes.  Wins between sparse and literal (~1/3..7/8 nonzero density).

Every mode is numpy-vectorized both ways; there is no entropy-coded
state across blocks, so ranges of the ENCODED stream shard/salvage
exactly like any other wire blob (the flow plane's byte-identity
invariant).  Encoding is a pure function of the input bytes — ties
break to the lowest mode id — so independent seeders produce
byte-identical streams (multi-sender ranges, NACK salvage, and
codec-qualified digests all depend on this).

Stream layout: ``b"DLE1"`` magic, uint64-le raw length, then blocks in
order.  The coder is model-agnostic: it sees bytes, not leaves, which
is what lets the delta form ride arbitrary (even non-model) layer
buffers.
"""

from __future__ import annotations

from typing import List

import numpy as np

MAGIC = b"DLE1"
BLOCK = 64 * 1024
_HEADER = len(MAGIC) + 8

MODE_LITERAL = 0
MODE_SPARSE = 1
MODE_BITPACK = 2
MODE_BITMAP = 3


def _zigzag(block: np.ndarray) -> np.ndarray:
    """int8-domain zigzag: 0,-1,1,-2,... -> 0,1,2,3,... (uint8)."""
    v = block.view(np.int8).astype(np.int16)
    return (((v << 1) ^ (v >> 8)) & 0xFF).astype(np.uint8)


def _unzigzag(z: np.ndarray) -> np.ndarray:
    zz = z.astype(np.int16)
    return (((zz >> 1) ^ -(zz & 1)) & 0xFF).astype(np.uint8)


def _bitwidth(maxval: int) -> int:
    return int(maxval).bit_length()


def _pack_bits(z: np.ndarray, b: int) -> bytes:
    """Pack each uint8 of ``z`` into ``b`` bits (big-endian within the
    value, values in order)."""
    bits = np.unpackbits(z[:, None], axis=1)[:, 8 - b:]
    return np.packbits(bits.reshape(-1)).tobytes()


def _unpack_bits(data: np.ndarray, n: int, b: int) -> np.ndarray:
    bits = np.unpackbits(data)[: n * b].reshape(n, b)
    full = np.zeros((n, 8), dtype=np.uint8)
    full[:, 8 - b:] = bits
    return np.packbits(full, axis=1).reshape(-1)


def encode(raw) -> bytes:
    """Encode ``raw`` bytes into one deterministic DLE1 stream."""
    buf = np.frombuffer(memoryview(raw), dtype=np.uint8)
    out: List[bytes] = [MAGIC, np.uint64(len(buf)).tobytes()]
    for off in range(0, len(buf), BLOCK):
        block = buf[off : off + BLOCK]
        L = len(block)
        nz = np.flatnonzero(block)
        n = len(nz)
        z = _zigzag(block)
        b = _bitwidth(int(z.max())) if L else 0
        # Candidate payload sizes (excluding the mode byte), computed
        # without materializing any payload; ties -> lowest mode id.
        sizes = (
            L,                                   # 0: literal
            4 + 3 * n,                           # 1: sparse
            1 + (L * b + 7) // 8,                # 2: zigzag bitpack
            (L + 7) // 8 + n,                    # 3: bitmap
        )
        mode = int(np.argmin(sizes))
        out.append(bytes([mode]))
        if mode == MODE_LITERAL:
            out.append(block.tobytes())
        elif mode == MODE_SPARSE:
            out.append(np.uint32(n).tobytes())
            out.append(nz.astype(np.uint16).tobytes())
            out.append(block[nz].tobytes())
        elif mode == MODE_BITPACK:
            out.append(bytes([b]))
            if b:
                out.append(_pack_bits(z, b))
        else:
            bitmap = np.zeros(L, dtype=np.uint8)
            bitmap[nz] = 1
            out.append(np.packbits(bitmap).tobytes())
            out.append(block[nz].tobytes())
    return b"".join(out)


def decode(data) -> bytes:
    """Decode one DLE1 stream back to the exact raw bytes."""
    buf = np.frombuffer(memoryview(data), dtype=np.uint8)
    if len(buf) < _HEADER or buf[:4].tobytes() != MAGIC:
        raise ValueError("not a DLE1 entropy stream (bad magic)")
    raw_len = int(buf[4:_HEADER].view(np.uint64)[0])
    out = np.empty(raw_len, dtype=np.uint8)
    off, pos = _HEADER, 0
    while pos < raw_len:
        L = min(BLOCK, raw_len - pos)
        mode = int(buf[off])
        off += 1
        if mode == MODE_LITERAL:
            out[pos : pos + L] = buf[off : off + L]
            off += L
        elif mode == MODE_SPARSE:
            n = int(buf[off : off + 4].view(np.uint32)[0])
            off += 4
            idx = buf[off : off + 2 * n].view(np.uint16)
            off += 2 * n
            block = np.zeros(L, dtype=np.uint8)
            block[idx.astype(np.int64)] = buf[off : off + n]
            off += n
            out[pos : pos + L] = block
        elif mode == MODE_BITPACK:
            b = int(buf[off])
            off += 1
            if b == 0:
                out[pos : pos + L] = 0
            else:
                nb = (L * b + 7) // 8
                out[pos : pos + L] = _unzigzag(
                    _unpack_bits(buf[off : off + nb], L, b))
                off += nb
        elif mode == MODE_BITMAP:
            mb = (L + 7) // 8
            bitmap = np.unpackbits(buf[off : off + mb])[:L]
            off += mb
            idx = np.flatnonzero(bitmap)
            block = np.zeros(L, dtype=np.uint8)
            block[idx] = buf[off : off + len(idx)]
            off += len(idx)
            out[pos : pos + L] = block
        else:
            raise ValueError(f"corrupt DLE1 stream: unknown block mode "
                             f"{mode} at offset {off - 1}")
        pos += L
    if off != len(buf):
        raise ValueError(
            f"corrupt DLE1 stream: {len(buf) - off} trailing bytes")
    return out.tobytes()


def xor_bytes(a, b) -> bytes:
    """Byte-wise XOR of two equal-length buffers (the delta residual)."""
    va = np.frombuffer(memoryview(a), dtype=np.uint8)
    vb = np.frombuffer(memoryview(b), dtype=np.uint8)
    if len(va) != len(vb):
        raise ValueError(
            f"xor_bytes: length mismatch {len(va)} != {len(vb)}")
    return np.bitwise_xor(va, vb).tobytes()


def delta_encode(new, base) -> bytes:
    """The content-delta wire form: DLE1-coded (new XOR base).  Requires
    same-length buffers — a base of another size can't be a delta base
    (the leader's base selection enforces this upstream)."""
    return encode(xor_bytes(new, base))


def delta_decode(data, base) -> bytes:
    """Reconstruct the full new bytes from a delta stream + the base."""
    return xor_bytes(decode(data), base)
