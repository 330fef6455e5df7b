"""The port's DLE1 coder (``models/entropy.py``) on ``tests/test_entropy.py``'s
cases, plus parity: for every length and mode case the port's stream is
the JAX package's stream, byte for byte, and each package decodes the
other's (independent seeders and codec-qualified digests depend on it).

The JAX file's account of the contract:

- **lossless**: decode(encode(x)) == x for every length, including the
  empty buffer and non-block-multiple tails;
- **deterministic**: encode is a pure function of the bytes -- ties break
  to the lowest mode id;
- **bounded overhead**: an incompressible input costs at most the header
  plus one mode byte per 64 KiB block over raw;
- **loud corruption**: a bad magic, an unknown block mode, a truncated
  stream, or trailing garbage raises.
"""

import numpy as np
import pytest

from distributed_llm_dissemination_tpu.models import entropy as jentropy
from distributed_llm_dissemination_tpu_torch.models import entropy

LENGTHS = [0, 1, 13, entropy.BLOCK - 1, entropy.BLOCK, entropy.BLOCK + 1,
           5 * entropy.BLOCK // 2]


def _rng_bytes(n: int, seed: int = 0) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, size=n, dtype=np.uint8).tobytes()


def _mode_blocks():
    return {
        "zero": bytes(entropy.BLOCK),
        "sparse": bytes(bytearray(entropy.BLOCK)[:-1]) + b"\x7f",
        "smallmag": np.random.default_rng(1).integers(
            -3, 4, size=entropy.BLOCK, dtype=np.int8).tobytes(),
        "middensity": bytes(
            b if i % 2 else 0 for i, b in enumerate(
                _rng_bytes(entropy.BLOCK, seed=2))),
        "literal": _rng_bytes(entropy.BLOCK, seed=3),
    }


def _assert_same_stream(raw: bytes) -> bytes:
    enc = entropy.encode(raw)
    assert enc == jentropy.encode(raw)
    assert jentropy.decode(enc) == raw
    return enc


@pytest.mark.parametrize("n", LENGTHS)
def test_roundtrip_every_length_shape(n):
    raw = _rng_bytes(n)
    enc = entropy.encode(raw)
    assert enc[:4] == entropy.MAGIC
    assert entropy.decode(enc) == raw


@pytest.mark.parametrize("n", LENGTHS)
def test_stream_equals_jax_every_length(n):
    _assert_same_stream(_rng_bytes(n))


def test_roundtrip_per_mode_inputs():
    blocks = _mode_blocks()
    for name, raw in blocks.items():
        enc = entropy.encode(raw)
        assert entropy.decode(enc) == raw, name
    assert len(entropy.encode(blocks["zero"])) < 64
    assert len(entropy.encode(blocks["sparse"])) < 64
    assert len(entropy.encode(blocks["smallmag"])) < \
        entropy.BLOCK // 2 + 64


@pytest.mark.parametrize("mode", sorted(_mode_blocks()))
def test_stream_equals_jax_every_mode(mode):
    raw = _mode_blocks()[mode]
    enc = _assert_same_stream(raw)
    # Each case really takes its mode (the first block's mode byte).
    want = {"zero": entropy.MODE_BITPACK, "sparse": entropy.MODE_SPARSE,
            "smallmag": entropy.MODE_BITPACK,
            "middensity": entropy.MODE_BITMAP,
            "literal": entropy.MODE_LITERAL}[mode]
    assert enc[12] == want


def test_encode_is_deterministic_across_buffer_types():
    raw = _rng_bytes(3 * entropy.BLOCK // 2, seed=4)
    enc = entropy.encode(raw)
    assert entropy.encode(bytearray(raw)) == enc
    assert entropy.encode(memoryview(raw)) == enc
    assert entropy.encode(raw) == enc


def test_incompressible_overhead_is_bounded():
    raw = _rng_bytes(2 * entropy.BLOCK + 17, seed=5)
    enc = entropy.encode(raw)
    n_blocks = 3
    assert len(enc) <= len(raw) + len(entropy.MAGIC) + 8 + n_blocks


def test_corrupt_streams_raise_loudly():
    raw = _rng_bytes(entropy.BLOCK, seed=6)
    enc = bytearray(entropy.encode(raw))
    with pytest.raises(ValueError, match="magic"):
        entropy.decode(b"NOPE" + bytes(enc[4:]))
    with pytest.raises(ValueError, match="magic"):
        entropy.decode(b"DL")
    bad_mode = bytearray(enc)
    bad_mode[12] = 0xFF
    with pytest.raises(ValueError, match="mode"):
        entropy.decode(bytes(bad_mode))
    with pytest.raises(ValueError):
        entropy.decode(bytes(enc[:-7]))
    with pytest.raises(ValueError, match="trailing"):
        entropy.decode(bytes(enc) + b"junk")


def _perturbed(seed=7):
    v1 = _rng_bytes(entropy.BLOCK + 100, seed=seed)
    v2 = bytearray(v1)
    for i in range(0, len(v2), 512):
        v2[i] ^= 0xA5
    return v1, bytes(v2)


def test_delta_encode_decode_and_xor_contract():
    v1, v2 = _perturbed()
    stream = entropy.delta_encode(v2, v1)
    assert len(stream) < len(v2) // 8
    assert entropy.delta_decode(stream, v1) == v2
    assert len(entropy.delta_encode(v1, v1)) < 64
    with pytest.raises(ValueError, match="length mismatch"):
        entropy.xor_bytes(v1, v1[:-1])
    with pytest.raises(ValueError, match="length mismatch"):
        entropy.delta_encode(v2, v1[:-1])


def test_delta_stream_equals_jax():
    v1, v2 = _perturbed()
    stream = entropy.delta_encode(v2, v1)
    assert stream == jentropy.delta_encode(v2, v1)
    assert jentropy.delta_decode(stream, v1) == v2
    assert entropy.delta_decode(jentropy.delta_encode(v2, v1), v1) == v2
