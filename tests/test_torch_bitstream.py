"""The port's wire format against the reference's: byte for byte."""
import numpy as np
import pytest

from repro.core import bitstream as jbitstream

from repro_torch.core import _msgpack, bitstream

# every width boundary of the msgpack subset: fix/8/16/32-bit strings,
# 8/16/32-bit binaries, every unsigned width, negative ints, fixmap/map16,
# fixarray/array16
INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63, -1, -32, -33, -128,
        -129, -32768, -32769, -2**31, -2**31 - 1]
HEADERS = [
    {"v": 1, "level": 0, "n_tokens": 37, "n_layers": 4, "n_channels": 64, "group_size": 10},
    {"v": 1, "level": 3, "n_tokens": 1536, "n_layers": 32, "n_channels": 320, "group_size": 10,
     "chunk_idx": 65536},
    {"name": "x" * 31, "long": "y" * 32, "longer": "z" * 256, "ints": INTS, "short": [1, 2, 3],
     **{f"k{i}": i * 40 for i in range(20)}},
    {},
]


def _arrays(seed):
    r = np.random.default_rng(seed)
    return {
        "a.payload": r.integers(0, 2**16, size=100, dtype=np.uint16),  # bin8
        "a.n_words": r.integers(0, 1000, size=64).astype(np.int32),  # bin8 (256 B)
        "scales": r.normal(size=(4, 2, 7)).astype(np.float16),
        "d.payload": r.integers(0, 2**16, size=20000, dtype=np.uint16),  # bin16
        "d.state": r.integers(0, 2**32, size=(40000,), dtype=np.uint64).astype(np.uint32),  # bin32
        "empty": np.zeros((0, 3), np.float32),
        "many_dims": np.zeros((1,) * 17, np.int8),  # shape list -> array16
    }


@pytest.mark.parametrize("header", HEADERS)
def test_pack_bytes_identical_to_reference(header):
    arrays = _arrays(len(header))
    blob = bitstream.pack(header, arrays)
    assert blob == jbitstream.pack(header, arrays)
    # each side reads the other's blob
    for h, a in (bitstream.unpack(jbitstream.pack(header, arrays)), jbitstream.unpack(blob)):
        assert h == header
        assert list(a) == list(arrays)
        for name in arrays:
            np.testing.assert_array_equal(a[name], arrays[name])
            assert a[name].dtype == arrays[name].dtype


@pytest.mark.parametrize("obj", [INTS, "s" * 70000, b"b" * 300, {"k": None, "t": True, "f": False}],
                         ids=["ints", "str32", "bin16", "constants"])
def test_msgpack_subset_roundtrip(obj):
    packed = _msgpack.packb(obj)
    reader = _msgpack.Reader(packed)
    assert reader.read() == obj and reader.tell() == len(packed)


@pytest.mark.parametrize("header", HEADERS[:2])
def test_peek_segment_index_and_head_identical(header):
    blob = bitstream.pack(header, _arrays(5))
    assert bitstream.peek_header(blob) == jbitstream.peek_header(blob) == header
    for run_bytes in (8192, 1000):
        got = bitstream.segment_index(blob, delta_run_bytes=run_bytes)
        want = jbitstream.segment_index(blob, delta_run_bytes=run_bytes)
        assert got.to_wire() == want.to_wire()
        assert got.verified_prefix(blob) == len(blob)
    idx = bitstream.segment_index(blob)
    head = bitstream.synthesize_head(header, idx.n_arrays)
    assert head == jbitstream.synthesize_head(header, idx.n_arrays) == blob[: idx.head.end]


def test_degenerate_layouts_segment_like_reference():
    blob = jbitstream.pack({"v": 1}, {})  # no arrays
    other = _msgpack.packb([1, 2, 3])  # not a {h, a} map
    for b in (blob, other):
        assert bitstream.segment_index(b).to_wire() == jbitstream.segment_index(b).to_wire()


def test_corruption_raises_integrity_error():
    blob = bitstream.pack(HEADERS[0], _arrays(1))
    bad = bytearray(blob)
    bad[len(bad) // 2] ^= 0x40
    with pytest.raises(bitstream.IntegrityError):
        bitstream.unpack(bytes(bad))
    body = blob[:-8]  # no trailer: parse failures are integrity failures too
    assert bitstream.verify_checksum(body) is False
    for cut in (body[:-5], b"\xc1" + body[1:], body + b"\x00"):
        with pytest.raises(bitstream.IntegrityError):
            bitstream.unpack(cut)
    with pytest.raises(bitstream.IntegrityError):
        bitstream.segment_index(blob).verified_prefix(bytes(bad))
    assert issubclass(bitstream.IntegrityError, ValueError)
