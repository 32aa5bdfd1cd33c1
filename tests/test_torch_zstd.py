"""The port's zstd decoder (`msfno_torch/csrc/zstd_decode.cpp` through
`msfno_torch/utils/zstd.py`, built here with g++) against the `zstandard`
package, the oracle of these tests only: every frame `zstandard.compress`
writes at levels 1, 3, 9 and 19 over a corpus decodes to its input byte for
byte, and the corpus is parsed to show that it holds every block type,
literals type and sequence-table mode.  Corrupt frames raise.  The Raw/RLE
writer's frames decode with `zstandard`; crc32c against its published
check value."""

import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from msfno_torch.utils import zstd

zstandard = pytest.importorskip("zstandard")

LEVELS = (1, 3, 9, 19)
MAGIC = 0xFD2FB528


def _corpus() -> dict[str, bytes]:
    rng = np.random.default_rng(0)
    words = ["the", "quick", "brown", "fox", "jumps", "over", "lazy", "dog", "sfno", "film",
             "gamma", "beta", "\n"]
    text = " ".join(rng.choice(words, 60000)).encode()
    smooth = np.cumsum(rng.standard_normal(100_000)).astype(np.float32).tobytes()
    runs = b"".join(bytes([int(b)]) * int(n) for b, n in
                    zip(rng.integers(0, 4, 4000), rng.integers(1, 40, 4000)))
    return {
        "random": rng.integers(0, 256, 200_000, dtype=np.uint8).tobytes(),
        "float32_weights": (0.02 * rng.standard_normal(64_000)).astype(np.float32).tobytes(),
        "zeros": bytes(300_000),
        "text": text,
        # > 128 KiB: many blocks, tables and Huffman trees repeated across them
        "smooth_float32": smooth,
        "runs": runs,
        # a counter: blocks whose sequences share one offset code (RLE tables)
        "int32_counter": np.arange(100_000, dtype=np.int32).tobytes(),
        "tiny": b"abc",
        "empty": b"",
    }


CORPUS = _corpus()


def _over_window() -> tuple[bytes, bytes]:
    """A 600 KB input whose repeats lie beyond a 128 KiB window, compressed
    with that window."""
    rng = np.random.default_rng(1)
    seg = rng.integers(0, 64, 150_000, dtype=np.uint8).tobytes()
    data = seg + bytes(rng.integers(0, 64, 150_000, dtype=np.uint8)) + seg + seg[::-1]
    params = zstandard.ZstdCompressionParameters.from_level(3, window_log=17)
    return data, zstandard.ZstdCompressor(compression_params=params).compress(data)


def _frames(level: int, checksum: bool = False) -> dict[str, bytes]:
    c = zstandard.ZstdCompressor(level=level, write_checksum=checksum)
    return {name: c.compress(data) for name, data in CORPUS.items()}


@pytest.mark.parametrize("level", LEVELS)
def test_decoder_matches_zstandard(level):
    for name, frame in _frames(level).items():
        assert zstd.decompress(frame) == CORPUS[name], (level, name)
        out = np.empty(len(CORPUS[name]), np.uint8)
        assert zstd.decompress_into(frame, out) == len(CORPUS[name])
        assert out.tobytes() == CORPUS[name]


@pytest.mark.parametrize("level", LEVELS)
def test_content_checksum_frames(level):
    for name, frame in _frames(level, checksum=True).items():
        assert frame[4] & 0x04  # the checksum flag is set
        assert zstd.decompress(frame) == CORPUS[name], (level, name)


def test_over_the_window_and_repeat_offsets():
    data, frame = _over_window()
    assert (frame[5] >> 3) + 10 == 17  # a 128 KiB window, no single segment
    assert zstd.decompress(frame) == data


def test_concatenated_and_skippable_frames():
    parts = [CORPUS["text"][:5000], CORPUS["random"][:3000], CORPUS["zeros"][:7000]]
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"12345"
    blob = b"".join(zstandard.ZstdCompressor(level=lv).compress(p)
                    for lv, p in zip((1, 9, 19), parts))
    assert zstd.decompress(blob) == b"".join(parts)
    assert zstd.decompress(skip + blob + skip) == b"".join(parts)


# ------------------------------------------------------------- coverage


def _blocks(frame: bytes):
    """(block type, literals type, four streams, Huffman weights direct,
    sequence-table modes) of each block of every frame in `frame`."""
    out, pos = [], 0
    while pos < len(frame):
        assert int.from_bytes(frame[pos:pos + 4], "little") == MAGIC
        fhd = frame[pos + 4]
        p = pos + 5 + (0 if fhd & 0x20 else 1) + (0, 1, 2, 4)[fhd & 3]
        fcs = (fhd >> 6)
        p += (1 if fhd & 0x20 else 0) if fcs == 0 else (2, 4, 8)[fcs - 1]
        while True:
            bh = int.from_bytes(frame[p:p + 3], "little")
            last, btype, size = bh & 1, (bh >> 1) & 3, bh >> 3
            p += 3
            if btype == 2:
                out.append((2, *_compressed(frame[p:p + size])))
            else:
                out.append((btype, None, None, None, None))
            p += 1 if btype == 1 else size
            if last:
                break
        pos = p + (4 if fhd & 0x04 else 0)
    return out


def _compressed(b: bytes):
    ltype, sf = b[0] & 3, (b[0] >> 2) & 3
    direct = None
    if ltype <= 1:
        hs = {0: 1, 2: 1, 1: 2, 3: 3}[sf]
        regen = (b[0] >> 3) if hs == 1 else int.from_bytes(b[:hs], "little") >> 4
        lsize = hs + (regen if ltype == 0 else 1)
        four = None
    else:
        hs = {0: 3, 1: 3, 2: 4, 3: 5}[sf]
        v = int.from_bytes(b[:hs], "little")
        csize = {3: (v >> 14) & 0x3FF, 4: (v >> 18) & 0x3FFF, 5: (v >> 22) & 0x3FFFF}[hs]
        lsize = hs + csize
        four = sf != 0
        if ltype == 2:
            direct = b[hs] >= 128
    s = b[lsize:]
    n = s[0]
    if n == 0:
        return ltype, four, direct, None
    k = 1 if n < 128 else 2 if n < 255 else 3
    m = s[k]
    return ltype, four, direct, (m >> 6, (m >> 4) & 3, (m >> 2) & 3)


def test_corpus_exercises_every_block_and_table_type():
    blocks = []
    for level in LEVELS:
        for frame in _frames(level).values():
            blocks += _blocks(frame)
    blocks += _blocks(_over_window()[1])
    assert {b[0] for b in blocks} == {0, 1, 2}  # Raw, RLE, Compressed
    comp = [b for b in blocks if b[0] == 2]
    assert {b[1] for b in comp} == {0, 1, 2, 3}  # Raw, RLE, Huffman, treeless literals
    assert {b[2] for b in comp if b[1] >= 2} == {False, True}  # one and four streams
    assert {b[3] for b in comp if b[1] == 2} == {False, True}  # FSE and direct weights
    modes = [b[4] for b in comp if b[4] is not None]
    for table in range(3):  # literal lengths, offsets, match lengths
        assert {m[table] for m in modes} == {0, 1, 2, 3}, table


@settings(max_examples=40, deadline=None)
@given(data=st.binary(min_size=0, max_size=3000), reps=st.integers(1, 6),
       level=st.sampled_from(LEVELS), checksum=st.booleans())
def test_random_inputs(data, reps, level, checksum):
    raw = data * reps + data[: len(data) // 2]
    frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(raw)
    assert zstd.decompress(frame) == raw


# ------------------------------------------------------------ corruption


def test_corrupt_frames_raise():
    data = CORPUS["text"][:50_000]
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data)
    with pytest.raises(ValueError, match="zstd"):
        zstd.decompress(frame[: len(frame) // 2])
    with pytest.raises(ValueError, match="checksum"):
        zstd.decompress(frame[:-1] + bytes([frame[-1] ^ 0xFF]))
    with pytest.raises(ValueError, match="magic"):
        zstd.decompress(b"\x00" + frame)
    # a frame that names dictionary 7 (single segment, 1-byte dictionary ID)
    needs_dict = zstd.MAGIC + bytes([0x21, 7, 3]) + (1 | 3 << 3).to_bytes(3, "little") + b"abc"
    with pytest.raises(zstandard.ZstdError):
        zstandard.ZstdDecompressor().decompress(needs_dict)
    with pytest.raises(ValueError, match="dictionary ID 7"):
        zstd.decompress(needs_dict)
    out = np.empty(10, np.uint8)
    with pytest.raises(ValueError, match="exceed"):
        zstd.decompress_into(frame, out)


# --------------------------------------------------------------- writer


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_writer_frames_decode_with_zstandard(name):
    data = CORPUS[name]
    frame = zstd.frame(data)
    d = zstandard.ZstdDecompressor()
    assert d.decompress(frame) == data  # the frame carries its content size
    assert zstd.decompress(frame) == data
    if name == "zeros":  # one byte repeated: RLE blocks of 4 bytes each
        assert len(frame) < 64


def test_writer_sizes_at_header_boundaries():
    for n in (0, 1, 255, 256, 65791, 65792, 131072, 131073, 300_001):
        data = bytes(np.random.default_rng(n).integers(0, 3, n, dtype=np.uint8))
        frame = zstd.frame(data)
        assert zstandard.ZstdDecompressor().decompress(frame, max_output_size=n + 1) == data
        assert zstandard.get_frame_parameters(frame).content_size == n


def test_crc32c():
    assert zstd.crc32c(b"123456789") == 0xE3069283  # the published check value
    assert zstd.crc32c(b"") == 0
    assert zstd.crc32c(b"6789", zstd.crc32c(b"12345")) == 0xE3069283
    data = CORPUS["random"]
    assert zstd.crc32c(data) == zstd.crc32c(data[777:], zstd.crc32c(data[:777]))


def test_decoder_throughput_on_8mb():
    """Sandbox-CPU figure (not a card figure): MB/s of decoded output on a
    frame of about 8 MB."""
    rng = np.random.default_rng(2)
    data = (0.02 * rng.standard_normal(2_400_000)).astype(np.float32).tobytes()
    frame = zstandard.ZstdCompressor(level=3).compress(data)
    assert 7e6 < len(frame) < 9.6e6
    out = np.empty(len(data), np.uint8)
    t = time.perf_counter()
    zstd.decompress_into(frame, out)
    dt = time.perf_counter() - t
    assert out.tobytes() == data
    print(f"zstd decode (sandbox CPU) {len(frame) / 1e6:.2f} MB compressed -> "
          f"{len(data) / 1e6:.2f} MB in {dt:.3f} s: {len(data) / 1e6 / dt:.1f} MB/s out, "
          f"{len(frame) / 1e6 / dt:.1f} MB/s in")
