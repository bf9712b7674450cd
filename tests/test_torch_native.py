"""The port's host library (``avdn_tpu_torch/csrc/avdn_host.cpp``, built here
with the host's g++ by ``ops/build.py``, bound by ``data/native.py``) against
its plain versions and the JAX package's native library, on the CPU.

* ``native.area_resize`` is bit-equal to ``data/resample.py`` and to
  ``avdn_tpu.data.native.area_resize`` on random tiles with down-, up- and
  identity ratios and odd widths (3 channels and 1); ``swap_rb`` reverses the
  channels; ``load_map_image`` resamples through the library.
* The native WordPiece encoder's ids and mask equal the JAX
  ``WordPieceTokenizer``'s (its C++ path and its Python path) and the port's
  own ``_encode_python``, with a hashed and a real vocabulary, with
  truncation, punctuation, control characters, an over-long word and
  non-ASCII texts (re-encoded one by one in Python); the static-shape call
  takes the native path, a vocabulary whose ids are not dense takes Python.
* Eight threads that ask for the library at once, while it is being built,
  all get the same loaded library.
* A build that fails raises ``RuntimeError`` with the compiler's output, and
  the map loader raises with it: nothing falls back.

The JAX package's library is loaded first, as ``tests/torch_shared.py``
does. Wall: ~10 s on one worker (three g++ builds of the library).
"""

import sys
import threading

import numpy as np
import pytest

from avdn_tpu.data import native as jax_native
from avdn_tpu.data.tokenizer import WordPieceTokenizer as JaxTokenizer

from avdn_tpu_torch.data import native, resample
from avdn_tpu_torch.data.tokenizer import WordPieceTokenizer
from avdn_tpu_torch.ops import build

# (source h, w, destination h, w, channels)
RESIZE_CASES = {
    "down": (240, 321, 120, 161, 3),
    "down_odd": (97, 203, 31, 67, 3),
    "up": (37, 53, 74, 119, 3),
    "up_odd_narrow": (13, 9, 29, 31, 3),
    "identity": (64, 77, 64, 77, 3),
    "width_only": (128, 333, 128, 385, 3),
    "gray": (61, 89, 40, 101, 1),
}


@pytest.fixture(scope="module", autouse=True)
def jax_library():
    assert jax_native.available(), "the JAX package's native library did not load"


@pytest.mark.parametrize("case", sorted(RESIZE_CASES))
def test_area_resize_bit_equal(case):
    h, w, dh, dw, ch = RESIZE_CASES[case]
    rng = np.random.default_rng(sorted(RESIZE_CASES).index(case))
    src = rng.integers(0, 256, (h, w, ch) if ch > 1 else (h, w), np.uint8)
    got = native.area_resize(src, dh, dw)
    assert got.shape == ((dh, dw, ch) if ch > 1 else (dh, dw)) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, resample.area_resize(src, dh, dw))
    np.testing.assert_array_equal(got, jax_native.area_resize(src, dh, dw))
    if case == "identity":
        np.testing.assert_array_equal(got, src)


def test_swap_rb_and_map_loader(tmp_path):
    import cv2

    from avdn_tpu.data.maps import load_map_image as jax_load
    from avdn_tpu_torch.data.maps import load_map_image

    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (33, 47, 3), np.uint8)
    np.testing.assert_array_equal(native.swap_rb(img.copy()), img[:, :, ::-1])
    path = str(tmp_path / "tile.tif")
    cv2.imwrite(path, img)
    got = load_map_image(path, 2.4e-5, 2e-5)
    assert got.shape == (33, int(47 * 2.4e-5 / 2e-5), 3)
    np.testing.assert_array_equal(got, jax_load(path, 2.4e-5, 2e-5))
    np.testing.assert_array_equal(
        got, resample.area_resize(img, 33, got.shape[1])[:, :, ::-1])
    with pytest.raises(ValueError, match="destination"):
        native.area_resize(img, 0, 5)


VOCAB = list(dict.fromkeys(  # ids dense 0..n-1: no repeated line
    ["[PAD]"] + [f"[unused{i}]" for i in range(99)]
    + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    + list("abcdefghijklmnopqrstuvwxyz0123456789") + list(".,!?;:'\"-()/[]#")
    + ["fly", "head", "north", "##ward", "over", "the", "build", "##ing",
       "##ings", "turn", "left", "right", "toward", "gray", "roof", "##top",
       "where", "should", "i", "go", "next", "am", "close", "yet", "keep",
       "##going", "forward", "road", "que", "ins", "number", "sep", "##s"]))

TEXTS = [
    "[QUE] where should i go next? [INS] head north over the road.",
    "Fly TOWARD the gray building number 3 [SEP]",
    "[QUE] am i close yet? [INS] keep going forward. " * 12,  # truncated
    "Turn\tleft,\nthen right!!! (the roof-top) ##ward",
    "ctrl\x07chars\x1fvanish inside a word",
    "x" * 101 + " fly",  # a word over max_chars_per_word
    "",
    "héllo wörld, go north",  # non-ASCII: the Python encoder
    "ÅNGSTRÖM — ｆｕｌｌｗｉｄｔｈ 東京 ok",
    "UPPER lower MiXeD 12345 9.5",
]


def _vocab_file(tmp_path):
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(VOCAB) + "\n")
    return str(path)


@pytest.mark.parametrize("mode", ["hashed", "real"])
@pytest.mark.parametrize("lengths", [(100, 120), (16, 16), (24, 12)])
def test_encoder_equals_jax(tmp_path, mode, lengths):
    max_length, pad_to = lengths
    if mode == "hashed":
        port, jax_tok = WordPieceTokenizer.fallback(), JaxTokenizer.fallback()
    else:
        path = _vocab_file(tmp_path)
        port, jax_tok = (WordPieceTokenizer.from_vocab_file(path),
                         JaxTokenizer.from_vocab_file(path))
    assert jax_tok._native_handle(), "the JAX package's C++ encoder is not in use"
    ids, mask = port(TEXTS, max_length=max_length, pad_to=pad_to)
    assert ids.shape == mask.shape == (len(TEXTS), pad_to)
    assert ids.dtype == mask.dtype == np.int32
    for want_ids, want_mask in (jax_tok(TEXTS, max_length=max_length, pad_to=pad_to),
                                jax_tok._encode_python(TEXTS, max_length, pad_to),
                                port._encode_python(TEXTS, max_length, pad_to)):
        np.testing.assert_array_equal(ids, want_ids)
        np.testing.assert_array_equal(mask, want_mask)
    # without a static shape both packages pad to the batch's longest row
    for got, want in zip(port(TEXTS), jax_tok(TEXTS)):
        np.testing.assert_array_equal(got, want)


def test_static_shape_takes_the_native_path(tmp_path, monkeypatch):
    port = WordPieceTokenizer.from_vocab_file(_vocab_file(tmp_path))
    want, _ = port._encode_python(TEXTS, 32, 32)

    def refuse(*a, **kw):
        raise AssertionError("the Python encoder ran a static-shape batch")

    monkeypatch.setattr(port, "_encode_python", refuse)
    ascii_only = [t for t in TEXTS if t.isascii()]
    ids, _ = port(ascii_only, max_length=32, pad_to=32)
    np.testing.assert_array_equal(ids, want[[TEXTS.index(t) for t in ascii_only]])
    # a vocabulary whose ids are not dense 0..n-1 has no C++ encoder
    sparse = WordPieceTokenizer({**port.vocab, "extra": len(port.vocab) + 5})
    assert sparse._native_handle() is None
    with pytest.raises(ValueError, match="max_length"):
        native.wp_encode_batch(port._native_handle(), ["a"], 1, 4)


def test_concurrent_first_loads_all_get_the_library(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(native, "_lib", None)
    start = threading.Barrier(8)
    got, errors = [None] * 8, []

    def first_call(i):
        try:
            start.wait(timeout=60)
            got[i] = native.library()
            got[i].swap_rb_u8  # a declared symbol
        except Exception as e:  # recorded and asserted on below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=first_call, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert all(lib is got[0] for lib in got) and got[0] is not None
    img = np.arange(2 * 3 * 3, dtype=np.uint8).reshape(2, 3, 3)
    np.testing.assert_array_equal(native.swap_rb(img.copy()), img[:, :, ::-1])


def test_failed_build_raises(tmp_path, monkeypatch):
    from avdn_tpu_torch.data.maps import load_map_image

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "avdn_host.cpp").write_text('extern "C" int broken( { return 0; }\n')
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match=r"(?s)failed for avdn_host\.cpp:\n.*error"):
        native.area_resize(np.zeros((4, 4, 3), np.uint8), 2, 2)
    assert native._lib is None  # nothing was loaded in its place
    import cv2

    path = str(tmp_path / "tile.tif")
    cv2.imwrite(path, np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(RuntimeError, match="avdn_host"):
        load_map_image(path, 1.0, 1.0)
    with pytest.raises(RuntimeError, match="avdn_host"):
        WordPieceTokenizer.fallback()(["go north"], max_length=8, pad_to=8)
