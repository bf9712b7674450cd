"""The port's host map preprocessing against the JAX package's, on the CPU.

``avdn_tpu_torch.data.resample.area_resize`` must be bit-equal to the JAX
package's native INTER_AREA resampler (``avdn_tpu.data.native.area_resize``)
on seeded uint8 tiles: a shrink, a stretch, the identity width, both axes
at once, and a single-channel image. ``load_map_image`` must give the JAX
package's decoded map byte for byte.
"""

import os

import numpy as np
import pytest

from avdn_tpu_torch.data.resample import area_resize

CASES = {
    "shrink_width": ((240, 320, 3), (240, 267)),
    "stretch_width": ((60, 40, 3), (60, 97)),
    "identity_width": ((64, 80, 3), (64, 80)),
    "both_axes": ((37, 53, 3), (300, 11)),
    "tall_tile_stretch": ((600, 500, 3), (600, 713)),
    "gray": ((50, 70), (31, 90)),
}


def _native():
    from avdn_tpu.data import native

    if not native.available():
        pytest.skip("the JAX package's native library (native/libavdn_host.so) "
                    "cannot be built or loaded here")
    return native


@pytest.mark.parametrize("case", sorted(CASES))
def test_area_resize_bit_equal_to_native(case):
    native = _native()
    shape, (dh, dw) = CASES[case]
    img = np.random.default_rng(sorted(CASES).index(case)).integers(
        0, 256, shape, np.uint8)
    want = native.area_resize(img, dh, dw)
    got = area_resize(img, dh, dw)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_load_map_image_matches_jax(tmp_path):
    cv2 = pytest.importorskip("cv2")
    _native()
    from avdn_tpu.data.maps import load_map_image as jax_load
    from avdn_tpu_torch.data.maps import load_map_image

    img = np.random.default_rng(7).integers(0, 256, (90, 120, 3), np.uint8)
    path = os.path.join(str(tmp_path), "tile.png")
    assert cv2.imwrite(path, img)
    got = load_map_image(path, lng_ratio=5.8e-6, lat_ratio=5e-6)
    want = jax_load(path, lng_ratio=5.8e-6, lat_ratio=5e-6)
    assert got.shape == (90, 139, 3)
    np.testing.assert_array_equal(got, want)
