"""Port parity: the COCO RLE codec (``utils/mask_rle.py``) against the JAX
package's, on both of the port's paths.

The port builds ``native/rle.cpp`` with g++ into
``gdrnpp_bop2022_torch/_build/`` (``utils/cuda_build.load_host_library``),
never into ``native/``; its numpy path gives the same bytes. Counts,
compressed strings, decoded masks and areas equal the JAX codec's exactly,
and the JAX package's round-trip oracles (``tests/test_mask_rle.py``) hold
for the port.
"""

import numpy as np
import pytest

from gdrnpp_bop2022_tpu.utils import mask_rle as J
from gdrnpp_bop2022_torch.utils import cuda_build
from gdrnpp_bop2022_torch.utils import mask_rle as T


@pytest.fixture(params=["native", "numpy"])
def backend(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setattr(T, "_load_native", lambda: None)
    else:
        assert T.native_loaded(), "the port's native RLE library did not build"
    return request.param


def _masks():
    rs = np.random.RandomState(0)
    out = [(rs.uniform(size=(37, 53)) > 0.6).astype(np.uint8),
           np.zeros((8, 8), np.uint8), np.ones((8, 8), np.uint8)]
    yy, xx = np.mgrid[0:120, 0:160]
    out.append(((yy - 60) ** 2 / 900 + (xx - 70) ** 2 / 2500 < 1).astype(np.uint8))
    m = np.zeros((64, 48), bool)
    m[0, 0] = m[-1, -1] = True                     # runs at both ends
    out.append(m)
    return out


@pytest.mark.parametrize("i", range(5))
def test_bytes_equal_jax(backend, i):
    m = _masks()[i]
    counts = T.mask_to_counts(m)
    np.testing.assert_array_equal(counts, J.mask_to_counts(m))
    s = T.counts_to_string(counts)
    assert s == J.counts_to_string(J.mask_to_counts(m))
    np.testing.assert_array_equal(T.string_to_counts(s), J.string_to_counts(s))
    rle = T.encode(m)
    assert rle == J.encode(m)
    np.testing.assert_array_equal(T.decode(rle), J.decode(rle))
    np.testing.assert_array_equal(T.decode(rle), m.astype(np.uint8))
    assert T.area(rle) == J.area(rle) == int(m.sum())
    text = {"size": rle["size"], "counts": rle["counts"].decode()}
    np.testing.assert_array_equal(T.decode(text), m.astype(np.uint8))
    plain = {"size": rle["size"], "counts": counts.tolist()}
    np.testing.assert_array_equal(T.decode(plain), m.astype(np.uint8))


def test_native_builds_into_the_package():
    assert T.native_loaded()
    path = cuda_build.host_library_path(T.RLE_SOURCE)
    assert path.exists() and path.parent == cuda_build.BUILD_DIR
    assert T.RLE_SOURCE.name == "rle.cpp" and T.RLE_SOURCE.parent.name == "native"
