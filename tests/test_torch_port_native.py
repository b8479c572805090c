"""The port's binding to the native image pipeline (`data/native.py`) on the
CPU: the library it builds from `native/difashion_io.cc` with
`native/Makefile`'s flags gives the JAX package's binding's images bit for
bit; they are within `tests/test_native_io.py`'s bound of the PIL pipeline
where it shrinks the images, as there (mean < 0.01, max < 0.2 in [-1, 1]:
decode and rounding LSBs); a library
built from another source is refused as stale; a failed build falls back to
PIL; and `extract-features`' item loader takes the native path where it
builds."""
import os

import numpy as np
import pytest
from PIL import Image

from difashion_tpu.cli.extract_features import make_item_loader as jax_make_item_loader
from difashion_tpu.data import native as jnative
from difashion_tpu_torch.cli.extract_features import make_item_loader
from difashion_tpu_torch.data import native
from difashion_tpu_torch.data.preprocessing import prepare_catalog_image

MEAN_TOL, MAX_TOL = 0.01, 0.2


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    """RGB JPEGs, RGBA PNGs (transparent corners), a grayscale PNG and a
    CMYK JPEG, square and not, larger and smaller than 64 px."""
    root = tmp_path_factory.mktemp("catalog")
    rng = np.random.RandomState(3)
    names = []
    for i, (h, w) in enumerate([(96, 80), (50, 50), (40, 70), (130, 64), (64, 64), (33, 90)]):
        rgb = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
        if i % 2:
            alpha = np.full((h, w, 1), 255, np.uint8)
            alpha[: h // 3, : w // 3] = 0
            name = f"item{i}.png"
            Image.fromarray(np.concatenate([rgb, alpha], 2), "RGBA").save(root / name)
        else:
            name = f"item{i}.jpg"
            Image.fromarray(rgb).save(root / name, quality=90)
        names.append(name)
    Image.fromarray(rng.randint(0, 256, (45, 60), dtype=np.uint8), "L").save(root / "gray.png")
    Image.fromarray(rng.randint(0, 256, (48, 48, 3), dtype=np.uint8)).convert("CMYK").save(
        root / "cmyk.jpg", quality=95)
    return str(root), names + ["gray.png", "cmyk.jpg"]


@pytest.fixture
def built():
    """The port's library, built here from the source; skipped where this
    machine cannot build it (no compiler, no libjpeg / libpng headers), as
    tests/test_native_io.py skips without the JAX package's library."""
    if not native.native_available():
        pytest.skip(native.unavailable())


@pytest.fixture
def jax_built(built):
    """The JAX package's library as well, to compare with."""
    if not jnative.native_available():
        pytest.skip("the JAX package's native library is not built (make -C native)")


def _pil(path, size):
    arr = np.asarray(prepare_catalog_image(Image.open(path), size), np.float32)
    return 2.0 * (arr / 255.0) - 1.0


def test_the_port_builds_its_own_library_from_the_source(built):
    path = native.build()
    assert path == native.BUILD_DIR / f"libdifashion_io-{native.source_hash()[:16]}.so"
    assert native.source_hash() == jnative._source_hash()
    assert os.path.realpath(path) != os.path.realpath(jnative._LIB_PATH)


@pytest.mark.parametrize("size", [32, 64, 512])
def test_bit_equal_to_the_jax_binding(catalog, size, jax_built):
    root, names = catalog
    for name in names:
        path = os.path.join(root, name)
        got = native.prepare_image(path, size)
        assert got.shape == (size, size, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, jnative.prepare_image(path, size), err_msg=name)


def test_near_pil_when_shrinking(catalog, built):
    """tests/test_native_io.py's bound, at its condition: every image shrunk
    (to 32 px). Enlarging pure noise 8x rings further apart (PIL's Lanczos
    weights are fixed-point, the native ones double): up to 0.25 at 512 px,
    the JAX package's pipelines' own difference, which the port keeps bit
    for bit (above)."""
    root, names = catalog
    for name in names:
        path = os.path.join(root, name)
        diff = np.abs(native.prepare_image(path, 32) - _pil(path, 32))
        assert diff.mean() < MEAN_TOL and diff.max() < MAX_TOL, (name, diff.mean(), diff.max())


def test_pool_loader_matches_single_images_and_fills_failures(catalog, caplog, built):
    root, names = catalog
    paths = [os.path.join(root, n) for n in names] + [os.path.join(root, "missing.jpg")]
    loader = native.NativeCatalogLoader(paths, size=48, n_threads=3)
    ids = [3, 0, len(paths) - 1, 5, 3]
    out = loader.load(ids)
    assert out.shape == (5, 48, 48, 3) and loader.last_failed == 1
    for row, i in zip(out[[0, 1, 3, 4]], [3, 0, 5, 3]):
        np.testing.assert_array_equal(row, native.prepare_image(paths[i], 48))
    assert (out[2] == 1.0).all() and "decodes failed" in caplog.text    # the white null
    loader.close()
    with pytest.raises(ValueError, match="closed"):
        loader.load([0])
    with pytest.raises(IOError, match="failed to decode"):
        native.prepare_image(paths[-1], 48)


def test_a_library_of_another_source_is_refused(tmp_path, built):
    src = tmp_path / "difashion_io.cc"
    src.write_text(native.SRC_PATH.read_text() + "\n// another revision\n")
    path = native.build(src=src, out_dir=tmp_path / "build")
    with pytest.raises(OSError, match="stale native library"):
        native.load_library(path)          # checked against the checkout's source
    import ctypes

    native.check_fresh(ctypes.CDLL(str(path)), path, src=src)   # its own source: fresh


def test_a_failed_build_falls_back_to_pil(catalog, monkeypatch, caplog):
    root, names = catalog
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "build", lambda *a, **k: (_ for _ in ()).throw(
        RuntimeError("g++ -O3 ... failed: fatal error: jpeglib.h: No such file or directory")))
    assert not native.native_available()
    assert "jpeglib.h" in native.unavailable()
    loader = make_item_loader(root, names, 64)
    assert loader.kind == "pil" and "taking the PIL catalog pipeline" in caplog.text
    for i in (0, 1):
        np.testing.assert_array_equal(loader(i), _pil(os.path.join(root, names[i]), 64))
    with pytest.raises(OSError, match="unavailable"):
        native.prepare_image(os.path.join(root, names[0]), 64)


def test_extract_features_item_loader_prefers_native_as_the_jax_command(catalog, jax_built):
    root, names = catalog
    loader = make_item_loader(root, names, 64)
    want = jax_make_item_loader(root, names, 64)
    assert loader.kind == "native"
    for i in range(len(names)):
        np.testing.assert_array_equal(loader(i), want(i))
