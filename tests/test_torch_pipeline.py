"""``mpmc_tpu_torch/image/pipeline.py`` (``ImagePipeline``) and
``train/loop.prefetch_batches`` against their JAX counterparts: the decoded
cache, the order, padding and ``n_valid`` of the batches, the prefetch
thread's batches, errors and stall counters."""

import numpy as np
import pytest
from PIL import Image

from mpmc_tpu import native_lib as j_native_lib
from mpmc_tpu.image import decode as j_decode
from mpmc_tpu.image.pipeline import ImagePipeline as JImagePipeline
from mpmc_tpu.train.loop import batch_iter as j_batch_iter
from mpmc_tpu.train.loop import prefetch_batches as j_prefetch_batches
from mpmc_tpu_torch.cli.experiments import prepare_images
from mpmc_tpu_torch.image.decode import decode_batch
from mpmc_tpu_torch.image.pipeline import ImagePipeline
from mpmc_tpu_torch.io.manifest import read_manifest
from mpmc_tpu_torch.train.loop import batch_iter, prefetch_batches


def load_jax_native():
    """The JAX package's decoder module, loaded.  Every test process
    imports ``tests/test_native.py``, whose ``skipif`` builds the JAX
    library at collection time: processes that build it at once can leave
    one of them with a failed load, remembered for the session.  The
    library is on disk by now, so such a process loads it again."""
    if j_native_lib.load() is None:
        j_native_lib._tried = False
        j_decode._native_checked = False
    assert j_native_lib.load() is not None, "the JAX native library builds"
    assert j_decode._load_native() is not None
    return j_decode


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """11 images (PNG and JPEG of several sizes) and one missing path."""
    d = tmp_path_factory.mktemp("pipe")
    rng = np.random.default_rng(3)
    paths = []
    for i in range(11):
        h, w = int(rng.integers(40, 300)), int(rng.integers(40, 300))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        name = f"img_{i}." + ("png" if i % 2 else "jpg")
        Image.fromarray(img).save(d / name)
        paths.append(name)
    paths.insert(5, "absent.jpg")
    return str(d), paths


def test_preload_equals_decode_batch_and_jax(split):
    """The first decode of the process goes through the pipeline's
    threads: each must wait for the library, not take the PIL path.  (The
    JAX package's ``_load_native`` has no lock, so its native library is
    loaded before its pipeline runs.)"""
    load_jax_native()
    root, paths = split
    pipe = ImagePipeline(paths, root=root, size=64)
    cache = pipe.preload()
    assert pipe.preload() is cache and len(pipe) == len(paths)
    np.testing.assert_array_equal(cache, decode_batch(paths, 64, False, root))
    np.testing.assert_array_equal(
        cache, JImagePipeline(paths, root=root, size=64).preload())
    gray = ImagePipeline(paths, root=root, size=32, grayscale=True).preload()
    assert gray.shape == (len(paths), 32, 32, 1)
    with pytest.raises(FileNotFoundError, match="1/12"):
        ImagePipeline(paths, root=root, size=32, strict=True).preload()


def test_prepare_images_reads_the_manifest(split, tmp_path):
    import json
    root, paths = split
    manifest = tmp_path / "m.json"
    manifest.write_text(json.dumps([{"id": p, "img_path": p, "text": "x"}
                                    for p in paths]))
    got = prepare_images(read_manifest(str(manifest)), root, 48)
    np.testing.assert_array_equal(got, decode_batch(paths, 48, False, root))


@pytest.mark.parametrize("batch_size", [1, 4, 5, 12, 20])
def test_batches_order_padding_and_n_valid(split, batch_size):
    root, paths = split
    pipe = ImagePipeline(paths, root=root, size=32)
    cache = pipe.preload()
    order = np.random.default_rng(batch_size).permutation(len(paths))
    got = list(pipe.batches(order, batch_size, put=lambda b: b.copy()))
    want = list(JImagePipeline(paths, root=root, size=32).batches(
        order, batch_size))
    assert [n for _, n in got] == [n for _, n in want]
    for (g, n), (w, _) in zip(got, want):
        assert g.shape == (batch_size, 32, 32, 3)
        np.testing.assert_array_equal(g, w)
        assert not g[n:].any()            # zero padding
    np.testing.assert_array_equal(np.concatenate([g[:n] for g, n in got]),
                                  cache[order])


def test_batches_raise_a_put_error(split):
    root, paths = split
    pipe = ImagePipeline(paths, root=root, size=16)

    def put(b):
        raise ValueError("put failed")

    with pytest.raises(ValueError, match="put failed"):
        list(pipe.batches(np.arange(len(paths)), 4, put=put))


def _data(n):
    rng = np.random.default_rng(n)
    return {"x": rng.normal(size=(n, 3)).astype(np.float32),
            "label": rng.integers(0, 2, n).astype(np.int32)}


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_prefetch_yields_every_batch_once_in_order(depth):
    data = _data(37)
    stats, j_stats = {}, {}
    got = list(prefetch_batches(batch_iter(data, 8, with_valid=True),
                                put=lambda b: {k: v * 1 for k, v in
                                               b.items()},
                                depth=depth, stats=stats))
    want = list(j_prefetch_batches(j_batch_iter(data, 8, with_valid=True),
                                   depth=depth, stats=j_stats))
    assert len(got) == len(want) == 5
    for (dev, host, n), (j_dev, j_host, j_n) in zip(got, want):
        assert n == j_n
        assert dev is not host
        for k in j_host:
            np.testing.assert_array_equal(host[k], j_host[k])
            np.testing.assert_array_equal(dev[k], j_dev[k])
    assert [n for _, _, n in got] == [8, 8, 8, 8, 5]
    for s in (stats, j_stats):
        assert s["gets"] == 5 and 0 <= s["empty_gets"] <= 5
        assert s["wait_s"] >= 0
    # The JAX loop also times its producer (put_s), which nothing reads.
    assert set(stats) == set(j_stats) - {"put_s"}


def test_prefetch_surfaces_a_producer_exception_after_earlier_batches():
    def it():
        yield {"x": np.zeros(2)}, 2
        yield {"x": np.ones(2)}, 2
        raise RuntimeError("producer broke")

    seen = []
    with pytest.raises(RuntimeError, match="producer broke"):
        for _, host, _ in prefetch_batches(it()):
            seen.append(host["x"].sum())
    assert seen == [0.0, 2.0]


def test_prefetch_counts_empty_gets_when_the_producer_is_slow():
    import time

    def slow():
        for i in range(3):
            time.sleep(0.05)
            yield {"i": np.array([i])}, 1

    stats = {}
    got = [h["i"][0] for _, h, _ in prefetch_batches(slow(), stats=stats)]
    assert got == [0, 1, 2]
    assert stats["gets"] == 3 and stats["empty_gets"] >= 2
    assert stats["wait_s"] >= 0.05
