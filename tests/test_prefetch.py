"""Thread-ahead prefetching must be transparent."""

import time

import numpy as np
import pytest

from ecckd_tpu.io.prefetch import prefetch_iter


def test_order_and_values_identical():
    items = [(i, np.full((3, 7), i, dtype=np.float64)) for i in range(17)]
    got = list(prefetch_iter(iter(items), depth=3))
    assert len(got) == len(items)
    for (i0, a), (i1, b) in zip(items, got):
        assert i0 == i1
        np.testing.assert_array_equal(a, b)


def test_depth_zero_passthrough():
    assert list(prefetch_iter(iter(range(5)), depth=0)) == [0, 1, 2, 3, 4]


def test_producer_exception_propagates():
    def gen():
        yield 1
        raise RuntimeError("disk on fire")

    it = prefetch_iter(gen(), depth=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="disk on fire"):
        list(it)


def test_early_consumer_exit_stops_producer():
    produced = []

    def gen():
        for i in range(1000):
            produced.append(i)
            yield i

    it = prefetch_iter(gen(), depth=2)
    for _ in range(3):
        next(it)
    it.close()
    n_at_close = len(produced)
    time.sleep(0.3)
    # Producer stops promptly: at most one extra item raced into the queue
    assert len(produced) <= n_at_close + 1


def test_reads_overlap_compute():
    """With a slow producer and a slow consumer, prefetching must beat
    the serial sum of the two (i.e. reads genuinely overlap)."""
    n, delay = 8, 0.03

    def slow_gen():
        for i in range(n):
            time.sleep(delay)
            yield i

    t0 = time.perf_counter()
    for _ in prefetch_iter(slow_gen(), depth=2):
        time.sleep(delay)           # consumer work
    dt = time.perf_counter() - t0
    serial = 2 * n * delay
    assert dt < serial * 0.85, (dt, serial)


def test_reordered_read_matches_unprefetched(tmp_path):
    """find_g_points' rank-order streamed read through the prefetcher must
    be bitwise identical to a direct gather."""
    from ecckd_tpu.io.spectrum import open_spectrum_profile, read_spectrum
    from ecckd_tpu.tools.find_g_points import _read_reordered_od
    from synth import synth_spectrum_file

    path = synth_spectrum_file(str(tmp_path / "h2o.h5"), nwav=1024, seed=5)
    sp = read_spectrum(path, 0)
    rng = np.random.default_rng(0)
    irank = rng.permutation(len(sp.wavenumber))
    with open_spectrum_profile(path, 0) as pb:
        od = _read_reordered_od(pb, irank, block_wav=123)
    expect = np.empty_like(sp.optical_depth)
    expect[:, irank] = sp.optical_depth
    np.testing.assert_array_equal(od, expect)
