"""The port's native batch gather (``dlwp_torch/csrc/batch_assembler.c``
through ``dlwp_torch.data.native``) on the CPU, where the host C compiler
builds it: bit-equal to ``dlwp_tpu.data.native.assemble`` and to its numpy
version (a gather is a copy), the sampler's three routes, and the build's
failure modes (a failing compiler raises; no compiler means numpy)."""

import os
import shutil

import numpy as np
import pytest

from dlwp_tpu.data.native import assemble as jax_assemble

from dlwp_torch.data import PredictorDataset, Preprocessor, SeriesSampler
from dlwp_torch.data import native
from dlwp_torch.data import sampler as tsampler
from dlwp_torch.kernels import _build

# (series shape, samples, offsets, channels): the flagship's batch shape
# at a small grid, duplicated and unsorted samples and channels, one
# sample, one channel, more threads than samples.
CASES = {
    "flagship_like": ((40, 2, 9, 18), np.arange(32)[::-1] % 36,
                      np.arange(4), [0, 1]),
    "duplicates_unsorted": ((25, 5, 4, 6), [7, 3, 7, 0, 20, 3],
                            [0, 2, 1], [4, 0, 4, 2]),
    "one_sample": ((6, 3, 2, 2), [5], [0], [1]),
    "empty_batch": ((6, 3, 2, 2), [], [0, 1], [1]),
}


def _series(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.fixture
def no_library(tmp_path, monkeypatch):
    """A fresh build directory and no loaded library."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "_LOADED", {})
    return tmp_path


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("n_threads", [1, 4, 64])
def test_assemble_matches_jax_and_numpy(case, n_threads):
    shape, samples, offsets, chans = CASES[case]
    series = _series(shape)
    before = native.assemble.launches
    got = native.assemble(series, samples, offsets, chans,
                          n_threads=n_threads)
    assert native.assemble.launches == before + 1
    assert got.dtype == np.float32 and got.flags.c_contiguous
    assert got.shape == (len(samples), len(offsets), len(chans)) + shape[2:]
    np.testing.assert_array_equal(
        got, native.assemble_plain(series, samples, offsets, chans))
    np.testing.assert_array_equal(
        got, jax_assemble(series, np.asarray(samples), np.asarray(offsets),
                          np.asarray(chans), n_threads))


@pytest.mark.parametrize("bad", ["sample_high", "sample_low", "channel"])
def test_assemble_refuses_indices_out_of_range(bad):
    series = _series((10, 3, 2, 2))
    samples, offsets, chans = [0, 4], [0, 1], [0, 2]
    if bad == "sample_high":
        offsets = [0, 6]  # 4 + 6 = 10
    elif bad == "sample_low":
        samples = [-1, 4]
    else:
        chans = [3]
    before = native.assemble.launches
    with pytest.raises(IndexError, match="out of range"):
        native.assemble(series, samples, offsets, chans)
    assert native.assemble.launches == before


@pytest.mark.parametrize("kind", ["float64", "strided", "list", "5d"])
def test_inapplicable_series_take_numpy(kind):
    base = _series((12, 3, 4, 4))
    series = {"float64": base.astype(np.float64), "strided": base[:, ::2],
              "list": base.tolist(), "5d": base[:, None]}[kind]
    before = native.assemble.launches
    got = native.assemble(series, [3, 1], [0, 2], [0])
    assert native.assemble.launches == before
    np.testing.assert_array_equal(
        got, native.assemble_plain(series, [3, 1], [0, 2], [0]))


def _dataset(n=30, dtype=np.float32, fmt="series"):
    rng = np.random.RandomState(1)
    shape = (n, 2, 2, 4, 8) if fmt == "samples" else (n, 2, 4, 8)
    return PredictorDataset(
        predictors=rng.randn(*shape).astype(dtype),
        targets=rng.randn(*shape).astype(dtype) if fmt == "samples" else None,
        sample=(np.datetime64("2007-01-01")
                + np.arange(n) * np.timedelta64(6, "h")),
        varlev=["HGT/500", "THICK/300-700"],
        lat=np.linspace(60.0, -60.0, 4), lon=np.arange(8) * 45.0)


@pytest.mark.parametrize("route", ["native", "numpy_float64",
                                   "numpy_samples_format", "lazy"])
def test_sampler_routes(route, monkeypatch, tmp_path):
    """Each route, told apart by the native counter and spies on the
    others, gives the in-memory float32 batches (float64 ones for a
    float64 series are equal after the sampler's cast): a C-contiguous
    float32 series the native gather, another array its numpy version, a
    lazy one the sorted-unique reads."""
    kw = dict(input_time_steps=2, output_time_steps=2, sequence=2,
              add_insolation=True, batch_size=8, shuffle=True, seed=0)
    data = _dataset()
    if route == "numpy_float64":
        data = _dataset(dtype=np.float64)
    elif route == "numpy_samples_format":
        data = _dataset(fmt="samples")
    elif route == "lazy":
        data.to_file(str(tmp_path / "p.h5"))
        data = PredictorDataset.from_file(str(tmp_path / "p.h5"), load="lazy")
    read, plain = [], []
    read_rows, assemble_plain = tsampler._read_rows, native.assemble_plain
    monkeypatch.setattr(tsampler, "_read_rows", lambda arr, idx: (
        read.append(type(arr).__name__), read_rows(arr, idx))[1])
    monkeypatch.setattr(native, "assemble_plain", lambda *a: (
        plain.append(1), assemble_plain(*a))[1])
    sampler = SeriesSampler(data, **kw)
    before = native.assemble.launches
    batches = list(sampler)
    calls = native.assemble.launches - before
    gathers = 3 * len(sampler)  # inputs and two target groups a batch
    if route == "native":
        assert calls == gathers and not read and not plain
    elif route == "lazy":
        assert calls == 0 and not plain
        assert read == ["Dataset"] * 2 * gathers  # a read a time step
    else:
        assert calls == 0 and not read and len(plain) == gathers
    reference = list(SeriesSampler(
        _dataset(fmt="samples") if route == "numpy_samples_format"
        else _dataset(), **kw))
    for (x, y), (rx, ry) in zip(batches, reference):
        np.testing.assert_array_equal(x, rx)
        np.testing.assert_array_equal(y, ry)
    if route == "lazy":
        data.close()


def test_failing_compiler_raises(no_library, monkeypatch):
    """A compiler that is found but fails raises with its output; the
    sampler does not fall back to numpy."""
    monkeypatch.setattr(_build, "cc_path", lambda: shutil.which("false"))
    assert native.have_native()
    with pytest.raises(RuntimeError, match="kernel build failed"):
        native.assemble(_series((5, 1, 2, 2)), [0], [0], [0])
    with pytest.raises(RuntimeError, match="batch_assembler.c"):
        SeriesSampler(_dataset()).generate([0, 1])
    assert not any(no_library.rglob("*.so"))


def test_missing_compiler_takes_numpy(no_library, monkeypatch):
    monkeypatch.setattr(_build, "cc_path", lambda: None)
    assert native.have_native() is False
    series = _series((8, 2, 2, 2))
    before = native.assemble.launches
    got = native.assemble(series, [3, 1], [0, 1], [1, 0])
    np.testing.assert_array_equal(
        got, native.assemble_plain(series, [3, 1], [0, 1], [1, 0]))
    x, _ = SeriesSampler(_dataset()).generate([0, 5])
    assert native.assemble.launches == before and x.shape == (2, 2, 4, 8)
    with pytest.raises(RuntimeError, match="no C compiler"):
        _build.build(["batch_assembler"])


def test_build_names_the_library_by_source_and_flags(no_library, monkeypatch):
    assert _build.host_sources() == ["batch_assembler"]
    assert "batch_assembler" not in _build.sources()
    assert _build.source_path("batch_assembler").suffix == ".c"
    path = _build.library_path("batch_assembler")
    monkeypatch.setattr(_build, "CC_FLAGS", _build.CC_FLAGS + ["-g"])
    assert _build.library_path("batch_assembler") != path
    assert _build.build(["batch_assembler"]) > 0
    assert _build.build(["batch_assembler"]) == 0.0  # current: reused
    assert _build.library_path("batch_assembler").exists()
    assert os.path.exists(
        _build.library_path("batch_assembler").with_suffix(".log"))


def test_streamed_file_to_native_sampler(tmp_path):
    """A file written by the streaming Preprocessor and read in full feeds
    the native route; read lazily, the lazy route; the batches agree."""

    class Source:
        times = (np.datetime64("2001-01-01")
                 + np.arange(40) * np.timedelta64(6, "h"))
        lat = np.linspace(60.0, -60.0, 4)
        lon = np.arange(8) * 45.0

        def field(self, variable, level):
            return np.random.RandomState(level).randn(40, 4, 8) * 50 + 5e3

    path = str(tmp_path / "s.h5")
    lazy = Preprocessor(Source()).data_to_series(
        ["HGT", "HGT"], [500, 700], pairwise=True, output_file=path)
    full = PredictorDataset.from_file(path)
    kw = dict(input_time_steps=2, output_time_steps=2, batch_size=16,
              shuffle=True, seed=3)
    before = native.assemble.launches
    from_full = list(SeriesSampler(full, **kw))
    assert native.assemble.launches - before == 2 * len(from_full)
    before = native.assemble.launches
    from_lazy = list(SeriesSampler(lazy, **kw))
    assert native.assemble.launches == before
    for (x, y), (lx, ly) in zip(from_full, from_lazy):
        np.testing.assert_array_equal(x, lx)
        np.testing.assert_array_equal(y, ly)
    lazy.close()
