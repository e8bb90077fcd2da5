"""The port's native token dataset against the JAX package, on the CPU.

Every case of ``tests/unit/test_indexed_dataset.py`` runs on the port's
``runtime/data`` (the repo's ``csrc/ds_dataio.cpp`` built by
``ops/dataio.py`` with g++, and the numpy reader), native and numpy where
that file parametrises them. Then the port's readers against the JAX
reader on the same files: documents and windows equal, and the
prefetch loaders' shuffled order equal batch for batch over three
epochs. A failed build and a failed open raise (no quiet fallback to
numpy). Integer data: every comparison is exact.
"""
import threading
import time

import numpy as np
import pytest

from deepspeed_tpu.runtime.data import (
    IndexedDataset as JaxDataset, IndexedDatasetBuilder as JaxBuilder,
    NativePrefetchLoader as JaxLoader)
from deepspeed_tpu_torch.ops import dataio, host_build
from deepspeed_tpu_torch.runtime.data import (IndexedDataset,
                                              IndexedDatasetBuilder,
                                              NativePrefetchLoader)
from deepspeed_tpu_torch.runtime.data import indexed_dataset as tid

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    rng = np.random.RandomState(0)
    docs = [rng.randint(0, 50000, size=rng.randint(3, 300)).astype(np.int32)
            for _ in range(37)]
    prefix = str(tmp_path_factory.mktemp("data") / "corpus")
    b = IndexedDatasetBuilder(prefix)
    for d in docs:
        b.add_doc(d)
    b.finalize()
    return prefix, docs


@pytest.mark.parametrize("use_native", [True, False])
def test_doc_roundtrip(corpus, use_native):
    prefix, docs = corpus
    ds = IndexedDataset(prefix, use_native=use_native)
    assert (ds._lib is not None) == use_native
    assert len(ds) == len(docs)
    assert ds.num_tokens == sum(d.size for d in docs)
    for i in [0, 1, 17, len(docs) - 1]:
        np.testing.assert_array_equal(ds[i], docs[i])
    ds.close()


@pytest.mark.parametrize("use_native", [True, False])
def test_batch_windows(corpus, use_native):
    prefix, docs = corpus
    ds = IndexedDataset(prefix, use_native=use_native)
    stream = np.concatenate(docs)
    seq = 64
    n = ds.num_samples(seq)
    assert n == stream.size // seq
    idx = [0, 3, n - 1, 1]
    got = ds.batch(idx, seq)
    assert got.dtype == np.int32
    for r, s in enumerate(idx):
        np.testing.assert_array_equal(got[r], stream[s * seq:(s + 1) * seq])
    ds.close()


def test_native_matches_numpy(corpus):
    prefix, _ = corpus
    nat = IndexedDataset(prefix, use_native=True)
    ref = IndexedDataset(prefix, use_native=False)
    idx = np.arange(min(8, nat.num_samples(32)))
    np.testing.assert_array_equal(nat.batch(idx, 32), ref.batch(idx, 32))
    nat.close()


@pytest.mark.parametrize("use_native", [True, False])
def test_prefetch_loader(corpus, use_native):
    prefix, _ = corpus
    ds = IndexedDataset(prefix, use_native=use_native)
    loader = NativePrefetchLoader(ds, batch_size=4, seq_len=32)
    seen = []
    for _ in range(6):
        b = next(loader)
        assert b.shape == (4, 32) and b.dtype == np.int32
        seen.append(b.copy())
    # shuffled order: successive batches differ
    assert not np.array_equal(seen[0], seen[1])
    # deterministic order: both paths produce the same schedule
    ds2 = IndexedDataset(prefix, use_native=False)
    loader2 = NativePrefetchLoader(ds2, batch_size=4, seq_len=32)
    for b in seen:
        np.testing.assert_array_equal(b, next(loader2))
    loader.close()
    loader2.close()
    ds.close()
    ds2.close()
    with pytest.raises(RuntimeError):
        next(loader)


@pytest.mark.parametrize("use_native", [True, False])
def test_close_while_blocked_in_next(corpus, use_native):
    """close() while a consumer is blocked in next() raises in the
    consumer, not a deadlock (the stop-aware wait and drain of
    ds_dataio.cpp; the numpy reader's _closed check)."""
    prefix, _ = corpus
    ds = IndexedDataset(prefix, use_native=use_native)
    loader = NativePrefetchLoader(ds, batch_size=4, seq_len=32)
    outcome = []

    def consumer():
        try:
            deadline = time.time() + 10
            while time.time() < deadline:
                next(loader)
            outcome.append("never stopped")
        except RuntimeError:
            outcome.append("raised")

    t = threading.Thread(target=consumer)
    t.start()
    time.sleep(0.2)
    ds.close()
    loader.close()
    t.join(timeout=10)
    assert not t.is_alive(), "consumer deadlocked after close()"
    assert outcome == ["raised"], outcome


def test_epoch_dependent_shuffle(corpus):
    """Each epoch is a bijection over the samples and consecutive epochs
    traverse different permutations (epoch-mixed affine map)."""
    prefix, _ = corpus
    ds = IndexedDataset(prefix, use_native=False)
    loader = NativePrefetchLoader(ds, batch_size=1, seq_len=32)
    n = loader.n_samples
    loader.close()
    loader.batch_size = n
    e0 = loader._indices(0)
    e1 = loader._indices(n)
    assert sorted(e0.tolist()) == list(range(n))
    assert sorted(e1.tolist()) == list(range(n))
    assert not np.array_equal(e0, e1)
    ds.close()


def test_native_numpy_shuffle_parity_across_epochs(corpus):
    """kMult in csrc/ds_dataio.cpp and the port's _SHUFFLE_MULTS stay in
    lockstep: both loaders through several epoch boundaries, batch for
    batch."""
    prefix, _ = corpus
    nat_ds = IndexedDataset(prefix, use_native=True)
    np_ds = IndexedDataset(prefix, use_native=False)
    nat = NativePrefetchLoader(nat_ds, batch_size=4, seq_len=32)
    ref = NativePrefetchLoader(np_ds, batch_size=4, seq_len=32)
    n = nat.n_samples
    for i in range((3 * n) // 4 + 2):
        np.testing.assert_array_equal(
            next(nat), next(ref),
            err_msg="native/numpy order diverged at batch {} "
                    "(~epoch {})".format(i, (i * 4) // n))
    nat.close()
    ref.close()
    nat_ds.close()
    np_ds.close()


# ------------------------------------------------- against the JAX reader


def test_format_constants_match_jax():
    from deepspeed_tpu.runtime.data import indexed_dataset as jid
    np.testing.assert_array_equal(tid._SHUFFLE_MULTS, jid._SHUFFLE_MULTS)
    assert (tid._MAGIC, tid._VERSION) == (jid._MAGIC, jid._VERSION)
    assert tid._DTYPE_CODES == jid._DTYPE_CODES
    assert tid._CODE_DTYPES == jid._CODE_DTYPES
    source = dataio.SOURCE.read_text()
    for mult in tid._SHUFFLE_MULTS.tolist():
        assert str(mult) in source


@pytest.mark.parametrize("dtype", [np.int32, np.uint16])
def test_files_written_by_either_package_match(tmp_path, dtype):
    rng = np.random.RandomState(3)
    docs = [rng.randint(0, 60000, size=rng.randint(1, 90)).astype(dtype)
            for _ in range(11)]
    paths = []
    for name, builder in (("port", IndexedDatasetBuilder),
                          ("jax", JaxBuilder)):
        b = builder(str(tmp_path / name), dtype=dtype)
        for d in docs:
            b.add_doc(d)
        paths.append(b.finalize())
    for ext in (".bin", ".idx"):
        assert (tmp_path / ("port" + ext)).read_bytes() == \
            (tmp_path / ("jax" + ext)).read_bytes()


@pytest.mark.parametrize("use_native", [True, False])
def test_readers_match_the_jax_reader(corpus, use_native):
    """Documents, windows, and the loader's shuffled order over three
    epochs, against the JAX reader on the same files."""
    prefix, docs = corpus
    port = IndexedDataset(prefix, use_native=use_native)
    ref = JaxDataset(prefix, use_native=False)
    assert (len(port), port.num_tokens) == (len(ref), ref.num_tokens)
    for i in range(len(docs)):
        np.testing.assert_array_equal(port[i], ref[i])
    idx = np.arange(port.num_samples(48))[::-1]
    np.testing.assert_array_equal(port.batch(idx, 48), ref.batch(idx, 48))
    loader = NativePrefetchLoader(port, batch_size=5, seq_len=32)
    jloader = JaxLoader(ref, batch_size=5, seq_len=32)
    assert loader.n_samples == jloader.n_samples
    for i in range((3 * loader.n_samples) // 5 + 2):
        np.testing.assert_array_equal(next(loader), next(jloader),
                                      err_msg="batch {}".format(i))
    loader.close()
    jloader.close()
    port.close()
    ref.close()


# ------------------------------------------------------- no quiet fallback


def test_failed_build_raises_with_the_compiler_output(tmp_path):
    bad = tmp_path / "broken_dataio.cpp"
    bad.write_text("extern \"C\" int ds_dataio_num_docs( {\n")
    with pytest.raises(host_build.HostBuildError, match="broken_dataio"):
        dataio.build(bad)
    with pytest.raises(host_build.HostBuildError, match="missing"):
        dataio.build(tmp_path / "absent.cpp")


def test_failed_open_raises(tmp_path, corpus):
    prefix, _ = corpus
    bad = str(tmp_path / "bad")
    with open(bad + ".idx", "wb") as f:
        f.write(b"NOTANIDX" + bytes(16))
    with open(bad + ".bin", "wb") as f:
        f.write(bytes(16))
    with pytest.raises(RuntimeError, match="ds_dataio_open failed"):
        IndexedDataset(bad, use_native=True)
    with pytest.raises(RuntimeError, match="ds_dataio_open failed"):
        IndexedDataset(str(tmp_path / "absent"), use_native=True)
    with pytest.raises(AssertionError, match="magic"):
        IndexedDataset(bad, use_native=False)


def test_openmp_only_where_the_compiler_links_it(tmp_path):
    """A compiler that refuses ``-fopenmp`` (a toolchain without libgomp)
    builds the same source without it; g++ here links it."""
    assert host_build.OPENMP_FLAG in host_build.flags(host_build.compiler())
    cxx = tmp_path / "cxx_without_openmp"
    cxx.write_text("#!/bin/sh\nfor a in \"$@\"; do [ \"$a\" = -fopenmp ] && "
                   "exit 1; done\nexec {} \"$@\"\n".format(
                       host_build.compiler()))
    cxx.chmod(0o755)
    assert host_build.flags(str(cxx)) == host_build.CXX_FLAGS


def test_build_is_reused(corpus):
    first = dataio.build()
    again = dataio.build()
    assert again.path == first.path and again.seconds == 0.0
    assert first.path.parent == host_build.BUILD_DIR
