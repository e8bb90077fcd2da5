"""Indexed token datasets with a native (C++) reader + prefetch loader.

Port of ``deepspeed_tpu/runtime/data/indexed_dataset.py``: the same
file format, document and window reads, and epoch-mixed affine shuffle,
so the two packages read one corpus identically. The input pipeline is a
host-side concern: a producer thread gathers the next batch from the
mmap'd file through the repo's ``csrc/ds_dataio.cpp`` (OpenMP gather,
double-buffered ring; built by ``ops/dataio.py``) while the device
computes. ``use_native=False`` selects the numpy reader, which keeps the
same order with a Python producer thread. No quiet fallback: with
``use_native=True`` a failed build or a failed open raises (the JAX
reader warns and reads with numpy instead).

Format:
  <prefix>.bin  raw little-endian tokens (int32 or uint16)
  <prefix>.idx  "DSTPUIDX" magic, u32 version, u32 dtype code (4=int32,
                2=uint16), u64 n_docs, (n_docs+1) u64 token offsets
"""
import struct
import threading

import numpy as np

# per-epoch shuffle multipliers; all prime and >= 2654435761 (the enforced
# n_samples bound) so each is coprime with n_samples. Mirrors kMult[] in
# csrc/ds_dataio.cpp — keep both tables identical.
_SHUFFLE_MULTS = np.array(
    [2654435761, 2754435769, 2854435811, 2954435791,
     3054435863, 3154435859, 3254435857, 3354435823,
     3454435837, 3554435839, 3654435857, 3754435859,
     3854435863, 3954435869, 4054435873, 4154435867], dtype=np.uint64)

_MAGIC = b"DSTPUIDX"
_VERSION = 1
_DTYPE_CODES = {np.dtype(np.int32): 4, np.dtype(np.uint16): 2}
_CODE_DTYPES = {4: np.int32, 2: np.uint16}


class IndexedDatasetBuilder:
    """Stream documents (1-D token arrays) into a .bin/.idx pair."""

    def __init__(self, prefix, dtype=np.int32):
        self.prefix = prefix
        self.dtype = np.dtype(dtype)
        assert self.dtype in _DTYPE_CODES, self.dtype
        self._bin = open(prefix + ".bin", "wb")
        self._offsets = [0]

    def add_doc(self, tokens):
        arr = np.ascontiguousarray(tokens, dtype=self.dtype)
        assert arr.ndim == 1
        self._bin.write(arr.tobytes())
        self._offsets.append(self._offsets[-1] + arr.size)

    def finalize(self):
        self._bin.close()
        with open(self.prefix + ".idx", "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<II", _VERSION, _DTYPE_CODES[self.dtype]))
            f.write(struct.pack("<Q", len(self._offsets) - 1))
            f.write(np.asarray(self._offsets, dtype=np.uint64).tobytes())
        return self.prefix


def _load_native():
    """The bound ``ds_dataio`` library; raises when it cannot build or
    load."""
    from ...ops import dataio
    return dataio.load()


class IndexedDataset:
    """Read side. Documents by index, or fixed seq-length windows over the
    concatenated token stream (GPT-2 pretraining convention).
    ``use_native`` reads through the C++ op (raising when it cannot), or
    with numpy when False."""

    def __init__(self, prefix, use_native=True):
        self.prefix = prefix
        self._lib = _load_native() if use_native else None
        self._handle = None
        # close() handshake: native calls register in-flight so close()
        # can quiesce them (via ds_dataio_stop) before freeing the handle
        self._io_cond = threading.Condition()
        self._inflight = 0
        self._closing = False
        idx_path = (prefix + ".idx").encode()
        bin_path = (prefix + ".bin").encode()
        if self._lib is not None:
            self._handle = self._lib.ds_dataio_open(idx_path, bin_path)
            if not self._handle:
                raise RuntimeError(
                    "ds_dataio_open failed for {!r} (missing files, a bad "
                    ".idx header, or a .bin shorter than its index); "
                    "use_native=False reads with numpy".format(prefix))
        self._was_native = self._lib is not None
        if self._lib is None:
            self._np_open()
        else:
            self.num_docs = int(self._lib.ds_dataio_num_docs(self._handle))
            self.num_tokens = int(
                self._lib.ds_dataio_num_tokens(self._handle))

    def _np_open(self):
        with open(self.prefix + ".idx", "rb") as f:
            assert f.read(8) == _MAGIC, "bad idx magic"
            version, code = struct.unpack("<II", f.read(8))
            assert version == _VERSION, \
                "idx version {} != supported {}".format(version, _VERSION)
            (n_docs,) = struct.unpack("<Q", f.read(8))
            self._offsets = np.frombuffer(f.read(8 * (n_docs + 1)),
                                          dtype=np.uint64)
        self._tokens = np.memmap(self.prefix + ".bin", mode="r",
                                 dtype=_CODE_DTYPES[code])
        self.num_docs = int(n_docs)
        self.num_tokens = int(self._offsets[-1])

    # -- close()-safe native-call guard ------------------------------------
    def _enter_io(self):
        """Register a native call in flight; returns (lib, handle), or
        None for numpy-backed readers. Raises once close() has begun so a
        racing reader can never touch a freed handle. Callers MUST pair a
        non-None return with _exit_io() in a finally block."""
        with self._io_cond:
            if self._closing or (self._was_native and self._lib is None):
                raise RuntimeError("IndexedDataset is closed")
            if self._lib is None:
                return None
            self._inflight += 1
            return self._lib, self._handle

    def _exit_io(self):
        with self._io_cond:
            self._inflight -= 1
            self._io_cond.notify_all()

    # -- documents ---------------------------------------------------------
    def doc(self, i):
        io = self._enter_io()
        if io is not None:
            lib, handle = io
            try:
                n = int(lib.ds_dataio_doc_len(handle, i))
                out = np.empty(n, dtype=np.int32)
                got = lib.ds_dataio_get_doc(handle, i, out.ctypes.data, n)
                return out[:got]
            finally:
                self._exit_io()
        s, e = int(self._offsets[i]), int(self._offsets[i + 1])
        return np.asarray(self._tokens[s:e], dtype=np.int32)

    def __len__(self):
        return self.num_docs

    def __getitem__(self, i):
        return self.doc(i)

    # -- fixed-window samples ---------------------------------------------
    def num_samples(self, seq_len):
        return self.num_tokens // seq_len

    def batch(self, sample_idx, seq_len):
        """Gather (len(sample_idx), seq_len) int32 windows."""
        idx = np.ascontiguousarray(sample_idx, dtype=np.int64)
        out = np.empty((idx.size, seq_len), dtype=np.int32)
        io = self._enter_io()
        if io is not None:
            lib, handle = io
            try:
                lib.ds_dataio_batch(handle, idx.ctypes.data,
                                    idx.size, seq_len, out.ctypes.data)
                return out
            finally:
                self._exit_io()
        for r, s in enumerate(idx):
            start = int(s) * seq_len
            chunk = np.asarray(self._tokens[start:start + seq_len],
                               dtype=np.int32)
            out[r, :chunk.size] = chunk
            out[r, chunk.size:] = 0
        return out

    def close(self):
        """Two-phase close: ds_dataio_stop wakes any reader blocked inside
        a native call (prefetch next returns -1), then we wait for the
        in-flight count to drain before ds_dataio_close frees the C++
        Dataset — no reader can touch a freed handle."""
        with self._io_cond:
            if self._closing:
                return
            self._closing = True
            lib, handle = self._lib, self._handle
        if lib is not None and handle:
            lib.ds_dataio_stop(handle)
            with self._io_cond:
                while self._inflight > 0:
                    self._io_cond.wait(timeout=10)
            lib.ds_dataio_close(handle)
            with self._io_cond:
                self._handle = None
                self._lib = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass


class NativePrefetchLoader:
    """Infinite (batch, seq) int32 batches, produced ahead of consumption.

    Native path: the C++ producer thread fills a double-buffered ring
    (csrc/ds_dataio.cpp) while the previous batch feeds the device —
    the role DataLoader worker processes play in the reference
    (runtime/dataloader.py), without pickling/IPC. The numpy reader uses
    a Python thread with the same epoch-mixed affine shuffled order
    (see _indices)."""

    def __init__(self, dataset, batch_size, seq_len):
        self.ds = dataset
        self.batch_size = int(batch_size)
        self.seq_len = int(seq_len)
        self.n_samples = dataset.num_samples(seq_len)
        assert self.n_samples > 0, "dataset smaller than one sample"
        # bijection precondition of the affine shuffle (multiplier coprime
        # with n_samples, no 2^64 wrap); the native side enforces the same
        if self.n_samples >= 2654435761:
            raise ValueError(
                "dataset has {} seq-{} samples; the shuffle supports fewer "
                "than 2654435761 — use a longer seq_len or shard the "
                "corpus".format(self.n_samples, seq_len))
        self._native = dataset._lib is not None
        self._closed = False
        if self._native:
            lib, handle = dataset._enter_io()
            try:
                rc = lib.ds_dataio_start_prefetch(
                    handle, self.batch_size, self.seq_len)
            finally:
                dataset._exit_io()
            assert rc == 0, "prefetch start failed: {}".format(rc)
        else:
            self._cursor = 0
            self._buf = None
            self._cond = threading.Condition()
            self._thread = threading.Thread(target=self._produce,
                                            daemon=True)
            self._thread.start()

    def _indices(self, cursor):
        # uint64 throughout: the C++ producer uses uint64, and int64 would
        # silently overflow (and diverge from it) past ~3.5e9 samples.
        # Epoch-varying affine shuffle: every multiplier is a prime >= the
        # enforced n_samples bound (2654435761), hence coprime with
        # n_samples -> each epoch's map is a bijection, and j*mult stays
        # below 2^64; the additive term is reduced mod n BEFORE the sum (a
        # wrap of the sum would break the bijection). Varying the
        # MULTIPLIER per epoch changes the successor structure — a
        # constant-only mix would merely rotate one fixed cyclic order.
        # MUST stay in lockstep with fill_slot() in csrc/ds_dataio.cpp.
        n = np.uint64(self.n_samples)
        pos = (np.uint64(cursor)
               + np.arange(self.batch_size, dtype=np.uint64))
        j = pos % n
        epoch = pos // n
        c = (np.uint64(12345)
             + epoch * np.uint64(0x9E3779B97F4A7C15)) % n
        mult = _SHUFFLE_MULTS[(epoch % np.uint64(16)).astype(np.int64)]
        return ((j * mult % n + c) % n).astype(np.int64)

    def _produce(self):
        try:
            while not self._closed:
                batch = self.ds.batch(self._indices(self._cursor),
                                      self.seq_len)
                self._cursor += self.batch_size
                with self._cond:
                    while self._buf is not None and not self._closed:
                        self._cond.wait()
                    if self._closed:
                        return
                    self._buf = batch
                    self._cond.notify_all()
        except RuntimeError:
            # dataset closed underneath us (ds.batch raises once
            # IndexedDataset.close() begins): mark the loader closed and
            # wake consumers so a blocked __next__ raises instead of
            # waiting forever on a producer that no longer exists
            with self._cond:
                self._closed = True
                self._cond.notify_all()

    def close(self):
        """Stop producing. The native producer thread is owned by the
        dataset and stops in IndexedDataset.close(); the numpy thread
        stops here. next() after close raises."""
        if self._closed:
            return
        self._closed = True
        if not self._native:
            with self._cond:
                self._cond.notify_all()
            self._thread.join(timeout=5)

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed or (self._native and self.ds._lib is None):
            raise RuntimeError("NativePrefetchLoader is closed (or its "
                               "dataset was closed underneath it)")
        if self._native:
            out = np.empty((self.batch_size, self.seq_len), dtype=np.int32)
            lib, handle = self.ds._enter_io()   # raises once close() began
            try:
                rc = lib.ds_dataio_next(handle, out.ctypes.data)
            finally:
                self.ds._exit_io()
            if rc != 0:
                # producer stopped (dataset closed underneath us): out was
                # never written — surfacing it would feed garbage token ids
                raise RuntimeError(
                    "NativePrefetchLoader: dataset closed while waiting "
                    "for the next batch (rc={})".format(rc))
            return out
        with self._cond:
            while self._buf is None:
                if self._closed:
                    # mirror the native path: close() while blocked here
                    # must raise, not hang (the producer thread is gone)
                    raise RuntimeError(
                        "NativePrefetchLoader: dataset closed while "
                        "waiting for the next batch")
                self._cond.wait()
            out, self._buf = self._buf, None
            self._cond.notify_all()
        return out
