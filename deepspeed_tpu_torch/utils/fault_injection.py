"""Deterministic fault injection for the checkpoint IO path.

``inject_faults(...)`` installs a :class:`FaultInjector` into
``runtime/checkpointing.py``'s hook point for the duration of a ``with``
block. Every fault is counter-based (no randomness), so a test that
kills the writer "after 2 files" kills it after exactly 2 files on every
run. Three fault families cover the failure modes a preempted TPU pod
job actually sees:

* **transient write/read failures** (``fail_substr`` / ``fail_reads``):
  raise ``OSError`` for the first ``n_failures`` attempts on matching
  paths — exercises the retry-with-backoff path;
* **kill-after-K-files** (``kill_after_files``): raise
  :class:`SimulatedKill` once K files of the save have fully landed —
  models preemption between the files of a multi-file tag.
  ``SimulatedKill`` derives from ``BaseException`` so no retry wrapper
  or ``except Exception`` can swallow it, exactly like a real SIGKILL;
* **kill-after-K-reads** (``kill_after_reads``): the restore-side
  twin — raise :class:`SimulatedKill` once K files of a LOAD have been
  read, modelling preemption mid-restore (an elastic rescale killed
  while re-loading). The on-disk tag is untouched by a read, so the
  engine must be able to fall back to the same or a prior tag
  afterwards;
* **post-hoc corruption** (``corrupt_substr`` + ``corrupt_mode``):
  silently truncate or bit-flip a file AFTER it was written and
  renamed into place — models storage bit-rot that only checksum
  verification can catch.
"""
import os


class SimulatedKill(BaseException):
    """Injected preemption. BaseException on purpose: a real kill cannot
    be caught by retry loops or ``except Exception`` cleanup."""


class FaultInjector:
    """Counter-based fault plan; see module docstring. All matching is
    substring-on-basename so tests name files ("model_states", "optim",
    "manifest") without caring about tmp dirs."""

    def __init__(self, kill_after_files=None, fail_substr=None,
                 n_failures=0, fail_reads=False, corrupt_substr=None,
                 corrupt_mode="flip", kill_after_reads=None):
        self.kill_after_files = kill_after_files
        self.kill_after_reads = kill_after_reads
        self.fail_substr = fail_substr
        self.n_failures = n_failures
        self.fail_reads = fail_reads
        self.corrupt_substr = corrupt_substr
        if corrupt_mode not in ("flip", "truncate"):
            raise ValueError("corrupt_mode must be 'flip' or 'truncate'")
        self.corrupt_mode = corrupt_mode
        # observable log: (event, path) tuples in order
        self.events = []
        self.files_written = 0
        self.files_read = 0
        self._failures_left = int(n_failures)

    # ---- hooks called from runtime/checkpointing.py -------------------
    def before_write(self, path):
        if self.kill_after_files is not None and \
                self.files_written >= self.kill_after_files:
            self.events.append(("kill", path))
            raise SimulatedKill(
                "injected kill after {} complete files (next: {})".format(
                    self.files_written, path))
        if self.fail_substr is not None and \
                self.fail_substr in os.path.basename(path) and \
                self._failures_left > 0:
            self._failures_left -= 1
            self.events.append(("write_fail", path))
            raise OSError("injected transient write failure: " + path)

    def after_write(self, path):
        self.files_written += 1
        self.events.append(("written", path))
        if self.corrupt_substr is not None and \
                self.corrupt_substr in os.path.basename(path):
            self._corrupt(path)

    def before_read(self, path):
        if self.kill_after_reads is not None and \
                self.files_read >= self.kill_after_reads:
            self.events.append(("kill_read", path))
            raise SimulatedKill(
                "injected kill after {} files read (next: {})".format(
                    self.files_read, path))
        if self.fail_reads and self.fail_substr is not None and \
                self.fail_substr in os.path.basename(path) and \
                self._failures_left > 0:
            self._failures_left -= 1
            self.events.append(("read_fail", path))
            raise OSError("injected transient read failure: " + path)
        self.files_read += 1

    # ---- corruption ---------------------------------------------------
    def _corrupt(self, path):
        size = os.path.getsize(path)
        if size == 0:
            return
        with open(path, "r+b") as f:
            if self.corrupt_mode == "truncate":
                f.truncate(size // 2)
                self.events.append(("truncated", path))
            else:
                f.seek(size // 2)
                byte = f.read(1)
                f.seek(size // 2)
                f.write(bytes([byte[0] ^ 0xFF]))
                self.events.append(("flipped", path))


class inject_faults:
    """Context manager installing a FaultInjector into the checkpoint IO
    layer. Yields the injector so tests can inspect ``.events``."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs
        self.injector = None

    def __enter__(self):
        from ..runtime import checkpointing as ckpt
        self.injector = FaultInjector(**self._kwargs)
        self._prev = ckpt._FAULT_INJECTOR
        ckpt._FAULT_INJECTOR = self.injector
        return self.injector

    def __exit__(self, *exc):
        from ..runtime import checkpointing as ckpt
        ckpt._FAULT_INJECTOR = self._prev
        return False
