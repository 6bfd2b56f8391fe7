"""What every traffic driver shares: the pool on the host, files held in
memory, and the record of failed segments."""
from __future__ import annotations

import os
import sys
import traceback


class Driver:
    """A driver is made once per run with the cell's context (``ctx``: the
    program's ``CodecConfig`` as ``ctx.cfg``, the pool as ``ctx.pool``, the
    device as ``ctx.device``).  ``setup`` does what the traffic needs before any segment,
    ``segment(slot, keep, spans)`` runs one segment of the pool slot through
    the program's entry points and returns {"frames", "counters",
    "outputs"} (``outputs`` only where ``keep``), and ``frame_info(slot)``
    the segment's frame types and split counts, for the kernels' counts."""

    kind = ""

    def __init__(self, ctx):
        self.ctx = ctx
        self.failures: list[str] = []
        self._fds: list[int] = []

    def setup(self) -> None:
        pass

    def memory_file(self, name: str) -> str:
        """A path the program can open, write, reopen and read like a file
        on disk, held in memory (``memfd_create``): a run writes its
        containers, some GB of them, to no disk.  It lives until ``close``."""
        fd = os.memfd_create(f"portbench-{name}")
        self._fds.append(fd)
        return f"/proc/self/fd/{fd}"

    def close(self) -> None:
        for fd in self._fds:
            os.close(fd)
        self._fds.clear()

    def note_failure(self, slot: int, exc: BaseException) -> None:
        if not self.failures:  # the first failure's traceback goes to standard error
            traceback.print_exception(exc, file=sys.stderr)
        self.failures.append(f"slot {slot}: {type(exc).__name__}: {exc}")
