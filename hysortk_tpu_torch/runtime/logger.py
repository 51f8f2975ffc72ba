"""Buffered logging in the reference's layout.

The port of hysortk_tpu/runtime/logger.py (reference Logger,
include/logger.hpp:12-30, src/logger.cpp:109-160), which buffers per-rank
messages and gathers them to the root: inside a torch.distributed group of
more than one rank `flush` gathers every rank's buffer (one
all_gather_object) and rank 0 prints them in rank order; otherwise it
prints the local buffer. `root` prints on rank 0 only.
"""

from __future__ import annotations

import io
import sys

import torch.distributed as dist


class Logger:
    """Buffered logger with a labelled flush."""

    def __init__(self, stream=None, rank: int = 0):
        self._buf = io.StringIO()
        self._stream = stream or sys.stdout
        self._rank = rank

    def log(self, msg: str) -> None:
        """Buffer a message for the next flush (reference Logger::operator())."""
        self._buf.write(msg)
        self._buf.write("\n")

    def root(self, msg: str) -> None:
        """Print immediately on rank 0 (reference flush_root)."""
        if self._rank == 0:
            print(msg, file=self._stream)

    def flush(self, label: str = "") -> None:
        """Print the buffered messages, labelled by process (reference
        Logger::flush, src/logger.cpp:109-160)."""
        mine = self._buf.getvalue()
        self._buf = io.StringIO()
        if not (dist.is_available() and dist.is_initialized()
                and dist.get_world_size() > 1):
            if label:
                print(f"## {label}", file=self._stream)
            if mine:
                print(f"[proc {self._rank}] {mine}", end="", file=self._stream)
            return
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        if dist.get_rank() == 0:
            if label:
                print(f"## {label}", file=self._stream)
            for p, text in enumerate(every):
                for line in text.splitlines():
                    print(f"[proc {p}] {line}", file=self._stream)
