"""Pinned staging for row patches: the host packs a patch's rows straight into
one buffer and the card gets them in one copy.

A `StagingRing` holds a few host buffers (pinned where the device is a
card), handed out in turn. `take(n)` gives the next buffer as a numpy
uint8 array to pack into; `upload(n)` copies its first n bytes to the
device with one non-blocking copy on the current stream and records an
event after it. The copy reads the buffer after the host has gone on, so
the host never writes a buffer again until that event has completed:
`take` waits on the event of the buffer's last upload first (the event
alone, never the whole device). With the card keeping pace the event has
long completed and `take` does not wait; behind a long kernel it does.

On the CPU there is no copy to wait for: `upload` returns a copy of the
bytes, and no event is recorded.

A `Fetch` is the other direction: one non-blocking copy of a device tensor
into pinned host memory, read only after the copy's event has completed.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

MIN_BYTES = 4096  # a buffer's least size; a buffer grows in powers of two
SLOTS = 4         # buffers a ring holds


def _cuda_event(device: torch.device, ev=None):
    """`ev` (a new event where None) recorded on the current stream of
    `device`."""
    ev = ev or torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


class StagingRing:
    """SLOTS host buffers for the uploads of one device, reused in turn,
    each written again only after the copy that read it last. `record(device,
    spent)` records the event of an upload, reusing `spent` (the buffer's
    last event, completed, or None) where it can (default: a CUDA event on
    the device's current stream; none on the CPU); an event has `query()`
    and `synchronize()`."""

    def __init__(self, device,
                 record: Optional[Callable[[torch.device, object], object]] = None):
        self.device = torch.device(device)
        self.pinned = self.device.type == "cuda"
        self._record = record or (_cuda_event if self.pinned else None)
        self._bufs: List[Optional[torch.Tensor]] = [None] * SLOTS
        self._events: List[object] = [None] * SLOTS   # pending: the last upload's
        self._spent: List[object] = [None] * SLOTS    # completed, to record again
        self._next = 0
        self.uploads = 0   # copies made
        self.waits = 0     # takes whose buffer's copy had not completed yet

    def take(self, nbytes: int) -> np.ndarray:
        """The next buffer's first `nbytes` bytes to pack into, once the copy
        that last read it has completed."""
        i = self._next
        ev, self._events[i] = self._events[i], None
        if ev is not None:
            if not ev.query():
                self.waits += 1
                ev.synchronize()
            self._spent[i] = ev
        buf = self._bufs[i]
        if buf is None or buf.numel() < nbytes:
            size = MIN_BYTES
            while size < nbytes:
                size *= 2
            buf = torch.empty(size, dtype=torch.uint8, pin_memory=self.pinned)
            self._bufs[i] = buf
        return buf.numpy()[:nbytes]

    def upload(self, nbytes: int) -> torch.Tensor:
        """The first `nbytes` bytes of the buffer `take` gave out, on the
        device: one copy, with the event the buffer's next `take` waits
        on. The ring moves on to its next buffer."""
        i = self._next
        self._next = (i + 1) % len(self._bufs)
        host = self._bufs[i][:nbytes]
        self.uploads += 1
        if self.device.type == "cpu":
            out = host.clone()
        else:
            out = torch.empty(nbytes, dtype=torch.uint8, device=self.device)
            out.copy_(host, non_blocking=True)
        if self._record is not None:
            self._events[i] = self._record(self.device, self._spent[i])
        return out


class Fetch:
    """A device tensor on its way to the host: one non-blocking copy into a
    new pinned buffer, on the current stream after the work that produced
    the tensor, with an event after it. `wait()` waits on that event alone
    and returns the host array; on the CPU the tensor is read as it is."""

    def __init__(self, value: torch.Tensor):
        if value.device.type == "cuda":
            self._host = torch.empty(value.shape, dtype=value.dtype, pin_memory=True)
            with torch.cuda.device(value.device):
                self._host.copy_(value, non_blocking=True)
                self._event = torch.cuda.Event()
                self._event.record()
        else:
            self._host = value
            self._event = None

    def wait(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()
