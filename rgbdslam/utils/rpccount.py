"""Host<->device round-trip accounting.

Every program dispatch and every blocking device->host fetch is a point
where the host waits on or feeds the device, so the SLAM hot paths keep a
strict dispatch/fetch budget. Call sites in tracking/system increment these
counters; the bench reports `rpcs_per_frame` and the host time blocked on
fetches.

Not thread-safe by design: the SLAM host orchestrator is single-writer.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np


@dataclasses.dataclass
class RpcCounter:
    dispatches: int = 0   # host -> device program launches
    fetches: int = 0      # device -> host array transfers
    fetch_s: float = 0.0  # wall seconds the host spent BLOCKED on fetches
    #                       (device compute + transfer latency;
    #                       wall - fetch_s bounds the host-side overhead)

    def reset(self) -> None:
        self.dispatches = 0
        self.fetches = 0
        self.fetch_s = 0.0

    @property
    def total(self) -> int:
        return self.dispatches + self.fetches

    def fetch(self, x) -> np.ndarray:
        """Fetch a device array to host, counting + timing the blocked wait."""
        t0 = time.perf_counter()
        out = np.asarray(x)
        self.fetches += 1
        self.fetch_s += time.perf_counter() - t0
        return out


# process-global counter; bench/CLI reset() it around timed regions
RPC = RpcCounter()
