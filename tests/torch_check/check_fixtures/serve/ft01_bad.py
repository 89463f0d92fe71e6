"""FT01 bad fixture: direct wall-clock reads in a serve/-scoped module.

Every timestamp here bypasses clock injection, so heartbeat timeouts and
failover decisions in a test replay would depend on real elapsed time."""
import time


class Watchdog:
    def __init__(self, timeout_s):
        self.timeout_s = timeout_s
        self.last_beat = time.monotonic()

    def beat(self):
        self.last_beat = time.time()

    def expired(self):
        return time.perf_counter() - self.last_beat > self.timeout_s
