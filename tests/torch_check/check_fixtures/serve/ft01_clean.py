"""FT01 clean fixture: the clock arrives by injection.

The default parameter value is a *reference* to ``time.monotonic`` (never
a call), and every read goes through the injected parameter — tests can
substitute a step-counter clock and replay failure timelines exactly."""
import time


class Watchdog:
    def __init__(self, timeout_s, clock=time.monotonic):
        self.timeout_s = timeout_s
        self.clock = clock
        self.last_beat = clock()

    def beat(self):
        self.last_beat = self.clock()

    def expired(self):
        return self.clock() - self.last_beat > self.timeout_s
