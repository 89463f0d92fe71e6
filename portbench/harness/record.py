"""What a run hands the metric readers (``metrics/<name>.py``).

Every reader takes one ``Record`` and returns a number, or None where it
finds nothing to read (the harness then leaves the metric out).  Fields:

* ``kind``: ``serve`` or ``train``; ``cell``, ``model``: the cell and its
  configuration file; ``setup_s``: process start to the window's start.
* ``window``: (start, end) on the host's clock of the untraced part (the
  whole window when untraced).
* Serving: ``records`` (``serve.Due``: each one-shot request and each
  session turn, when due and its token times), ``token_times`` (every
  generated token), ``lateness`` ((due, released) of every release),
  ``step_walls`` ((end, seconds) of every ``LLM.step``), ``stats0`` /
  ``stats1``: the engine's ``stats()`` at the window's start and end.
* Training: ``steps``: (start, end, tokens) of every timed step.
* Traced runs: ``spans`` (``trace.Spans``) over ``spans_wall`` seconds,
  and ``device`` (``trace.DeviceSlice``, or None when three profiles saw
  no device activity: the device metrics then read nothing).
"""

from __future__ import annotations


class Record:
    def __init__(self, **kw):
        self.spans = None
        self.spans_wall = 0.0
        self.device = None
        self.records = []
        self.token_times = []
        self.lateness = []
        self.step_walls = []
        self.steps = []
        self.stats0 = {}
        self.stats1 = {}
        self.window = (0.0, 0.0)
        self.attempted = 0
        self.failed = 0
        self.memory_peak_bytes = 0
        self.__dict__.update(kw)

    def in_window(self, t: float) -> bool:
        return self.window[0] <= t <= self.window[1]
