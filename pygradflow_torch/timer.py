"""Wall-clock timer (reference ``pygradflow/timer.py``)."""

import time


class Timer:
    def __init__(self, time_limit: float) -> None:
        self.time_limit = time_limit
        self.start = time.time()

    def elapsed(self) -> float:
        return time.time() - self.start

    def remaining(self) -> float:
        return self.time_limit - self.elapsed()

    def reached_time_limit(self) -> bool:
        return self.remaining() <= 0.0
