"""``src/repro_torch/core`` is a copy of the SCISPACE core ``src/repro/core``.

Each copied file equals its reference once ``repro.core`` is read as
``repro_torch.core``, with one deliberate difference in code:
``ReplicaPump.start`` starts its thread before it publishes it under the
pump's lock, and ``stop`` takes it under the same lock, so a concurrent
``stop`` never joins a thread that was never started (the reference's race:
``RuntimeError: cannot join thread before it is started``).  Each thread
gets its own stop event, so a ``start`` that follows a ``stop`` at once
cannot revive the thread being stopped.  The last test drives that race.  Besides, four lines of the reference's docstrings and
comments name numbers from its own development history; the copy leaves
them out.  Both are written out below.
"""

import random
import re
import sys
import threading
import time
from pathlib import Path

import pytest

from repro_torch.core import Collaboration

ROOT = Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "src" / "repro" / "core", ROOT / "src" / "repro_torch" / "core"
NAMES = sorted(p.name for p in REF.glob("*.py"))

# the reference's ReplicaPump.start / stop, and the copy's
REF_START = '''        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name=f"replica-pump-dtn{self.dtn.dtn_id}", daemon=True
            )
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            if self._should_drain():
                self.drain()
            self._stop.wait(self.poll_s)
'''
PORT_START = '''        # the thread is started before it is published, under the lock that
        # stop() reads it under: a concurrent stop() never joins a thread
        # that has not started.  Each thread has its own stop event, so a
        # start() right after a stop() cannot revive the thread being stopped
        with self._lock:
            if self._thread is None:
                stop = threading.Event()
                thread = threading.Thread(
                    target=self._run, args=(stop,), name=f"replica-pump-dtn{self.dtn.dtn_id}", daemon=True
                )
                thread.start()
                self._thread, self._stop = thread, stop
        return self

    def _run(self, stop: threading.Event) -> None:
        while not stop.is_set():
            if self._should_drain():
                self.drain()
            stop.wait(self.poll_s)
'''
REF_STOP = '''        self._stop.set()
        if self._thread is not None:
            # a fault-plane crash can fire from inside this pump's own drain
            # (the Nth served call was one of ours) — joining ourselves would
            # deadlock, and the _stop flag already ends the loop on return
            if self._thread is not threading.current_thread():
                self._thread.join(timeout=10)
            self._thread = None
'''
PORT_STOP = '''        with self._lock:
            self._stop.set()
            thread, self._thread = self._thread, None
        if thread is not None:
            # a fault-plane crash can fire from inside this pump's own drain
            # (the Nth served call was one of ours) — joining ourselves would
            # deadlock, and the _stop flag already ends the loop on return
            if thread is not threading.current_thread():
                thread.join(timeout=10)
'''
# the lines where the reference names numbers from its own development history, by their line number
# in the reference, and the copy's text of each
HISTORY = {
    "leases.py": {3: "The problem: the fault plane made *reads* survive"},
    "plane.py": {410: "        #: partition-tolerant writes: mutations accepted while the",
                 624: "        The partition-tolerant write path: acquire the prefix's"},
    "workspace.py": {327: '        """Partition-tolerant write: accept the mutation at home.'},
}
ALLOWED = {"replication.py": [(REF_START, PORT_START), (REF_STOP, PORT_STOP)]}


def test_the_copy_has_every_file_and_no_other():
    assert len(NAMES) == 17
    assert sorted(p.name for p in PORT.glob("*.py")) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_copy_matches_the_reference(name):
    lines = (REF / name).read_text().replace("repro.core", "repro_torch.core").split("\n")
    for lineno, text in HISTORY.get(name, {}).items():
        assert re.search(r"\b[A-Z]+ \d+\b", lines[lineno - 1]), f"{name}:{lineno} names no number of its history"
        lines[lineno - 1] = text
    expected = "\n".join(lines)
    for ref_text, port_text in ALLOWED.get(name, []):
        assert expected.count(ref_text) == 1, f"{name}: the reference's text of the allowed difference moved"
        expected = expected.replace(ref_text, port_text)
    assert (PORT / name).read_text() == expected


def test_pump_start_and_stop_race_without_error():
    """start() and stop() from two threads, a few hundred times: no RuntimeError, no stop() waits out its
    join, the last stop holds, and no pump thread outlives the collaboration."""
    def pump_threads():
        return {t for t in threading.enumerate() if t.name.startswith("replica-pump-dtn")}

    before = pump_threads()
    collab = Collaboration()
    collab.add_datacenter("dc0", n_dtns=2)
    collab.start_replication(poll_s=0.001)
    pump = collab.dtns[0].replica_pump
    # each pass of the pump's loop takes a moment, as a drain does: a stop() then often lands while the
    # thread is inside its loop, not in its wait, and a start() can follow before the thread looks again
    should_drain = pump._should_drain
    pump._should_drain = lambda: time.sleep(0.002) or should_drain()
    errors, stop_s = [], []
    rng = random.Random(0)

    def call(fn):
        def body():
            try:
                fn()
            except Exception as exc:  # every failure of either side is what the test looks for
                errors.append(repr(exc))
        return threading.Thread(target=body)

    def timed_stop():
        t0 = time.perf_counter()
        pump.stop(drain=False)
        stop_s.append(time.perf_counter() - t0)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(300):
            workers = [call(pump.start), call(timed_stop)]
            rng.shuffle(workers)  # a stop() just before a start() finds the pump running half the time
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=20)
            assert not any(w.is_alive() for w in workers)
            if max(stop_s, default=0.0) >= 5.0:
                break
        pump.stop(drain=False)
    finally:
        sys.setswitchinterval(interval)
        collab.close()
    assert errors == []
    assert pump._thread is None
    # a stop() whose thread was revived waits out its 10 s join; a healthy one returns in milliseconds
    assert max(stop_s) < 5.0
    assert pump_threads() - before == set()
