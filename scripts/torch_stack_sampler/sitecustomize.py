"""A stack sampler for any Python command, its spawned children included.

    PYTHONPATH=scripts/torch_stack_sampler CHIP_PROF_DIR=results/prof \
        python3 chip_smoke.py --out results/run

With ``CHIP_PROF_DIR`` set, every Python process started with this
directory on ``PYTHONPATH`` (children inherit it) samples its main
thread's stack every 0.25 s and writes ``<pid>.json`` there every 10 s
and at exit: its ``argv``, start and end (epoch seconds) and the sample
counts keyed by ``"<chip_smoke.py frames, outermost first> @
<file>:<function>:<line> of the innermost frame"``.  A count times 0.25
is seconds.  A thread that holds the GIL inside a C call (a launch into a
full CUDA queue, a blocking copy) stops the sampler too, so such time is
missing, not misplaced: compare the samples with the process's wall
time.  Without ``CHIP_PROF_DIR`` the module does nothing.
"""
import atexit
import collections
import json
import os
import sys
import threading
import time

PERIOD_S = 0.25
FLUSH_S = 10.0

_dir = os.environ.get("CHIP_PROF_DIR")
if _dir:
    os.makedirs(_dir, exist_ok=True)
    _main = threading.main_thread().ident
    _counts: collections.Counter = collections.Counter()
    _path = os.path.join(_dir, f"{os.getpid()}.json")
    _start = time.time()

    def _flush() -> None:
        with open(_path, "w") as f:
            json.dump({"argv": sys.argv, "start": _start, "end": time.time(),
                       "period": PERIOD_S,
                       "counts": [[k, v] for k, v in _counts.items()]}, f)

    def _key(frame) -> str:
        code = frame.f_code
        inner = (f"{os.path.basename(code.co_filename)}:{code.co_name}:"
                 f"{frame.f_lineno}")
        chain = []
        while frame is not None:
            if frame.f_code.co_filename.endswith("chip_smoke.py"):
                chain.append(f"{frame.f_code.co_name}:{frame.f_lineno}")
            frame = frame.f_back
        return "|".join(reversed(chain)) + " @ " + inner

    def _sample() -> None:
        last = time.time()
        while True:
            time.sleep(PERIOD_S)
            frame = sys._current_frames().get(_main)
            if frame is not None:
                _counts[_key(frame)] += 1
            if time.time() - last > FLUSH_S:
                _flush()
                last = time.time()

    threading.Thread(target=_sample, daemon=True).start()
    atexit.register(_flush)
