"""Run chip_smoke.py with a callback that reports every slow gen-2 GC.

    python3 tools/gc_watch.py      # from the repository root, on the card

A Python gen-2 collection walks every tracked object, and chip_smoke.py's
heap (profiler events, the ledgers, the JSON record) reaches about a
million objects, so one collection can take most of a second.  When a
timed step reads slow while its device time does not move, this prints,
in line with chip_smoke.py's own output, every gen-2 collection longer
than 20 ms and how many objects it freed.
"""
import gc
import runpy
import sys
import time

t = {}


def cb(phase, info):
    if info["generation"] != 2:
        return
    if phase == "start":
        t["s"] = time.perf_counter()
    else:
        dt = time.perf_counter() - t["s"]
        if dt > 0.02:
            print(f"[gc] gen-2 collection {dt * 1e3:.0f} ms, "
                  f"collected {info['collected']}", flush=True)


if __name__ == "__main__":
    # guarded: a process chip_smoke.py spawns (the calibration's echo
    # child, the front end's workers) re-imports this file
    gc.callbacks.append(cb)
    sys.argv = ["chip_smoke.py"]
    runpy.run_path("chip_smoke.py", run_name="__main__")
