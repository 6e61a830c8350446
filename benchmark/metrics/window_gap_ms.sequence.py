"""Device-idle ms a window inside the program's ``generate/window`` span (a window of a sequence: its seed poses, its call, its poses to the host); the host ms a window of each part goes to stderr."""

import sys

from benchmark.common import spans

PARTS = ("generate/sample", "generate/to_host")


def read(rec):
    windows = spans.intervals(rec, "generate/window")
    if not windows:
        return None
    n = len(windows)
    parts = ", ".join(f"{p} {1e3 * spans.self_s(rec, p, ()) / n!r} "
                      f"({len(spans.intervals(rec, p))} spans)" for p in PARTS)
    own = spans.self_s(rec, "generate/window", PARTS)
    print(f"generate/window, host ms a window over {n} windows "
          f"({rec['work'].get('windows')} in the traffic): {parts}, the "
          f"window's own {1e3 * own / n!r}", file=sys.stderr)
    return 1e3 * spans.idle_s(rec, windows) / n
