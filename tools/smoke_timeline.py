#!/usr/bin/env python3
"""Where ``chip_smoke.py``'s wall goes, line by line, on one CUDA card: the
script run as it is, with each line it prints stamped with the seconds
since the start, so the gap before a line is the time of the work that
line reports.

    python3 tools/smoke_timeline.py [--through-14] > timeline.log

``--through-14`` stops after phase 14 (phases 15, 16 and 17 are skipped;
their walls print as 0), for a quicker look at the phases before them.
The stamps make the script's JSON lines unreadable to a parser, so this
is a tool for finding the slow parts, not a check.
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402


def main() -> int:
    t0 = time.perf_counter()
    say = chip_smoke.say

    def stamped(*args) -> None:
        say(f"[{time.perf_counter() - t0:8.2f}]", *args)

    chip_smoke.say = stamped
    if "--through-14" in sys.argv[1:]:
        chip_smoke.phase_service = lambda *args: None
        chip_smoke.phase_sparse_ipm = lambda *args: []
        chip_smoke.phase_families = lambda *args: None
    return chip_smoke.main()


if __name__ == "__main__":
    sys.exit(main())
