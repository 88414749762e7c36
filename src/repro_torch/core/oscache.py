"""OS page-cache control: the paper clears the system file cache before each
cold inference ('To eliminate the impacts of file cache, we clear the system
cache before each cold inference'). Works when running privileged; no-op
otherwise (reported so benchmarks can label their numbers)."""
from __future__ import annotations

import os


def drop_page_cache() -> bool:
    try:
        os.sync()
        with open("/proc/sys/vm/drop_caches", "w") as f:
            f.write("3\n")
        return True
    except (PermissionError, FileNotFoundError, OSError):
        return False


CAN_DROP = drop_page_cache()
