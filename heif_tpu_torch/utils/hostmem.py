"""Host allocator tuning for fault-expensive VMs.

Copy of heif_tpu/utils/hostmem.py. Hosts that are Firecracker-style
microVMs serve first-touch page faults very slowly (~100s of us/page), which makes every fresh large
numpy allocation cost orders of magnitude more than the copy itself.
Steady-state (warm-page) bandwidth is normal. Raising glibc's mmap/trim
thresholds keeps large buffers inside the arena across free/alloc cycles,
so repeated decode calls reuse warm pages instead of refaulting.

No-op (safely) on non-glibc platforms.
"""

from __future__ import annotations

import ctypes

_done = False

# glibc mallopt parameter codes
_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3


def tune_allocator() -> bool:
    """Keep big malloc blocks in-arena (idempotent). Returns success."""
    global _done
    if _done:
        return True
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        ok1 = libc.mallopt(_M_MMAP_THRESHOLD, 1 << 30)
        ok2 = libc.mallopt(_M_TRIM_THRESHOLD, 1 << 30)
        _done = bool(ok1 and ok2)
    except Exception:
        _done = False
    return _done

