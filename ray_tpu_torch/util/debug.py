"""Process-introspection helpers (reference: dashboard/modules/reporter —
py-spy stack traces; here dependency-free via sys._current_frames)."""

from __future__ import annotations

import sys
import threading
import traceback


def dump_all_stacks() -> str:
    """Formatted stacks of every thread in this process, with thread names."""
    names = {t.ident: t.name for t in threading.enumerate()}
    parts = []
    for tid, frame in sys._current_frames().items():
        parts.append(f"--- thread {names.get(tid, '?')} ({tid}) ---\n"
                     + "".join(traceback.format_stack(frame)))
    return "\n".join(parts)
