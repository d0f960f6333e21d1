from .checkpoint import (save, save_async, restore, latest_step,
                         gc_keep_last, wait_pending, gather_full)

__all__ = ["save", "save_async", "restore", "latest_step", "gc_keep_last",
           "wait_pending", "gather_full"]
